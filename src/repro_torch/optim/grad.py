"""Gradient utilities: global-norm clipping and int8 error-feedback
compression, on name -> tensor dicts (the JAX package's ``optim/grad.py``).

Compression: per-tensor scale max|g| / 127, quantise to int8, and carry
the quantisation error in an f32 buffer added to the next step's
gradient, so the compression is unbiased over time.
"""
from __future__ import annotations

import torch

__all__ = ["clip_by_global_norm", "compress_int8", "decompress_int8",
           "ef_compress_grads"]


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """(clipped grads, global norm in f32)."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                        for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, gn


def compress_int8(x):
    scale = torch.max(torch.abs(x.float())) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(x.float() / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.float() * scale


def ef_compress_grads(grads: dict, errors: dict | None):
    """Error-feedback int8 compression of a gradient dict.  Returns
    ({name: (q, scale)}, {name: new error})."""
    if errors is None:
        errors = {k: torch.zeros(g.shape, dtype=torch.float32,
                                 device=g.device) for k, g in grads.items()}
    quant, new_err = {}, {}
    for k, g in grads.items():
        corrected = g.float() + errors[k]
        q, s = compress_int8(corrected)
        quant[k] = (q, s)
        new_err[k] = corrected - decompress_int8(q, s)
    return quant, new_err
