"""Mamba-2 (SSD, state-space duality -- arXiv:2405.21060) -- the PyTorch
counterpart of the JAX package's ``models/ssm.py``.

The chunked SSD form: within chunks of length Q the token mixing is a
masked, attention-like product, computed for every chunk at once; across
chunks a Python loop carries the (B, H, N, P) state, one step a chunk (the
JAX package's ``lax.scan`` over chunks, whose steps also hold the
intra-chunk products).  All of the scan's arithmetic is f32.

One deliberate difference: the intra-chunk decay ``exp(L_t - L_s)`` is
masked by sending the upper triangle's exponent to -inf before the
``exp`` (the JAX package takes the ``exp`` of every entry and zeroes the
upper triangle after).  The forward is the same; where an upper-triangle
exponent overflows to inf, the JAX package's gradient is 0 * inf = NaN and
the port's stays finite.

Decode carries O(1) state a layer: the SSM state (B, H, N, P) and a
(K-1)-step depthwise-conv ring (``mamba2_state``, ``mamba2_decode``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (
    ParamInit,
    dense,
    product,
    rmsnorm,
    span,
)

__all__ = ["Mamba2", "mamba2_init", "mamba2_apply", "mamba2_decode",
           "mamba2_state", "ssd_chunked"]


class Mamba2(nn.Module):
    """The Mamba-2 mixer's parameters: ``in_proj`` (d_model, 2 d_inner +
    2 G N + H), ``conv_w`` (K, conv_dim), ``conv_b``, ``A_log``,
    ``dt_bias``, ``D`` (H,), ``norm`` (d_inner,), ``out_proj``."""

    def __init__(self, pi: ParamInit, d_model: int, *, d_state: int = 128,
                 headdim: int = 64, expand: int = 2, d_conv: int = 4,
                 n_groups: int = 1):
        super().__init__()
        d_inner = expand * d_model
        nheads = d_inner // headdim
        conv_dim = d_inner + 2 * n_groups * d_state
        d_in_proj = 2 * d_inner + 2 * n_groups * d_state + nheads
        self.in_proj = pi.normal((d_model, d_in_proj), ("embed", "rnn"))
        self.conv_w = pi.normal((d_conv, conv_dim), ("conv", "rnn"),
                                scale=0.5)
        self.conv_b = pi.zeros((conv_dim,), ("rnn",))
        self.A_log = pi.const(torch.log(torch.linspace(1.0, 16.0, nheads)),
                              ("heads",))
        self.dt_bias = pi.const(torch.log(torch.expm1(
            torch.full((nheads,), 1e-2))), ("heads",))
        self.D = pi.ones((nheads,), ("heads",))
        self.norm = pi.ones((d_inner,), ("rnn",))
        self.out_proj = pi.normal((d_inner, d_model), ("rnn", "embed"))


def mamba2_init(pi: ParamInit, d_model: int, *, d_state: int = 128,
                headdim: int = 64, expand: int = 2, d_conv: int = 4,
                n_groups: int = 1) -> Mamba2:
    return Mamba2(pi, d_model, d_state=d_state, headdim=headdim,
                  expand=expand, d_conv=d_conv, n_groups=n_groups)


def _dims(p: Mamba2):
    d_model = p.in_proj.shape[0]
    nheads = p.A_log.shape[0]
    d_conv, conv_dim = p.conv_w.shape
    d_inner = p.norm.shape[0]
    gn = (conv_dim - d_inner) // 2  # n_groups * d_state
    headdim = d_inner // nheads
    return d_model, d_inner, nheads, headdim, gn, d_conv


def _causal_conv(xBC, w, b):
    """Depthwise causal conv along the sequence, then SiLU.  xBC (B, S, C);
    w (K, C); the K taps summed in order, in xBC's dtype."""
    K, S = w.shape[0], xBC.shape[1]
    pads = F.pad(xBC, (0, 0, K - 1, 0))
    out = pads[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pads[:, i:i + S] * w[i]
    return F.silu(out + b)


def _chunk_intra(xc, dtc, Bc, Cc, csum, mask):
    """Every chunk's own tokens at once: the masked, attention-like
    product sum_s C_t.B_s exp(L_t - L_s) dt_s x_s over s <= t.  Operands
    carry a chunk axis: xc (B, nc, Q, H, P), dtc and csum (B, nc, Q, H),
    Bc and Cc (B, nc, Q, N)."""
    with span("ssd.intra"):
        with product(True):
            CB = torch.einsum("bctn,bcsn->bcts", Cc, Bc)
        seg = csum[:, :, :, None, :] - csum[:, :, None, :, :]  # (B,c,t,s,H)
        decay = torch.exp(torch.where(mask[None, None, :, :, None], seg,
                                      -math.inf))
        M = CB[..., None] * decay * dtc[:, :, None, :, :]
        with product(True):
            return torch.einsum("bctsh,bcshp->bcthp", M, xc)


def _chunk_state(xc, dtc, Bc, Cc, csum, s):
    """The state across chunks: each chunk's contribution to the state at
    its end, carried in chunk order from ``s`` (a loop over the chunks on
    (B, H, N, P) states, the JAX package's ``lax.scan``), and what the
    state entering each chunk adds to its outputs.  Returns (y_inter
    (B, nc, Q, H, P), the final state)."""
    with span("ssd.state"):
        wts = dtc * torch.exp(csum[:, :, -1:, :] - csum)     # (B,c,Q,H)
        xw = xc * wts[..., None]
        with product(True):
            st = torch.einsum("bcsn,bcshp->bchnp", Bc, xw)
        last = torch.exp(csum[:, :, -1])                     # (B,c,H)
        entering = []
        for c in range(xc.shape[1]):
            entering.append(s)
            s = s * last[:, c, :, None, None] + st[:, c]
        s_in = torch.stack(entering, dim=1)
        with product(True):
            y_inter = torch.einsum("bctn,bchnp->bcthp", Cc, s_in)
        y_inter = y_inter * torch.exp(csum)[..., None]
        return y_inter, s


def ssd_chunked(x, dt, A, Bm, Cm, *, chunk: int = 256, init_state=None,
                return_state: bool = False, unroll: int = 1):
    """Chunked SSD scan.

    x: (B, S, H, P); dt: (B, S, H) (after the softplus); A: (H,) negative;
    Bm, Cm: (B, S, N) (one group, broadcast over heads).  Returns y
    (B, S, H, P) in x's dtype [, the final state (B, H, N, P) f32].
    ``unroll`` is the JAX package's scan unrolling, without effect here.

    The intra-chunk products of every chunk run at once (they do not
    depend on the state); only the state's recurrence loops over chunks.
    """
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    pad = (-S) % Q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    nc = x.shape[1] // Q
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    s = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    xc = x.float().reshape(Bsz, nc, Q, H, P)
    dtc = dt.float().reshape(Bsz, nc, Q, H)
    Bc = Bm.float().reshape(Bsz, nc, Q, N)
    Cc = Cm.float().reshape(Bsz, nc, Q, N)
    csum = torch.cumsum(dtc * A, dim=2)                 # (B,c,Q,H) L_t
    y_inter, s = _chunk_state(xc, dtc, Bc, Cc, csum, s)
    y = _chunk_intra(xc, dtc, Bc, Cc, csum, mask) + y_inter
    y = y.reshape(Bsz, nc * Q, H, P)[:, :S].to(x.dtype)
    if return_state:
        return y, s
    return y


def mamba2_apply(p: Mamba2, u, *, chunk: int = 256,
                 compute_dtype=torch.bfloat16, init_state=None,
                 return_state: bool = False, unroll: int = 1):
    """The Mamba-2 block: u (B, S, E) -> (B, S, E) [, final state]."""
    d_model, d_inner, H, P, gn, K = _dims(p)
    N = gn  # one group
    zxbcdt = dense(u, p.in_proj, compute_dtype)
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * gn]
    dt_raw = zxbcdt[..., -H:]
    xBC = _causal_conv(xBC.to(compute_dtype), p.conv_w.to(compute_dtype),
                       p.conv_b.to(compute_dtype))
    x = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + N].float()
    Cm = xBC[..., d_inner + N:].float()
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())
    A = -torch.exp(p.A_log.float())
    Bsz, S = u.shape[:2]
    xh = x.reshape(Bsz, S, H, P)
    res = ssd_chunked(xh, dt, A, Bm, Cm, chunk=chunk, init_state=init_state,
                      return_state=return_state, unroll=unroll)
    y, s_final = res if return_state else (res, None)
    y = y + p.D.to(y.dtype)[None, None, :, None] * xh.to(y.dtype)
    y = y.reshape(Bsz, S, d_inner)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p.norm)
    out = dense(y.to(compute_dtype), p.out_proj, compute_dtype,
                residual=True).to(u.dtype)
    if return_state:
        return out, s_final
    return out


def mamba2_state(p: Mamba2, batch: int) -> dict:
    """Zero decode state: ``ssm`` (B, H, N, P) f32, ``conv`` the
    (B, K-1, conv_dim) bf16 ring."""
    d_model, d_inner, H, P, gn, K = _dims(p)
    dev = p.in_proj.device
    return {
        "ssm": torch.zeros((batch, H, gn, P), dtype=torch.float32,
                           device=dev),
        "conv": torch.zeros((batch, K - 1, d_inner + 2 * gn),
                            dtype=torch.bfloat16, device=dev),
    }


def mamba2_decode(p: Mamba2, u, state: dict, *,
                  compute_dtype=torch.bfloat16):
    """One-token step: u (B, 1, E) and a state from :func:`mamba2_state`
    -> (out (B, 1, E), the new state)."""
    d_model, d_inner, H, P, gn, K = _dims(p)
    N = gn
    zxbcdt = dense(u, p.in_proj, compute_dtype)       # (B, 1, .)
    z = zxbcdt[..., :d_inner]
    xBC_new = zxbcdt[..., d_inner:2 * d_inner + 2 * gn]
    dt_raw = zxbcdt[..., -H:]
    # the conv window: [ring, new]
    win = torch.cat([state["conv"].to(compute_dtype),
                     xBC_new.to(compute_dtype)], dim=1)  # (B, K, C)
    conv_out = torch.einsum("bkc,kc->bc", win, p.conv_w.to(compute_dtype))
    xBC = F.silu(conv_out + p.conv_b.to(conv_out.dtype))[:, None]
    new_conv = win[:, 1:].to(state["conv"].dtype)
    x = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + N].float()[:, 0]    # (B, N)
    Cm = xBC[..., d_inner + N:].float()[:, 0]
    dt = F.softplus(dt_raw.float() + p.dt_bias.float())[:, 0]  # (B, H)
    A = -torch.exp(p.A_log.float())
    xh = x.reshape(-1, H, P).float()                     # (B, H, P)
    dA = torch.exp(dt * A[None, :])                      # (B, H)
    s = (state["ssm"] * dA[:, :, None, None]
         + torch.einsum("bn,bhp->bhnp", Bm, dt[:, :, None] * xh))
    y = torch.einsum("bn,bhnp->bhp", Cm, s)
    y = y + p.D.float()[None, :, None] * xh
    y = y.reshape(-1, 1, d_inner)
    y = rmsnorm(y.to(u.dtype) * F.silu(z.float()).to(u.dtype), p.norm)
    out = dense(y.to(compute_dtype), p.out_proj, compute_dtype)
    return out.to(u.dtype), {"ssm": s, "conv": new_conv}
