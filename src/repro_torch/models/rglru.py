"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427) --
the PyTorch counterpart of the JAX package's ``models/rglru.py``.

The temporal core is a diagonal gated linear recurrence

    a_t = exp(-c * softplus(Lambda) * r_t),   r_t = sigmoid(W_a x_t + b_a)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The JAX package evaluates it with ``jax.lax.associative_scan``; the port
with a Hillis-Steele scan of the same ``combine``: ceil(log2 S) steps, each
combining every position with the one 2^j before it, so a sequence of 2048
costs 11 steps of whole-tensor operations rather than 2048.  Both are
exact prefix scans of an associative operator; they sum in another order,
so they agree to f32 rounding.

The block follows RecurrentGemma's recurrent layer: two input branches
(one conv1d(4) + RG-LRU, one GeLU gate), multiplied, projected out.
Decode carries O(1) state: the (B, d_rnn) hidden state and a (K-1)-step
conv ring (``rglru_state``, ``rglru_decode``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import _ACTS, ParamInit, dense, span

__all__ = ["RGLRU", "rglru_init", "rglru_apply", "rglru_decode",
           "rglru_state", "linear_scan"]

_C = 8.0


class RGLRU(nn.Module):
    """The recurrent mixer's parameters: ``wx``/``wy`` (d_model, d_rnn),
    ``conv_w`` (K, d_rnn), ``conv_b``, the gates ``wa``/``wi`` (d_rnn,
    d_rnn) with ``ba``/``bi``, ``lam`` (d_rnn,) and ``out`` (d_rnn,
    d_model)."""

    def __init__(self, pi: ParamInit, d_model: int, d_rnn: int, *,
                 d_conv: int = 4):
        super().__init__()
        r = ("rnn",)
        self.wx = pi.normal((d_model, d_rnn), ("embed", "rnn"))
        self.wy = pi.normal((d_model, d_rnn), ("embed", "rnn"))
        self.conv_w = pi.normal((d_conv, d_rnn), ("conv", "rnn"), scale=0.5)
        self.conv_b = pi.zeros((d_rnn,), r)
        self.wa = pi.normal((d_rnn, d_rnn), ("rnn", None), scale=0.02)
        self.ba = pi.zeros((d_rnn,), r)
        self.wi = pi.normal((d_rnn, d_rnn), ("rnn", None), scale=0.02)
        self.bi = pi.zeros((d_rnn,), r)
        self.lam = pi.const(torch.linspace(0.5, 4.0, d_rnn), r)
        self.out = pi.normal((d_rnn, d_model), ("rnn", "embed"))


def rglru_init(pi: ParamInit, d_model: int, d_rnn: int, *,
               d_conv: int = 4) -> RGLRU:
    return RGLRU(pi, d_model, d_rnn, d_conv=d_conv)


def _gates(p: RGLRU, x):
    """x: (..., d_rnn) after the conv -> the recurrence's (a, b), f32."""
    r = torch.sigmoid(dense(x, p.wa, torch.float32) + p.ba.float())
    i = torch.sigmoid(dense(x, p.wi, torch.float32) + p.bi.float())
    log_a = -_C * F.softplus(p.lam.float()) * r
    a = torch.exp(log_a)
    b = (torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
         * (i * x.float()))
    return a, b


def _conv(x, w, b):
    """Depthwise causal conv along the sequence (no activation)."""
    K, S = w.shape[0], x.shape[1]
    pads = F.pad(x, (0, 0, K - 1, 0))
    out = pads[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + pads[:, i:i + S] * w[i]
    return out + b


def linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along dim 1, as a
    Hillis-Steele scan of ``combine((a_l, b_l), (a_r, b_r)) = (a_l a_r,
    a_r b_l + b_r)``: step j combines each position with the partial
    result 2^j positions before it (an identity (1, 0) before the start).
    Returns h, shaped like b."""
    with span("rglru.scan"):
        S = a.shape[1]
        d = 1
        while d < S:
            pad = [0, 0] * (a.dim() - 2) + [d, 0]
            a_prev = F.pad(a[:, :S - d], pad, value=1.0)
            b_prev = F.pad(b[:, :S - d], pad, value=0.0)
            b = a * b_prev + b
            a = a * a_prev
            d *= 2
        return b


def rglru_apply(p: RGLRU, u, *, compute_dtype=torch.bfloat16,
                init_state=None, return_state: bool = False):
    """u: (B, S, E) -> (B, S, E) [, the last hidden state (B, d_rnn)]."""
    x = dense(u, p.wx, compute_dtype)
    g = _ACTS["gelu"](dense(u, p.wy, compute_dtype))
    x = _conv(x.to(compute_dtype), p.conv_w.to(compute_dtype),
              p.conv_b.to(compute_dtype))
    a, b = _gates(p, x)
    if init_state is not None:
        # fold the carried state into step 0: h_0 = a_0 h_init + b_0
        b = torch.cat([b[:, :1] + a[:, :1] * init_state.float()[:, None],
                       b[:, 1:]], dim=1)
    h = linear_scan(a, b)
    y = h.to(compute_dtype) * g.to(compute_dtype)
    out = dense(y, p.out, compute_dtype, residual=True).to(u.dtype)
    if return_state:
        return out, h[:, -1]
    return out


def rglru_state(p: RGLRU, batch: int) -> dict:
    """Zero decode state: ``h`` (B, d_rnn) f32, ``conv`` the (B, K-1,
    d_rnn) bf16 ring."""
    d_rnn, K = p.lam.shape[0], p.conv_w.shape[0]
    dev = p.lam.device
    return {"h": torch.zeros((batch, d_rnn), dtype=torch.float32,
                             device=dev),
            "conv": torch.zeros((batch, K - 1, d_rnn), dtype=torch.bfloat16,
                                device=dev)}


def rglru_decode(p: RGLRU, u, state: dict, *, compute_dtype=torch.bfloat16):
    """One-token step: u (B, 1, E) -> (out (B, 1, E), the new state)."""
    x = dense(u, p.wx, compute_dtype)                    # (B, 1, R)
    g = _ACTS["gelu"](dense(u, p.wy, compute_dtype))
    win = torch.cat([state["conv"].to(compute_dtype), x.to(compute_dtype)],
                    dim=1)
    xc = torch.einsum("bkc,kc->bc", win, p.conv_w.to(compute_dtype))
    xc = (xc + p.conv_b.to(xc.dtype))[:, None]
    a, b = _gates(p, xc)
    h = a[:, 0] * state["h"] + b[:, 0]
    y = h[:, None].to(compute_dtype) * g.to(compute_dtype)
    out = dense(y, p.out, compute_dtype).to(u.dtype)
    return out, {"h": h, "conv": win[:, 1:].to(state["conv"].dtype)}
