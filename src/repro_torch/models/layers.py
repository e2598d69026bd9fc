"""Shared layers: the parameter initialiser, norms, dense products, MLPs,
embeddings and rotary position embeddings -- the PyTorch counterpart of the
JAX package's ``models/layers.py``.

Conventions, as in the JAX package:

  * every parameter is created by :class:`ParamInit`, which records its
    initialisation rule on it; :meth:`ParamInit.fill` draws them all from a
    seed, on a CPU ``torch.Generator``, so a model initialised from a seed
    holds the same numbers on every device.  The numbers differ from the
    JAX package's (another generator); parity tests carry parameters
    across with :mod:`repro_torch.models.convert`;
  * the compute dtype is applied by casting the inputs of each product;
    products of parameters with activations come out in the compute dtype.

``scan_layers`` has no counterpart: the port runs its layers in a Python
loop (``StackedLM.apply``), each layer under ``torch.utils.checkpoint``
when the config asks for ``remat="full"``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

__all__ = [
    "ParamInit", "dense", "rmsnorm", "layernorm", "MLP", "mlp_init",
    "mlp_apply", "embed_init", "rope", "apply_rope", "span",
    "abstract_params",
]


@dataclasses.dataclass
class ParamInit:
    """Creates parameters and records how each is drawn and placed.

    ``normal`` draws N(0, 1) times ``scale`` (``1/sqrt(fan_in)`` by default,
    fan_in being ``shape[-2]``, or ``shape[-1]`` for a vector, as in the JAX
    package), ``zeros`` and ``ones`` are constants, ``const`` a given f32
    value cast to the parameter dtype.  Each takes the parameter's logical
    axes (``("embed", "heads", "head_dim")``, ...; one name or None a
    dimension), as the JAX package's do, and records them on the
    parameter as ``logical`` beside ``init_rule``; placement resolves them
    against a mesh (:mod:`repro_torch.parallel.sharding`).  Axes left out
    are None: replicated.  On the ``meta`` device nothing is allocated
    (the JAX package's ``abstract=True``): the shapes alone, for parameter
    counts and placement.
    """

    param_dtype: torch.dtype = torch.float32
    device: torch.device | str = "cpu"

    def _param(self, shape, logical, rule) -> nn.Parameter:
        shape = tuple(shape)
        logical = (None,) * len(shape) if logical is None else tuple(logical)
        if len(logical) != len(shape):
            raise ValueError(f"logical axes {logical} for shape {shape}")
        p = nn.Parameter(torch.empty(shape, dtype=self.param_dtype,
                                     device=self.device))
        p.init_rule = rule
        p.logical = logical
        return p

    def normal(self, shape, logical=None, scale=None) -> nn.Parameter:
        if scale is None:
            scale = 1.0 / math.sqrt(shape[-2] if len(shape) > 1
                                    else shape[-1])
        return self._param(shape, logical, ("normal", scale))

    def zeros(self, shape, logical=None) -> nn.Parameter:
        return self._param(shape, logical, ("zeros", None))

    def ones(self, shape, logical=None) -> nn.Parameter:
        return self._param(shape, logical, ("ones", None))

    def const(self, value, logical=None) -> nn.Parameter:
        value = torch.as_tensor(value, dtype=torch.float32)
        return self._param(value.shape, logical, ("const", value))

    @staticmethod
    @torch.no_grad()
    def fill(module: nn.Module, seed: int) -> None:
        """Draw every parameter of ``module`` in ``parameters()`` order
        from one CPU generator seeded with ``seed``."""
        gen = torch.Generator().manual_seed(int(seed))
        for p in module.parameters():
            if p.device.type == "meta":
                continue
            kind, arg = p.init_rule
            if kind == "normal":
                w = torch.randn(p.shape, generator=gen,
                                dtype=torch.float32) * arg
                p.copy_(w.to(p.dtype))
            elif kind == "zeros":
                p.zero_()
            elif kind == "const":
                p.copy_(arg.to(p.dtype))
            else:
                p.fill_(1.0)


def abstract_params(module: nn.Module):
    """(name -> shape-only tensor, name -> logical axes) of ``module``'s
    parameters, in ``named_parameters()`` order: the JAX package's
    ``abstract_params()`` pair, keyed by the port's parameter names."""
    params = dict(module.named_parameters())
    return ({n: p.detach() for n, p in params.items()},
            {n: p.logical for n, p in params.items()})


def span(name: str):
    """A ``torch.profiler`` range named ``name`` while a profiler records,
    else nothing.  The model code names its parts with these ranges
    (``attention``, ``moe.dispatch``, ``moe.experts``, ``ssd.intra``, ...)
    so that a profile of a step can be split by part: the profiler of
    some builds records no Python stacks with device activity."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


# ----------------------------------------------------------------------
# primitives
# ----------------------------------------------------------------------


def dense(x, w, compute_dtype=None):
    """``x @ w`` contracting x's last dim with w's first; the output stays
    in the compute dtype (cuBLAS accumulates in f32 inside)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    return torch.tensordot(x, w, dims=([x.dim() - 1], [0]))


def rmsnorm(x, scale, eps=1e-6, offset=0.0):
    """RMSNorm.  In f32 (or f64) the plain formula; otherwise the JAX
    package's branch for a backend without bf16 batched dots: the sum of
    squares in f32, the normalisation in ``x.dtype``."""
    if x.dtype in (torch.float32, torch.float64):
        var = torch.mean(x * x, dim=-1, keepdim=True)
        return x * torch.rsqrt(var + eps) * (offset + scale.to(x.dtype))
    xf = x.float()
    ss = torch.sum(xf * xf, dim=-1)
    var = ss / x.shape[-1]
    inv = torch.rsqrt(var + eps)[..., None].to(x.dtype)
    return x * inv * (offset + scale.float()).to(x.dtype)


def layernorm(x, scale, bias, eps=1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(dt)


_ACTS = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


class MLP(nn.Module):
    """The feed-forward sublayer's parameters: ``wi`` (d_model, d_ff),
    ``wo`` (d_ff, d_model) and, gated, ``wg`` (d_model, d_ff)."""

    def __init__(self, pi: ParamInit, d_model: int, d_ff: int,
                 gated: bool = True):
        super().__init__()
        self.wi = pi.normal((d_model, d_ff), ("embed", "mlp"))
        self.wo = pi.normal((d_ff, d_model), ("mlp", "embed"))
        self.wg = (pi.normal((d_model, d_ff), ("embed", "mlp")) if gated
                   else None)


def mlp_init(pi: ParamInit, d_model: int, d_ff: int, act: str = "silu",
             gated: bool = True) -> MLP:
    return MLP(pi, d_model, d_ff, gated=gated)


def mlp_apply(p: MLP, x, act: str = "silu", compute_dtype=torch.bfloat16):
    a = _ACTS[act]
    h = dense(x, p.wi, compute_dtype)
    if p.wg is not None:
        h = a(dense(x, p.wg, compute_dtype)) * h
    else:
        h = a(h)
    return dense(h.to(compute_dtype), p.wo, compute_dtype)


def embed_init(pi: ParamInit, vocab: int, d_model: int) -> nn.Parameter:
    # 0.02 (GPT-2-style): with a tied output head a unit-variance embedding
    # puts the initial logits at O(sqrt(d)) and the initial loss ~4x ln V.
    return pi.normal((vocab, d_model), ("vocab", "embed"), scale=0.02)


# ----------------------------------------------------------------------
# rotary position embeddings
# ----------------------------------------------------------------------


def rope(positions, head_dim: int, theta: float = 10000.0):
    """(..., S) int positions -> (sin, cos) of shape (..., S, head_dim/2),
    in f32."""
    half = head_dim // 2
    expo = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (torch.tensor(theta, dtype=torch.float32,
                                device=positions.device) ** expo)
    ang = positions.float()[..., None] * freqs
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x, sin, cos):
    """x: (..., S, H, D); sin/cos: (..., S, D/2) broadcast over heads.  A
    compute-dtype x times the f32 tables comes out in f32, as in JAX."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    s = sin[..., None, :]
    c = cos[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
