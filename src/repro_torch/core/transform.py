"""Asymmetric NH/FH transforms (Huang et al., SIGMOD'21) used by the
baselines :mod:`repro_torch.core.nh` and :mod:`repro_torch.core.fh`.

The key identity: with ``f(x) = [x_i^2 ; sqrt(2) x_i x_j (i<j)]`` (dimension
``D = d(d+1)/2``) and the same map ``g`` applied to the query,

    <f(x), g(q)> = (sum_i x_i q_i)^2 = <x, q>^2 .

NH appends a norm-completion coordinate to the data side so all transformed
points share the norm ``M`` (``P(y) = [y; sqrt(M^2-||y||^2)]``) and negates
the query side (``Q(z) = [-z; 0]``), turning min-|<x,q>| into classical NNS
in the lifted space.  FH keeps data norms and instead partitions by
``||f(x)||``.  The sampled variant (``sample_pairs`` + ``sampled_lift``)
estimates ``<x,q>^2`` from ``lam`` uniformly sampled ordered coordinate
pairs, a lifted dimension of ``O(lam)``.

Host numpy, the JAX package's expressions one for one: the lifted points
decide the hash tables, so the same inputs give bit-equal outputs (the
float64 norm accumulation and the f32 ``sqrt(2)`` included).
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "lift_dim",
    "lift",
    "sample_pairs",
    "sampled_lift",
    "nh_data_transform",
    "nh_query_transform",
]


def lift_dim(d: int) -> int:
    return d * (d + 1) // 2


def lift(x: np.ndarray) -> np.ndarray:
    """Exact quadratic lift f(x): (n, d) -> (n, d(d+1)/2), float32.

    Layout: diagonal terms first, then sqrt(2)-scaled upper-triangle terms.
    """
    x = np.asarray(x, dtype=np.float32)
    n, d = x.shape
    iu, ju = np.triu_indices(d, k=1)
    out = np.empty((n, lift_dim(d)), dtype=np.float32)
    out[:, :d] = x * x
    out[:, d:] = np.sqrt(np.float32(2.0)) * x[:, iu] * x[:, ju]
    return out


def sample_pairs(d: int, lam: int, rng: np.random.Generator):
    """lam uniformly-sampled ordered index pairs (the SIGMOD'21 sampling)."""
    return rng.integers(0, d, size=(2, lam))


def sampled_lift(x: np.ndarray, pairs: np.ndarray) -> np.ndarray:
    """Sampled lift: (n, d) -> (n, lam); <f_s(x), f_s(q)> ~ (lam/d^2)<x,q>^2."""
    x = np.asarray(x, dtype=np.float32)
    return x[:, pairs[0]] * x[:, pairs[1]]


def nh_data_transform(fx: np.ndarray):
    """P o f: append the norm-completion coordinate (all rows -> norm M)."""
    sq = (fx.astype(np.float64) ** 2).sum(axis=1)
    M2 = float(sq.max())
    last = np.sqrt(np.maximum(M2 - sq, 0.0)).astype(np.float32)
    return np.concatenate([fx, last[:, None]], axis=1), np.sqrt(M2)


def nh_query_transform(fq: np.ndarray) -> np.ndarray:
    """Q o g: negate and zero-pad the query side."""
    zero = np.zeros((fq.shape[0], 1), dtype=np.float32)
    return np.concatenate([-fq, zero], axis=1)
