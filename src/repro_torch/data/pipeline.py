"""Synthetic P2HNNS point sets and hyperplane queries (host numpy).

The same generator as the JAX package's ``data/pipeline.py``: with the same
arguments it returns bit-identical arrays, so both packages can be fed the
same data from a seed.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_p2h_dataset"]


def make_p2h_dataset(n: int, d: int, *, kind: str = "clustered",
                     n_queries: int = 100, seed: int = 0):
    """Point set (n, d) + hyperplane queries (n_queries, d+1).

    Kinds: "normal" (isotropic), "clustered" (GMM, the common real-data
    shape), "unit" (normalized), "heavy" (Cauchy-ish heavy tails),
    "planted" (clustered points near a low-dimensional subspace -- the
    low-intrinsic-dimension regime where metric-tree bounds prune).
    """
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x = rng.normal(size=(n, d))
    elif kind == "clustered":
        k = max(4, d // 8)
        centers = rng.normal(size=(k, d)) * 4.0
        x = centers[rng.integers(0, k, n)] + rng.normal(size=(n, d)) * 0.5
    elif kind == "planted":
        # planted clusters in a k_lat-dim latent subspace, projected to the
        # ambient dim with small isotropic noise: intrinsic dim ~ k_lat << d
        k_lat = max(2, d // 16)
        n_c = 8
        basis = np.linalg.qr(rng.normal(size=(d, k_lat)))[0]
        centers = rng.normal(size=(n_c, k_lat)) * 6.0
        z = centers[rng.integers(0, n_c, n)] \
            + rng.normal(size=(n, k_lat))
        x = z @ basis.T + rng.normal(size=(n, d)) * 0.05
    elif kind == "unit":
        x = rng.normal(size=(n, d))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    elif kind == "heavy":
        x = rng.standard_cauchy(size=(n, d)).clip(-50, 50)
    else:
        raise ValueError(kind)
    # queries: random hyperplanes through the data region; coefficients
    # ~ N(0,1), bias placed near the data
    q = rng.normal(size=(n_queries, d + 1))
    anchor = x[rng.integers(0, n, n_queries)]
    q[:, -1] = -np.einsum("qd,qd->q", q[:, :-1], anchor)
    q[:, -1] += rng.normal(scale=0.1, size=n_queries)
    return x.astype(np.float32), q.astype(np.float32)
