"""Shared parity rule for the PyTorch port's tests.

A framework change reorders f32 sums, so the port is held to the reference
by a tolerance, not bit equality: distances ``allclose(rtol=1e-5,
atol=1e-6)``, ids equal apart from ties -- the rule of
:func:`repro_torch.core.exact.assert_topk_close`, which ``chip_smoke.py``
applies on the card too.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.exact import assert_topk_close

RTOL, ATOL = 1e-5, 1e-6

# the suite runs several workers at once, each beside XLA's own threads;
# these tests' tensors are small, so torch's intra-op threads only contend
torch.set_num_threads(1)


def assert_topk_parity(d, i, ref_d, ref_i, kth_next=None):
    assert_topk_close(d, i, ref_d, ref_i, kth_next, rtol=RTOL, atol=ATOL)


def oracle(points: np.ndarray, queries: np.ndarray, k: int):
    """Brute-force top-(k+1) in float64: ``(dists (B,k), ids (B,k),
    kth_next (B,))``; ``points`` carry the appended 1-coordinate."""
    d = np.abs(queries.astype(np.float64) @ points.astype(np.float64).T)
    order = np.argsort(d, axis=1, kind="stable")[:, :k + 1]
    dd = np.take_along_axis(d, order, axis=1)
    nxt = dd[:, k] if dd.shape[1] > k else np.full(len(d), np.inf)
    return dd[:, :k], order[:, :k], nxt
