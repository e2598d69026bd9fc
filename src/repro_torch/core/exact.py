"""Brute-force P2HNNS oracle: argmin_x |<x, q>| (paper Definition 1).

The ground truth for recall and the correctness oracle of every search
scheme and kernel of the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch.platform import ensure_full_precision

__all__ = ["exact_search", "p2h_dists", "topk_smallest", "assert_topk_close",
           "dists64", "assert_exact_topk", "verify_candidates"]


def topk_smallest(dists, ids, k: int):
    """The ``k`` smallest ``dists`` along the last axis, ascending, with
    their ``ids``.  Equal values keep their input order (lower index first),
    the tie rule of ``lax.top_k`` -- ``torch.topk`` promises none."""
    order = torch.argsort(dists, dim=-1, stable=True)[..., :k]
    return torch.gather(dists, -1, order), torch.gather(ids, -1, order)


def assert_topk_close(d, i, ref_d, ref_i, kth_next=None, *,
                      rtol: float = 1e-5, atol=1e-6) -> float:
    """Hold a top-k answer ``(d, i)`` to a reference ``(ref_d, ref_i)``,
    both (B, k) and sorted ascending; returns the largest absolute distance
    error, raises ``AssertionError`` on a mismatch.

    A framework change reorders f32 sums, so distances must be
    ``allclose(rtol, atol)``, and ids equal except among ties: an id may
    stand anywhere among the reference's entries whose distance ties its
    own within that tolerance, and is free where the reference's k-th
    distance ties the (k+1)-th, ``kth_next`` (B,), when that is given.
    ``atol`` is a scalar or one tolerance per row, (B,).
    """
    d, i, ref_d, ref_i = (np.asarray(a) for a in (d, i, ref_d, ref_i))
    atol = np.broadcast_to(np.asarray(atol, np.float64).reshape(-1),
                           (d.shape[0],))
    with np.errstate(invalid="ignore"):  # inf - inf where both are +inf
        err = np.where(np.isinf(d) & np.isinf(ref_d), 0.0,
                       np.abs(d - ref_d))
    if not np.allclose(d, ref_d, rtol=rtol, atol=atol[:, None]):
        raise AssertionError(f"distances differ: max abs error "
                             f"{float(err.max())}")
    for b in np.nonzero((i != ref_i).any(axis=1))[0]:
        near = np.isclose(ref_d[b][:, None], ref_d[b][None, :],
                          rtol=rtol, atol=atol[b])
        boundary = kth_next is not None and np.isclose(
            ref_d[b, -1], kth_next[b], rtol=rtol, atol=atol[b])
        for j in np.nonzero(i[b] != ref_i[b])[0]:
            if (boundary and near[j, -1]) or i[b, j] in ref_i[b][near[j]]:
                continue
            raise AssertionError(f"row {b} slot {j}: id {i[b, j]} vs "
                                 f"reference {ref_i[b, j]} at distance "
                                 f"{ref_d[b, j]}")
    return float(err.max())


def dists64(points, queries, ids):
    """``|<q_b, x_i>|`` in float64 for each id ``i`` of row ``b`` of ``ids``
    (B, m), from the f32 operands ``points`` (n, d) and ``queries`` (B, d);
    returns ``(dists (B, m), sum_j |q_bj x_ij| (B, m))``, the second the
    scale of an f32 evaluation's rounding error."""
    terms = points[ids.long()].double() * queries.double()[:, None, :]
    return torch.abs(terms.sum(-1)), torch.abs(terms).sum(-1)


def assert_exact_topk(d, i, ref_i, points, queries, *, rtol: float = 1e-5,
                      atol=1e-6) -> float:
    """Hold an exact route's f32 answer ``(d, i)`` (B, k) to an oracle's
    top-(k+1) ids ``ref_i`` (B, k+1); returns the largest ``|d - d64|``,
    raises ``AssertionError`` on a mismatch.

    Every id's ``|<q, x>|`` is recomputed in float64 from the f32 operands
    ``points`` (n, d) and ``queries`` (B, d), on their device:

      * the ids must equal the oracle's apart from ties, under
        :func:`assert_topk_close` at ``rtol``/``atol`` applied to those
        float64 distances (each side sorted by them; the oracle's (k+1)-th
        gives the boundary tie).  The same id then has the same distance on
        both sides, whatever order either side's f32 sums ran in, so a
        dropped true neighbour fails once its distance stands more than the
        tolerance from its replacement's (``atol`` a scalar or one per
        row);
      * each returned f32 distance must lie within the forward error bound
        of an f32 dot product of length d in any summation order,
        ``gamma_d * sum_j |q_j x_j|`` with ``gamma_d = d u / (1 - d u)``,
        ``u = 2**-24``, of its id's float64 distance.
    """
    dev = points.device
    d = torch.as_tensor(d).to(dev, torch.float64)
    ids = torch.as_tensor(i).to(dev, torch.int64)
    ref = torch.as_tensor(ref_i).to(dev, torch.int64)
    if (ids < 0).any():
        raise AssertionError("an exact route left a top-k slot empty")
    d64, mag = dists64(points, queries, ids)
    gamma = points.shape[1] * 2.0 ** -24 / (1 - points.shape[1] * 2.0 ** -24)
    err = torch.abs(d - d64)
    over = err - gamma * mag
    if (over > 0).any():
        b, j = (int(v) for v in np.unravel_index(int(torch.argmax(over)),
                                                  tuple(over.shape)))
        raise AssertionError(
            f"row {b} slot {j}: distance {float(d[b, j])} of id "
            f"{int(ids[b, j])} is not an f32 evaluation of its float64 "
            f"distance {float(d64[b, j])}")

    def by_dist(dd, ii):
        order = torch.argsort(dd, dim=1, stable=True)
        return (torch.gather(dd, 1, order).cpu().numpy(),
                torch.gather(ii, 1, order).cpu().numpy())

    k = ids.shape[1]
    r64 = dists64(points, queries, ref)[0]
    assert_topk_close(*by_dist(d64, ids), *by_dist(r64[:, :k], ref[:, :k]),
                      r64[:, k].cpu().numpy(), rtol=rtol, atol=atol)
    return float(err.max())


def p2h_dists(points, queries):
    """|<x, q>| for all pairs -> (num_queries, n)."""
    ensure_full_precision(queries.device)
    return torch.abs(queries @ points.T)


def exact_search(points, queries, k: int = 1, chunk: int = 65536):
    """Exact top-k P2HNNS by chunked scan.

    Args:
      points: (n, d) with the appended 1-coordinate.
      queries: (b, d) hyperplane queries, on the same device.
    Returns:
      (dists (b,k) f32, ids (b,k) i32) sorted ascending by distance.
    """
    ensure_full_precision(queries.device)
    n, b = points.shape[0], queries.shape[0]
    best_d = torch.full((b, k), float("inf"), dtype=points.dtype,
                        device=points.device)
    best_i = torch.full((b, k), -1, dtype=torch.int32, device=points.device)
    for off in range(0, n, chunk):
        xc = points[off:off + chunk]
        d = torch.abs(queries @ xc.T)  # (b, chunk)
        ids = torch.arange(off, off + xc.shape[0], dtype=torch.int32,
                           device=points.device).expand(b, -1)
        best_d, best_i = topk_smallest(torch.cat([best_d, d], dim=1),
                                       torch.cat([best_i, ids], dim=1), k)
    return best_d, best_i


def verify_candidates(points, queries, cand, k: int, chunk: int = 256):
    """Top-k of each query over its own candidate ids, the verification
    step of the hashing baselines (NH, FH).

    Args:
      points: (n, d) with the appended 1-coordinate, on the device.
      queries: (B, d) on the same device.
      cand: B host integer arrays of candidate ids (any may be empty).
    Returns:
      (dists (B,k) f32, ids (B,k) i32) ascending; a row with fewer than k
      candidates ends in +inf / -1.

    One batched pass per ``chunk`` queries: the ids padded to the chunk's
    widest set with -1, the rows gathered, ``|X_c . q|`` by a batched
    product, pads masked to +inf, and the k smallest kept
    (:func:`topk_smallest`).  A chunk of 256 queries of 2048 candidates at
    d = 129 gathers 270 MB.
    """
    ensure_full_precision(queries.device)
    dev = points.device
    B = queries.shape[0]
    out_d = torch.full((B, k), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    for off in range(0, B, chunk):
        rows = cand[off:off + chunk]
        width = max([k] + [len(c) for c in rows])
        ids = np.full((len(rows), width), -1, np.int64)
        for r, c in enumerate(rows):
            ids[r, :len(c)] = c
        ids = torch.from_numpy(ids).to(dev)
        x = points[ids.clamp(min=0)]  # (c, width, d)
        q = queries[off:off + len(rows)]
        d = torch.abs(torch.bmm(x, q[:, :, None])[..., 0])
        d = torch.where(ids >= 0, d, torch.full_like(d, float("inf")))
        out_d[off:off + len(rows)], out_i[off:off + len(rows)] = \
            topk_smallest(d, ids.to(torch.int32), k)
    return out_d, out_i
