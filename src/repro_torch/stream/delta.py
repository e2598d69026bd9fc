"""Fixed-capacity delta buffer: the LSM "memtable" of the mutable index.

Freshly inserted points land here before any tree exists over them.  The
buffer is a pair of preallocated host arrays -- ``points (C, d)`` (with the
appended 1-coordinate) and ``gids (C,)`` (global ids, -1 for empty/deleted
rows) -- written append-only: row ``i`` is assigned once, at insert time,
and never moves.  A snapshot therefore captures ``(points, gids.copy(),
length)`` and later inserts, which only touch rows ``>= length``, leave the
pinned view consistent without copying the point block.

Queries over the delta are an exact brute-force scan: one ``(B, C)`` matmul
on the query's device with dead rows masked to +inf (a plain product, not a
kernel, as in the JAX package).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.exact import topk_smallest

__all__ = ["DeltaBuffer", "delta_topk"]


def delta_topk(points: np.ndarray, gids: np.ndarray, queries, k: int):
    """Exact top-k over the delta rows on ``queries``' device; ``(dists
    (B, k), gids (B, k))``, ties in row order (``lax.top_k``'s rule)."""
    dev = queries.device
    pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(dev)
    g = torch.from_numpy(np.ascontiguousarray(gids, np.int32)).to(dev)
    d = torch.abs(queries @ pts.T)  # (B, C)
    d = torch.where(g[None, :] >= 0, d, float("inf"))
    if k > d.shape[1]:  # fewer rows than k: pad with invalid slots
        pad = k - d.shape[1]
        d = F.pad(d, (0, pad), value=float("inf"))
        g = F.pad(g, (0, pad), value=-1)
    bd, bi = topk_smallest(d, g.expand(d.shape[0], -1), k)
    return bd, torch.where(torch.isfinite(bd), bi, -1)


class DeltaBuffer:
    """Append-only write buffer with in-place tombstoning.

    Not thread-safe by itself; :class:`~repro_torch.stream.mutable.
    MutableP2HIndex` serialises all writers behind one lock.
    """

    def __init__(self, capacity: int, d: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = int(capacity)
        self.d = int(d)
        self.points = np.zeros((self.capacity, self.d), np.float32)
        self.gids = np.full((self.capacity,), -1, np.int32)
        self.length = 0  # rows assigned (live + tombstoned)

    # ------------------------------------------------------------------
    @property
    def full(self) -> bool:
        return self.length >= self.capacity

    @property
    def live(self) -> int:
        return int((self.gids[: self.length] >= 0).sum())

    def append(self, point: np.ndarray, gid: int) -> int:
        """Assign the next row; returns the row index.  Caller checks
        ``full`` first (a full delta must be sealed by compaction)."""
        assert not self.full, "delta buffer full: compact before appending"
        row = self.length
        self.points[row] = point
        self.gids[row] = gid
        self.length += 1
        return row

    def tombstone(self, row: int) -> None:
        self.gids[row] = -1

    # ------------------------------------------------------------------
    def live_rows(self):
        """(points, gids) of the live rows -- compaction input."""
        mask = self.gids[: self.length] >= 0
        return self.points[: self.length][mask], self.gids[: self.length][mask]

    def frozen_view(self):
        """Immutable (points, gids, length) triple for a snapshot:
        ``points`` is shared (rows past ``length`` do not affect the view),
        ``gids`` is copied so later tombstones do not leak into it."""
        return self.points, self.gids.copy(), self.length
