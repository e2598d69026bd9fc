"""FH baseline: Furthest-Hyperplane hashing (Huang et al., SIGMOD'21).

FH lifts data with the same asymmetric transform as NH but keeps the data
norms and instead:
  1. partitions the database into ``l`` partitions by lifted norm
     ``||f(x)||`` (the paper's "separation threshold l in {2,4,6}");
  2. inside each partition (norms nearly equal) min-|<x,q>| is equivalent
     to *furthest* neighbor search in the lifted space, solved with
     query-aware projections (RQALSH-style): per projection, entries are
     kept sorted by projection value and probed **outward from both ends**
     (furthest-first) at query time;
  3. candidates are verified in the original space.

The split between host and device is NH's (:mod:`repro_torch.core.nh`):
the build and the candidates are host numpy, the JAX package's
expressions one for one (Python's ``round`` for the partition bounds, the
float64 norm order, the stable per-partition argsorts decide the tables),
and the verification is one batched device pass
(:func:`repro_torch.core.exact.verify_candidates`).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import transform as T
from repro_torch.core.balltree import append_ones, normalize_query
from repro_torch.core.exact import verify_candidates
from repro_torch.launch.platform import resolve_device

__all__ = ["FHIndex"]


@dataclasses.dataclass
class FHIndex:
    proj: np.ndarray  # (m, D)
    part_slices: list  # l partitions: (start, end) into sorted id order
    sorted_vals: np.ndarray  # (m, n) projection values, sorted per (proj, part)
    sorted_ids: np.ndarray  # (m, n)
    lifted_pairs: np.ndarray | None
    data: torch.Tensor  # (n, d) original (1-appended) points, on the device
    build_seconds: float  # host build, the upload excluded
    upload_seconds: float = 0.0

    @classmethod
    def build(
        cls,
        data: np.ndarray,
        *,
        m: int = 64,
        l: int = 4,
        lam: int | None = None,
        seed: int = 0,
        append_one: bool = True,
        device=None,
    ) -> "FHIndex":
        device = resolve_device(device)
        t0 = time.perf_counter()
        X = append_ones(np.asarray(data)) if append_one else np.asarray(data)
        X = X.astype(np.float32)
        n, d = X.shape
        rng = np.random.default_rng(seed)
        if lam is None:
            fx = T.lift(X)
            pairs = None
        else:
            pairs = T.sample_pairs(d, lam, rng)
            fx = T.sampled_lift(X, pairs)
        norms = np.sqrt((fx.astype(np.float64) ** 2).sum(axis=1))
        norm_order = np.argsort(norms)
        bounds_idx = [round(i * n / l) for i in range(l + 1)]
        part_slices = [(bounds_idx[i], bounds_idx[i + 1]) for i in range(l)]
        D = fx.shape[1]
        proj = rng.normal(size=(m, D)).astype(np.float32)
        vals = fx @ proj.T  # (n, m)
        sorted_vals = np.empty((m, n), dtype=np.float32)
        sorted_ids = np.empty((m, n), dtype=np.int32)
        for t in range(m):
            for s, e in part_slices:
                part_ids = norm_order[s:e]
                order = np.argsort(vals[part_ids, t], kind="stable")
                sorted_ids[t, s:e] = part_ids[order]
                sorted_vals[t, s:e] = vals[part_ids[order], t]
        build_seconds = time.perf_counter() - t0
        return cls.from_arrays(proj=proj, part_slices=part_slices,
                               sorted_vals=sorted_vals,
                               sorted_ids=sorted_ids, lifted_pairs=pairs,
                               data=X, build_seconds=build_seconds,
                               device=device)

    @classmethod
    def from_arrays(cls, *, proj, part_slices, sorted_vals, sorted_ids,
                    lifted_pairs, data, build_seconds: float = 0.0,
                    device=None) -> "FHIndex":
        """An index from the JAX package's fields as numpy arrays (its
        ``FHIndex``'s dataclass fields), the points uploaded to
        ``device``."""
        device = resolve_device(device)
        t0 = time.perf_counter()
        points = torch.from_numpy(np.ascontiguousarray(data, np.float32))
        points = points.to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return cls(proj=np.asarray(proj),
                   part_slices=[(int(s), int(e)) for s, e in part_slices],
                   sorted_vals=np.asarray(sorted_vals),
                   sorted_ids=np.asarray(sorted_ids),
                   lifted_pairs=(None if lifted_pairs is None
                                 else np.asarray(lifted_pairs)),
                   data=points, build_seconds=build_seconds,
                   upload_seconds=time.perf_counter() - t0)

    def to(self, device) -> "FHIndex":
        """The same index with its points on ``device``."""
        return dataclasses.replace(self,
                                   data=self.data.to(resolve_device(device)))

    def index_bytes(self) -> int:
        return int(self.proj.nbytes + self.sorted_vals.nbytes
                   + self.sorted_ids.nbytes)

    def candidates(self, queries: np.ndarray, *, budget: int = 4096,
                   normalize: bool = True):
        """Host step: ``(q (B, d) f32, [candidate ids of each query])``,
        the JAX package's furthest-first probing query by query."""
        q = np.atleast_2d(np.asarray(queries))
        if normalize:
            q = normalize_query(q)
        q = q.astype(np.float32)
        if self.lifted_pairs is None:
            fq = T.lift(q)
        else:
            fq = T.sampled_lift(q, self.lifted_pairs)
        qv = fq @ self.proj.T  # (B, m)
        m = self.proj.shape[0]
        per_probe = max(1, budget // (m * len(self.part_slices) * 2))
        out = []
        for b in range(q.shape[0]):
            cand = []
            for t in range(m):
                for s, e in self.part_slices:
                    vals = self.sorted_vals[t, s:e]
                    # furthest |val - qv|: take both ends of the sorted list
                    take = min(per_probe, len(vals))
                    lo_far = np.abs(vals[:take] - qv[b, t])
                    hi_far = np.abs(vals[-take:] - qv[b, t])
                    if lo_far.max(initial=0) >= hi_far.max(initial=0):
                        cand.append(self.sorted_ids[t, s:s + take])
                        cand.append(self.sorted_ids[t, e - take:e])
                    else:
                        cand.append(self.sorted_ids[t, e - take:e])
                        cand.append(self.sorted_ids[t, s:s + take])
            c = np.unique(np.concatenate(cand))
            if len(c) > budget:
                c = c[np.random.default_rng(0).permutation(len(c))[:budget]]
            out.append(c)
        return q, out

    def query(
        self,
        queries: np.ndarray,
        k: int = 1,
        *,
        budget: int = 4096,
        normalize: bool = True,
    ):
        """Furthest-first outward probing per partition (host) +
        verification (device); numpy ``(dists (B,k), ids (B,k),
        {"verified": n})``."""
        q, cand = self.candidates(queries, budget=budget,
                                  normalize=normalize)
        qt = torch.from_numpy(q).to(self.data.device)
        bd, bi = verify_candidates(self.data, qt, cand, k)
        return (bd.cpu().numpy(), bi.cpu().numpy(),
                {"verified": int(sum(len(c) for c in cand))})
