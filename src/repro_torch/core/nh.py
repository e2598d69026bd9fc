"""NH baseline: Nearest-Hyperplane hashing (Huang et al., SIGMOD'21).

Pipeline (paper Section I & V-C):
  1. lift data with the asymmetric transform (exact ``Omega(d^2)`` lift or
     the randomized-sampling variant with dimension ``lam``);
  2. NH-side completion so transformed data live on a sphere of radius M;
  3. E2LSH over the lifted space: ``m`` hash tables, each bucketing
     ``floor((a . y + b)/w)``; a query probes its bucket and ``probes``
     adjacent buckets per table;
  4. candidates are verified *in the original space* with |<x,q>| and the
     top-k returned.

The split between host and device:

  * the build is host numpy, the JAX package's expressions one for one: a
    key ``floor((a . y + b)/w)`` summed in another order can cross a bucket
    edge, so only the same numpy product gives the same tables;
  * the candidates of a query are host numpy too (``searchsorted`` per
    table, the early stop at ``4 * budget`` entries, the sorted union, the
    seeded subsample), so the candidate sets and the ``verified`` count are
    the reference's; the tables stay on the host, where that step reads
    them;
  * the verification is one batched pass on the device
    (:func:`repro_torch.core.exact.verify_candidates`) over the appended
    points, which :meth:`NHIndex.build` uploads.

``device=None`` means the CUDA card (raising without one); pass
``device="cpu"`` for the host.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import transform as T
from repro_torch.core.balltree import append_ones, normalize_query
from repro_torch.core.exact import exact_search, verify_candidates
from repro_torch.launch.platform import resolve_device

__all__ = ["NHIndex"]


@dataclasses.dataclass
class NHIndex:
    proj: np.ndarray  # (m, D+1) projection vectors
    bias: np.ndarray  # (m,)
    width: float
    bucket_keys: np.ndarray  # (m, n) sorted bucket id per entry
    bucket_ids: np.ndarray  # (m, n) data ids sorted by bucket
    lifted_pairs: np.ndarray | None  # sampling pairs or None for exact lift
    data: torch.Tensor  # (n, d) original (1-appended) points, on the device
    M: float
    build_seconds: float  # host build, the upload excluded
    upload_seconds: float = 0.0

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        data: np.ndarray,
        *,
        m: int = 64,
        width: float = 4.0,
        lam: int | None = None,
        seed: int = 0,
        append_one: bool = True,
        device=None,
    ) -> "NHIndex":
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
        px, M = T.nh_data_transform(fx)
        D = px.shape[1]
        proj = rng.normal(size=(m, D)).astype(np.float32)
        bias = rng.uniform(0, width, size=(m,)).astype(np.float32)
        h = np.floor((px @ proj.T + bias) / width).astype(np.int32)  # (n, m)
        keys = np.empty((m, n), dtype=np.int32)
        ids = np.empty((m, n), dtype=np.int32)
        for t in range(m):
            order = np.argsort(h[:, t], kind="stable")
            keys[t] = h[order, t]
            ids[t] = order
        build_seconds = time.perf_counter() - t0
        return cls.from_arrays(proj=proj, bias=bias, width=width,
                               bucket_keys=keys, bucket_ids=ids,
                               lifted_pairs=pairs, data=X, M=M,
                               build_seconds=build_seconds, device=device)

    @classmethod
    def from_arrays(cls, *, proj, bias, width, bucket_keys, bucket_ids,
                    lifted_pairs, data, M, build_seconds: float = 0.0,
                    device=None) -> "NHIndex":
        """An index from the JAX package's fields as numpy arrays (its
        ``NHIndex``'s dataclass fields), the points uploaded to
        ``device``."""
        device = resolve_device(device)
        t0 = time.perf_counter()
        points = torch.from_numpy(np.ascontiguousarray(data, np.float32))
        points = points.to(device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return cls(proj=np.asarray(proj), bias=np.asarray(bias),
                   width=float(width), bucket_keys=np.asarray(bucket_keys),
                   bucket_ids=np.asarray(bucket_ids),
                   lifted_pairs=(None if lifted_pairs is None
                                 else np.asarray(lifted_pairs)),
                   data=points, M=float(M), build_seconds=build_seconds,
                   upload_seconds=time.perf_counter() - t0)

    def to(self, device) -> "NHIndex":
        """The same index with its points on ``device``."""
        return dataclasses.replace(self,
                                   data=self.data.to(resolve_device(device)))

    # ------------------------------------------------------------------
    def index_bytes(self) -> int:
        return int(
            self.proj.nbytes
            + self.bias.nbytes
            + self.bucket_keys.nbytes
            + self.bucket_ids.nbytes
        )

    # ------------------------------------------------------------------
    def _lift_query(self, q: np.ndarray) -> np.ndarray:
        if self.lifted_pairs is None:
            fq = T.lift(q)
        else:
            fq = T.sampled_lift(q, self.lifted_pairs)
        return T.nh_query_transform(fq)

    def candidates(self, queries: np.ndarray, *, probes: int = 2,
                   budget: int = 4096, normalize: bool = True):
        """Host step: ``(q (B, d) f32, [candidate ids of each query])``,
        the JAX package's bucket probing query by query.

        The union of a query's windows is the reference's ``np.unique`` of
        their concatenation -- the sorted distinct ids -- taken through a
        bitmap over the points, one pass of ``n`` flags a query."""
        q = np.atleast_2d(np.asarray(queries))
        if normalize:
            q = normalize_query(q)
        q = q.astype(np.float32)
        zq = self._lift_query(q)  # (B, D)
        hq = np.floor((zq @ self.proj.T + self.bias) / self.width).astype(
            np.int32)
        m, n = self.bucket_keys.shape
        seen = np.zeros(n, bool)
        out = []
        for b in range(q.shape[0]):
            cand: list[np.ndarray] = []
            count = 0
            for t in range(m):
                keys = self.bucket_keys[t]
                lo = np.searchsorted(keys, hq[b, t] - probes, "left")
                hi = np.searchsorted(keys, hq[b, t] + probes, "right")
                cand.append(self.bucket_ids[t, lo:hi])
                count += hi - lo
                if count >= budget * 4:
                    break
            for ids in cand:
                seen[ids] = True
            c = np.flatnonzero(seen).astype(np.int32)
            seen[c] = False
            if len(c) > budget:
                c = c[np.random.default_rng(0).permutation(len(c))[:budget]]
            out.append(c)
        return q, out

    def query(
        self,
        queries: np.ndarray,
        k: int = 1,
        *,
        probes: int = 2,
        budget: int = 4096,
        normalize: bool = True,
    ):
        """Top-k via bucket probing (host) + original-space verification
        (device); numpy ``(dists (B,k), ids (B,k), {"verified": n})``."""
        q, cand = self.candidates(queries, probes=probes, budget=budget,
                                  normalize=normalize)
        qt = torch.from_numpy(q).to(self.data.device)
        bd, bi = verify_candidates(self.data, qt, cand, k)
        return (bd.cpu().numpy(), bi.cpu().numpy(),
                {"verified": int(sum(len(c) for c in cand))})

    # ------------------------------------------------------------------
    def exact_check(self, queries, k=1):
        """Oracle helper for recall computation (on the points' device)."""
        q = normalize_query(np.atleast_2d(queries)).astype(np.float32)
        return exact_search(self.data, torch.from_numpy(q).to(
            self.data.device), k=k)
