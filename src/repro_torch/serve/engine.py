"""P2HEngine: micro-batched, auto-dispatched, lambda-warm P2HNNS serving.

Composes the three serve-layer pieces over a built :class:`P2HIndex`, a
mutable :class:`repro_torch.stream.MutableP2HIndex` or a sharded mutable
:class:`repro_torch.stream.ShardedMutableP2HIndex` -- in the mutable cases
every micro-batch pins one epoch-numbered snapshot (an epoch *vector* pin
across shards for the sharded index, served through the two-round lambda
exchange) and the lambda cache is epoch-tagged per shard (see
``lambda_cache``):

  * :class:`~repro_torch.serve.batcher.MicroBatcher` -- fixed-shape slot
    batches;
  * :class:`~repro_torch.serve.dispatch.DispatchPolicy` -- per-batch
    backend choice by occupancy / k / recall target / segment fan-out;
  * :class:`~repro_torch.serve.lambda_cache.LambdaCache` -- warm-start
    ``lambda_cap`` from previously-served neighbor queries (exactness
    argument in that module's docstring).

The engine is the host-side control loop, as in the JAX package: batches,
cache and results are host numpy.  Each batch's queries go to the index's
device once, and its answers and counters come back once.  On a CUDA
device the batched exact route is ``"pallas"``, the CUDA sweep kernel
(``kernels/csrc/p2h_sweep.cu``); a mutable snapshot's ``"stacked"`` route
launches the stacked kernel (``kernels/csrc/stacked_sweep.cu``), and so
does round 2 of a sharded snapshot's exchange, once for every shard's
segments (once per mesh position and pass under a serving mesh).  The
route keeps the JAX package's name ``"pallas"`` in ``Route.method`` and
``stats()["routes"]``; ``method="kernel"`` forces the same route.  A
frozen index may come with its device-sharded forest (``sharded=``, a
:class:`repro_torch.core.distributed.ShardedP2HIndex`): exact batches then
take the ``"sharded"`` route, the forest's two-round exchange.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import search
from repro_torch.core.balltree import normalize_query
from repro_torch.parallel.sharding import mesh_devices
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.dispatch import HOST_SMALL_BATCH, DispatchPolicy, Route
from repro_torch.serve.lambda_cache import LambdaCache
from repro_torch.serve.resilience import (RESILIENCE_COUNTERS, Deadline,
                                          QueryRejected, ResilienceConfig,
                                          ShardSupervisor)

__all__ = ["P2HEngine"]

#: result metadata for a batch served with nothing missing
_META_COMPLETE = {"complete": True, "degraded": False, "shed": False,
                  "missing_shards": ()}

class P2HEngine:
    """Serving front-end for P2HNNS query traffic.

    Two APIs:

      * streaming -- ``submit()`` requests, ``flush()``, ``result(ticket)``;
      * drop-in   -- ``query(queries, k)`` (same contract as
        ``P2HIndex.query``; also reachable as
        ``index.query(..., engine=engine)``).

    ``use_cache=False`` disables the lambda warm start (cold dispatch);
    with it enabled, answers are still bit-identical to cold (the cache
    only ever supplies *valid* caps, see ``lambda_cache``).

    ``resilience`` (a :class:`repro_torch.serve.resilience.ResilienceConfig`)
    arms the read-path resilience layer: per-request deadlines
    (``deadline_s=`` on submit/query) propagate into per-shard budgets of
    a sharded index's exchange, shard timeouts and errors degrade to
    exact-over-live-shards answers (``result_meta`` / ``return_meta=True``
    expose ``missing_shards`` and ``complete``), per-shard circuit breakers
    fast-fail wedged shards, batches whose every member's deadline expired
    in the queue are shed, and ``max_pending`` sheds at admission with
    :class:`~repro_torch.serve.resilience.QueryRejected`.  Left at None the
    engine runs the plain path bit for bit.
    """

    def __init__(self, index, *, sharded=None, slot_size: int = 8,
                 policy: DispatchPolicy | None = None, use_cache: bool = True,
                 cache_bits: int = 14, seed: int = 0,
                 resilience: ResilienceConfig | None = None):
        from repro_torch.core.api import P2HIndex
        from repro_torch.stream.mutable import MutableP2HIndex
        from repro_torch.stream.sharded import ShardedMutableP2HIndex

        self._sharded_mutable = isinstance(index, ShardedMutableP2HIndex)
        if isinstance(index, MutableP2HIndex) or self._sharded_mutable:
            if sharded is not None:
                raise ValueError("sharded= serves beside a frozen P2HIndex, "
                                 "not a mutable index")
            # update-aware serving: every micro-batch pins one snapshot (an
            # epoch *vector* pin for the sharded index), lambda-cache
            # entries are epoch-tagged (see lambda_cache)
            self.mutable = index
            self.index = None
            d = index.d
            device = index.device
            # monotone over inserts; refreshed from the pinned snapshot
            # each batch so caps always use a current R >= max ||x||
            self.max_norm = float(index.max_norm)
        elif isinstance(index, P2HIndex):
            self.mutable = None
            self.index = index
            tree = index.tree
            d = tree.d
            device = tree.device
            # R >= max ||x||: every point lies in the root ball (read once,
            # here: on the card both are device tensors)
            self.max_norm = float(
                np.linalg.norm(tree.centers[0].cpu().numpy())
                + float(tree.radii[0]))
        else:
            raise TypeError(f"P2HEngine serves a P2HIndex, a "
                            f"MutableP2HIndex or a ShardedMutableP2HIndex, "
                            f"not {type(index).__name__}")
        self.sharded = sharded
        self.device = torch.device(device)
        self.policy = self.resolve_policy(policy or DispatchPolicy(),
                                          self.device)
        self.resilience = resilience
        self._supervisor = (ShardSupervisor(resilience)
                            if resilience is not None else None)
        self.batcher = MicroBatcher(
            d, slot_size,
            max_pending=resilience.max_pending if resilience else None)
        self.cache = (LambdaCache(d, self.max_norm, n_bits=cache_bits,
                                  seed=seed) if use_cache else None)
        self._results: dict[int, tuple] = {}
        self._meta: dict[int, dict] = {}
        self._shed = {"queue_full": 0, "deadline": 0, "expired_batches": 0}
        self._route_counts: dict[str, int] = {}
        self._counters: dict[str, np.ndarray] = {}
        self._latencies_s: list[float] = []
        self._batches = 0
        self._queries_served = 0
        # placement generation (sharded index): every batch pins the
        # router version its snapshot was routed under, so a live
        # split/merge shows as a version transition here -- cap soundness
        # across it is the lambda cache's epoch-vector length check
        self._router_version = None
        self._router_transitions = 0
        # the serving mesh the last multi-position snapshot carried (1:
        # every batch ran as one program); the mesh itself travels
        # snapshot -> exchange -> stacked launch
        self._mesh_devices = 1

    @staticmethod
    def resolve_policy(policy: DispatchPolicy, device) -> DispatchPolicy:
        """Fill the policy's device-dependent defaults: on a CUDA device
        the batched exact route is the sweep kernel and there is no DFS
        window (the DFS is a host-driven loop there); on the host the JAX
        package's defaults (the plain sweep, a window of 2)."""
        on_card = torch.device(device).type == "cuda"
        if policy.prefer_pallas is None:
            policy = dataclasses.replace(policy, prefer_pallas=on_card)
        if policy.small_batch is None:
            policy = dataclasses.replace(
                policy, small_batch=0 if on_card else HOST_SMALL_BATCH)
        return policy

    # ------------------------------------------------------------------
    # streaming API
    # ------------------------------------------------------------------
    def submit(self, query, k: int = 1, *, recall_target: float = 1.0,
               normalize: bool = True,
               deadline_s: float | None = None) -> int:
        """Enqueue one hyperplane query; returns a ticket for result().

        ``deadline_s`` gives the request a latency budget from now:
        exhausted-at-submit requests (and, with
        ``resilience.max_pending`` set, submits into a full queue) are
        rejected with :class:`~repro_torch.serve.resilience.QueryRejected`
        instead of queueing -- the rejection is counted in
        ``stats()["resilience"]``."""
        q = np.asarray(query, np.float32).reshape(1, -1)
        if normalize:
            q = normalize_query(q)
        deadline = (Deadline.after(deadline_s)
                    if deadline_s is not None else None)
        try:
            return self.batcher.submit(q[0], k, recall_target,
                                       deadline=deadline)
        except QueryRejected as e:
            self._shed[e.reason] = self._shed.get(e.reason, 0) + 1
            raise

    def flush(self) -> int:
        """Serve every pending request; returns the number of batches."""
        n = 0
        for mb in self.batcher.drain():
            self._execute(mb)
            n += 1
        return n

    def result(self, ticket: int):
        """(dists (k,), ids (k,)) for a served ticket (pops it, along
        with its metadata -- read :meth:`result_meta` first)."""
        self._meta.pop(ticket, None)
        return self._results.pop(ticket)

    def result_meta(self, ticket: int) -> dict:
        """Degradation metadata for a served-but-not-yet-popped ticket:
        ``complete`` (False iff a missing shard could hold a closer
        point), ``missing_shards``, ``degraded``, ``shed``."""
        return self._meta.get(ticket, _META_COMPLETE)

    # ------------------------------------------------------------------
    # drop-in API
    # ------------------------------------------------------------------
    def query(self, queries, k: int = 1, *, recall_target: float = 1.0,
              method: str | None = None, normalize: bool = True,
              return_stats: bool = False, deadline_s: float | None = None,
              return_meta: bool = False):
        """Batch query with the same contract as ``P2HIndex.query``.

        ``method`` forces a dispatch route (None = auto; ``"kernel"`` is
        the ``"pallas"`` route).  ``deadline_s`` bounds the whole call's
        latency budget (shared by every row); with the resilience layer
        armed, shards of a sharded index that cannot answer in time
        degrade the result instead of stalling it.  ``return_meta=True``
        appends the per-batch metadata (see :meth:`result_meta`)."""
        deadline = (Deadline.after(deadline_s)
                    if deadline_s is not None else None)
        if deadline is not None and deadline.expired:
            self._shed["deadline"] += 1
            raise QueryRejected("deadline")
        q = np.atleast_2d(np.asarray(queries))
        if normalize:
            q = normalize_query(q)
        q = q.astype(np.float32)
        # force=True: the drop-in path drains immediately, so its own
        # rows are in-flight work, not backlog the queue bound guards
        tickets = [self.batcher.submit(row, k, recall_target,
                                       deadline=deadline, force=True)
                   for row in q]
        for mb in self.batcher.drain():
            self._execute(mb, method=method)
        metas = [self.result_meta(t) for t in tickets]
        ds, is_ = zip(*(self.result(t) for t in tickets))
        bd, bi = np.stack(ds), np.stack(is_)
        out = (bd, bi)
        if return_stats:
            out += (self.stats(),)
        if return_meta:
            out += (metas,)
        return out

    # ------------------------------------------------------------------
    # execution
    # ------------------------------------------------------------------
    def _execute(self, mb, *, method: str | None = None):
        deadline = mb.deadline
        if (mb.deadlines and all(d is not None and d.expired
                                 for d in mb.deadlines)):
            # every member's budget burned while queued: shed the batch
            # (inf/-1 + shed metadata, never an exception -- the callers
            # already hold tickets) instead of running work nobody can
            # use within its budget
            empty = (np.full((mb.k,), np.inf, np.float32),
                     np.full((mb.k,), -1, np.int32))
            meta = {"complete": False, "degraded": True, "shed": True,
                    "missing_shards": ()}
            for ticket in mb.tickets:
                self._results[ticket] = empty
                self._meta[ticket] = meta
            self._shed["expired_batches"] += 1
            self._batches += 1
            self._queries_served += mb.occupancy
            return
        if method == "kernel":
            method = "pallas"
        # resilient exchange iff this batch carries a deadline or the
        # engine was armed -- otherwise the plain path, bit for bit
        resilient = (self._sharded_mutable
                     and (self._supervisor is not None
                          or deadline is not None))
        if resilient and self._supervisor is None:
            # deadline on an unarmed engine: default supervision, kept so
            # breaker state and counters persist across batches
            self._supervisor = ShardSupervisor()
        # pin one consistent view for the whole micro-batch: concurrent
        # inserts/deletes publish new snapshots, this batch never sees them
        snap = self.mutable.snapshot() if self.mutable is not None else None
        if snap is not None and self._sharded_mutable:
            rv = getattr(snap, "router_version", 0)
            if self._router_version is not None \
                    and rv != self._router_version:
                self._router_transitions += 1
            self._router_version = rv
        fanout = (len(snap.segments) + len(snap.deltas)) if snap else 1
        if snap is not None:
            from repro_torch.kernels.stacked_sweep import tile_density

            # snapshot-composition signals for the stacked crossover:
            # live sealed segments (the units one launch can absorb),
            # live delta rows over live points, dead over sealed rows,
            # live-tile fraction of the would-be stacked grid
            stackable = sum(1 for s in snap.segments if s.live)
            delta_frac = snap.delta_live / max(1, snap.live_count)
            tombstone_frac = snap.tombstone_frac
            density = tile_density(snap.segments)
        else:
            stackable, delta_frac, tombstone_frac = 0, 0.0, 0.0
            density = 1.0
        n_mesh = mesh_devices(getattr(snap, "mesh", None))
        if n_mesh > 1:
            self._mesh_devices = n_mesh
        route = (Route(method, frac=self.policy.frac_for_recall(
                     mb.recall_target) if method == "beam" else 1.0,
                     reason="forced")
                 if method is not None else
                 self.policy.route(mb.occupancy, mb.k, mb.recall_target,
                                   sharded=self.sharded is not None,
                                   segments=fanout,
                                   stackable=stackable,
                                   delta_frac=delta_frac,
                                   tombstone_frac=tombstone_frac,
                                   tile_density=density,
                                   mesh_devices=n_mesh))
        # warm start: valid caps only for exact routes (a cap bounds the
        # *exact* k-th distance; applying it to a budgeted beam could prune
        # candidates the direct beam would have returned) ... and never for
        # the resilient exchange: the cache's caps bound the *full*-set
        # k-th, which can undercut the live-shard-restricted k-th a
        # degraded answer must match
        caps = None
        if self.cache is not None and route.method != "beam" \
                and not resilient:
            if snap is not None:
                # inserts may have grown max ||x||; the cap formula needs
                # the current bound (monotone, so only ever grows)
                self.cache.max_norm = max(self.cache.max_norm,
                                          snap.max_norm)
            # look up live slots only: pad rows replicate slot 0, and
            # counting them would inflate hit/miss stats with dead work
            c = np.full((len(mb.queries),), np.inf, np.float32)
            c[:mb.occupancy] = self.cache.lookup(
                mb.queries[:mb.occupancy], mb.k,
                min_epoch=snap.last_delete_epoch if snap else 0)
            if np.isfinite(c).any():
                caps = c
        t0 = time.perf_counter()
        shard_kth = None
        meta = None
        degraded = False
        if snap is not None and self._sharded_mutable:
            # epoch-vector pin: the two-round exchange also reports each
            # shard's local k-th bound for per-shard cache components
            bd, bi, cnt, info = snap.query(
                mb.queries, mb.k, method=route.method, frac=route.frac,
                lambda_cap=caps, return_counters=True, return_info=True,
                stacked=route.method == "stacked",
                probe_tiles=route.probe_tiles,
                probe_dtype=route.probe_dtype,
                deadline=deadline if resilient else None,
                resilience=self._supervisor if resilient else None)
            shard_kth = info["shard_kth"]  # (S, B)
            degraded = bool(info.get("degraded", False))
            if resilient:
                meta = {"complete": bool(info.get("complete", True)),
                        "degraded": degraded, "shed": False,
                        "missing_shards": tuple(
                            info.get("missing_shards", ()))}
        elif snap is not None:
            # the policy (not the snapshot's fan-out default) owns the
            # stacked decision on the engine path, so route stats stay
            # truthful about which schedule ran
            bd, bi, cnt = snap.query(mb.queries, mb.k, method=route.method,
                                     frac=route.frac, lambda_cap=caps,
                                     return_counters=True,
                                     stacked=route.method == "stacked",
                                     probe_tiles=route.probe_tiles,
                                     probe_dtype=route.probe_dtype)
        else:
            bd, bi, cnt = self._run_backend(route, mb.queries, mb.k, caps)
        dt = time.perf_counter() - t0

        for slot, ticket in enumerate(mb.tickets):
            self._results[ticket] = (bd[slot], bi[slot])
            if meta is not None:
                self._meta[ticket] = meta
        # a degraded batch's per-shard k-ths are restricted-set bounds with
        # +inf rows for the missing shards: skip the cache update entirely
        if self.cache is not None and not degraded:
            live = slice(0, mb.occupancy)
            if shard_kth is not None:
                self.cache.update_sharded(
                    mb.queries[live], mb.k, shard_kth.T[live],
                    epoch=snap.epoch, min_epoch=snap.last_delete_epoch)
            else:
                self.cache.update(
                    mb.queries[live], mb.k, bd[live, mb.k - 1],
                    epoch=snap.epoch if snap else 0,
                    min_epoch=snap.last_delete_epoch if snap else 0)
        # stats
        self._route_counts[route.method] = (
            self._route_counts.get(route.method, 0) + 1)
        c8 = np.asarray(cnt, np.int64)
        self._counters[route.method] = (
            self._counters.get(route.method, np.zeros(8, np.int64)) + c8)
        self._latencies_s.append(dt)
        self._batches += 1
        self._queries_served += mb.occupancy

    def _run_backend(self, route: Route, q: np.ndarray, k: int, caps):
        """One backend call on the frozen index (the forest's exchange on
        the ``"sharded"`` route): the queries go to the device once, the
        answers and counters come back once."""
        if route.method == "sharded":
            if self.sharded is None:
                raise ValueError("the 'sharded' route needs sharded=")
            bd, bi, st = self.sharded.query(q, k, normalize=False,
                                            lambda_cap=caps)
            return bd, bi, np.array([st[n] for n in search._COUNTER_NAMES],
                                    np.int64)
        tree = self.index.tree
        is_bc = self.index.variant == "bc"
        common = dict(use_ball=is_bc, use_cone=is_bc)
        qt = torch.from_numpy(np.ascontiguousarray(q)).to(tree.device)
        cap = None if caps is None else torch.from_numpy(caps).to(
            tree.device)
        if route.method == "dfs":
            out = search.dfs_search(tree, qt, k, use_collab=is_bc,
                                    lambda_cap=cap, **common)
        elif route.method in ("sweep", "stacked"):
            # a frozen index is a single tree: the stacked sweep
            # degenerates to the ordinary one (forced-route escape hatch)
            out = search.sweep_search(tree, qt, k, frac=1.0,
                                      lambda_cap=cap, **common)
        elif route.method == "beam":
            out = search.sweep_search(tree, qt, k, frac=route.frac, **common)
        elif route.method == "pallas":
            from repro_torch.kernels import ops

            out = ops.sweep_search_kernel(tree, qt, k, frac=1.0,
                                          lambda_cap=cap, **common)
        else:
            raise ValueError(f"unknown route {route.method!r}")
        bd, bi, cnt = out
        return bd.cpu().numpy(), bi.cpu().numpy(), cnt.cpu().numpy()

    # ------------------------------------------------------------------
    def route_counters(self, method: str) -> np.ndarray:
        """Cumulative (8,) search counters for one dispatch route."""
        return np.array(self._counters.get(method, np.zeros(8, np.int64)))

    def total_counters(self) -> np.ndarray:
        """Cumulative (8,) search counters summed over all routes."""
        out = np.zeros(8, np.int64)
        for c in self._counters.values():
            out += c
        return out

    def stats(self) -> dict:
        lat = sorted(self._latencies_s)

        def pct(p):
            if not lat:
                return float("nan")
            return lat[min(len(lat) - 1, int(round(p / 100 * (len(lat) - 1))))]

        out: dict[str, Any] = {
            "batches": self._batches,
            "queries": self._queries_served,
            "routes": dict(self._route_counts),
            "latency_p50_ms": pct(50) * 1e3,
            "latency_p99_ms": pct(99) * 1e3,
            "counters": {m: search.SearchStats(c)
                         for m, c in self._counters.items()},
        }
        if self.cache is not None:
            out["lambda_cache"] = self.cache.stats()
        if self._router_version is not None:
            out["router_version"] = self._router_version
            out["router_transitions"] = self._router_transitions
        if self._mesh_devices > 1:
            out["mesh_devices"] = self._mesh_devices
        admission = getattr(self.mutable, "admission_stats", None)
        if callable(admission):
            # write-admission counters (seals/stalls/pending) from the
            # mutable index: whether compaction backpressure ever stalled
            # an acknowledged write
            out["admission"] = admission()
        # uniform resilience surface: zero-filled when the layer never
        # armed, so dashboards key the same fields either way
        res: dict[str, Any] = {k: 0 for k in RESILIENCE_COUNTERS}
        if self._supervisor is not None:
            res.update(self._supervisor.stats())
        res["shed_queue_full"] = self._shed["queue_full"]
        res["shed_deadline"] = self._shed["deadline"]
        res["shed_expired_batches"] = self._shed["expired_batches"]
        out["resilience"] = res
        if self._sharded_mutable:
            # router-drift tripwire: deletes whose gid no shard owned
            out["misroutes"] = self.mutable.misroutes
        return out

    def reset_stats(self):
        self._route_counts.clear()
        self._counters.clear()
        self._latencies_s.clear()
        self._batches = 0
        self._queries_served = 0
        self._shed = {"queue_full": 0, "deadline": 0, "expired_batches": 0}
