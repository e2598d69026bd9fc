"""Immutable, epoch-numbered views of the mutable index.

A :class:`Snapshot` is what queries run against: a tuple of sealed
:class:`Segment`\\ s (each an ordinary :class:`FlatTree` on the index's
device plus a local-id -> global-id table) and frozen views of the delta
buffers.  Snapshots are *published atomically* -- every mutation builds a
new snapshot and swaps one reference -- so a query always sees one
consistent point set.

Deletes never touch tree geometry: a tombstoned point's ``point_ids`` row
is set to -1, the convention every search route already uses for leaf
padding, so masked points leave the candidates while every node and point
bound stays valid (it bounds a superset of the live points).

``Snapshot.query`` scans the delta first (exact); its k-th distance caps
the segments.  The sequential walk then queries segment after segment,
each capped by the merged k-th so far.  At segment fan-out >=
``STACKED_FANOUT_DEFAULT`` (or with ``method="stacked"`` /
``stacked=True``) the walk is replaced by **one** two-pass stacked launch
over every segment (:mod:`repro_torch.kernels.stacked_sweep`), which also
merges the per-segment planes with the delta's candidates.  The stacked
tile grid is cached per snapshot and carried across publishes; tombstone
republishes swap only its ids planes.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.core import search
from repro_torch.core.balltree import FlatTree
from repro_torch.stream.delta import delta_topk

__all__ = ["Segment", "Snapshot", "DeltaView", "ShardedSnapshot"]


@dataclasses.dataclass(frozen=True)
class DeltaView:
    """Frozen view of one delta buffer (active or sealed for compaction).

    ``points`` is the buffer's shared append-only block; rows past
    ``length`` were unassigned at freeze time and their ``gids`` are -1 in
    the frozen copy, so later appends are invisible here.
    """

    points: np.ndarray  # (C, d) shared
    gids: np.ndarray  # (C,) frozen copy, -1 = empty/deleted
    length: int

    @property
    def live(self) -> int:
        return int((self.gids >= 0).sum())


@dataclasses.dataclass(frozen=True)
class Segment:
    """A sealed FlatTree over a batch of points + global-id bookkeeping."""

    uid: int  # stable identity across tombstone rewrites
    tree: FlatTree  # on the index's device
    gids: np.ndarray  # (n_seg,) i32 -- local point id -> global id
    row_of_local: np.ndarray  # (n_seg,) i32 -- local id -> tree.points row
    live: int
    dead: int

    @classmethod
    def from_points(cls, uid: int, points: np.ndarray, gids: np.ndarray,
                    *, n0: int, seed: int = 0, device="cpu") -> "Segment":
        """Seal a batch of already-appended (n, d) points into a tree on
        ``device``.  The leaf count is padded to a quantum so successive
        compactions land on few distinct tile grids."""
        from repro_torch.core.balltree import (build_tree, leaf_pad_quantum,
                                               pad_tree_leaves)

        tree = build_tree(points, n0=n0, seed=seed, append_one=False)
        quantum = leaf_pad_quantum(tree.num_leaves)
        tree = pad_tree_leaves(
            tree, -(-tree.num_leaves // quantum) * quantum)
        pid = tree.point_ids.numpy()
        row_of_local = np.full((len(gids),), -1, np.int32)
        rows = np.nonzero(pid >= 0)[0]
        row_of_local[pid[rows]] = rows
        return cls(uid=uid, tree=tree.to(device),
                   gids=np.asarray(gids, np.int32),
                   row_of_local=row_of_local, live=len(gids), dead=0)

    # ------------------------------------------------------------------
    @property
    def tombstone_frac(self) -> float:
        total = self.live + self.dead
        return self.dead / total if total else 0.0

    def with_tombstone(self, local_id: int) -> "Segment":
        """New segment with one point masked out (point_ids row -> -1)."""
        return self.with_tombstones([local_id])

    def with_tombstones(self, local_ids) -> "Segment":
        """New segment with these points masked out: one copy of the ids
        plane on the tree's device; the geometry, and the padded points
        plane the kernel reads, are shared with this segment."""
        local_ids = np.asarray(list(local_ids), np.int64)
        if local_ids.size == 0:
            return self
        pid = self.tree.point_ids.clone()
        rows = torch.from_numpy(self.row_of_local[local_ids].astype(np.int64))
        pid[rows.to(pid.device)] = -1
        return dataclasses.replace(self, tree=self.tree.with_point_ids(pid),
                                   live=self.live - int(local_ids.size),
                                   dead=self.dead + int(local_ids.size))

    def live_rows(self):
        """(points, gids) of live rows as host arrays -- compaction input."""
        pid = self.tree.point_ids.cpu().numpy()
        rows = np.nonzero(pid >= 0)[0]
        at = torch.from_numpy(rows).to(self.tree.device)
        pts = self.tree.points[at].cpu().numpy()
        return pts, self.gids[pid[rows]]


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """One consistent, immutable view of the live point set."""

    epoch: int
    #: epoch of the most recent delete; a lambda cap recorded at epoch e is
    #: valid for this snapshot iff e >= last_delete_epoch (inserts only
    #: shrink the true k-th distance, deletes can grow it).
    last_delete_epoch: int
    segments: tuple  # tuple[Segment, ...]
    deltas: tuple  # tuple[DeltaView, ...] -- active first, then sealed
    live_count: int
    max_norm: float  # >= max ||x|| over live points (monotone)
    variant: str  # "ball" | "bc"
    n0: int
    d: int
    #: where queries run (the segments' device)
    device: torch.device = dataclasses.field(
        default=torch.device("cpu"), compare=False)

    # ------------------------------------------------------------------
    @property
    def delta_live(self) -> int:
        return sum(v.live for v in self.deltas)

    @property
    def tombstone_frac(self) -> float:
        """Dead fraction over the snapshot's sealed rows."""
        live = sum(s.live for s in self.segments)
        dead = sum(s.dead for s in self.segments)
        return dead / (live + dead) if live + dead else 0.0

    # -- stacked-leaf cache (segment-parallel sweep) -------------------
    def stacked_leaves(self):
        """The segments stacked into one padded tile grid
        (:class:`repro_torch.kernels.stacked_sweep.StackedLeaves`),
        memoised on this snapshot.  A base stack plus pending ids-plane
        diffs travel through publishes as plain references
        (:meth:`adopt_stacked_from`) and the diffs are applied here, on
        first stacked access, so the publish path -- and the delete path,
        which publishes per tombstone -- does no device work."""
        stk = self.__dict__.get("_stacked")
        if stk is None and self.segments:
            base = self.__dict__.get("_stacked_base")
            if base is not None:
                stk = base.with_updated_ids(
                    self.__dict__.get("_stacked_pending") or {})
            else:
                from repro_torch.kernels.stacked_sweep import StackedLeaves

                stk = StackedLeaves.from_segments(self.segments)
            object.__setattr__(self, "_stacked", stk)
        return stk

    def adopt_stacked_from(self, prev: "Snapshot") -> None:
        """Carry ``prev``'s stacked-leaf memo forward when the segment set
        allows it: same uids + unchanged geometry means delta-only
        publishes reuse the stack as it is and tombstone publishes defer
        an ids-plane diff to :meth:`stacked_leaves`."""
        if prev is None:
            return
        base = prev.__dict__.get("_stacked")
        pending = {}
        if base is None:
            base = prev.__dict__.get("_stacked_base")
            pending = dict(prev.__dict__.get("_stacked_pending") or {})
        if base is None or len(self.segments) != len(prev.segments):
            return
        if tuple(s.uid for s in self.segments) != base.uids:
            return  # compaction changed the set: rebuild lazily
        for i, (new, old) in enumerate(zip(self.segments, prev.segments)):
            if new is old:
                continue
            if new.tree.points is not old.tree.points:
                return  # geometry rewrite: rebuild lazily
            pending[i] = new  # latest plane wins over an older diff
        if pending:
            object.__setattr__(self, "_stacked_base", base)
            object.__setattr__(self, "_stacked_pending", pending)
        else:
            object.__setattr__(self, "_stacked", base)

    def adopt_prebuilt_stacked(self, stk, sources) -> bool:
        """Adopt a stack the background compactor built before the publish
        flipped the epoch.  ``sources`` are the segments ``stk`` was
        stacked from; a segment that moved on since (a raced tombstone)
        becomes a pending ids-plane diff.  Returns False, leaving the lazy
        rebuild in charge, when the published set no longer matches."""
        if stk is None or len(sources) != len(self.segments):
            return False
        if tuple(s.uid for s in self.segments) != stk.uids:
            return False
        pending = {}
        for i, (new, old) in enumerate(zip(self.segments, sources)):
            if new is old:
                continue
            if new.tree.points is not old.tree.points:
                return False
            pending[i] = new
        if pending:
            object.__setattr__(self, "_stacked_base", stk)
            object.__setattr__(self, "_stacked_pending", pending)
        else:
            object.__setattr__(self, "_stacked", stk)
        return True

    def live_points(self):
        """The live set as ``(points (n, d), gids (n,))`` host arrays -- the
        brute-force oracle's view and a from-scratch rebuild's input."""
        pts, gids = [], []
        for v in self.deltas:
            mask = v.gids >= 0
            pts.append(v.points[mask])
            gids.append(v.gids[mask])
        for s in self.segments:
            p, g = s.live_rows()
            pts.append(p)
            gids.append(g)
        if not pts:
            return (np.zeros((0, self.d), np.float32),
                    np.zeros((0,), np.int32))
        return np.concatenate(pts), np.concatenate(gids)

    def query(self, queries, k: int = 1, *, method: str = "sweep",
              frac: float = 1.0, lambda_cap=None,
              return_counters: bool = False, include_deltas: bool = True,
              stacked: bool | None = None, probe_tiles: int | None = None,
              probe_dtype: str | None = None, bq: int | None = None,
              split: int | None = None,
              mesh=None, mesh_axis: str = "shard"):
        """Exact (or beam-budgeted) top-k over the snapshot's live set.

        ``queries`` must already be normalised (B, d) float32; results are
        host arrays of *global* ids.  ``lambda_cap`` (B,) optional valid
        upper bounds on the true k-th distance (``method="beam"`` never
        uses caps and is budgeted on segments only; the delta is always
        scanned exactly).  ``include_deltas=False`` scans segments only.

        ``stacked``: ``None`` auto-promotes the exact ``sweep``/``pallas``
        (``kernel``) methods to the stacked launch at live-segment fan-out
        >= ``STACKED_FANOUT_DEFAULT`` on a dense enough grid, ``True``
        forces it, ``False`` forbids it; ``method="stacked"`` is
        ``stacked=True``.  ``probe_tiles`` is the probe-pass width (None =
        default; 0 = one pass) and ``probe_dtype`` its precision
        ("f32"/"bf16"/"int8"; answers are exact either way).  ``mesh`` (a
        :class:`repro_torch.launch.mesh.DeviceMesh`) spreads the stacked
        launch's segment axis over ``mesh_axis``; only the stacked route
        takes it, and the answers are the same.  ``bq``
        and ``split`` set the kernels' query block and CTAs per block, on
        the stacked launch and on the sequential ``pallas``/``kernel`` walk
        (``None``: the device's defaults, 64 and as many CTAs as fill the
        card in one wave on a CUDA device, 8 and one on the host;
        :func:`repro_torch.kernels.stacked_sweep.stacked_sweep_query`).
        """
        q = torch.as_tensor(np.atleast_2d(np.asarray(queries, np.float32)),
                            device=self.device)
        B = q.shape[0]
        counters = np.zeros((8,), np.int64)

        if include_deltas:
            bd, bi, nver = self.delta_candidates(q, k)
            counters[search.C_VERIFIED] += nver
        else:
            bd = torch.full((B, k), float("inf"), device=self.device)
            bi = torch.full((B, k), -1, dtype=torch.int32,
                            device=self.device)
        exact = method != "beam"
        ext = (None if lambda_cap is None or not exact
               else torch.as_tensor(lambda_cap, dtype=torch.float32,
                                    device=self.device).reshape(-1))
        if self.segments and self._use_stacked(method, stacked):
            # the entry cap of every segment: the delta scan's k-th,
            # tightened by any external cap; the launch tightens it
            # further and merges the delta's candidates itself
            cap = bd[:, k - 1]
            if ext is not None:
                cap = torch.minimum(cap, ext)
            bd, bi, cnt = self._stacked_query(
                q, k, cap=cap, probe_tiles=probe_tiles,
                probe_dtype=probe_dtype, extra_d=bd, extra_i=bi, bq=bq,
                split=split, mesh=mesh, mesh_axis=mesh_axis)
            counters += cnt.cpu().numpy().astype(np.int64)
        else:
            for seg in self.segments:
                if seg.live == 0:
                    continue
                cap = None
                if exact:
                    cap = bd[:, k - 1]  # running merged k-th: a valid cap
                    if ext is not None:
                        cap = torch.minimum(cap, ext)
                sd, si, cnt = _segment_query(seg.tree, q, k, method=method,
                                             frac=frac,
                                             variant=self.variant,
                                             lambda_cap=cap, bq=bq,
                                             split=split)
                g = torch.from_numpy(seg.gids).to(self.device)
                sg = torch.where(si >= 0,
                                 g[torch.clamp(si, 0, len(g) - 1).long()],
                                 -1).to(torch.int32)
                bd, bi = search.merge_topk(torch.cat([bd, sd], dim=1),
                                           torch.cat([bi, sg], dim=1), k)
                counters += cnt.cpu().numpy().astype(np.int64)
        bd, bi = bd.cpu().numpy(), bi.cpu().numpy()
        if return_counters:
            return bd, bi, counters
        return bd, bi

    def delta_candidates(self, q, k: int):
        """The delta scan's merged top-k over every delta view, on ``q``'s
        device: ``(dists (B, k), global ids (B, k), rows verified)``.  Only
        the assigned prefix of each view is scanned: the rows past
        ``length`` are dead and would only add +inf candidates."""
        B = q.shape[0]
        bd = torch.full((B, k), float("inf"), device=q.device)
        bi = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
        verified = 0
        for view in self.deltas:
            dd, di = delta_topk(view.points[:view.length],
                                view.gids[:view.length], q, k)
            bd, bi = search.merge_topk(torch.cat([bd, dd], dim=1),
                                       torch.cat([bi, di], dim=1), k)
            verified += view.live * B
        return bd, bi, verified

    def _use_stacked(self, method: str, stacked: bool | None) -> bool:
        """Resolve the segment-parallel dispatch decision."""
        if method == "stacked":
            return True
        if method not in ("sweep", "pallas", "kernel"):
            return False  # dfs walks trees, beam budgets per segment
        if stacked is not None:
            return bool(stacked)
        from repro_torch.kernels.stacked_sweep import (
            STACKED_DENSITY_DEFAULT,
            STACKED_FANOUT_DEFAULT,
            tile_density,
        )

        n_live = sum(1 for s in self.segments if s.live)
        return (n_live >= STACKED_FANOUT_DEFAULT
                and tile_density(self.segments) >= STACKED_DENSITY_DEFAULT)

    def _stacked_query(self, q, k: int, *, cap, probe_tiles=None,
                       probe_dtype=None, extra_d=None, extra_i=None,
                       bq=None, split=None, mesh=None,
                       mesh_axis: str = "shard"):
        """One two-pass stacked launch over all segments (probe + main +
        merge with the ``extra`` delta candidates); returns the merged
        ``(dists (B, k), global ids (B, k), counters)`` on the device."""
        from repro_torch.kernels.stacked_sweep import stacked_sweep_query

        is_bc = self.variant == "bc"
        fd, fi, cnt, _ = stacked_sweep_query(
            self.stacked_leaves(), q, k, lambda_cap=cap,
            probe_tiles=probe_tiles, probe_dtype=probe_dtype,
            extra_d=extra_d, extra_i=extra_i, bq=bq, split=split,
            use_ball=is_bc, use_cone=is_bc, mesh=mesh, mesh_axis=mesh_axis)
        return fd, fi, cnt


@dataclasses.dataclass(frozen=True)
class ShardedSnapshot:
    """A cross-shard snapshot pin: one per-shard :class:`Snapshot` each,
    plus the **epoch vector** (one epoch per shard).

    Each component is individually consistent (atomic per-shard publish);
    the vector pins the exact cross-shard state a query ran against while
    compactions republish shards independently.  Validity of a lambda cap
    against this view is per shard: a cap recorded at epoch vector ``E``
    is valid iff ``E[s] >= last_delete_epoch[s]`` for every shard ``s``,
    so one shard's delete does not invalidate caps recorded against the
    other shards' states.

    ``query`` runs the two-round lambda exchange
    (:func:`repro_torch.core.distributed.two_round_exchange`) with each
    shard's pinned ``Snapshot`` as the round backend, so the exchange
    spans heterogeneous shard states: delta-only, multi-segment,
    mid-compaction (sealed delta views included).
    """

    shards: tuple  # tuple[Snapshot, ...] -- index s = shard s's pin
    epoch: tuple  # per-shard epoch vector
    last_delete_epoch: tuple  # per-shard delete-epoch vector
    variant: str
    d: int
    #: router version this view was pinned under (0 = the un-versioned
    #: hash router).  A split/merge changes the shard count, so the epoch
    #: vector's length changes with it and the lambda cache's staleness
    #: check already invalidates caps across a resharding; this field
    #: makes the placement generation observable to the serving layer.
    router_version: int = 0
    #: serving mesh (:func:`repro_torch.launch.mesh.make_serving_mesh`)
    #: that round 2's stacked launch spreads over.  Placement, not state --
    #: excluded from identity.
    mesh: Any = dataclasses.field(default=None, compare=False)
    mesh_axis: str = dataclasses.field(default="shard", compare=False)

    # ------------------------------------------------------------------
    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def device(self) -> torch.device:
        """Where queries run (the shards' device)."""
        return (self.shards[0].device if self.shards
                else torch.device("cpu"))

    @property
    def live_count(self) -> int:
        return sum(s.live_count for s in self.shards)

    @property
    def max_norm(self) -> float:
        return max((s.max_norm for s in self.shards), default=0.0)

    @property
    def segments(self) -> tuple:
        """All shards' segments, flattened (fan-out accounting)."""
        return tuple(seg for s in self.shards for seg in s.segments)

    @property
    def deltas(self) -> tuple:
        """All shards' delta views, flattened."""
        return tuple(v for s in self.shards for v in s.deltas)

    @property
    def delta_live(self) -> int:
        return sum(s.delta_live for s in self.shards)

    def live_points(self):
        """Union of the shard live sets as ``(points, gids)`` host arrays
        -- the brute-force oracle's view."""
        parts = [s.live_points() for s in self.shards]
        pts = [p for p, _ in parts if len(p)]
        gids = [g for _, g in parts if len(g)]
        if not pts:
            return (np.zeros((0, self.d), np.float32),
                    np.zeros((0,), np.int32))
        return np.concatenate(pts), np.concatenate(gids)

    @property
    def tombstone_frac(self) -> float:
        """Dead fraction over all shards' sealed rows (dispatch signal)."""
        live = sum(seg.live for seg in self.segments)
        dead = sum(seg.dead for seg in self.segments)
        return dead / (live + dead) if live + dead else 0.0

    def query(self, queries, k: int = 1, *, method: str = "sweep",
              frac: float = 1.0, frac1: float = 0.25, lambda_cap=None,
              return_counters: bool = False, return_info: bool = False,
              stacked: bool | None = None, probe_tiles: int | None = None,
              probe_dtype: str | None = None, deadline=None,
              resilience=None, bq: int | None = None,
              split: int | None = None):
        """Top-k over the cross-shard live set via the two-round lambda
        exchange; same contract as :meth:`Snapshot.query` (normalised
        queries in, global ids and host arrays out) plus ``frac1``, the
        round-1 prefix fraction.  ``return_info`` also returns the
        exchange's ``lambda0`` and per-shard k-ths.  ``stacked`` controls
        round 2's segment-parallel form (every shard's segments in one
        stacked launch under lambda0); ``probe_tiles``/``probe_dtype`` are
        that launch's probe knobs and ``bq``/``split`` its schedule.
        ``deadline``/``resilience`` route through the exchange's
        degraded-capable branch (:func:`repro_torch.core.distributed.
        two_round_exchange`)."""
        from repro_torch.core.distributed import two_round_exchange

        out = two_round_exchange(self.shards, queries, k, frac1=frac1,
                                 method=method, frac=frac,
                                 lambda_cap=lambda_cap,
                                 return_info=return_info, stacked=stacked,
                                 probe_tiles=probe_tiles,
                                 probe_dtype=probe_dtype,
                                 mesh=self.mesh, mesh_axis=self.mesh_axis,
                                 deadline=deadline, resilience=resilience,
                                 bq=bq, split=split)
        if return_info:
            bd, bi, cnt, info = out
            return (bd, bi, cnt, info) if return_counters else (bd, bi, info)
        bd, bi, cnt = out
        return (bd, bi, cnt) if return_counters else (bd, bi)


def _segment_query(tree: FlatTree, q, k: int, *, method: str, frac: float,
                   variant: str, lambda_cap, bq=None, split=None) -> Any:
    """One search call over one segment tree (local ids returned);
    ``pallas`` (or ``kernel``) is the sweep kernel route."""
    is_bc = variant == "bc"
    common = dict(use_ball=is_bc, use_cone=is_bc)
    if method == "dfs":
        return search.dfs_search(tree, q, k, use_collab=is_bc,
                                 lambda_cap=lambda_cap, **common)
    if method == "sweep":
        return search.sweep_search(tree, q, k, frac=1.0,
                                   lambda_cap=lambda_cap, **common)
    if method == "beam":
        return search.sweep_search(tree, q, k, frac=frac, **common)
    if method in ("pallas", "kernel"):
        from repro_torch.kernels import ops

        return ops.sweep_search_kernel(tree, q, k, frac=1.0,
                                       lambda_cap=lambda_cap, bq=bq,
                                       split=split, **common)
    raise ValueError(f"unknown method {method!r}")
