"""ShardedMutableP2HIndex: per-shard delta/compaction under the
two-round lambda exchange.

A host-level partition of the mutable index: every shard is a full
:class:`~repro_torch.stream.mutable.MutableP2HIndex` -- its own
:class:`~repro_torch.stream.delta.DeltaBuffer`, segment list,
:class:`~repro_torch.stream.compaction.CompactionPolicy` and (optionally)
background compactor -- so shards restructure **independently**: one
shard folding its delta never stalls, or invalidates caps recorded
against, the others.  The paper's 1-3-orders-cheaper tree construction
is what makes this per-shard rebuild loop viable at all.

Composition:

  * **Routing** -- the front-end owns the global id space; a pluggable
    router (default :class:`HashRouter`, multiplicative hash of the gid)
    maps every id to its owning shard.  Inserts allocate a gid and route
    it; deletes forward to the owner (derived from the gid, no global
    lookup table).
  * **Epoch vectors** -- every shard mutation publishes that shard's
    epoch; a query pins a
    :class:`~repro_torch.stream.snapshot.ShardedSnapshot` -- the vector of
    per-shard snapshot pins plus their epoch/delete-epoch vectors --
    giving one consistent cross-shard view while background compactors
    republish shards underneath it.
  * **Queries** -- ``ShardedSnapshot.query`` runs the two-round lambda
    exchange (:func:`repro_torch.core.distributed.two_round_exchange`) with
    each shard's pinned ``Snapshot`` as a round backend: round 1 fans
    out each shard's own delta+segment scan (budgeted prefix), round 2
    reruns exactly under the exchanged ``lambda0`` cap, ``merge_topk``
    finishes.  Heterogeneous shard states (delta-only, multi-segment,
    mid-compaction) all serve through the same two rounds.  At stackable
    fan-out round 2 is one launch of the stacked kernel over every
    shard's segments.
  * **Serving** -- ``P2HEngine(sharded_mutable)`` pins one epoch vector
    per micro-batch; the lambda cache stores epoch *vectors* so a delete
    in one shard only invalidates caps stale in **that** component (see
    ``repro_torch.serve.lambda_cache``).
  * **Durability** -- ``save``/``load`` persist each shard through its
    own :class:`repro_torch.checkpoint.CheckpointManager` directory plus one
    fsync'd top-level manifest (shard count, router spec, id-space
    high-water mark, per-shard steps and WAL frontiers).  With
    ``wal_dir=`` set, every shard also appends routed ops to its own
    :class:`repro_torch.stream.wal.ShardWal` before acknowledging them --
    restore = load checkpoint + replay each shard's log tail, so
    recovery reaches the last *acknowledged* write with no cross-shard
    barrier (routed ops commute across shards; each shard replays
    independently).  ``open`` is the create-or-recover entry point the
    kill-and-recover chaos harness drives.
  * **Resharding** -- ``split_shard`` / ``merge_shards`` migrate data
    between shards under live traffic through the versioned slot router
    (:class:`repro_torch.stream.resharding.VersionedRouter`): writes route by
    the new map version immediately, queries keep fanning over every
    shard (``merge_topk`` de-duplicates by gid, so a point momentarily
    present in both owners is harmless), and the migration is journaled
    (atomic JSON + ``OP_ROUTER`` WAL records) so a crash mid-migration
    recovers to a consistent map with every gid owned exactly once.

Thread model: per-shard writer locks only -- there is no global write
lock.  Gid allocation is the single cross-shard synchronization point
(one counter behind a mutex); deletes additionally hold the migration
lock so a concurrent slot-copy can never resurrect a just-deleted point
(see :meth:`ShardedMutableP2HIndex.delete`); everything else is
shard-local, which is what lets per-shard write throughput scale with
the shard count.

Every shard lives on the index's ``device`` (the CUDA card unless
``"cpu"`` is asked for).  The manifest, router, journal and log files are
the JAX package's formats: either package recovers the other's
directories.  The serving mesh is ``None`` or one device; more devices
are ROADMAP.md, queue 1, item 12.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import re
import threading
from typing import Any

import numpy as np

from repro_torch.core import search
from repro_torch.core.balltree import normalize_query
from repro_torch.launch.platform import resolve_device
from repro_torch.parallel.sharding import (mesh_devices, mesh_signature,
                                           require_one_device)
from repro_torch.stream.compaction import CompactionPolicy
from repro_torch.stream.mutable import MutableP2HIndex, query_via_engine
from repro_torch.stream.resharding import (DEFAULT_SLOTS, MigrationJournal,
                                           VersionedRouter, plan_merge,
                                           plan_split)
from repro_torch.stream.snapshot import ShardedSnapshot
from repro_torch.stream.wal import OP_ROUTER, ShardWal, WalConfig

__all__ = ["ShardedMutableP2HIndex", "HashRouter"]

_MANIFEST = "MANIFEST.json"
_FORMAT = "p2h-stream-sharded"
_VERSION = 2  # v2: versioned-router specs + per-shard WAL frontiers

#: batch size of the migration copy loop: each batch is one migration-
#: lock hold (insert-into-dst then delete-from-src), bounding how long a
#: concurrent delete can be blocked behind the copier
_MIGRATE_BATCH = 256

# Knuth's multiplicative constant: decorrelates sequential gids so shard
# assignment is balanced but not trivially periodic in allocation order
_HASH_MULT = 2654435761


class HashRouter:
    """Deterministic hash-of-gid shard router (the default).

    Any object with ``shard_of(gid) -> int`` and ``spec() -> dict`` (plus
    a registered ``from_spec`` for persistence) can replace it -- e.g. a
    range router for locality-ordered id spaces.
    """

    kind = "hash"

    def __init__(self, num_shards: int):
        assert num_shards >= 1
        self.num_shards = int(num_shards)

    def shard_of(self, gid: int) -> int:
        return ((int(gid) * _HASH_MULT) & 0xFFFFFFFF) % self.num_shards

    def shard_of_many(self, gids) -> np.ndarray:
        """Vectorized :meth:`shard_of` (bulk-load / batch-insert path).
        uint64 wraparound preserves the product's low 32 bits, so this
        matches the scalar arbitrary-precision arithmetic exactly."""
        g = np.asarray(gids).astype(np.uint64)
        return (((g * np.uint64(_HASH_MULT)) & np.uint64(0xFFFFFFFF))
                % np.uint64(self.num_shards)).astype(np.int32)

    def spec(self) -> dict:
        return {"kind": self.kind, "num_shards": self.num_shards}

    @classmethod
    def from_spec(cls, spec: dict) -> "HashRouter":
        assert spec.get("kind") == cls.kind, spec
        return cls(spec["num_shards"])


#: router kinds load() can reconstruct from a manifest spec
_ROUTER_KINDS = {HashRouter.kind: HashRouter,
                 VersionedRouter.kind: VersionedRouter}


#: the shard-log naming scheme _wal_path writes; anything else in the
#: WAL dir (backups, editor droppings, "shard_old.wal") is not ours and
#: must not crash recovery
_WAL_NAME = re.compile(r"shard_(\d+)\.wal")


def _count_wal_shards(wal_dir: str) -> int:
    """Number of shards a WAL directory's logs imply (0 if none)."""
    if not os.path.isdir(wal_dir):
        return 0
    n = 0
    for name in os.listdir(wal_dir):
        m = _WAL_NAME.fullmatch(name)
        if m is not None:
            n = max(n, int(m.group(1)) + 1)
    return n


class ShardedMutableP2HIndex:
    """Read-write P2HNNS index sharded into independent mutable shards."""

    def __init__(self, dim: int, num_shards: int = 2, *, n0: int = 128,
                 variant: str = "bc", policy: CompactionPolicy | None = None,
                 seed: int = 0, background: bool = False, router: Any = None,
                 shards: tuple | None = None, wal_dir: str | None = None,
                 wal_config: WalConfig | None = None,
                 on_ack: Any = None, ckpt_root: str | None = None,
                 device=None):
        self.device = resolve_device(device)
        self.dim = int(dim)
        self.d = self.dim + 1
        self.num_shards = int(num_shards)
        self.n0 = int(n0)
        self.variant = variant
        self.policy = policy or CompactionPolicy()
        self.seed = int(seed)
        self.background = bool(background)
        #: per-shard WAL root (``shard_{s:03d}.wal`` + MIGRATION.json
        #: live here); None = no write-ahead logging
        self._wal_dir = wal_dir
        self._wal_config = wal_config
        self._on_ack = on_ack
        #: serializes migration copy batches against deletes (the
        #: read-then-resurrect race) and router transitions
        self._mig_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._misroutes = 0  # deletes that found their gid in no owner
        #: read-path supervisor (see :meth:`set_resilience`); None =
        #: historical fail-fast exchange
        self._resilience = None
        #: serving mesh (see :meth:`set_mesh`): None or one device.
        #: Snapshots pin the reference at snapshot() time, so in-flight
        #: queries are unaffected by a later set_mesh.
        self._mesh = None
        self._mesh_axis = "shard"
        if shards is None and wal_dir is not None:
            # leftover logs (or a journaled mid-flight migration) from a
            # crashed incarnation imply its shard count; never recover
            # fewer shards than either records
            self.num_shards = max(self.num_shards,
                                  _count_wal_shards(wal_dir))
            journal = MigrationJournal.read(wal_dir)
            if journal is not None:
                self.num_shards = max(self.num_shards,
                                      max(journal.assignment) + 1)
        self.router = router or HashRouter(self.num_shards)
        if shards is not None:  # load() supplies restored shards
            assert len(shards) == self.num_shards
            self.shards = tuple(shards)
        else:
            # distinct per-shard seeds: shard trees must not be clones
            self.shards = tuple(
                MutableP2HIndex(dim, n0=n0, variant=variant,
                                policy=self.policy, seed=seed + 1000 * s,
                                background=background, device=self.device)
                for s in range(self.num_shards))
        self._gid_lock = threading.Lock()
        self._next_gid = max((sh._next_gid for sh in self.shards),
                             default=0)
        # pre-publish warmup: when shard i's compactor prepares its
        # post-compaction stack, it also prepares the *cross-shard*
        # round-2 stack that stack will take part in.  One shared publish
        # gate serialises warm-then-flip across shards, so the
        # composition each warmup prepares is the one it publishes into
        # (shard compactions overlap heavily under churn)
        self._publish_gate = threading.Lock()
        for s, sh in enumerate(self.shards):
            self._wire_shard(s, sh)
        if shards is None and wal_dir is not None:
            # fresh construction over a WAL dir: replay whatever a
            # previous incarnation logged (no-checkpoint recovery), then
            # attach the logs and finish any journaled migration.  A
            # crash during the *first* save can leave shard checkpoints
            # without a top-level manifest -- and those shards' logs
            # already truncated against them -- so when ``ckpt_root``
            # names the checkpoint directory, a shard that has one is
            # restored from it (latest step + tail replay) instead of
            # from its log alone.
            rebuilt = []
            for s, sh in enumerate(self.shards):
                wal = self._make_wal(s)
                loaded = None
                if ckpt_root is not None:
                    try:
                        loaded = MutableP2HIndex.load(
                            os.path.join(ckpt_root, f"shard_{s:03d}"),
                            background=background, wal=wal,
                            device=self.device)
                    except FileNotFoundError:
                        loaded = None
                if loaded is not None:
                    self._wire_shard(s, loaded)
                    sh = loaded
                else:
                    sh.wal_replay(wal)
                    sh.attach_wal(wal)
                rebuilt.append(sh)
            self.shards = tuple(rebuilt)
            with self._gid_lock:
                self._next_gid = max(self._next_gid,
                                     max(sh._next_gid
                                         for sh in self.shards))
            self._recover_migration()

    def _wire_shard(self, s: int, sh: MutableP2HIndex) -> None:
        sh._warmup_hook = functools.partial(self._prepublish_warm, s)
        sh._publish_gate = self._publish_gate

    def _wal_path(self, s: int) -> str:
        return os.path.join(self._wal_dir, f"shard_{s:03d}.wal")

    def _make_wal(self, s: int) -> ShardWal:
        return ShardWal(self._wal_path(s), config=self._wal_config,
                        on_ack=self._on_ack)

    # ------------------------------------------------------------------
    @classmethod
    def from_data(cls, data: np.ndarray, num_shards: int = 2,
                  **kw: Any) -> "ShardedMutableP2HIndex":
        """Bulk-load: route rows by gid, seal one segment per shard."""
        data = np.asarray(data, np.float32)
        self = cls(data.shape[1], num_shards, **kw)
        gids = np.arange(len(data), dtype=np.int64)
        owner = self._owners(gids)
        for s, shard in enumerate(self.shards):
            mask = owner == s
            if mask.any():
                shard.bulk_seed(data[mask], gids=gids[mask])
        with self._gid_lock:
            self._next_gid = len(data)
        return self

    # ------------------------------------------------------------------
    # write path (routed)
    # ------------------------------------------------------------------
    def _alloc_gids(self, n: int) -> np.ndarray:
        with self._gid_lock:
            start = self._next_gid
            self._next_gid += n
        return np.arange(start, start + n, dtype=np.int64)

    def _owners(self, gids: np.ndarray) -> np.ndarray:
        """gid -> owning shard, via the router's vectorized fast path
        when it offers one (the default HashRouter does)."""
        fast = getattr(self.router, "shard_of_many", None)
        if fast is not None:
            return np.asarray(fast(gids), np.int32)
        return np.fromiter((self.router.shard_of(g) for g in gids),
                           np.int32, len(gids))

    def insert(self, point: np.ndarray) -> int:
        """Insert one raw (dim,) point; allocates a global id, routes it
        to its owning shard, returns it."""
        gid = int(self._alloc_gids(1)[0])
        owner = self.router.shard_of(gid)
        self.shards[owner].insert(point, gid=gid)
        self._fix_stragglers([gid], owner)
        return gid

    def insert_batch(self, points: np.ndarray) -> np.ndarray:
        """Bulk insert: one id-range allocation, one routed sub-batch per
        shard (each shard publishes once)."""
        pts = np.atleast_2d(np.asarray(points, np.float32))
        gids = self._alloc_gids(len(pts))
        owner = self._owners(gids)
        for s in range(len(self.shards)):
            mask = owner == s
            if mask.any():
                self.shards[s].insert_batch(pts[mask], gids=gids[mask])
                self._fix_stragglers(gids[mask], s)
        return gids.astype(np.int32)

    def _fix_stragglers(self, gids, owner: int) -> None:
        """Re-home writes that raced a router transition.

        The write path routes without the migration lock; if the
        assignment changed between routing and the shard write landing,
        the rows may sit in a shard the (possibly finished) migration
        copy loop no longer scans.  Re-reading the router *after* the
        write closes the race: either the re-read still sees the old
        map (then ``apply`` -- and hence the copy loop's gid scan --
        happens after our write and migrates it), or it sees the new
        map and this fixup moves the rows itself, idempotently racing
        the copier under the migration lock."""
        stale = [int(g) for g in gids
                 if self.router.shard_of(int(g)) != owner]
        if not stale:
            return
        with self._mig_lock:
            src = self.shards[owner]
            for g in stale:
                dst = self.shards[self.router.shard_of(g)]
                if dst is src:
                    continue
                pts, found = src.points_for([g])
                if len(found):
                    dst.insert_batch(pts, gids=found)
                    src.delete(g)

    def delete(self, gid: int) -> bool:
        """Delete by global id, forwarded to the owning shard; returns
        False if the id is not live.

        Holds the migration lock across the in-memory delete only
        (O(dict ops)): while a slot migration is copying, the gid may
        still live in the slot's *previous* owner (double-resolve via
        ``router.prev_shard_of``), and the lock keeps the copier from
        re-inserting a row this delete just removed
        (read-then-resurrect).  The WAL group commit -- a possible
        fsync -- runs *after* the lock is released, so deletes on other
        shards never serialize behind one shard's disk.  A delete that
        finds its gid in no owner is counted as a ``misroute``
        (:meth:`stats`) -- the signal that the versioned router and the
        data ever disagree."""
        gid = int(gid)
        owner = None
        with self._mig_lock:
            sh = self.shards[self.router.shard_of(gid)]
            if sh.delete(gid, commit=False):
                owner = sh
            else:
                prev = getattr(self.router, "prev_shard_of",
                               lambda g: None)(gid)
                if prev is not None and self.shards[prev].delete(
                        gid, commit=False):
                    owner = self.shards[prev]
        if owner is not None:
            owner._wal_commit()
            return True
        with self._stats_lock:
            self._misroutes += 1
        return False

    def set_mesh(self, mesh, *, axis: str = "shard") -> None:
        """Attach (or detach, ``mesh=None``) the serving mesh: ``None`` or
        one device, the one the shards live on.  Every snapshot pinned
        after this carries it; answers are the same with or without one.
        A mesh of more than one device raises ``NotImplementedError``
        (ROADMAP.md, queue 1, item 12: multi-device)."""
        dev = require_one_device(mesh)
        if dev is not None and (dev.type != self.device.type or (
                dev.index is not None and dev.index != self.device.index)):
            raise ValueError(f"mesh device {dev} is not the index's "
                             f"device {self.device}")
        self._mesh = mesh
        self._mesh_axis = str(axis)

    def _prepublish_warm(self, shard_idx: int, prebuilt_stk) -> None:
        """Compactor warmup hook (runs on shard ``shard_idx``'s
        background thread, off every lock): predict the cross-shard
        stack the two-round exchange will concatenate once this shard
        publishes -- the *other* shards' current stacks with
        ``prebuilt_stk`` in this shard's slot, same order as
        ``_stacked_round2`` -- concatenate it (``concat_cached``, so the
        first post-publish cross-shard query finds it built) and record
        the recent query templates against it.  Best-effort by contract
        (the caller swallows exceptions); other shards may republish
        before the flip, in which case the query path concatenates
        anew."""
        from repro_torch.kernels.stacked_sweep import (concat_cached,
                                                       warm_stacked)

        stks = []
        for s, sh in enumerate(self.shards):
            if s == shard_idx:
                stks.append(prebuilt_stk)
                continue
            snap = sh.snapshot()
            if snap.segments:
                stks.append(snap.stacked_leaves())
        if stks:
            warm_stacked(concat_cached(stks))

    def admission_stats(self) -> dict:
        """Cross-shard write-admission counters (sums of each shard's
        :meth:`MutableP2HIndex.admission_stats`)."""
        out = {"seals": 0, "stalls": 0, "pending_seals": 0,
               "compactor_leaked": 0}
        for sh in self.shards:
            for key, val in sh.admission_stats().items():
                out[key] = out.get(key, 0) + val
        return out

    @property
    def misroutes(self) -> int:
        """Deletes whose gid no shard owned (router drift tripwire)."""
        with self._stats_lock:
            return self._misroutes

    def set_resilience(self, supervisor) -> None:
        """Attach a :class:`repro_torch.serve.resilience.ShardSupervisor` for
        direct-path queries (``None`` detaches): per-shard calls run
        supervised and shard failures degrade instead of raising.
        Engine-owned supervisors are passed per call instead."""
        self._resilience = supervisor

    # ------------------------------------------------------------------
    # live resharding (repro_torch.stream.resharding)
    # ------------------------------------------------------------------
    def _ensure_versioned(self) -> VersionedRouter:
        """Upgrade the default hash router to the versioned slot router
        in place (bit-compatible: every gid keeps its owner), first
        resharding op only."""
        if isinstance(self.router, VersionedRouter):
            return self.router
        if not isinstance(self.router, HashRouter):
            raise TypeError(
                f"cannot reshard under router {type(self.router).__name__}"
                "; pass a VersionedRouter")
        slots = DEFAULT_SLOTS
        if slots % self.num_shards:
            slots = DEFAULT_SLOTS * self.num_shards
        self.router = VersionedRouter(self.num_shards, num_slots=slots)
        return self.router

    def split_shard(self, shard: int) -> int:
        """Split ``shard`` under live traffic: a fresh shard takes over
        half of its slots, and the affected rows migrate in bounded
        batches (insert-into-dst before delete-from-src, per batch,
        under the migration lock -- a crash leaves a duplicate, never a
        loss; queries de-duplicate by gid throughout).  Writes route by
        the new map the moment it is adopted.  Returns the new shard's
        index."""
        with self._mig_lock:
            router = self._ensure_versioned()
            new = len(self.shards)
            assignment, moving = plan_split(router, int(shard), new)
            sh = MutableP2HIndex(self.dim, n0=self.n0,
                                 variant=self.variant, policy=self.policy,
                                 seed=self.seed + 1000 * new,
                                 background=self.background,
                                 device=self.device)
            self._wire_shard(new, sh)
            if self._wal_dir is not None:
                sh.attach_wal(self._make_wal(new))
            self.shards = (*self.shards, sh)
            self.num_shards = len(self.shards)
            # journal the planned assignment BEFORE apply() routes any
            # write by it: the moment the new map is live, an insert can
            # land in the destination's WAL and be acked -- if the
            # journal (what recovery adopts) were not already durable, a
            # crash in that window would recover the old map and strand
            # the acked gid as a permanent misroute.  apply() bumps the
            # version by one, so the journal records version + 1.
            journal = MigrationJournal(
                src=int(shard), dst=new, moved_slots=tuple(moving),
                assignment=tuple(assignment),
                version=router.version + 1, op="split")
            self._journal(journal)
            router.apply(assignment, moving)
        self._run_migration(journal)
        return new

    def merge_shards(self, src: int, dst: int) -> None:
        """Merge shard ``src`` into ``dst`` under live traffic (same
        journaled copy loop as :meth:`split_shard`).  ``src`` stays in
        the shard list as an empty husk -- shard indices, and hence the
        epoch-vector layout, stay stable; its deletes bumped its
        delete-epoch, so caps recorded against the pre-merge state
        invalidate naturally."""
        with self._mig_lock:
            router = self._ensure_versioned()
            assignment, moving = plan_merge(router, int(src), int(dst))
            # journal durably before the new map routes a single write
            # (see split_shard)
            journal = MigrationJournal(
                src=int(src), dst=int(dst), moved_slots=tuple(moving),
                assignment=tuple(assignment),
                version=router.version + 1, op="merge")
            self._journal(journal)
            router.apply(assignment, moving)
        self._run_migration(journal)

    def _journal(self, journal: MigrationJournal) -> None:
        """Persist a migration phase transition: atomic JSON in the WAL
        dir + an ``OP_ROUTER`` record in both participants' logs (under
        each shard's writer lock -- the WAL is single-writer)."""
        if self._wal_dir is None:
            return
        journal.write(self._wal_dir)
        blob = journal.wal_blob()
        for s in (journal.src, journal.dst):
            sh = self.shards[s]
            with sh._lock:
                if sh._wal is not None:
                    sh._wal.append(OP_ROUTER, -1, 0, blob)
                    sh._wal.commit(force=True)

    def _run_migration(self, journal: MigrationJournal) -> None:
        """The copy phase: stream the moved slots' rows src -> dst in
        ``_MIGRATE_BATCH``-row batches, each one migration-lock hold,
        then mark the journal done and clear the double-resolve map."""
        router = self.router
        src_sh = self.shards[journal.src]
        dst_sh = self.shards[journal.dst]
        moved = np.asarray(sorted(int(s) for s in journal.moved_slots),
                           np.int32)
        while True:
            gids = src_sh.live_gids()
            if len(gids):
                gids = gids[np.isin(router.slot_of_many(gids), moved)]
            if len(gids) == 0:
                break
            for i in range(0, len(gids), _MIGRATE_BATCH):
                with self._mig_lock:
                    # re-resolve under the lock: a delete may have raced
                    pts, found = src_sh.points_for(
                        gids[i:i + _MIGRATE_BATCH])
                    if len(found):
                        dst_sh.insert_batch(pts, gids=found)
                        for g in found:
                            src_sh.delete(int(g))
        with self._mig_lock:
            router.moving = {}
            done = dataclasses.replace(journal, phase="done")
            self._journal(done)
            if self._wal_dir is not None:
                MigrationJournal.clear(self._wal_dir)

    def _adopt_wal_router(self) -> None:
        """Adopt the newest ``OP_ROUTER`` assignment found in any
        shard's log tail.  Covers the crash window where a migration
        finished (journal cleared) but no checkpoint ran afterwards:
        the manifest's router predates the move, and without the new
        assignment the migrated gids would be unreachable for deletes
        (permanent misroutes)."""
        import json

        best = None
        for sh in self.shards:
            if sh._wal is None:
                continue
            for rec in sh._wal.records(0):
                if rec.op != OP_ROUTER:
                    continue
                spec = json.loads(rec.blob)
                if best is None or spec["version"] > best["version"]:
                    best = spec
        if best is not None and \
                best["version"] > getattr(self.router, "version", -1):
            self.router = VersionedRouter(
                num_slots=len(best["assignment"]),
                assignment=best["assignment"],
                version=best["version"])

    def _recover_migration(self) -> None:
        """Finish a migration a crash interrupted (journal present, not
        done): adopt the journaled assignment, delete the src copy of
        any gid present in both owners (the crash window between a
        batch's insert and its deletes), then re-run the copy loop."""
        if self._wal_dir is None:
            return
        self._adopt_wal_router()
        journal = MigrationJournal.read(self._wal_dir)
        if journal is None:
            return
        if journal.phase == "done":
            MigrationJournal.clear(self._wal_dir)
            return
        # the journaled assignment is authoritative (written atomically
        # before any data moved); the manifest router may predate it --
        # and may even still be the hash router, whose slot count need
        # not match, so rebuild rather than upgrade in place
        self.router = VersionedRouter(
            num_slots=len(journal.assignment),
            assignment=journal.assignment,
            version=max(journal.version,
                        getattr(self.router, "version", 0)))
        src_sh = self.shards[journal.src]
        dst_sh = self.shards[journal.dst]
        for g in np.intersect1d(src_sh.live_gids(), dst_sh.live_gids()):
            src_sh.delete(int(g))  # dst, the new owner, wins
        self._run_migration(journal)

    # ------------------------------------------------------------------
    # read path (epoch-vector pinned)
    # ------------------------------------------------------------------
    def snapshot(self) -> ShardedSnapshot:
        """Pin one cross-shard view: the vector of per-shard snapshots
        (each an atomic reference read) plus their epoch vectors."""
        pins = tuple(sh.snapshot() for sh in self.shards)
        return ShardedSnapshot(
            shards=pins,
            epoch=tuple(p.epoch for p in pins),
            last_delete_epoch=tuple(p.last_delete_epoch for p in pins),
            variant=self.variant,
            d=self.d,
            router_version=getattr(self.router, "version", 0),
            mesh=self._mesh,
            mesh_axis=self._mesh_axis,
        )

    @property
    def epoch(self) -> tuple:
        """The current epoch vector (one epoch per shard)."""
        return tuple(sh.epoch for sh in self.shards)

    @property
    def live_count(self) -> int:
        return sum(sh.live_count for sh in self.shards)

    @property
    def max_norm(self) -> float:
        return max((sh.max_norm for sh in self.shards), default=0.0)

    @property
    def compaction_log(self) -> list:
        """All shards' compaction runs (``shard`` field added), merged in
        completion order."""
        out = []
        for s, sh in enumerate(self.shards):
            out += [{**c, "shard": s} for c in sh.compaction_log]
        return sorted(out, key=lambda c: c["t1_s"])

    def query(self, queries, k: int = 1, *, method: str | None = None,
              frac: float = 1.0, frac1: float = 0.25,
              normalize: bool = True, lambda_cap=None,
              return_stats: bool = False, return_info: bool = False,
              engine: Any = None, deadline_s: float | None = None,
              resilience: Any = None, **kw: Any):
        """Top-k over the cross-shard live set; same contract as
        ``MutableP2HIndex.query`` plus ``frac1`` (round-1 prefix
        fraction), ``lambda_cap`` (externally-valid caps, tightening
        both exchange rounds), and ``return_info`` (append the
        exchange's lambda0 / per-shard k-th diagnostics; direct path
        only).  ``engine=`` routes through a
        :class:`repro_torch.serve.P2HEngine` constructed over this index.

        ``deadline_s`` (seconds of budget from now) and/or
        ``resilience`` (a supervisor; defaults to the one attached via
        :meth:`set_resilience`) run the exchange's degraded-capable
        branch: per-shard timeouts/breakers/hedging, and shard failures
        surface as ``missing_shards``/``complete`` in the
        ``return_info`` dict instead of raising.  ``lambda_cap`` is
        rejected there -- external caps bound the *full*-set k-th and
        could prune live-shard answers from a degraded result."""
        if engine is not None:
            if lambda_cap is not None:
                raise ValueError(
                    "lambda_cap is derived by the engine's cache; do not "
                    "pass both engine= and lambda_cap=")
            if return_info:
                raise ValueError("return_info is a direct-path diagnostic; "
                                 "the engine does not expose it")
            return query_via_engine(self, engine, queries, k,
                                    method=method, normalize=normalize,
                                    return_stats=return_stats, kw=kw)
        resilience = resilience if resilience is not None else self._resilience
        deadline = None
        if deadline_s is not None:
            from repro_torch.serve.resilience import Deadline

            deadline = Deadline.after(deadline_s)
        if (deadline is not None or resilience is not None) \
                and lambda_cap is not None:
            raise ValueError(
                "lambda_cap is not honored on the resilient exchange "
                "(external caps bound the full-set k-th, not the "
                "live-shard-restricted one); drop it or the deadline")
        q = np.atleast_2d(np.asarray(queries))
        if normalize:
            q = normalize_query(q)
        snap = self.snapshot()
        out = snap.query(q.astype(np.float32), k,
                         method=method or "sweep", frac=frac,
                         frac1=frac1, lambda_cap=lambda_cap,
                         return_counters=True, return_info=return_info,
                         deadline=deadline, resilience=resilience,
                         **kw)
        if return_info:
            bd, bi, cnt, info = out
        else:
            bd, bi, cnt = out
        extra = ((search.SearchStats(cnt),) if return_stats else ())
        extra += ((info,) if return_info else ())
        return (bd, bi, *extra)

    # ------------------------------------------------------------------
    # compaction (per shard)
    # ------------------------------------------------------------------
    def compact(self, *, force: bool = False, shard: int | None = None
                ) -> bool:
        """Run one inline compaction on ``shard`` (or on every shard);
        returns whether any ran.  Shards compact independently -- there
        is no cross-shard barrier."""
        targets = (self.shards if shard is None
                   else (self.shards[shard],))
        ran = False
        for sh in targets:
            ran = sh.compact(force=force) or ran
        return ran

    def wait_compaction(self) -> None:
        """Block until no shard has a background compaction in flight;
        re-raises any shard compactor error."""
        for sh in self.shards:
            sh.wait_compaction()

    def close(self, *, timeout_s: float = 5.0) -> None:
        """Stop every shard's background compactor; safe to call twice.
        Wedged compactors are leaked-and-counted per shard (see
        :meth:`MutableP2HIndex.close`)."""
        for sh in self.shards:
            sh.close(timeout_s=timeout_s)

    # ------------------------------------------------------------------
    # persistence: per-shard checkpoints + one top-level manifest
    # ------------------------------------------------------------------
    def save(self, directory: str) -> list:
        """Persist every shard (each through its own CheckpointManager
        directory) plus a top-level fsync'd manifest; returns the
        per-shard steps saved.  Each shard's save records the WAL
        frontier ``(wal_offset, wal_seq)`` it covers and truncates the
        covered log prefix; the manifest mirrors the per-shard
        ``(checkpoint_epoch, wal_offset, wal_seq)`` triples."""
        from repro_torch.checkpoint.manager import write_json_atomic

        os.makedirs(directory, exist_ok=True)
        steps, frontiers = [], []
        for s, sh in enumerate(self.shards):
            steps.append(sh.save(os.path.join(directory,
                                              f"shard_{s:03d}")))
            frontiers.append(sh.last_saved_wal)
        with self._gid_lock:
            next_gid = self._next_gid
        manifest = {
            "format": _FORMAT,
            "version": _VERSION,
            "dim": self.dim,
            "n0": self.n0,
            "variant": self.variant,
            "seed": self.seed,
            "num_shards": self.num_shards,
            "router": self.router.spec(),
            "next_gid": int(next_gid),
            "policy": dataclasses.asdict(self.policy),
            "shard_steps": steps,
            "shards": [
                {"checkpoint_epoch": step,
                 "wal_offset": None if fr is None else fr[0],
                 "wal_seq": None if fr is None else fr[1]}
                for step, fr in zip(steps, frontiers)
            ],
        }
        write_json_atomic(os.path.join(directory, _MANIFEST), manifest)
        return steps

    @classmethod
    def load(cls, directory: str, *, background: bool = False,
             router: Any = None, wal_dir: str | None = None,
             wal_config: WalConfig | None = None,
             on_ack: Any = None, device=None) -> "ShardedMutableP2HIndex":
        """Recover a sharded index saved by :meth:`save`.  ``router``
        overrides the manifest's router spec (custom router classes are
        the caller's to reconstruct; the spec must describe the same
        gid -> shard mapping the save used).  ``wal_dir`` replays each
        shard's log tail past its checkpoint frontier (recovery to the
        last acknowledged write), re-attaches the logs, and completes
        any journaled mid-flight migration.  Shards go to ``device``."""
        from repro_torch.checkpoint.manager import read_json

        manifest = read_json(os.path.join(directory, _MANIFEST))
        if manifest.get("format") != _FORMAT:
            raise ValueError(f"{directory}: not a {_FORMAT} checkpoint")
        if manifest.get("version", 0) > _VERSION:
            raise ValueError(f"{directory}: manifest version "
                             f"{manifest['version']} is newer than this "
                             "reader")
        if router is None:
            spec = manifest["router"]
            kind = _ROUTER_KINDS.get(spec.get("kind"))
            if kind is None:
                raise ValueError(
                    f"unknown router kind {spec.get('kind')!r}: pass "
                    "router= to load")
            router = kind.from_spec(spec)
        # shards a post-checkpoint split created exist only as WALs (and
        # the migration journal); recover them too
        num_shards = manifest["num_shards"]
        if wal_dir is not None:
            num_shards = max(num_shards, _count_wal_shards(wal_dir))
            journal = MigrationJournal.read(wal_dir)
            if journal is not None:
                num_shards = max(num_shards,
                                 max(journal.assignment) + 1)
        device = resolve_device(device)
        shards = []
        for s in range(num_shards):
            wal = None
            if wal_dir is not None:
                wal = ShardWal(os.path.join(wal_dir,
                                            f"shard_{s:03d}.wal"),
                               config=wal_config, on_ack=on_ack)
            shard_dir = os.path.join(directory, f"shard_{s:03d}")
            try:
                # restore the shard's *latest* checkpoint, not the step
                # the top-level manifest recorded: each shard save
                # truncates its WAL against the checkpoint it just
                # wrote, so a crash between a shard save and the
                # manifest write leaves the manifest's older step
                # inconsistent with the (already truncated) log --
                # restoring it would lose acknowledged ops.  The newest
                # shard checkpoint is always the one the log frontier
                # matches; the manifest's per-shard steps are
                # diagnostics only.
                shards.append(MutableP2HIndex.load(
                    shard_dir, background=background, wal=wal,
                    device=device))
            except FileNotFoundError:
                # never checkpointed (e.g. born in a post-checkpoint
                # split): the WAL is its entire history
                sh = MutableP2HIndex(
                    manifest["dim"], n0=manifest["n0"],
                    variant=manifest["variant"],
                    policy=CompactionPolicy(**manifest["policy"]),
                    seed=manifest["seed"] + 1000 * s,
                    background=background, device=device)
                if wal is not None:
                    sh.wal_replay(wal)
                    sh.attach_wal(wal)
                shards.append(sh)
        self = cls(manifest["dim"], num_shards,
                   n0=manifest["n0"], variant=manifest["variant"],
                   policy=CompactionPolicy(**manifest["policy"]),
                   seed=manifest["seed"], background=background,
                   router=router, shards=tuple(shards), wal_dir=wal_dir,
                   wal_config=wal_config, on_ack=on_ack, device=device)
        with self._gid_lock:
            self._next_gid = max(self._next_gid, manifest["next_gid"],
                                 max(sh._next_gid for sh in self.shards))
        self._recover_migration()
        return self

    @classmethod
    def open(cls, directory: str, *, dim: int | None = None,
             num_shards: int = 2,
             wal_config: WalConfig | None = None, on_ack: Any = None,
             **kw: Any) -> "ShardedMutableP2HIndex":
        """Create-or-recover a durable sharded index rooted at
        ``directory`` (checkpoints at the top, WALs under ``wal/``).

        If a manifest exists: :meth:`load` + WAL-tail replay.  Otherwise
        a fresh index is built -- replaying any logs a crashed
        never-checkpointed incarnation left behind -- with write-ahead
        logging attached.  This is the entry point the kill-and-recover
        chaos harness drives; pair with :meth:`save` to bound log
        growth."""
        wal_dir = os.path.join(directory, "wal")
        if os.path.exists(os.path.join(directory, _MANIFEST)):
            return cls.load(directory, wal_dir=wal_dir,
                            wal_config=wal_config, on_ack=on_ack, **kw)
        assert dim is not None, "dim is required to create a new index"
        return cls(dim, num_shards, wal_dir=wal_dir, ckpt_root=directory,
                   wal_config=wal_config, on_ack=on_ack, **kw)

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Per-shard serving/maintenance stats (bench + ops surface)."""
        pins = [sh.snapshot() for sh in self.shards]
        with self._stats_lock:
            misroutes = self._misroutes
        mesh = self._mesh
        return {
            "num_shards": self.num_shards,
            "live_count": sum(p.live_count for p in pins),
            "epoch": tuple(p.epoch for p in pins),
            "router_version": getattr(self.router, "version", 0),
            "mesh_devices": mesh_devices(mesh),
            "mesh": None if mesh is None else mesh_signature(mesh),
            "misroutes": misroutes,
            "admission": self.admission_stats(),
            "resilience": (None if self._resilience is None
                           else self._resilience.stats()),
            "per_shard": [
                {"live": p.live_count, "epoch": p.epoch,
                 "segments": len(p.segments),
                 "delta_live": p.delta_live,
                 "compactions": len(sh.compaction_log)}
                for p, sh in zip(pins, self.shards)
            ],
        }
