"""MutableP2HIndex: streaming inserts/deletes over the Ball/BC-Tree.

The LSM-style composition:

  * writes (``insert`` / ``delete``) hit a fixed-capacity
    :class:`~repro_torch.stream.delta.DeltaBuffer` and per-segment tombstone
    masks -- never a tree rebuild on the write path;
  * a :class:`~repro_torch.stream.compaction.CompactionPolicy` decides when
    to fold the delta (and tombstone-heavy segments) into fresh sealed
    :class:`~repro_torch.stream.snapshot.Segment` trees -- inline by
    default, or on a background thread (``background=True``);
  * every mutation publishes a new epoch-numbered immutable
    :class:`~repro_torch.stream.snapshot.Snapshot` by swapping one
    reference, so queries are never torn.

Thread model: one re-entrant writer lock serialises mutations and
publishing; readers are lock-free (they read ``self._snapshot`` once).
Background compaction pins its inputs under the lock, builds trees outside
it, and republishes under it; deletes that raced the build are re-applied
to the new segment before it becomes visible.

Trees live on the index's ``device`` (the CUDA card unless ``"cpu"`` is
asked for); the delta buffer and the bookkeeping stay on the host.
``save``/``load`` write and read the JAX package's checkpoint format.

Durability: with a :class:`repro_torch.stream.wal.ShardWal` attached
(:meth:`MutableP2HIndex.attach_wal`), every insert/delete is appended to
the log before it is acknowledged, the checkpoint records the
``(wal_offset, wal_seq)`` frontier it covers, and ``load(..., wal=...)``
replays the log's tail idempotently -- recovery to the last
*acknowledged* write, not just the last checkpoint.  The log's bytes are
the JAX package's: a log either package writes replays in the other.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Any

import numpy as np

from repro_torch.core import search
from repro_torch.core.balltree import FlatTree, append_ones, normalize_query
from repro_torch.launch.platform import resolve_device
from repro_torch.stream.compaction import CompactionPlan, CompactionPolicy
from repro_torch.stream.delta import DeltaBuffer
from repro_torch.stream.snapshot import DeltaView, Segment, Snapshot
from repro_torch.stream.wal import OP_DELETE, OP_INSERT, OP_ROUTER

__all__ = ["MutableP2HIndex"]

logger = logging.getLogger(__name__)

_STATE_FORMAT = "p2h-stream"
_STATE_VERSION = 1


def query_via_engine(index, engine, queries, k, *, method, normalize,
                     return_stats, kw):
    """``query(engine=...)`` delegation of the mutable index: flush pending
    streaming work, serve through the engine, report this call's counter
    delta."""
    if engine.mutable is not index:
        raise ValueError("engine serves a different index")
    engine.flush()
    before = engine.total_counters()
    bd, bi = engine.query(queries, k, normalize=normalize, method=method,
                          **kw)
    if return_stats:
        delta = engine.total_counters() - before
        return bd, bi, search.SearchStats(delta)
    return bd, bi


class MutableP2HIndex:
    """Read-write P2HNNS index with LSM-style segments + delta buffer."""

    def __init__(self, dim: int, *, n0: int = 128, variant: str = "bc",
                 policy: CompactionPolicy | None = None, seed: int = 0,
                 background: bool = False, device=None):
        if variant not in ("ball", "bc"):
            raise ValueError(f"unknown variant {variant!r}")
        self.device = resolve_device(device)
        self.dim = int(dim)  # raw point dimensionality
        self.d = self.dim + 1  # with the appended 1-coordinate
        self.n0 = int(n0)
        self.variant = variant
        self.policy = policy or CompactionPolicy()
        self.seed = int(seed)

        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._delta = DeltaBuffer(self.policy.delta_capacity, self.d)
        self._sealed: list[DeltaBuffer] = []  # frozen inputs of an
        #                                       in-flight compaction
        self._segments: dict[int, Segment] = {}  # uid -> segment (ordered)
        self._locator: dict[int, tuple] = {}  # gid -> location
        self._next_gid = 0
        self._next_uid = 0
        self._epoch = 0
        self._last_delete_epoch = 0
        self._live_count = 0
        self._max_norm = 0.0
        self._compacting = False
        self._pending_tombstones: set[int] = set()
        self._compact_errors: list[BaseException] = []
        self.compaction_log: list[dict] = []  # wall/rows/reason per run
        self._tl = threading.local()  # delete-path compaction tripwire
        # write admission + close() leak tripwire
        self._admission = {"seals": 0, "stalls": 0, "compactor_leaked": 0}
        #: optional repro_torch.stream.wal.ShardWal -- when attached, every
        #: insert/delete appends a record (under the writer lock, which
        #: also serialises the single-writer log) and the public write
        #: calls run the group commit before returning
        self._wal = None
        self.last_saved_wal = None  # (wal_offset, wal_seq) of last save
        self._wal_replayed_seq = 0  # highest seq wal_replay applied
        #: optional callable(prebuilt StackedLeaves) the compactor runs
        #: during its pre-publish warmup -- the sharded front-end hooks
        #: this to also prepare the cross-shard round-2 stack
        self._warmup_hook = None
        #: optional threading.Lock shared by every shard of a sharded
        #: front-end: held from the pre-publish warmup through the epoch
        #: flip, it serialises concurrent shard publishes so each warmup
        #: predicts the cross-shard composition it publishes into
        self._publish_gate = None

        self._background = bool(background)
        self._stop = False
        self._compact_event = threading.Event()
        self._compactor: threading.Thread | None = None
        if self._background:
            self._compactor = threading.Thread(
                target=self._compactor_loop, daemon=True)
            self._compactor.start()

        self._snapshot = self._make_snapshot()

    # ------------------------------------------------------------------
    @classmethod
    def from_data(cls, data: np.ndarray, *, gids: np.ndarray | None = None,
                  **kw: Any) -> "MutableP2HIndex":
        """Bulk-load: seed with one sealed segment over ``data``; ``gids``
        (optional) are externally allocated global ids, one per row."""
        data = np.asarray(data, np.float32)
        self = cls(data.shape[1], **kw)
        self.bulk_seed(data, gids=gids)
        return self

    def bulk_seed(self, data: np.ndarray, *,
                  gids: np.ndarray | None = None) -> None:
        """Seed an *empty* index with one sealed segment over ``data``."""
        data = np.asarray(data, np.float32)
        pts = append_ones(data)
        if gids is None:
            gids = np.arange(len(pts), dtype=np.int32)
        else:
            gids = np.asarray(gids, np.int32)
            if len(gids) != len(pts):
                raise ValueError(f"{len(gids)} gids for {len(pts)} rows")
        with self._lock:
            if self._segments or self._delta.length:
                raise ValueError("bulk_seed requires an empty index")
            if len(pts):
                seg = Segment.from_points(self._alloc_uid(), pts, gids,
                                          n0=self.n0, seed=self.seed,
                                          device=self.device)
                self._segments[seg.uid] = seg
                self._locator.update(_seg_locator(seg))
                self._max_norm = float(np.linalg.norm(pts, axis=1).max())
                self._next_gid = int(gids.max()) + 1
            self._live_count = len(pts)
            self._publish()

    # ------------------------------------------------------------------
    # write path
    # ------------------------------------------------------------------
    def insert(self, point: np.ndarray, *, gid: int | None = None) -> int:
        """Insert one raw (dim,) point; returns its stable global id
        (``gid``: an externally allocated, fresh id)."""
        x = np.asarray(point, np.float32).reshape(-1)
        if x.shape != (self.dim,):
            raise ValueError(f"point of shape {x.shape}, index dim "
                             f"{self.dim}")
        with self._lock:
            gid = self._insert_one_locked(x, gid=gid)
            self._publish()
            self._wal_log_insert(x, gid)
            self._maybe_compact_locked()
        self._wal_commit()
        return gid

    def insert_batch(self, points: np.ndarray,
                     gids: np.ndarray | None = None) -> np.ndarray:
        """Bulk insert: one lock hold, one snapshot publish at the end
        (mid-batch compactions still run when the delta fills)."""
        pts = np.atleast_2d(np.asarray(points, np.float32))
        if pts.shape[1] != self.dim:
            raise ValueError(f"points of shape {pts.shape}, index dim "
                             f"{self.dim}")
        if gids is not None and len(gids) != len(pts):
            raise ValueError(f"{len(gids)} gids for {len(pts)} rows")
        out = np.empty((len(pts),), np.int32)
        with self._lock:
            for i, x in enumerate(pts):
                out[i] = self._insert_one_locked(
                    x, gid=None if gids is None else int(gids[i]))
                self._wal_log_insert(x, int(out[i]))
            self._publish()
            self._maybe_compact_locked()
        self._wal_commit()
        return out

    def _insert_one_locked(self, x: np.ndarray, *,
                           gid: int | None = None) -> int:
        """Append one point to the delta (compacting if full); no
        publish -- callers publish once per API call."""
        x1 = np.concatenate([x, np.ones((1,), np.float32)])
        while self._delta.full:
            self._raise_compact_errors_locked()  # don't spin forever
            if self._background:
                self._compact_event.set()
                if len(self._sealed) < self.policy.max_pending_seals:
                    # admission control: seal the full delta and keep
                    # writing into a fresh one; sealed buffers stay
                    # queryable and deletable until the compactor
                    # consumes them
                    self._sealed.append(self._delta)
                    self._delta = DeltaBuffer(self.policy.delta_capacity,
                                              self.d)
                    self._admission["seals"] += 1
                else:
                    self._admission["stalls"] += 1
                    self._cond.wait(timeout=1.0)  # compactor republishes
            else:
                self._compact_locked(self._plan_locked())
        if gid is None:
            gid = self._next_gid
            self._next_gid += 1
        else:
            gid = int(gid)
            if gid in self._locator:
                raise ValueError(f"gid {gid} already live")
            self._next_gid = max(self._next_gid, gid + 1)
        row = self._delta.append(x1, gid)
        self._locator[gid] = ("delta", id(self._delta), row)
        self._live_count += 1
        self._max_norm = max(self._max_norm, float(np.linalg.norm(x1)))
        return gid

    def delete(self, gid: int, *, commit: bool = True) -> bool:
        """Delete by global id; returns False if the id is not live.

        A tombstone flip + one snapshot publish.  Compaction never runs on
        this thread: background mode signals the compactor, inline mode
        defers to the next insert or ``compact()``.

        ``commit=False`` logs the op but leaves the WAL group commit to the
        caller; the op is not acknowledged until a commit covers it."""
        gid = int(gid)
        self._tl.in_delete = True
        try:
            with self._lock:
                ok = self._delete_locked(gid)
                if ok:
                    self._wal_log(OP_DELETE, gid)
        finally:
            self._tl.in_delete = False
        if ok and commit:
            self._wal_commit()
        return ok

    def _delete_locked(self, gid: int) -> bool:
        loc = self._locator.pop(gid, None)
        if loc is None:
            return False
        if loc[0] == "delta":
            _, buf_id, row = loc
            for buf in [self._delta, *self._sealed]:
                if id(buf) == buf_id:
                    buf.tombstone(row)
                    break
        else:
            _, uid, local = loc
            self._segments[uid] = \
                self._segments[uid].with_tombstone(local)
        if self._compacting:
            # the in-flight compaction copied its input rows before this
            # delete; re-apply it to the output at publish time
            self._pending_tombstones.add(gid)
        self._live_count -= 1
        self._last_delete_epoch = self._epoch + 1  # post-publish
        self._publish()
        if (self._background and not self._compacting
                and self._plan_locked()):
            self._compact_event.set()
        return True

    # ------------------------------------------------------------------
    # write-ahead log (repro_torch.stream.wal)
    # ------------------------------------------------------------------
    def attach_wal(self, wal) -> None:
        """Attach a :class:`repro_torch.stream.wal.ShardWal`: subsequent
        inserts/deletes are logged (and group-committed) before the write
        call returns.  Attach *after* any replay -- replayed ops are
        already in the log and must not be appended again."""
        with self._lock:
            self._wal = wal

    def _wal_log_insert(self, x_raw: np.ndarray, gid: int) -> None:
        """Log one insert (raw ``(dim,)`` row; caller holds the lock)."""
        if self._wal is not None:
            self._wal.append(OP_INSERT, gid, self._epoch,
                             np.asarray(x_raw, np.float32).tobytes(),
                             token=("ins", int(gid)))

    def _wal_log(self, op: int, gid: int, blob: bytes = b"") -> None:
        if self._wal is not None:
            self._wal.append(op, gid, self._epoch, blob,
                             token=("del", int(gid)) if op == OP_DELETE
                             else None)

    def _wal_commit(self) -> None:
        """Group commit (off the writer lock): the public write call's
        acknowledgement point.  Per :class:`~repro_torch.stream.wal.
        WalConfig`, either this call's fsync covers the op now, or a later
        group commit does and the ``on_ack`` callback reports it then."""
        if self._wal is not None:
            self._wal.commit()

    def wal_replay(self, wal, *, from_offset: int = 0,
                   min_seq: int = 0) -> dict:
        """Replay a WAL tail into this (just-restored) index.

        Idempotent: records at ``seq <= min_seq`` (already covered by the
        checkpoint) are skipped, an insert whose gid is already live is
        skipped, a delete of a non-live gid is skipped -- so replaying the
        same tail twice applies each op at most once.  After replay the
        epoch is bumped past the largest epoch any replayed record
        carried, so the published epoch stays monotone across a crash.
        Returns ``{"applied", "skipped", "ops"}``."""
        applied = skipped = seen = 0
        with self._lock:
            # replaying the same log twice into one instance must be a
            # no-op: the gid-liveness guards alone would re-apply an
            # insert+delete *pair* (dead gid -> reinsert -> redelete)
            min_seq = max(min_seq, self._wal_replayed_seq)
            max_epoch = self._epoch
            for rec in wal.records(from_offset):
                if rec.op == OP_ROUTER:  # placement, not data
                    continue
                seen += 1
                self._wal_replayed_seq = max(self._wal_replayed_seq,
                                             rec.seq)
                if rec.seq <= min_seq:
                    skipped += 1
                    continue
                max_epoch = max(max_epoch, rec.epoch)
                if rec.op == OP_INSERT:
                    if rec.gid in self._locator:
                        skipped += 1
                        continue
                    self._insert_one_locked(rec.point(), gid=rec.gid)
                    self._publish()
                    applied += 1
                elif rec.op == OP_DELETE:
                    if self._delete_locked(rec.gid):
                        applied += 1
                    else:
                        skipped += 1
            if max_epoch > self._epoch:
                # jump past the pre-crash epoch: _publish increments, so
                # the republished epoch is strictly greater than any
                # epoch an acked op ever observed
                self._epoch = max_epoch
                self._publish()
            self._maybe_compact_locked()
        return {"applied": applied, "skipped": skipped, "ops": seen}

    # ------------------------------------------------------------------
    def has_gid(self, gid: int) -> bool:
        with self._lock:
            return int(gid) in self._locator

    def live_gids(self) -> np.ndarray:
        """Snapshot of the live global ids (sorted, for determinism)."""
        with self._lock:
            out = np.fromiter(self._locator.keys(), np.int64,
                              len(self._locator))
        out.sort()
        return out

    def points_for(self, gids) -> tuple[np.ndarray, np.ndarray]:
        """Rows for the requested gids as ``(points (n, dim), found
        gids)`` -- raw rows without the appended 1-coordinate.  Unknown
        gids are dropped, not errors."""
        pts, found = [], []
        with self._lock:
            for g in np.asarray(gids, np.int64):
                loc = self._locator.get(int(g))
                if loc is None:
                    continue
                if loc[0] == "delta":
                    _, buf_id, row = loc
                    for buf in [self._delta, *self._sealed]:
                        if id(buf) == buf_id:
                            pts.append(np.array(buf.points[row]))
                            found.append(int(g))
                            break
                else:
                    _, uid, local = loc
                    seg = self._segments[uid]
                    row = int(seg.row_of_local[local])
                    pts.append(seg.tree.points[row].cpu().numpy())
                    found.append(int(g))
        if not pts:
            return (np.zeros((0, self.dim), np.float32),
                    np.zeros((0,), np.int64))
        # stored rows carry the appended 1-coordinate; strip it
        return (np.stack(pts)[:, :-1].astype(np.float32),
                np.asarray(found, np.int64))

    # ------------------------------------------------------------------
    # read path
    # ------------------------------------------------------------------
    def snapshot(self) -> Snapshot:
        """The current published snapshot (atomic reference read)."""
        return self._snapshot

    @property
    def epoch(self) -> int:
        return self._snapshot.epoch

    @property
    def live_count(self) -> int:
        return self._snapshot.live_count

    @property
    def max_norm(self) -> float:
        return self._snapshot.max_norm

    def admission_stats(self) -> dict:
        """Write-admission counters: ``seals`` (full deltas sealed without
        blocking the writer), ``stalls`` (writer waited for the
        compactor), ``pending_seals`` and ``compactor_leaked``."""
        with self._lock:
            return dict(self._admission,
                        pending_seals=len(self._sealed))

    def query(self, queries, k: int = 1, *, method: str | None = None,
              frac: float = 1.0, normalize: bool = True,
              return_stats: bool = False, engine: Any = None, **kw: Any):
        """Top-k over the live set; same contract as ``P2HIndex.query``.

        Pins one snapshot for the whole call.  ``method=None`` means
        ``"sweep"``; ``"stacked"`` forces the stacked launch, and
        ``stacked=`` / ``probe_tiles=`` / ``probe_dtype=`` are forwarded to
        :meth:`Snapshot.query`.  Results are host arrays.  ``engine=``
        routes through a :class:`repro_torch.serve.P2HEngine` built over
        this index (micro-batching + epoch-tagged lambda warm start), where
        ``method=None`` means auto-dispatch and a method forces that route.
        """
        if engine is not None:
            return query_via_engine(self, engine, queries, k, method=method,
                                    normalize=normalize,
                                    return_stats=return_stats, kw=kw)
        q = np.atleast_2d(np.asarray(queries))
        if normalize:
            q = normalize_query(q)
        bd, bi, cnt = self.snapshot().query(
            q.astype(np.float32), k, method=method or "sweep", frac=frac,
            return_counters=True, **kw)
        if return_stats:
            return bd, bi, search.SearchStats(cnt)
        return bd, bi

    # ------------------------------------------------------------------
    # compaction
    # ------------------------------------------------------------------
    def compact(self, *, force: bool = False) -> bool:
        """Run one compaction now (inline, even in background mode);
        ``force=True`` merges all segments and the delta into one.
        Returns whether a compaction ran."""
        with self._lock:
            # an in-flight background run owns _pending_tombstones and the
            # sealed delta; pinning on top of it would corrupt both
            while self._compacting:
                self._cond.wait(timeout=1.0)
            self._raise_compact_errors_locked()
            if force:
                plan = CompactionPlan(
                    include_delta=True,
                    segment_uids=tuple(self._segments),
                    reason="forced")
            else:
                plan = self._plan_locked()
            if not plan:
                return False
            self._compact_locked(plan)
        return True

    def wait_compaction(self) -> None:
        """Block until no background compaction is in flight; re-raises
        any error a background run died with."""
        with self._lock:
            while self._compacting:
                self._cond.wait(timeout=1.0)
            self._raise_compact_errors_locked()

    def _raise_compact_errors_locked(self) -> None:
        if self._compact_errors:
            raise self._compact_errors.pop(0)

    def close(self, *, timeout_s: float = 5.0) -> None:
        """Stop the background compactor (if any) and close the attached
        WAL (final group commit included); safe to call twice.  A
        compactor that does not stop within ``timeout_s`` is leaked (a
        daemon thread), logged and counted in :meth:`admission_stats`."""
        self._stop = True
        self._compact_event.set()
        if self._compactor is not None:
            self._compactor.join(timeout=timeout_s)
            if self._compactor.is_alive():
                with self._lock:
                    self._admission["compactor_leaked"] += 1
                logger.warning(
                    "compactor thread still alive %.1fs after close(); "
                    "leaking daemon thread %s", timeout_s,
                    self._compactor.name)
            self._compactor = None
        if self._wal is not None:
            self._wal.close()
            self._wal = None

    def _plan_locked(self) -> CompactionPlan:
        plan = self.policy.plan(delta_full=self._delta.full,
                                delta_live=self._delta.live,
                                segments=tuple(self._segments.values()))
        if not plan and self._sealed:
            # leftovers a failed background run never published: any
            # compaction consumes them, so force one
            plan = CompactionPlan(include_delta=True, segment_uids=(),
                                  reason="recover sealed delta")
        return plan

    def _maybe_compact_locked(self) -> None:
        if self._compacting:
            return
        if self._plan_locked():
            if self._background:
                self._compact_event.set()
            else:
                self._compact_locked(self._plan_locked())

    def _compactor_loop(self) -> None:
        while True:
            self._compact_event.wait()
            self._compact_event.clear()
            if self._stop:
                return
            try:
                with self._lock:
                    plan = self._plan_locked()
                    if not plan or self._compacting:
                        continue
                    pin = self._pin_inputs_locked(plan)
                # row copies, the tree build and the stack of the next
                # snapshot run OFF the writer lock: raced deletes land in
                # _pending_tombstones (re-applied by gid at publish)
                self._collect_pinned_rows(pin)
                built = self._build_segment(pin)
                # the gate (shared across a sharded front-end's shards)
                # makes warm-then-flip atomic against the other shards'
                # publishes
                gate = self._publish_gate or contextlib.nullcontext()
                with gate:
                    prepub = self._prewarm_publish(pin, built)
                    with self._lock:
                        self._publish_compaction_locked(pin, built,
                                                        prepub=prepub)
                        if self._plan_locked():
                            # seals (or churn) accumulated meanwhile: drain
                            self._compact_event.set()
                        self._cond.notify_all()
                # post-publish re-warm (outside the gate): ungated
                # publishes -- deletes, seals -- may have raced the warmup
                hook = self._warmup_hook
                if hook is not None and prepub is not None \
                        and prepub.get("stacked") is not None:
                    try:
                        hook(prepub["stacked"])
                    except Exception:
                        pass
            except BaseException as e:
                # never die wedged: writers blocked on _compacting would
                # hang forever.  Pinned buffers stay in _sealed (queryable)
                # and the next compaction re-consumes them; the error
                # surfaces at the next wait_compaction()/compact()/insert()
                with self._lock:
                    self._compact_errors = [e]
                    self._compacting = False
                    self._pending_tombstones = set()
                    self._cond.notify_all()

    def _compact_locked(self, plan: CompactionPlan) -> None:
        """Inline compaction: pin + build + publish under the lock."""
        if not plan:
            return
        pin = self._pin_inputs_locked(plan)
        self._collect_pinned_rows(pin)
        built = self._build_segment(pin)
        self._publish_compaction_locked(pin, built)
        self._cond.notify_all()

    # -- compaction phases (pin/build/publish) --------------------------
    def _pin_inputs_locked(self, plan: CompactionPlan) -> dict:
        """Seal the delta (if consumed) and capture input *references*;
        the row copies happen in :meth:`_collect_pinned_rows`.  Buffers
        already in ``_sealed`` are admission seals or leftovers of a
        failed run; every compaction re-consumes them."""
        assert not getattr(self._tl, "in_delete", False), \
            "compaction must never run on a delete caller's thread"
        t0 = time.perf_counter()
        pinned = list(self._sealed)
        if plan.include_delta:
            buf = self._delta
            self._sealed.append(buf)
            self._delta = DeltaBuffer(self.policy.delta_capacity, self.d)
            pinned.append(buf)
        segs = [self._segments[uid] for uid in plan.segment_uids]
        self._compacting = True
        self._pending_tombstones = set()
        return dict(plan=plan, bufs=pinned, segs=segs, t0=t0)

    def _collect_pinned_rows(self, pin: dict) -> None:
        """Copy the pinned inputs' live rows into ``pin`` (safe off the
        lock once ``_compacting`` is set: raced deletes are re-applied by
        gid at publish)."""
        parts_p, parts_g = [], []
        for src in [*pin["bufs"], *pin["segs"]]:
            p, g = src.live_rows()
            parts_p.append(p)
            parts_g.append(g)
        pin["points"] = (np.concatenate(parts_p) if parts_p
                         else np.zeros((0, self.d), np.float32))
        pin["gids"] = (np.concatenate(parts_g) if parts_g
                       else np.zeros((0,), np.int32))

    def _build_segment(self, pin: dict) -> Segment | None:
        """Tree build over the pinned rows (outside the lock in background
        mode)."""
        if len(pin["gids"]) == 0:
            return None
        return Segment.from_points(self._alloc_uid(), pin["points"],
                                   pin["gids"], n0=self.n0,
                                   seed=self.seed + self._epoch + 1,
                                   device=self.device)

    def _prewarm_publish(self, pin: dict, built: Segment | None):
        """Off the lock, before the background publish flips the epoch:
        stack the predicted post-publish segment set, record the recent
        query templates against it (:func:`repro_torch.kernels.
        stacked_sweep.warm_stacked`, or the sharded front-end's
        ``_warmup_hook``, which prepares the cross-shard stack instead),
        record the exchange's round-1 templates against the new tree
        (:func:`repro_torch.core.distributed.warm_round1`), and prebuild
        the new segment's locator entries, so the publish's lock hold is
        one dict update.  Best-effort: a failure only means the first
        query stacks lazily."""
        try:
            from repro_torch.kernels.stacked_sweep import (StackedLeaves,
                                                           warm_stacked)

            plan: CompactionPlan = pin["plan"]
            with self._lock:
                segs = [seg for uid, seg in self._segments.items()
                        if uid not in plan.segment_uids]
            if built is not None:
                segs.append(built)
            prepub = dict(stacked=None, sources=None, locator=None,
                          warmed=0)
            if segs:
                stk = StackedLeaves.from_segments(segs)
                prepub.update(stacked=stk, sources=tuple(segs))
                hook = self._warmup_hook
                if hook is None:
                    # one index: the shard-local stack is the served one
                    prepub["warmed"] = warm_stacked(stk)
                else:
                    # sharded: serving goes through the hook's cross-shard
                    # concatenation, never the shard-local stack
                    try:
                        hook(stk)
                        prepub["warmed"] += 1
                    except Exception:
                        pass
            if built is not None:
                # the exchange's round 1 beams each segment tree: record
                # its templates against the new tree too
                from repro_torch.core.distributed import warm_round1

                prepub["warmed"] += warm_round1(
                    built.tree, is_bc=(self.variant == "bc"))
                prepub["locator"] = _seg_locator(built)
            return prepub
        except Exception:
            return None  # warmup must never break the compaction

    def _publish_compaction_locked(self, pin: dict,
                                   built: Segment | None,
                                   prepub: dict | None = None) -> None:
        plan: CompactionPlan = pin["plan"]
        dead_gids = self._pending_tombstones
        if built is not None and dead_gids:
            # deletes that raced the build: mask them in the new segment
            dead = np.fromiter(dead_gids, np.int64, len(dead_gids))
            locals_ = np.nonzero(np.isin(built.gids, dead))[0]
            built = built.with_tombstones(locals_)
        for buf in pin["bufs"]:
            self._sealed.remove(buf)
        for uid in plan.segment_uids:
            del self._segments[uid]
        if built is not None:
            self._segments[built.uid] = built
            loc = prepub.get("locator") if prepub is not None else None
            if loc is None:
                loc = _seg_locator(built)
            for gid in dead_gids:  # never resurrect a raced delete
                loc.pop(gid, None)
            self._locator.update(loc)
        self._compacting = False
        self._pending_tombstones = set()
        self._publish(prepub=prepub)
        t1 = time.perf_counter()
        self.compaction_log.append(dict(
            wall_s=t1 - pin["t0"], t0_s=pin["t0"], t1_s=t1,
            rows=int(len(pin["gids"])), reason=plan.reason,
            epoch=self._epoch,
            warmed=(0 if prepub is None else int(prepub["warmed"])),
        ))

    # ------------------------------------------------------------------
    def _alloc_uid(self) -> int:
        with self._lock:
            uid = self._next_uid
            self._next_uid += 1
            return uid

    def _make_snapshot(self) -> Snapshot:
        views = [DeltaView(*self._delta.frozen_view())]
        views += [DeltaView(*b.frozen_view()) for b in self._sealed]
        return Snapshot(
            epoch=self._epoch,
            last_delete_epoch=self._last_delete_epoch,
            segments=tuple(self._segments.values()),
            deltas=tuple(views),
            live_count=self._live_count,
            max_norm=self._max_norm,
            variant=self.variant,
            n0=self.n0,
            d=self.d,
            device=self.device,
        )

    def _publish(self, prepub: dict | None = None) -> None:
        """Atomic snapshot swap (caller holds the lock).  The new snapshot
        adopts the previous one's stack when the segment set allows it
        (tombstone publishes defer just the changed ids planes), or the
        compactor's prebuilt stack (``prepub``)."""
        self._epoch += 1
        prev = self._snapshot
        snap = self._make_snapshot()
        snap.adopt_stacked_from(prev)
        if prepub is not None and prepub.get("stacked") is not None:
            snap.adopt_prebuilt_stacked(prepub["stacked"],
                                        prepub["sources"])
        self._snapshot = snap

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def save(self, directory: str) -> int:
        """Persist segments + delta atomically; returns the step saved.
        Joins any in-flight background compaction under the writer lock
        and folds leftover sealed buffers into a segment first, so the
        state is always segments + one active delta.  With a WAL attached
        the checkpoint records the log frontier it covers, and the covered
        prefix of the log is truncated away.  The log is committed before
        the checkpoint is written, so the checkpoint never covers a record
        that is not on disk."""
        from repro_torch.checkpoint import CheckpointManager

        with self._lock:
            while self._compacting:
                self._cond.wait(timeout=1.0)
            self._raise_compact_errors_locked()
            if self._sealed:  # leftovers of a failed background run
                self._compact_locked(self._plan_locked())
            state, meta = self._state_locked()
            if self._wal is not None:
                # everything at seq <= wal_seq is in the serialised state:
                # restore replays strictly past it.  Commit first, so the
                # log on disk holds every record the checkpoint covers: a
                # record still in the writer's buffer when a crash follows
                # the checkpoint would vanish from the log, the reopened
                # log would hand its seq and offset to a later write, and
                # the next restore would skip that acknowledged write as
                # covered.
                self._wal.commit(force=True)
                meta["wal_offset"] = self._wal.tail_offset()
                meta["wal_seq"] = self._wal.last_seq
            step = self._epoch
            CheckpointManager(directory, keep=2).save(
                step, state, blocking=True, extra_meta=meta)
            if self._wal is not None:
                self._wal.truncate_prefix(meta["wal_offset"])
                self.last_saved_wal = (meta["wal_offset"], meta["wal_seq"])
        return step

    def _state_locked(self):
        assert not self._compacting and not self._sealed
        seg_arrays, seg_meta = [], []
        for seg in self._segments.values():
            arrays = seg.tree.to_numpy()
            arrays["gids"] = np.asarray(seg.gids)
            arrays["row_of_local"] = np.asarray(seg.row_of_local)
            seg_arrays.append(arrays)
            seg_meta.append(dict(uid=seg.uid, live=seg.live, dead=seg.dead,
                                 tree_static=seg.tree.statics()))
        state = {
            "segments": seg_arrays,
            "delta": {"points": self._delta.points, "gids": self._delta.gids},
        }
        meta = {
            "format": _STATE_FORMAT,
            "version": _STATE_VERSION,
            "dim": self.dim,
            "n0": self.n0,
            "variant": self.variant,
            "seed": self.seed,
            "epoch": self._epoch,
            "last_delete_epoch": self._last_delete_epoch,
            "next_gid": self._next_gid,
            "next_uid": self._next_uid,
            "live_count": self._live_count,
            "max_norm": self._max_norm,
            "delta_length": self._delta.length,
            "policy": dataclasses.asdict(self.policy),
            "segments": seg_meta,
        }
        return state, meta

    @classmethod
    def load(cls, directory: str, *, step: int | None = None,
             background: bool = False, wal=None,
             device=None) -> "MutableP2HIndex":
        """Recover a mutable index saved by :meth:`save` (this package's or
        the JAX package's) onto ``device``.

        ``wal`` (optional :class:`repro_torch.stream.wal.ShardWal`): replay
        the log's tail past the checkpoint's recorded ``(wal_offset,
        wal_seq)`` frontier, then attach the log for later writes."""
        from repro_torch.checkpoint import CheckpointManager
        from repro_torch.checkpoint.manager import unflatten

        mgr = CheckpointManager(directory)
        if step is None:
            step = mgr.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint under {directory}")
        leaves, manifest = mgr.restore_leaves(step)
        meta = manifest["extra"]
        if meta.get("format") != _STATE_FORMAT:
            raise ValueError(f"{directory}: not a {_STATE_FORMAT} checkpoint")
        if meta.get("version", 0) > _STATE_VERSION:
            raise ValueError(f"{directory}: state version "
                             f"{meta['version']} is newer than this reader")

        array_fields = FlatTree.array_names() + ["gids", "row_of_local"]
        skeleton = {
            "segments": [{name: 0 for name in array_fields}
                         for _ in meta["segments"]],
            "delta": {"points": 0, "gids": 0},
        }
        state = unflatten(skeleton, leaves)

        policy = CompactionPolicy(**meta["policy"])
        self = cls(meta["dim"], n0=meta["n0"], variant=meta["variant"],
                   policy=policy, seed=meta["seed"], background=background,
                   device=device)
        with self._lock:
            for arrays, smeta in zip(state["segments"], meta["segments"]):
                gids = np.asarray(arrays.pop("gids"), np.int32)
                row_of_local = np.asarray(arrays.pop("row_of_local"),
                                          np.int32)
                tree = FlatTree.from_numpy(arrays, smeta["tree_static"])
                seg = Segment(uid=smeta["uid"], tree=tree.to(self.device),
                              gids=gids, row_of_local=row_of_local,
                              live=smeta["live"], dead=smeta["dead"])
                self._segments[seg.uid] = seg
                self._locator.update(_seg_locator(seg))
            self._delta.points[:] = state["delta"]["points"]
            self._delta.gids[:] = np.asarray(state["delta"]["gids"],
                                             np.int32)
            self._delta.length = meta["delta_length"]
            for row in range(self._delta.length):
                gid = int(self._delta.gids[row])
                if gid >= 0:
                    self._locator[gid] = ("delta", id(self._delta), row)
            self._next_gid = meta["next_gid"]
            self._next_uid = max(meta["next_uid"], self._next_uid)
            self._epoch = meta["epoch"]
            self._last_delete_epoch = meta["last_delete_epoch"]
            self._live_count = meta["live_count"]
            self._max_norm = meta["max_norm"]
            self._snapshot = self._make_snapshot()
        if wal is not None:
            self.wal_replay(wal, from_offset=meta.get("wal_offset", 0),
                            min_seq=meta.get("wal_seq", 0))
            self.attach_wal(wal)
        return self


def _seg_locator(seg: Segment) -> dict:
    """gid -> ("seg", uid, local id) for every live point of ``seg``."""
    pid = seg.tree.point_ids.cpu().numpy()
    local = pid[pid >= 0]
    return {int(g): ("seg", seg.uid, int(lo))
            for g, lo in zip(seg.gids[local], local)}
