"""Per-shard write-ahead log: durability to the last acknowledged write.

The paper's headline -- Ball/BC-Tree construction is 1-3 orders of
magnitude cheaper than the hashing baselines' indexing -- only matters in
deployment if the index survives a crash without a rebuild.  Checkpoints
(``repro_torch.checkpoint``) bound the rebuild to "since the last save"; this
module closes the remaining window: every routed op (insert/delete, with
gid and the shard epoch it published) is appended to a length-prefixed,
checksummed per-shard log *before* it is acknowledged, so

    restore = load checkpoint + replay the WAL tail

recovers to the last acknowledged write with **no cross-shard barrier**
(each shard replays its own log independently; there is no global
ordering to reconstruct because routed ops commute across shards).

Log format (little-endian)::

    header:  8-byte magic "P2HWAL1\\n" + u64 base_offset + u64 seq_floor
    record:  u32 payload_len | u32 crc32(payload) | payload
    payload: u8 op | u64 seq | i64 gid | u64 epoch | u32 blob_len | blob

``base_offset`` makes offsets *logical*: checkpoint manifests record a
``(checkpoint_epoch, wal_offset)`` pair per shard, and
:meth:`ShardWal.truncate_prefix` rewrites the file to start at a new
base without invalidating recorded offsets.  ``seq`` is the shard's
monotone op counter (also persisted in checkpoints), which makes replay
idempotent: a record whose seq the checkpoint already covers is skipped,
and a double restore applies each op at most once.  ``seq_floor``
(rewritten by truncation to the truncating writer's ``last_seq``) keeps
seq monotone across truncation + process restart: without it, a log a
checkpoint fully emptied would hand a new incarnation seq 1 again, and
every subsequent acknowledged op would fall under the checkpoint's
recorded ``wal_seq`` and be skipped -- silently lost -- at replay.

Group commit: appends buffer in the OS page cache; :meth:`ShardWal.commit`
fsyncs when ``fsync_every_n`` records are pending or
``fsync_interval_ms`` has elapsed since the last sync.  An op is
*acknowledged* only once the group commit covering it returns -- callers
register ack tokens at append time and receive them back (in seq order,
exactly once) from the ``on_ack`` callback after the covering fsync.
Exactly those tokens are the durability contract: every acked op must
survive a crash.

The byte format is the JAX package's (``repro.stream.wal``), both ways: a
log either package writes replays in the other.

Torn tails: a crash mid-append can leave a truncated or corrupt final
record.  Both :meth:`ShardWal.open`-for-append and replay stop at the
first bad length/checksum and truncate the file there -- the torn record
was never acked (its group commit never returned), so dropping it is
exactly the contract.
"""
from __future__ import annotations

import dataclasses
import os
import struct
import threading
import time
import zlib
from typing import Any, Callable, Iterator

__all__ = ["WalConfig", "WalRecord", "ShardWal",
           "OP_INSERT", "OP_DELETE", "OP_ROUTER"]

_MAGIC = b"P2HWAL1\n"
_HEADER = struct.Struct("<8sQQ")         # magic, base_offset, seq_floor
_FRAME = struct.Struct("<II")            # payload_len, crc32
_PAYLOAD = struct.Struct("<BQqQI")       # op, seq, gid, epoch, blob_len

OP_INSERT = 1   # blob = float32 point bytes (raw dim, no appended 1)
OP_DELETE = 2   # blob = b""
OP_ROUTER = 3   # blob = utf-8 JSON router spec / migration phase

#: ceiling on one record's payload (a corrupt length prefix must not
#: make replay try to allocate gigabytes before the checksum check)
_MAX_PAYLOAD = 1 << 26


@dataclasses.dataclass(frozen=True)
class WalConfig:
    """Group-commit knobs.  ``fsync_every_n=1`` is per-op durability;
    larger values amortize the fsync over a batch, with
    ``fsync_interval_ms`` bounding how long a lone op can wait for
    companions before its group commits anyway."""

    fsync_every_n: int = 8
    fsync_interval_ms: float = 50.0


@dataclasses.dataclass(frozen=True)
class WalRecord:
    op: int
    seq: int
    gid: int
    epoch: int
    blob: bytes
    offset: int      # logical offset of the record's first byte
    end_offset: int  # logical offset just past the record

    def point(self, dtype="float32"):
        import numpy as np

        return np.frombuffer(self.blob, dtype=dtype)


def _encode(op: int, seq: int, gid: int, epoch: int, blob: bytes) -> bytes:
    payload = _PAYLOAD.pack(op, seq, gid, epoch, len(blob)) + blob
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


class ShardWal:
    """One shard's append-only log.

    Appends are serialized by the shard's writer lock, but **group
    commits run off that lock** (an acknowledged write must not stall
    concurrent appenders behind its fsync), so the class guards its own
    state: ``_mu`` makes each append atomic with respect to the commit
    path's prefix snapshot, and ``_commit_mu`` serializes committers
    (and truncation, which swaps the file handle) with each other.  A
    commit fsyncs, then marks synced and acks **only the prefix that
    was pending when it started**: a record appended while the fsync is
    in flight stays pending, with its ack token, for a later commit
    (its own write call always issues one) -- an ack can never fire for
    a record that is not yet on disk."""

    def __init__(self, path: str, *, config: WalConfig | None = None,
                 on_ack: Callable[[list], None] | None = None):
        self.path = path
        self.config = config or WalConfig()
        self.on_ack = on_ack
        self.base_offset = 0
        self.last_seq = 0        # highest seq ever appended (or scanned)
        self.synced_seq = 0      # highest seq covered by an fsync
        self.synced_offset = 0   # logical offset covered by an fsync
        self._pending = 0        # records appended since the last fsync
        self._pending_acks: list[tuple[int, Any]] = []  # (seq, token)
        self._last_sync_t = time.monotonic()
        self._mu = threading.Lock()        # append/commit state
        self._commit_mu = threading.RLock()  # one committer at a time
        self._fh = self._open_scan()

    # ------------------------------------------------------------------
    # open / scan
    # ------------------------------------------------------------------
    def _open_scan(self):
        """Open for append: create with a header if missing, else scan to
        the tail (physically truncating a torn final record)."""
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        if not os.path.exists(self.path):
            with open(self.path, "wb") as fh:
                fh.write(_HEADER.pack(_MAGIC, 0, 0))
                fh.flush()
                os.fsync(fh.fileno())
            _fsync_dir(os.path.dirname(self.path) or ".")
        fh = open(self.path, "r+b")
        magic, base, seq_floor = _HEADER.unpack(fh.read(_HEADER.size))
        if magic != _MAGIC:
            raise IOError(f"{self.path}: not a P2H WAL (bad magic)")
        self.base_offset = base
        # the header's seq floor makes seq survive prefix truncation: a
        # fully-truncated log reopened by a new process must NOT restart
        # at seq 1, or every subsequent op would fall under a
        # checkpoint's recorded wal_seq and be skipped at replay --
        # silently dropping acknowledged writes
        self.last_seq = max(self.last_seq, seq_floor)
        good_end = _HEADER.size
        for rec in _iter_records(fh, base):
            good_end = rec.end_offset - base + _HEADER.size
            self.last_seq = max(self.last_seq, rec.seq)
        fh.truncate(good_end)  # drop any torn tail before appending
        fh.seek(good_end)
        # everything that survived open is on disk already
        self.synced_seq = self.last_seq
        self.synced_offset = base + good_end - _HEADER.size
        return fh

    # ------------------------------------------------------------------
    # append / commit
    # ------------------------------------------------------------------
    def tail_offset(self) -> int:
        """Logical offset just past the last appended record."""
        return self.base_offset + self._fh.tell() - _HEADER.size

    def append(self, op: int, gid: int, epoch: int,
               blob: bytes = b"", *, token: Any = None) -> int:
        """Append one record (no fsync); returns the logical offset past
        it.  ``token`` (optional) is handed to ``on_ack`` once the
        covering group commit completes."""
        with self._mu:
            self.last_seq += 1
            self._fh.write(_encode(op, self.last_seq, int(gid),
                                   int(epoch), blob))
            self._pending += 1
            if token is not None:
                self._pending_acks.append((self.last_seq, token))
            return self.tail_offset()

    def commit(self, *, force: bool = False) -> bool:
        """Group commit: fsync if ``force``, ``fsync_every_n`` records
        are pending, or ``fsync_interval_ms`` has elapsed.  Returns
        whether a sync happened.

        Only the records pending at entry are marked synced and acked:
        an append racing the fsync is *not* covered by it (the flush
        already happened), so it stays pending -- with its ack token --
        until its own covering commit.  Acks fire in seq order, under
        the commit lock, off the append mutex."""
        with self._commit_mu:
            with self._mu:
                if self._pending == 0:
                    return False
                due = (force
                       or self._pending >= self.config.fsync_every_n
                       or (time.monotonic() - self._last_sync_t) * 1e3
                       >= self.config.fsync_interval_ms)
                if not due:
                    return False
                covered_n = self._pending
                covered_seq = self.last_seq
                covered_off = self.tail_offset()
                n_acks = len(self._pending_acks)
                self._fh.flush()
            os.fsync(self._fh.fileno())
            with self._mu:
                self._pending -= covered_n
                self._last_sync_t = time.monotonic()
                self.synced_seq = max(self.synced_seq, covered_seq)
                self.synced_offset = max(self.synced_offset, covered_off)
                acked = self._pending_acks[:n_acks]
                del self._pending_acks[:n_acks]
            if acked and self.on_ack is not None:
                self.on_ack([tok for _, tok in acked])
            return True

    def close(self) -> None:
        with self._commit_mu:
            if self._fh is not None:
                self.commit(force=True)
                self._fh.close()
                self._fh = None

    # ------------------------------------------------------------------
    # replay / truncation
    # ------------------------------------------------------------------
    def records(self, from_offset: int = 0) -> Iterator[WalRecord]:
        """Iterate records at logical offsets >= ``from_offset`` (the
        replay path).  Stops cleanly at the first torn/corrupt record.

        Reads through a separate handle so an open writer is unaffected;
        offsets older than ``base_offset`` (already truncated away) clamp
        to the start -- the seq dedup makes over-replay harmless."""
        with self._mu:
            if self._fh is not None:
                self._fh.flush()
        with open(self.path, "rb") as fh:
            magic, base, _ = _HEADER.unpack(fh.read(_HEADER.size))
            if magic != _MAGIC:
                raise IOError(f"{self.path}: not a P2H WAL (bad magic)")
            for rec in _iter_records(fh, base):
                if rec.end_offset <= from_offset:
                    continue
                yield rec

    def truncate_prefix(self, upto_offset: int) -> None:
        """Drop records wholly below logical ``upto_offset`` (they are
        covered by a checkpoint): the surviving tail is rewritten to a
        tmp file with ``base_offset = upto_offset`` and atomically
        renamed over the log, so recorded logical offsets stay valid.

        Callers must serialize truncation with appends (the shard's
        writer lock does); the commit lock held here keeps a delayed
        group commit from racing the file-handle swap."""
        with self._commit_mu:
            if upto_offset <= self.base_offset:
                return
            self.commit(force=True)
            tail = []
            for rec in self.records(self.base_offset):
                if rec.offset >= upto_offset:
                    tail.append(_encode(rec.op, rec.seq, rec.gid,
                                        rec.epoch, rec.blob))
            new_base = upto_offset if not tail else min(
                upto_offset, self.tail_offset())
            tmp = self.path + ".tmp"
            with open(tmp, "wb") as fh:
                # last_seq as the seq floor: every truncated record's
                # seq is covered, and surviving tail seqs re-derive on
                # scan
                fh.write(_HEADER.pack(_MAGIC, new_base, self.last_seq))
                for chunk in tail:
                    fh.write(chunk)
                fh.flush()
                os.fsync(fh.fileno())
            with self._mu:
                self._fh.close()
                os.replace(tmp, self.path)
                self.base_offset = new_base
                self._fh = open(self.path, "r+b")
                self._fh.seek(0, os.SEEK_END)
                self.synced_offset = max(self.synced_offset, new_base)
            _fsync_dir(os.path.dirname(self.path) or ".")


def _iter_records(fh, base: int) -> Iterator[WalRecord]:
    """Frame-by-frame scan from the current position; stops (without
    raising) at the first short read or checksum mismatch -- the torn
    tail a crash mid-append leaves behind."""
    pos = fh.tell()
    while True:
        frame = fh.read(_FRAME.size)
        if len(frame) < _FRAME.size:
            return
        ln, crc = _FRAME.unpack(frame)
        if ln < _PAYLOAD.size or ln > _MAX_PAYLOAD:
            return
        payload = fh.read(ln)
        if len(payload) < ln or zlib.crc32(payload) != crc:
            return
        op, seq, gid, epoch, blob_len = _PAYLOAD.unpack(
            payload[:_PAYLOAD.size])
        if blob_len != ln - _PAYLOAD.size:
            return
        start = base + pos - _HEADER.size
        pos = fh.tell()
        yield WalRecord(op=op, seq=seq, gid=gid, epoch=epoch,
                        blob=payload[_PAYLOAD.size:],
                        offset=start, end_offset=base + pos - _HEADER.size)


def _fsync_dir(path: str) -> None:
    """fsync a directory so a just-renamed file inside it survives a
    crash (rename durability needs the parent's metadata flushed)."""
    fd = os.open(path, getattr(os, "O_DIRECTORY", os.O_RDONLY))
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems refuse directory fsync; best-effort
    finally:
        os.close(fd)
