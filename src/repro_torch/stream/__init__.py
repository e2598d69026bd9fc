"""Mutable LSM-style P2HNNS index: streaming inserts/deletes over the
BC-Tree with inline or background compaction and atomic snapshots.

``DeltaBuffer`` (delta.py)
    The memtable: inserts append to a fixed-capacity host buffer, queried
    by an exact brute-force scan.
``Segment`` / ``Snapshot`` / ``DeltaView`` (snapshot.py)
    Sealed trees with global-id tables; deletes mask a point's
    ``point_ids`` row to -1.  Queries fan out across delta + segments, by
    a sequential walk that threads a running cap, or by one stacked launch
    over every segment (``repro_torch.kernels.stacked_sweep``).
``CompactionPolicy`` (compaction.py)
    When to fold the delta and tombstone-heavy segments into fresh trees.
``MutableP2HIndex`` (mutable.py)
    The front-end: ``insert`` / ``delete`` / ``query`` / ``compact``,
    ``save`` / ``load`` in the JAX package's checkpoint format.
``ShardWal`` / ``WalConfig`` (wal.py)
    Write-ahead log with group-commit fsync: an acknowledged write
    (``on_ack`` fires after the fsync) survives a crash; recovery is the
    newest checkpoint plus an idempotent replay of the log's tail.  The
    JAX package's byte format.
``ShardedMutableP2HIndex`` / ``HashRouter`` (sharded.py)
    Independent mutable shards behind a gid router, queried through the
    two-round lambda exchange (``ShardedSnapshot``, an epoch-vector pin;
    round 2 spread over a serving mesh once ``set_mesh`` sets one);
    per-shard logs and checkpoints under one manifest.
``VersionedRouter`` / ``MigrationJournal`` (resharding.py)
    Live ``split_shard`` / ``merge_shards`` under a journaled slot map.
"""
from repro_torch.stream.compaction import CompactionPlan, CompactionPolicy
from repro_torch.stream.delta import DeltaBuffer
from repro_torch.stream.mutable import MutableP2HIndex
from repro_torch.stream.resharding import (MigrationJournal, VersionedRouter,
                                           plan_merge, plan_split)
from repro_torch.stream.sharded import HashRouter, ShardedMutableP2HIndex
from repro_torch.stream.snapshot import (DeltaView, Segment, ShardedSnapshot,
                                         Snapshot)
from repro_torch.stream.wal import ShardWal, WalConfig

__all__ = ["MutableP2HIndex", "Snapshot", "Segment", "DeltaView",
           "DeltaBuffer", "CompactionPolicy", "CompactionPlan",
           "ShardWal", "WalConfig", "ShardedMutableP2HIndex",
           "ShardedSnapshot", "HashRouter", "VersionedRouter",
           "MigrationJournal", "plan_split", "plan_merge"]
