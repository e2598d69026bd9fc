"""Live resharding in the port (``repro_torch.stream.resharding`` and the
sharded index's ``split_shard``/``merge_shards``) against the JAX
package's, on the CPU.

The versioned slot router, the split and merge plans and the migration
journal equal the JAX package's on the same inputs; router specs, journal
files (JSON and ``OP_ROUTER`` log records) and sharded manifests written by
one package are read by the other.  A split and a merge under a concurrent
query storm stay bit-exact against the unsplit answer and hold the live
set; the journal reaches disk before the new map routes a write; and a
crash in the middle of a journaled migration recovers to a consistent map
with every gid owned once.
"""
import json
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_parity import ATOL, RTOL, assert_topk_parity, oracle  # noqa: E402
from repro.stream import ShardedMutableP2HIndex as JSharded  # noqa: E402
from repro.stream import resharding as jr  # noqa: E402
from repro.stream.wal import WalConfig as JWalConfig  # noqa: E402
from repro_torch.core.balltree import normalize_query  # noqa: E402
from repro_torch.stream import (  # noqa: E402
    CompactionPolicy,
    HashRouter,
    MigrationJournal,
    ShardedMutableP2HIndex,
    VersionedRouter,
    WalConfig,
    plan_merge,
    plan_split,
)
from repro_torch.stream import resharding as tr  # noqa: E402
from repro_torch.stream import sharded as sharded_mod  # noqa: E402

DIM, K = 8, 6


def _mkdata(n, seed=0, dim=DIM):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(
        np.float32)


def _storm(idx, n_ops, seed, dim=DIM):
    """Deterministic mixed workload; returns the surviving gid set."""
    rng = np.random.default_rng(seed)
    live = []
    for _ in range(n_ops):
        gids = idx.insert_batch(rng.normal(size=(2, dim)).astype(np.float32))
        live += [int(g) for g in gids]
        if live and rng.random() < 0.4:
            assert idx.delete(live.pop(int(rng.integers(len(live)))))
    return set(live)


def _owned(idx) -> list:
    return [set(int(g) for g in sh.live_gids()) for sh in idx.shards]


def _live_exact(idx, q, k):
    X, G = idx.snapshot().live_points()
    d, i, nxt = oracle(X, normalize_query(q), k)
    bd, bi = idx.query(q, k)
    assert_topk_parity(bd, bi, d, G[i], nxt)


# ------------------------------------------------------------- the router
@pytest.mark.parametrize("num_shards,num_slots", [(2, 64), (4, 64), (3, 96)])
def test_versioned_router_equals_jax(num_shards, num_slots):
    t = VersionedRouter(num_shards, num_slots=num_slots)
    j = jr.VersionedRouter(num_shards, num_slots=num_slots)
    gids = np.concatenate([np.arange(4000), [2**31 - 1, 2**33 + 9]])
    assert t.spec() == j.spec()
    assert np.array_equal(t.slot_of_many(gids), j.slot_of_many(gids))
    assert np.array_equal(t.shard_of_many(gids), j.shard_of_many(gids))
    assert [t.shard_of(int(g)) for g in gids[:500]] == \
        [j.shard_of(int(g)) for g in gids[:500]]
    # bit-compatible with the hash router it upgrades
    h = HashRouter(num_shards)
    assert np.array_equal(t.shard_of_many(gids), h.shard_of_many(gids))
    assert tr.VersionedRouter.from_hash_spec(
        h.spec(), num_slots=num_slots).spec() == t.spec()
    # a split, then a merge, by both packages' planners
    ta, tm = plan_split(t, 0, num_shards)
    ja, jm = jr.plan_split(j, 0, num_shards)
    assert (ta, tm) == (ja, jm)
    t.apply(ta, tm)
    j.apply(ja, jm)
    assert t.spec() == j.spec() and t.version == 1 and t.moving == j.moving
    assert t.prev_shard_of(int(gids[0])) == j.prev_shard_of(int(gids[0]))
    ma, mm = plan_merge(t, num_shards, 0)
    assert (ma, mm) == jr.plan_merge(j, num_shards, 0)
    assert VersionedRouter.from_spec(j.spec()).spec() == t.spec()
    assert jr.VersionedRouter.from_spec(t.spec()).spec() == j.spec()


def test_plans_refuse_what_the_jax_package_refuses():
    t, j = VersionedRouter(4, num_slots=4), jr.VersionedRouter(4, num_slots=4)
    for fn, jfn, args in ((plan_split, jr.plan_split, (1, 4)),
                          (plan_merge, jr.plan_merge, (2, 2))):
        with pytest.raises(ValueError) as te:
            fn(t, *args)
        with pytest.raises(ValueError) as je:
            jfn(j, *args)
        assert str(te.value) == str(je.value)
    assert tr.DEFAULT_SLOTS == jr.DEFAULT_SLOTS
    assert tr._HASH_MULT == jr._HASH_MULT


# ------------------------------------------------------------ the journal
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_files_read_across_packages(tmp_path, writer):
    spec = dict(src=1, dst=3, moved_slots=(4, 9, 17),
                assignment=tuple(s % 4 for s in range(32)), version=5,
                op="split")
    t, j = MigrationJournal(**spec), jr.MigrationJournal(**spec)
    assert t.to_spec() == j.to_spec()
    assert t.wal_blob() == j.wal_blob()
    (t if writer == "port" else j).write(str(tmp_path))
    raw = open(tmp_path / MigrationJournal.FILENAME, "rb").read()
    os.makedirs(tmp_path / "other")
    (j if writer == "port" else t).write(str(tmp_path / "other"))
    assert open(tmp_path / "other" / MigrationJournal.FILENAME,
                "rb").read() == raw  # byte for byte
    assert MigrationJournal.read(str(tmp_path)) == t
    assert jr.MigrationJournal.read(str(tmp_path)) == j
    done = MigrationJournal.from_spec(json.loads(j.wal_blob()))
    assert done == t
    MigrationJournal.clear(str(tmp_path))
    assert jr.MigrationJournal.read(str(tmp_path)) is None


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_split_index_reads_across_packages(tmp_path, writer):
    """A sharded index split under its logs and saved by one package
    (manifest v2 with the versioned router, per-shard checkpoints, logs
    with ``OP_ROUTER`` records) opens in the other with the same live set,
    router and answers; writes after the save replay from the logs."""
    root = str(tmp_path / "idx")
    kw = dict(wal_config=WalConfig(fsync_every_n=1), device="cpu")
    if writer == "jax":
        kw = dict(wal_config=JWalConfig(fsync_every_n=1))
    cls = ShardedMutableP2HIndex if writer == "port" else JSharded
    idx = cls.open(root, dim=DIM, num_shards=2, **kw)
    live = _storm(idx, 25, seed=1)
    idx.split_shard(0)
    live |= _storm(idx, 10, seed=2)
    idx.save(root)
    live |= _storm(idx, 8, seed=3)  # only in the logs
    spec = idx.router.spec()
    q = _mkdata(4, seed=4, dim=DIM + 1)
    want = idx.query(q, K)
    idx.close()
    reader = JSharded if writer == "port" else ShardedMutableP2HIndex
    rec = reader.open(root, **({} if writer == "port" else
                               dict(device="cpu")))
    assert rec.num_shards == 3 and rec.router.spec() == spec
    assert set().union(*_owned(rec)) == live
    assert sum(len(s) for s in _owned(rec)) == len(live)
    got = rec.query(q, K)
    assert_topk_parity(np.asarray(got[0]), np.asarray(got[1]),
                       np.asarray(want[0]), np.asarray(want[1]))
    assert rec.stats()["misroutes"] == 0
    for g in sorted(live)[:6]:  # deletes route by the recovered map
        assert rec.delete(g)
    rec.close()


# ------------------------------------------------------- split and merge
def test_split_and_merge_bit_exact_under_concurrent_queries(monkeypatch):
    """A shard split under a live query storm returns the unsplit answer's
    ids bit for bit throughout the migration, the merge back does too, and
    every row stays owned exactly once.  Distances agree within the parity
    tolerance:
    a moved row is re-scored by its new owner's delta scan or rebuilt
    tree, whose sums run in another order (the JAX package's split moves
    them by 1.5e-8 on this data, the port's by 7.5e-9)."""
    monkeypatch.setattr(sharded_mod, "_MIGRATE_BATCH", 16)
    data = _mkdata(600, seed=11)
    idx = ShardedMutableP2HIndex.from_data(
        data, 2, n0=32, device="cpu",
        policy=CompactionPolicy(delta_capacity=32))
    q = np.random.default_rng(2).normal(size=(4, DIM + 1)).astype(np.float32)
    want_d, want_i = idx.query(q, K)
    errors, done, seen = [], threading.Event(), [0]

    def storm():
        try:
            while not done.is_set():
                got_d, got_i = idx.query(q, K)
                np.testing.assert_array_equal(got_i, want_i)
                np.testing.assert_allclose(got_d, want_d, rtol=RTOL, atol=ATOL)
                seen[0] += 1
        except BaseException as e:  # surfaced after join
            errors.append(e)

    th = threading.Thread(target=storm)
    th.start()
    try:
        new = idx.split_shard(0)
    finally:
        done.set()
        th.join()
    assert not errors, errors[0]
    assert seen[0] > 0
    assert new == 2 and idx.num_shards == 3
    assert idx.stats()["router_version"] == 1
    per_shard = _owned(idx)
    assert sum(len(s) for s in per_shard) == len(data)
    assert set().union(*per_shard) == set(range(len(data)))
    assert all(per_shard)  # data moved
    for step in ("split", "merge"):
        if step == "merge":
            idx.merge_shards(2, 0)
        got_d, got_i = idx.query(q, K)
        np.testing.assert_array_equal(got_i, want_i)
        np.testing.assert_allclose(got_d, want_d, rtol=RTOL, atol=ATOL)
    assert len(idx.shards[2].live_gids()) == 0  # the husk stays
    assert idx.live_count == len(data)
    _live_exact(idx, q, K)


def test_split_matches_the_jax_package():
    """The same data split by both packages: the same slots move, the
    same gids land in the same shards, and the answers agree."""
    data = _mkdata(500, seed=13)
    t = ShardedMutableP2HIndex.from_data(data, 2, n0=32, device="cpu")
    j = JSharded.from_data(data, 2, n0=32)
    assert t.split_shard(1) == j.split_shard(1) == 2
    assert t.router.spec() == j.router.spec()
    assert _owned(t) == _owned(j)
    t.merge_shards(0, 2)
    j.merge_shards(0, 2)
    assert t.router.spec() == j.router.spec() and _owned(t) == _owned(j)
    q = _mkdata(5, seed=14, dim=DIM + 1)
    td, ti, ts = t.query(q, K, return_stats=True)
    jd, ji, js = j.query(q, K, return_stats=True)
    assert_topk_parity(td, ti, np.asarray(jd), np.asarray(ji))
    assert ts == js


def test_split_journal_durable_before_new_map_routes(tmp_path, monkeypatch):
    """The journal reaches disk BEFORE ``router.apply()`` makes the new
    assignment live: a write routed by the new map can be acked at once,
    and recovery (which trusts the journal) must already know it."""
    idx = ShardedMutableP2HIndex.open(
        str(tmp_path / "idx"), dim=DIM, num_shards=2, device="cpu",
        wal_config=WalConfig(fsync_every_n=1))
    _storm(idx, 10, seed=7)
    at_write, real_write = [], MigrationJournal.write

    def spy(self, directory):
        if self.phase != "done":
            at_write.append((idx.router.version,
                             tuple(idx.router.assignment)))
        return real_write(self, directory)

    monkeypatch.setattr(MigrationJournal, "write", spy)
    idx.split_shard(0)
    assert at_write, "the split never journaled"
    version, assignment = at_write[0]
    assert version == idx.router.version - 1, "journal written after apply"
    assert assignment != idx.router.assignment
    # both participants' logs carry the journal as OP_ROUTER records
    from repro_torch.stream.wal import OP_ROUTER
    for s in (0, 2):
        recs = [r for r in idx.shards[s]._wal.records(0)
                if r.op == OP_ROUTER]
        assert [json.loads(r.blob)["phase"] for r in recs] == \
            ["copy", "done"]
    assert MigrationJournal.read(str(tmp_path / "idx" / "wal")) is None
    idx.close()


def test_split_with_writes_and_crash_recovery(tmp_path):
    """Split, then writes routed by the new map; then a crash in the
    middle of the next split (journal says copy, no row moved): ``open``
    adopts the journaled map and finishes the migration."""
    root = str(tmp_path / "idx")
    idx = ShardedMutableP2HIndex.open(
        root, dim=DIM, num_shards=2, device="cpu",
        wal_config=WalConfig(fsync_every_n=1))
    live = _storm(idx, 30, seed=9)
    idx.split_shard(0)
    live |= _storm(idx, 10, seed=10)
    assert set().union(*_owned(idx)) == live
    with idx._mig_lock:  # a journaled split whose copy never ran
        router = idx.router
        assignment, moving = plan_split(router, 1, 3)
        idx.shards = (*idx.shards, type(idx.shards[0])(
            DIM, n0=idx.n0, variant=idx.variant, policy=idx.policy,
            seed=idx.seed + 3000, device="cpu"))
        idx.num_shards = 4
        router.apply(assignment, moving)
        idx._journal(MigrationJournal(
            src=1, dst=3, moved_slots=tuple(moving),
            assignment=router.assignment, version=router.version,
            op="split"))
    idx.close()  # the "crash"

    rec = ShardedMutableP2HIndex.open(root, dim=DIM, num_shards=2,
                                      device="cpu")
    assert rec.num_shards == 4
    assert set().union(*_owned(rec)) == live
    owners = {g: s for s, gs in enumerate(_owned(rec)) for g in gs}
    assert len(owners) == len(live)
    for g, s in owners.items():
        assert rec.router.shard_of(g) == s, (g, s)
    assert rec.stats()["misroutes"] == 0
    assert MigrationJournal.read(os.path.join(root, "wal")) is None
    for g in sorted(live)[:10]:
        assert rec.delete(g)
    rec.close()


def test_recovery_removes_the_duplicates_of_a_torn_batch(tmp_path):
    """A crash between a migration batch's insert into the destination
    and its deletes from the source leaves gids in both owners; recovery
    keeps the destination's copy only."""
    root = str(tmp_path / "idx")
    idx = ShardedMutableP2HIndex.open(
        root, dim=DIM, num_shards=2, device="cpu",
        wal_config=WalConfig(fsync_every_n=1))
    live = _storm(idx, 30, seed=12)
    with idx._mig_lock:
        router = idx._ensure_versioned()
        assignment, moving = plan_split(router, 0, 2)
        dst = type(idx.shards[0])(DIM, n0=idx.n0, variant=idx.variant,
                                  policy=idx.policy, seed=idx.seed + 2000,
                                  device="cpu")
        dst.attach_wal(idx._make_wal(2))
        idx.shards = (*idx.shards, dst)
        idx.num_shards = 3
        journal = MigrationJournal(
            src=0, dst=2, moved_slots=tuple(moving),
            assignment=tuple(assignment), version=router.version + 1,
            op="split")
        idx._journal(journal)
        router.apply(assignment, moving)
        src = idx.shards[0]
        gids = src.live_gids()
        gids = gids[np.isin(router.slot_of_many(gids),
                            sorted(moving))][:5]
        pts, found = src.points_for(gids)
        dst.insert_batch(pts, gids=found)  # inserted, never deleted
    idx.close()
    rec = ShardedMutableP2HIndex.open(root, device="cpu") \
        if os.path.exists(os.path.join(root, "MANIFEST.json")) else \
        ShardedMutableP2HIndex.open(root, dim=DIM, num_shards=2,
                                    device="cpu")
    owned = _owned(rec)
    assert sum(len(s) for s in owned) == len(live)
    assert set().union(*owned) == live
    rec.close()
