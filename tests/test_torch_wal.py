"""The port's write-ahead log (``repro_torch.stream.wal``) and the mutable
index's log hooks, on the CPU, against the JAX package's.

The single-index cases of the JAX package's durability suite: empty logs,
append/commit/reopen, torn tails, prefix truncation keeping logical
offsets, seq surviving truncation and reopen, ack order (explicit seeds),
a commit covering only the pending prefix, concurrent writers acked
exactly once, and a double replay applying nothing.  Across packages: the
same op sequence writes the same bytes, a log either package writes
replays in the other to the same live set and answers, and a checkpoint
plus the log's tail recovers exactly the acknowledged writes.
"""
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_topk_parity  # noqa: E402
from repro.stream import CompactionPolicy as JPolicy  # noqa: E402
from repro.stream import MutableP2HIndex as JIndex  # noqa: E402
from repro.stream.wal import ShardWal as JWal  # noqa: E402
from repro.stream.wal import WalConfig as JWalConfig  # noqa: E402
from repro_torch.stream import (  # noqa: E402
    CompactionPolicy,
    MutableP2HIndex,
    ShardWal,
    WalConfig,
)
from repro_torch.stream.wal import OP_DELETE, OP_INSERT  # noqa: E402

DIM = 8


def _wal(tmp_path, name="s.wal", **kw):
    return ShardWal(str(tmp_path / name), **kw)


def _records(path, cls=ShardWal):
    wal = cls(str(path))
    try:
        return list(wal.records(0))
    finally:
        wal.close()


# ------------------------------------------------------------------ wal
def test_wal_empty_log_roundtrip(tmp_path):
    wal = _wal(tmp_path)
    assert wal.tail_offset() == 0 and list(wal.records(0)) == []
    wal.close()
    wal = _wal(tmp_path)  # reopen: header only, still empty
    assert wal.last_seq == 0 and list(wal.records(0)) == []
    wal.close()


def test_wal_append_commit_reopen(tmp_path):
    wal = _wal(tmp_path)
    wal.append(OP_INSERT, 7, 3, b"\x01\x02")
    off = wal.append(OP_DELETE, 7, 4)
    assert wal.commit(force=True)
    wal.close()
    recs = _records(tmp_path / "s.wal")
    assert [(r.op, r.gid, r.epoch) for r in recs] == [
        (OP_INSERT, 7, 3), (OP_DELETE, 7, 4)]
    assert recs[0].blob == b"\x01\x02" and recs[1].end_offset == off
    assert [r.seq for r in recs] == [1, 2]


@pytest.mark.parametrize("damage", ["short", "corrupt"])
def test_wal_torn_tail_truncated(tmp_path, damage):
    wal = _wal(tmp_path)
    for g in range(4):
        wal.append(OP_INSERT, g, g, b"x" * 8)
    wal.commit(force=True)
    good_tail = wal.tail_offset()
    wal.close()
    path = tmp_path / "s.wal"
    if damage == "short":  # a crash mid-append: half a record
        with open(path, "ab") as fh:
            fh.write(b"\x40\x00\x00\x00\xde\xad")
    else:  # full-length final record, flipped payload byte
        with open(path, "r+b") as fh:
            fh.seek(-3, os.SEEK_END)
            fh.write(b"\xff")
    wal = _wal(tmp_path)  # reopen-for-append truncates the torn tail
    kept = list(wal.records(0))
    assert wal.tail_offset() == (good_tail if damage == "short"
                                 else kept[-1].end_offset)
    assert [r.gid for r in kept] == ([0, 1, 2, 3] if damage == "short"
                                     else [0, 1, 2])
    wal.append(OP_INSERT, 99, 9, b"y")  # and appends continue cleanly
    wal.commit(force=True)
    wal.close()
    assert [r.gid for r in _records(path)][-1] == 99


def test_wal_truncate_prefix_keeps_logical_offsets(tmp_path):
    wal = _wal(tmp_path)
    offs = [wal.append(OP_INSERT, g, g) for g in range(6)]
    wal.commit(force=True)
    wal.truncate_prefix(offs[2])  # drop the first three records
    assert wal.base_offset == offs[2]
    tail = list(wal.records(0))
    assert [r.gid for r in tail] == [3, 4, 5]
    assert tail[0].offset == offs[2]  # logical offsets survive
    wal.append(OP_INSERT, 6, 6)
    wal.commit(force=True)
    wal.close()
    assert [r.gid for r in _records(tmp_path / "s.wal")] == [3, 4, 5, 6]


def test_wal_seq_survives_truncation_and_reopen(tmp_path):
    """A checkpoint that empties the log must not let the next incarnation
    restart at seq 1, or its acked ops would fall under the checkpoint's
    wal_seq and be skipped at replay."""
    wal = _wal(tmp_path)
    for g in range(5):
        wal.append(OP_INSERT, g, g)
    wal.commit(force=True)
    wal.truncate_prefix(wal.tail_offset())  # checkpoint covered it all
    wal.close()
    wal = _wal(tmp_path)  # a new process reopens the empty log
    assert wal.last_seq == 5
    wal.append(OP_INSERT, 9, 9)
    wal.commit(force=True)
    assert [r.seq for r in wal.records(0)] == [6]
    wal.close()


@pytest.mark.parametrize("seed", range(8))
def test_wal_ack_order_and_durability(tmp_path, seed):
    """Acks fire exactly once, in seq order, only after a covering fsync,
    under seeded append/commit interleavings and group sizes."""
    rng = np.random.default_rng(seed)
    acked = []
    wal = _wal(tmp_path, "a.wal",
               config=WalConfig(fsync_every_n=int(rng.integers(1, 6)),
                                fsync_interval_ms=1e9),  # size-only trigger
               on_ack=acked.extend)
    appended = []
    for g in range(int(rng.integers(5, 40))):
        wal.append(OP_INSERT, g, 0, token=g)
        appended.append(g)
        if rng.random() < 0.3:
            wal.commit(force=bool(rng.random() < 0.5))
        # every acked token's record is covered by a sync already
        assert all(t < wal.synced_seq for t in acked)
    wal.commit(force=True)
    assert acked == appended  # exactly once, in order
    wal.close()
    assert [r.gid for r in _records(tmp_path / "a.wal")] == appended


def test_wal_commit_covers_only_the_pending_prefix(tmp_path, monkeypatch):
    """A record appended while a commit's fsync is in flight is not acked
    (or marked synced) by that commit: it is not on disk yet."""
    acked = []
    wal = _wal(tmp_path, "race.wal", config=WalConfig(fsync_every_n=1),
               on_ack=acked.extend)
    wal.append(OP_INSERT, 1, 0, b"\x00" * 4, token="a")
    real_fsync = os.fsync

    def racing_fsync(fd):
        # another writer appends while this commit's fsync is on disk
        monkeypatch.setattr(os, "fsync", real_fsync)
        wal.append(OP_INSERT, 2, 0, b"\x00" * 4, token="b")
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", racing_fsync)
    assert wal.commit(force=True)
    assert acked == ["a"]            # b's record was never fsync'd
    assert wal.synced_seq == 1 and wal._pending == 1
    assert wal.commit(force=True)    # b's own covering commit
    assert acked == ["a", "b"]
    assert wal.synced_seq == 2 and wal._pending == 0
    wal.close()
    assert [r.gid for r in _records(tmp_path / "race.wal")] == [1, 2]


def test_wal_concurrent_writers_ack_exactly_once(tmp_path):
    """Threaded append + commit storm: every token acks exactly once and
    every record survives reopen."""
    acked, n_threads, per = [], 4, 50
    wal = _wal(tmp_path, "mt.wal",
               config=WalConfig(fsync_every_n=4, fsync_interval_ms=1e9),
               on_ack=acked.extend)

    def writer(base):
        for i in range(per):
            wal.append(OP_DELETE, base + i, 0, token=base + i)
            wal.commit()

    threads = [threading.Thread(target=writer, args=(1000 * t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120.0)
    assert not any(t.is_alive() for t in threads)
    wal.close()  # the final forced commit drains the stragglers
    want = {1000 * t + i for t in range(n_threads) for i in range(per)}
    assert len(acked) == len(want) and set(acked) == want
    recs = _records(tmp_path / "mt.wal")
    assert {r.gid for r in recs} == want
    assert sorted(r.seq for r in recs) == list(range(1, len(want) + 1))


# ------------------------------------------------------ replay / restore
def _policy(cls):
    return cls(delta_capacity=16)


def _writes(m, *, n=30, seed=0):
    """A fixed op sequence: n single inserts, then every third deleted (one
    left uncommitted until a later write's commit covers it); returns the
    live gids."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        m.insert(rng.normal(size=DIM).astype(np.float32))
    m.insert_batch(rng.normal(size=(4, DIM)).astype(np.float32))
    dead = list(range(0, n, 3))
    for g in dead:
        assert m.delete(g, commit=g != 0)
    return set(range(n + 4)) - set(dead)


def test_mutable_wal_replay_double_restore_idempotent(tmp_path):
    wal = _wal(tmp_path, "m.wal", config=WalConfig(fsync_every_n=1))
    m = MutableP2HIndex(DIM, n0=32, policy=_policy(CompactionPolicy),
                        device="cpu")
    m.attach_wal(wal)
    live = _writes(m)
    assert m.has_gid(1) and not m.has_gid(0)
    m.close()

    r1 = MutableP2HIndex(DIM, n0=32, policy=_policy(CompactionPolicy),
                         device="cpu")
    stats = r1.wal_replay(_wal(tmp_path, "m.wal"))
    assert stats["applied"] == 34 + 10 and stats["skipped"] == 0
    assert set(int(g) for g in r1.live_gids()) == live
    stats2 = r1.wal_replay(_wal(tmp_path, "m.wal"))  # again: nothing
    assert stats2["applied"] == 0 and stats2["ops"] == stats["ops"]
    ep = r1.epoch
    r2 = MutableP2HIndex(DIM, n0=32, policy=_policy(CompactionPolicy),
                         device="cpu")
    r2.wal_replay(_wal(tmp_path, "m.wal"))
    pts1, g1 = r1.points_for(sorted(live))
    pts2, g2 = r2.points_for(sorted(live))
    np.testing.assert_array_equal(g1, g2)
    np.testing.assert_array_equal(pts1, pts2)
    assert r1.epoch == ep  # the second replay did not move the epoch


def _acked_index(cls, policy_cls, wal_cls, cfg_cls, path, acks, **kw):
    m = cls(DIM, n0=32, policy=_policy(policy_cls), **kw)
    m.attach_wal(wal_cls(str(path), config=cfg_cls(fsync_every_n=1),
                         on_ack=acks.extend))
    return m


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_wal_bytes_and_replay_cross_package(tmp_path, writer):
    """Both packages write the same bytes for the same ops, and a log either
    writes replays in the other to the same live set and answers."""
    ta, ja = [], []
    tm = _acked_index(MutableP2HIndex, CompactionPolicy, ShardWal, WalConfig,
                      tmp_path / "t.wal", ta, device="cpu")
    jm = _acked_index(JIndex, JPolicy, JWal, JWalConfig,
                      tmp_path / "j.wal", ja)
    live = _writes(tm)
    assert _writes(jm) == live
    tm.close()
    jm.close()
    assert ta == ja  # the same tokens acked, in the same order
    assert {g for op, g in ta if op == "ins"} >= live
    assert ((tmp_path / "t.wal").read_bytes()
            == (tmp_path / "j.wal").read_bytes())
    src = tmp_path / ("j.wal" if writer == "jax" else "t.wal")
    tr = MutableP2HIndex(DIM, n0=32, policy=_policy(CompactionPolicy),
                         device="cpu")
    jr = JIndex(DIM, n0=32, policy=_policy(JPolicy))
    st = tr.wal_replay(ShardWal(str(src)))
    assert jr.wal_replay(JWal(str(src))) == st
    assert set(tr.live_gids().tolist()) == set(jr.live_gids().tolist()) \
        == live
    q = np.random.default_rng(9).normal(size=(5, DIM + 1)).astype(np.float32)
    td, ti = tr.query(q, 4)
    jd, ji = jr.query(q, 4)
    assert_topk_parity(td, ti, np.asarray(jd), np.asarray(ji))


@pytest.mark.parametrize("saver,loader", [("torch", "torch"),
                                          ("jax", "torch"),
                                          ("torch", "jax")])
def test_checkpoint_plus_wal_recovers_acked_writes(tmp_path, saver, loader):
    """save, more acknowledged writes, drop the object, ``load(wal=)``: the
    recovered live set is exactly the acknowledged one, across packages."""
    acks = []
    if saver == "torch":
        m = _acked_index(MutableP2HIndex, CompactionPolicy, ShardWal,
                         WalConfig, tmp_path / "x.wal", acks, device="cpu")
    else:
        m = _acked_index(JIndex, JPolicy, JWal, JWalConfig,
                         tmp_path / "x.wal", acks)
    live = _writes(m, n=40, seed=1)
    m.save(str(tmp_path / "ckpt"))
    assert m.last_saved_wal is not None
    rng = np.random.default_rng(2)
    for _ in range(6):
        live.add(int(m.insert(rng.normal(size=DIM).astype(np.float32))))
    for g in (1, 2, 44):
        assert m.delete(g)
        live.discard(g)
    acked_live = set()
    for op, g in acks:
        (acked_live.add if op == "ins" else acked_live.discard)(g)
    assert acked_live == live
    q = np.random.default_rng(9).normal(size=(5, DIM + 1)).astype(np.float32)
    want_d, want_i = m.query(q, 4)
    m.close()
    del m
    if loader == "torch":
        r = MutableP2HIndex.load(str(tmp_path / "ckpt"), device="cpu",
                                 wal=ShardWal(str(tmp_path / "x.wal")))
    else:
        r = JIndex.load(str(tmp_path / "ckpt"),
                        wal=JWal(str(tmp_path / "x.wal")))
    assert set(r.live_gids().tolist()) == acked_live
    got_d, got_i = r.query(q, 4)
    assert_topk_parity(np.asarray(got_d), np.asarray(got_i),
                       np.asarray(want_d), np.asarray(want_i))
    gid = r.insert(np.ones(DIM, np.float32))  # the log stays attached
    r.close()
    assert [rec.gid for rec in _records(tmp_path / "x.wal")][-1] == gid
