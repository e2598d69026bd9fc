"""Durability of the port's sharded index, on the CPU: recovery by ``open``
and ``load`` against the JAX package's, the crash windows of a save, and
a SIGKILL chaos round.

A sharded index written by either package recovers in the other with the
same live set and answers.  Recovery reaches every acknowledged write when
a save dies between a shard checkpoint and the manifest, on the first save
too; at the moment a checkpoint is written the log on disk already holds
every record it covers (a record still in the writer's buffer would vanish
with a kill, and its seq would be handed to a later acknowledged write that
the next restore then skips).  The chaos rounds kill a write-storm child
(``_torch_chaos.py``) once it has logged enough acknowledgements -- no
wall-clock gate -- and count zero acknowledged inserts lost, zero gids
owned twice, zero acknowledged deletes resurrected and zero epoch
regressions.
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_chaos  # noqa: E402
from _torch_parity import assert_topk_parity  # noqa: E402
from repro.stream import ShardedMutableP2HIndex as JSharded  # noqa: E402
from repro.stream.wal import WalConfig as JWalConfig  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.stream import (  # noqa: E402
    CompactionPolicy,
    MutableP2HIndex,
    ShardedMutableP2HIndex,
    ShardWal,
    WalConfig,
)
from repro_torch.stream import wal as wal_mod  # noqa: E402

DIM, K = 8, 4


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


def _live(idx) -> set:
    return {int(g) for sh in idx.shards for g in sh.live_gids()}


def _open(pkg, root, **kw):
    if pkg == "port":
        return ShardedMutableP2HIndex.open(root, device="cpu", **kw)
    if "wal_config" in kw:
        kw["wal_config"] = JWalConfig(fsync_every_n=1)
    return JSharded.open(root, **kw)


# ------------------------------------------------------ recovery parity
@pytest.mark.parametrize("writer,reader", [("port", "port"),
                                           ("port", "jax"),
                                           ("jax", "port")])
def test_open_recovers_to_the_last_acked_write(tmp_path, writer, reader):
    """Checkpoint plus log tail equals the live set before the crash,
    ops acknowledged after the last save included, whichever package
    wrote and whichever recovers; the answers agree."""
    root = str(tmp_path / "idx")
    idx = _open(writer, root, dim=DIM, num_shards=2,
                wal_config=WalConfig(fsync_every_n=1))
    live = _storm(idx, 20, seed=1)
    idx.save(root)
    live |= _storm(idx, 15, seed=2)
    for g in sorted(live)[:5]:
        assert idx.delete(g)
        live.discard(g)
    epochs = idx.epoch
    q = np.zeros((2, DIM + 1), np.float32)
    q[:, 0] = 1.0
    q[1, 3] = 0.5
    want_d, want_i = idx.query(q, K)
    idx.close()  # no second save
    rec = _open(reader, root)
    assert _live(rec) == live
    assert all(b >= a for a, b in zip(epochs, rec.epoch))
    got_d, got_i = rec.query(q, K)
    assert_topk_parity(np.asarray(got_d), np.asarray(got_i),
                       np.asarray(want_d), np.asarray(want_i))
    rec.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_load_reads_the_other_packages_manifest(tmp_path, writer):
    """``load`` (no logs) of a manifest v2 directory: the same shards,
    router, id high-water mark and answers in both packages."""
    root = str(tmp_path / "idx")
    data = np.random.default_rng(3).normal(size=(400, DIM)).astype(
        np.float32)
    kw = dict(n0=32, policy=CompactionPolicy(delta_capacity=64))
    src = (ShardedMutableP2HIndex.from_data(data, 3, device="cpu", **kw)
           if writer == "port" else JSharded.from_data(data, 3, **kw))
    src.insert_batch(data[:50] + 0.01)
    for g in range(0, 400, 9):
        src.delete(g)
    src.save(root)
    dst = (JSharded.load(root) if writer == "port"
           else ShardedMutableP2HIndex.load(root, device="cpu"))
    assert dst.num_shards == 3 and _live(dst) == _live(src)
    assert dst._next_gid == src._next_gid
    assert dst.router.spec() == src.router.spec()
    assert [sh.epoch for sh in dst.shards] == [sh.epoch for sh in src.shards]
    q = np.random.default_rng(4).normal(size=(5, DIM + 1)).astype(np.float32)
    a, b = src.query(q, K), dst.query(q, K)
    assert_topk_parity(np.asarray(a[0]), np.asarray(a[1]),
                       np.asarray(b[0]), np.asarray(b[1]))


def test_recovery_survives_the_save_manifest_crash_window(tmp_path):
    """A crash between the shard checkpoints (logs truncated against them)
    and the manifest write loses no acknowledged op: recovery takes each
    shard's newest checkpoint, not the manifest's step, and the id
    high-water mark does not regress."""
    root = str(tmp_path / "idx")
    idx = _open("port", root, dim=DIM, num_shards=2,
                wal_config=WalConfig(fsync_every_n=1))
    live = _storm(idx, 15, seed=3)
    idx.save(root)
    stale = open(os.path.join(root, "MANIFEST.json"), "rb").read()
    next_gid = idx._next_gid
    live |= _storm(idx, 15, seed=4)
    idx.save(root)
    idx.close()
    with open(os.path.join(root, "MANIFEST.json"), "wb") as fh:
        fh.write(stale)  # the second manifest never landed
    rec = _open("port", root)
    assert _live(rec) == live
    assert rec._next_gid > next_gid
    rec.close()


def test_recovery_survives_the_first_save_without_manifest(tmp_path):
    root = str(tmp_path / "idx")
    idx = _open("port", root, dim=DIM, num_shards=2,
                wal_config=WalConfig(fsync_every_n=1))
    live = _storm(idx, 15, seed=5)
    idx.save(root)
    live |= _storm(idx, 10, seed=6)
    idx.close()
    os.remove(os.path.join(root, "MANIFEST.json"))
    rec = _open("port", root, dim=DIM, num_shards=2)
    assert _live(rec) == live
    rec.close()


def test_checkpoint_never_covers_a_record_not_on_disk(tmp_path, monkeypatch):
    """When a shard checkpoint is written, the log file already holds every
    record up to the checkpoint's frontier, so a kill right after the
    checkpoint cannot drop covered records from the log."""
    real = CheckpointManager.save
    seen = []

    def spy(self, step, state, *, extra_meta=None, **kw):
        wal = shards_wal[self.dir]
        size = os.path.getsize(wal.path)
        covered = wal_mod._HEADER.size + extra_meta["wal_offset"] \
            - wal.base_offset
        seen.append((size, covered))
        return real(self, step, state, extra_meta=extra_meta, **kw)

    root = str(tmp_path / "idx")
    # a large group: records stay in the writer's buffer between commits
    idx = _open("port", root, dim=DIM, num_shards=2,
                wal_config=WalConfig(fsync_every_n=1000,
                                     fsync_interval_ms=1e9))
    shards_wal = {os.path.join(root, f"shard_{s:03d}"): sh._wal
                  for s, sh in enumerate(idx.shards)}
    monkeypatch.setattr(CheckpointManager, "save", spy)
    live = _storm(idx, 12, seed=7)
    idx.save(root)
    assert len(seen) == 2
    assert all(size >= covered > wal_mod._HEADER.size
               for size, covered in seen), seen
    live |= _storm(idx, 6, seed=8)
    idx.close()
    rec = _open("port", root)
    assert _live(rec) == live
    rec.close()


def _kill_the_rename_in(monkeypatch):
    """``os.rename`` raises for a ``step_N.tmp`` source: a kill after a
    rewrite's old ``step_N`` has left its place, before the new one is in."""
    real = os.rename

    def rename(src, dst):
        if str(src).endswith(".tmp") and os.path.basename(
                str(dst)).startswith("step_"):
            raise OSError("killed before the new step was renamed in")
        return real(src, dst)

    monkeypatch.setattr(os, "rename", rename)


def test_a_rewrite_killed_at_its_rename_keeps_the_step(tmp_path):
    """A save over an existing step killed between moving the old one
    aside and renaming the new one in (the directory as such a kill leaves
    it): the next manager restores that step's old contents, not an older
    step, and leaves no aside behind."""
    root = str(tmp_path / "ck")
    mgr = CheckpointManager(root, keep=2)
    mgr.save(4, {"a": np.arange(3)}, blocking=True)
    mgr.save(5, {"a": np.arange(5)}, blocking=True)
    os.rename(os.path.join(root, "step_5"), os.path.join(root, "prev_step_5"))
    os.makedirs(os.path.join(root, "step_5.tmp"))  # the new one, unfinished
    rec = CheckpointManager(root)
    assert rec.all_steps() == [4, 5]
    leaves, manifest = rec.restore_leaves(5)
    assert manifest["step"] == 5
    np.testing.assert_array_equal(leaves[0], np.arange(5))
    assert not [n for n in os.listdir(root) if n.startswith("prev_")]
    rec.save(5, {"a": np.arange(7)}, blocking=True)  # a rewrite lands
    np.testing.assert_array_equal(rec.restore_leaves(5)[0][0], np.arange(7))
    assert sorted(os.listdir(root)) == ["step_4", "step_5"]


def test_a_rewrite_whose_rename_raises_puts_the_step_back(tmp_path,
                                                          monkeypatch):
    """A rewrite whose rename into place raises puts the old step back
    before the error surfaces: the same manager, and the JAX package's
    manager, which knows no aside, read step N's old contents."""
    from repro.checkpoint.manager import CheckpointManager as JManager

    root = str(tmp_path / "ck")
    mgr = CheckpointManager(root, keep=2)
    mgr.save(4, {"a": np.arange(3)}, blocking=True)
    mgr.save(5, {"a": np.arange(5)}, blocking=True)
    _kill_the_rename_in(monkeypatch)
    with pytest.raises(OSError):
        mgr.save(5, {"a": np.arange(7)}, blocking=True)
    monkeypatch.undo()
    assert not [n for n in os.listdir(root) if n.startswith("prev_")]
    for reader in (mgr, JManager(root)):
        assert reader.all_steps() == [4, 5]
        np.testing.assert_array_equal(reader.restore_leaves(5)[0][0],
                                      np.arange(5))


def test_a_shard_saved_twice_at_one_epoch_survives_the_rename_window(
        tmp_path, monkeypatch):
    """A mutable shard saved again with no write in between rewrites its
    step; a kill inside that rewrite must not leave only the older step,
    whose frontier the log has already been truncated past: the recovered
    live set is every acknowledged write."""
    ck, path = str(tmp_path / "ck"), str(tmp_path / "m.wal")
    m = MutableP2HIndex(DIM, n0=32, device="cpu",
                        policy=CompactionPolicy(delta_capacity=16))
    m.attach_wal(ShardWal(path, config=WalConfig(fsync_every_n=1)))
    rng = np.random.default_rng(9)
    for _ in range(20):
        m.insert(rng.normal(size=DIM).astype(np.float32))
    m.save(ck)
    for _ in range(15):
        m.insert(rng.normal(size=DIM).astype(np.float32))
    for g in range(0, 35, 4):
        assert m.delete(g)
    step = m.save(ck)
    live = set(m.live_gids().tolist())
    _kill_the_rename_in(monkeypatch)
    with pytest.raises(OSError):
        assert m.save(ck) == step  # the same epoch: a rewrite of the step
    monkeypatch.undo()
    m.close()
    assert CheckpointManager(ck).latest_step() == step
    r = MutableP2HIndex.load(ck, wal=ShardWal(path), device="cpu")
    assert set(r.live_gids().tolist()) == live
    r.close()


def test_unknown_gid_delete_counts_misroute():
    data = np.random.default_rng(0).normal(size=(64, DIM)).astype(np.float32)
    idx = ShardedMutableP2HIndex.from_data(data, 2, n0=32, device="cpu")
    assert not idx.delete(10_000)
    assert idx.delete(3) and not idx.delete(3)
    assert idx.stats()["misroutes"] == 2 and idx.misroutes == 2
    assert idx.live_count == 63


def test_delete_commit_runs_outside_the_migration_lock(tmp_path,
                                                       monkeypatch):
    idx = _open("port", str(tmp_path / "idx"), dim=DIM, num_shards=2,
                wal_config=WalConfig(fsync_every_n=1))
    gids = idx.insert_batch(
        np.random.default_rng(0).normal(size=(8, DIM)).astype(np.float32))
    real_fsync, held = os.fsync, []

    def spy(fd):
        held.append(idx._mig_lock.locked())
        return real_fsync(fd)

    monkeypatch.setattr(os, "fsync", spy)
    assert idx.delete(int(gids[0]))
    assert held and not any(held)
    idx.close()


def test_open_ignores_stray_wal_filenames(tmp_path):
    wal_dir = tmp_path / "idx" / "wal"
    wal_dir.mkdir(parents=True)
    (wal_dir / "shard_old.wal").write_bytes(b"junk")
    (wal_dir / "shard_003.wal.bak").write_bytes(b"junk")
    idx = _open("port", str(tmp_path / "idx"), dim=DIM, num_shards=2)
    assert idx.num_shards == 2
    idx.close()


def test_replay_into_a_mutable_shard_is_idempotent(tmp_path):
    path = str(tmp_path / "m.wal")
    m = MutableP2HIndex(DIM, n0=32, device="cpu",
                        policy=CompactionPolicy(delta_capacity=16))
    m.attach_wal(ShardWal(path, config=WalConfig(fsync_every_n=1)))
    rng = np.random.default_rng(0)
    for _ in range(30):
        m.insert(rng.normal(size=DIM).astype(np.float32))
    for g in range(0, 30, 3):
        m.delete(g)
    m.close()
    r = MutableP2HIndex(DIM, n0=32, device="cpu",
                        policy=CompactionPolicy(delta_capacity=16))
    assert r.wal_replay(ShardWal(path))["applied"] == 40
    assert r.wal_replay(ShardWal(path))["applied"] == 0
    assert set(r.live_gids().tolist()) == set(range(30)) - set(range(0, 30,
                                                                     3))


# ------------------------------------------------------------------ chaos
def test_kill_and_recover_chaos_rounds(tmp_path):
    """SIGKILL a write-storm child once it has logged 40 new
    acknowledgements, recover, and count: three rounds against one
    directory (checkpoints every 6 iterations, none, every iteration)."""
    root = str(tmp_path / "chaos")
    os.makedirs(root)
    for r, save_every in enumerate((6, 0, 1)):
        res = _torch_chaos.kill_round(root, dim=DIM, shards=2, seed=100 + r,
                                      min_acks=40, save_every=save_every)
        assert res["acked_loss"] == 0, res
        assert res["dup_gids"] == 0, res
        assert res["resurrected"] == 0, res
        assert res["epoch_regressions"] == 0, res
        assert res["misroutes"] == 0, res
        assert res["acked_ops"] > 0 and res["live_count"] > 0, res
    shutil.rmtree(root)
