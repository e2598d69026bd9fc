"""The port's mutable index (``repro_torch.stream``) against the JAX
package's, on the CPU.

The same op sequence -- ``from_data``, ``insert_batch``, ``insert``,
``delete``, ``compact`` -- runs on both packages' ``MutableP2HIndex``; their
answers and all eight counters must agree on the stacked route (each probe
mode), the sequential walk and auto-promotion.  A churn property holds the
port's stacked route to its sequential walk and to a float64 brute force on
the live set, zero-segment states included; checkpoints written by either
package load in the other.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_topk_parity, oracle  # noqa: E402
from repro.stream import CompactionPolicy as JPolicy  # noqa: E402
from repro.stream import MutableP2HIndex as JIndex  # noqa: E402
from repro.stream.delta import delta_topk as j_delta_topk  # noqa: E402
from repro_torch.core.balltree import normalize_query  # noqa: E402
from repro_torch.launch import platform  # noqa: E402
from repro_torch.stream import (  # noqa: E402
    CompactionPlan,
    CompactionPolicy,
    DeltaBuffer,
    MutableP2HIndex,
)
from repro_torch.stream.delta import delta_topk  # noqa: E402

DIM = 8


def _mkdata(n, seed=0, dim=DIM):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(
        np.float32)


def _ops(m, policy_cls, *, seed=17, chunks=6, chunk=40):
    """The op sequence both packages run: chunked bulk loads (one sealed
    segment per full delta), loose inserts into the delta, deletes spread
    over every segment and the delta."""
    rng = np.random.default_rng(seed)
    data = _mkdata(chunks * chunk, seed=seed)
    idx = m.from_data(data[:chunk], n0=16, policy=policy_cls(
        delta_capacity=chunk, tombstone_frac=0.95, max_segments=64),
        **({} if m is JIndex else dict(device="cpu")))
    for c in range(1, chunks):
        idx.insert_batch(data[c * chunk:(c + 1) * chunk])
    for _ in range(5):
        idx.insert(rng.normal(size=DIM).astype(np.float32))
    for g in list(range(0, chunks * chunk, 9)) + [chunks * chunk + 1]:
        assert idx.delete(g)
    return idx


@pytest.fixture(scope="module")
def pair():
    return _ops(MutableP2HIndex, CompactionPolicy), _ops(JIndex, JPolicy)


def _live_oracle(m, q, k):
    X, G = m.snapshot().live_points()
    d, i, nxt = oracle(X, normalize_query(q), k)
    return d, G[i], nxt


def _assert_exact(d, i, m, q, k):
    od, oi, nxt = _live_oracle(m, q, k)
    assert_topk_parity(d, i, od, oi, nxt)


@pytest.mark.parametrize("kw", [
    dict(method="stacked"),
    dict(method="stacked", probe_dtype="bf16"),
    dict(method="stacked", probe_dtype="int8"),
    dict(method="stacked", probe_tiles=0),
    dict(method="stacked", probe_tiles=1000),
    dict(method="sweep"),  # 6 segments: auto-promoted
    dict(method="sweep", stacked=False),
    dict(method="pallas", stacked=False),
    dict(method="dfs"),
], ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_slice_matches_jax_and_oracle(pair, kw):
    t, j = pair
    assert len(t.snapshot().segments) == len(j.snapshot().segments) == 6
    q = _mkdata(11, seed=18, dim=DIM + 1)
    k = 5
    td, ti, ts = t.query(q, k=k, return_stats=True, **kw)
    jd, ji, js = j.query(q, k=k, return_stats=True, **kw)
    assert_topk_parity(td, ti, jd, ji)
    assert ts == js
    _assert_exact(td, ti, t, q, k)


def test_auto_promotion_is_the_stacked_route(pair):
    t, _ = pair
    q = _mkdata(4, seed=19, dim=DIM + 1)
    a = t.query(q, k=3, return_stats=True)
    b = t.query(q, k=3, method="stacked", return_stats=True)
    c = t.query(q, k=3, stacked=False, return_stats=True)
    assert np.array_equal(a[1], b[1]) and a[2] == b[2]
    assert a[2]["tiles_skipped"] != c[2]["tiles_skipped"]


def test_delta_topk_matches_jax():
    rng = np.random.default_rng(1)
    pts = np.round(rng.normal(size=(12, 5)), 1).astype(np.float32)
    pts[7] = pts[2]  # an exact tie
    gids = np.arange(100, 112, dtype=np.int32)
    gids[[3, 9]] = -1
    q = rng.normal(size=(4, 5)).astype(np.float32)
    for k in (3, 12, 15):  # 15 > capacity: padded with empty slots
        td, ti = delta_topk(pts, gids, torch.from_numpy(q), k)
        jd, ji = j_delta_topk(pts, gids, jnp.asarray(q), k)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_delta_buffer_and_policy_behave_as_jax():
    b = DeltaBuffer(4, 3)
    b.append(np.array([1, 2, 3], np.float32), gid=7)
    b.append(np.array([4, 5, 6], np.float32), gid=8)
    b.tombstone(0)
    pts, gids = b.live_rows()
    assert gids.tolist() == [8] and pts.shape == (1, 3)

    @dataclasses.dataclass
    class S:
        uid: int
        live: int
        dead: int
        tombstone_frac: float

    segs = (S(0, 10, 0, 0.0), S(1, 2, 8, 0.8), S(2, 5, 5, 0.5))
    for pol in (dict(), dict(tombstone_frac=0.6), dict(max_segments=2)):
        for full in (False, True):
            a = CompactionPolicy(**pol).plan(delta_full=full, delta_live=3,
                                             segments=segs)
            b = JPolicy(**pol).plan(delta_full=full, delta_live=3,
                                    segments=segs)
            assert dataclasses.astuple(a) == dataclasses.astuple(b)
            assert bool(a) == bool(b)
    assert not CompactionPlan(include_delta=False, segment_uids=())


# ------------------------------------------------------ churn property
def _check_stacked_matches_sequential(m, q, k, tag):
    sd, si = m.query(q, k=k, stacked=False)
    td, ti = m.query(q, k=k, stacked=True)
    np.testing.assert_allclose(td, sd, rtol=1e-5, atol=1e-6, err_msg=tag)
    if not np.array_equal(ti, si):  # disagreements must be ties
        mism = ti != si
        assert (np.abs(td - sd)[mism]
                <= (1e-5 * np.abs(sd) + 1e-6)[mism]).all(), tag
    X, _ = m.snapshot().live_points()
    if len(X) >= k:
        _assert_exact(td, ti, m, q, k)
    else:  # fewer live points than k: the rest of each row stays empty
        assert (ti[:, len(X):] == -1).all() and np.isinf(td[:, len(X):]).all()


@pytest.mark.parametrize("seed", [0, 1, 2, 36])
def test_churn_property_stacked_equals_sequential_and_oracle(seed):
    """Random insert / delete / whole-segment tombstone / forced compaction
    interleavings leave the stacked route equal to the sequential walk and
    to the brute force on the live set.  Whole-segment tombstones followed
    by a forced compaction leave zero segments at some step of every one
    of these seeds: that is a legal state."""
    rng = np.random.default_rng(seed)
    m = MutableP2HIndex.from_data(
        _mkdata(100, seed=seed), n0=32, device="cpu",
        policy=CompactionPolicy(delta_capacity=6 + seed % 7,
                                tombstone_frac=0.95, max_segments=64))
    live = list(range(100))
    q = rng.normal(size=(3, DIM + 1)).astype(np.float32)
    k = 5
    emptied = False
    for step in range(50):
        op = rng.random()
        snap = m.snapshot()
        emptied |= not snap.segments
        if op < 0.4 or not live:
            live.append(m.insert(rng.normal(size=DIM).astype(np.float32)))
        elif op < 0.6:
            victim = live.pop(int(rng.integers(len(live))))
            assert m.delete(victim)
        elif op < 0.7 and snap.segments:
            seg = snap.segments[int(rng.integers(len(snap.segments)))]
            pid = seg.tree.point_ids.numpy()
            for gid in seg.gids[pid[pid >= 0]]:
                if m.delete(int(gid)):
                    live.remove(int(gid))
        elif op < 0.78:
            m.compact(force=True)
        else:
            _check_stacked_matches_sequential(m, q, k, f"step{step}")
    assert emptied and 0 <= len(m.snapshot().segments) <= 64
    assert sorted(live) == m.live_gids().tolist()
    for k2 in (1, 5):
        _check_stacked_matches_sequential(m, q, k2, f"final-k{k2}")
    m.compact(force=True)
    _check_stacked_matches_sequential(m, q, k, "post-compact")


@pytest.mark.parametrize("fresh", [0, 3, 9])
def test_zero_segments_after_tombstoning_every_segment(fresh):
    """Every segment tombstoned whole, then a forced compaction: no segment
    is left; ``fresh`` rows then go into the delta (none, fewer than k, or
    more).  Both routes still answer, equal to each other, to the brute
    force and to the JAX package's answers and counters."""
    rng = np.random.default_rng(36)
    data = _mkdata(120, seed=36)
    pair = []
    for cls, kw in ((MutableP2HIndex, dict(device="cpu")), (JIndex, {})):
        m = cls.from_data(data[:40], n0=16, policy=(
            CompactionPolicy if cls is MutableP2HIndex else JPolicy)(
                delta_capacity=40, tombstone_frac=0.95, max_segments=64),
            **kw)
        m.insert_batch(data[40:])
        for gid in range(120):
            assert m.delete(gid)
        m.compact(force=True)
        for row in data[:fresh] + 0.5:  # stays in the delta
            m.insert(row)
        assert not m.snapshot().segments
        assert m.live_gids().tolist() == list(range(120, 120 + fresh))
        pair.append(m)
    t, j = pair
    q = rng.normal(size=(4, DIM + 1)).astype(np.float32)
    _check_stacked_matches_sequential(t, q, 5, f"fresh{fresh}")
    for kw in (dict(method="stacked"), dict(stacked=False)):
        td, ti, ts = t.query(q, k=5, return_stats=True, **kw)
        jd, ji, js = j.query(q, k=5, return_stats=True, **kw)
        assert_topk_parity(td, ti, jd, ji)
        assert ts == js


# ------------------------------------------------------- checkpoints
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_reads_across_packages(pair, tmp_path, writer):
    t, j = pair
    src, dst_cls = (t, JIndex) if writer == "port" else (j, MutableP2HIndex)
    step = src.save(str(tmp_path))
    kw = dict(device="cpu") if dst_cls is MutableP2HIndex else {}
    back = dst_cls.load(str(tmp_path), **kw)
    assert back.epoch == step == src.epoch
    np.testing.assert_array_equal(back.live_gids(), src.live_gids())
    q = _mkdata(7, seed=20, dim=DIM + 1)
    for kw in (dict(method="stacked"), dict(stacked=False)):
        bd, bi, bs = back.query(q, k=4, return_stats=True, **kw)
        sd, si, ss = src.query(q, k=4, return_stats=True, **kw)
        assert_topk_parity(bd, bi, sd, si)
        assert bs == ss
    assert back.insert(np.ones(DIM, np.float32)) == src._next_gid
    manifest = __import__("json").load(open(
        tmp_path / f"step_{step}" / "manifest.json"))
    assert manifest["treedef"].startswith("PyTreeDef({'delta': {'gids': *")


# ------------------------------------------- publish and cache semantics
def test_tombstone_keeps_the_padded_points_plane():
    m = MutableP2HIndex.from_data(_mkdata(300, seed=2), n0=16, device="cpu")
    seg = m.snapshot().segments[0]
    padded = seg.tree.points_padded  # d = 9: padded to 12 columns
    assert padded.shape[1] == 12
    assert m.delete(5)
    new = m.snapshot().segments[0]
    assert new is not seg and new.tree.points is seg.tree.points
    assert new.tree.points_padded is padded
    assert (new.tree.point_ids == -1).sum() == (seg.tree.point_ids == -1).sum() + 1


def test_stacked_cache_adopted_updated_and_rebuilt(pair):
    t = _ops(MutableP2HIndex, CompactionPolicy, seed=21)
    q = _mkdata(3, seed=22, dim=DIM + 1)
    t.query(q, k=3, method="stacked")
    stk = t.snapshot().stacked_leaves()
    stk.padded_pts()
    t.insert(np.ones(DIM, np.float32))  # delta-only publish: same stack
    assert t.snapshot().stacked_leaves() is stk
    victim = int(t.snapshot().segments[2].gids[0])
    assert t.delete(victim)  # tombstone publish: ids planes only
    upd = t.snapshot().stacked_leaves()
    assert upd is not stk and upd.pts is stk.pts
    assert upd.padded_pts() is stk.padded_pts()
    assert not torch.equal(upd.ids[2], stk.ids[2])
    assert torch.equal(upd.ids[[0, 1, 3, 4, 5]], stk.ids[[0, 1, 3, 4, 5]])
    assert victim not in set(upd.ids.flatten().tolist())
    t.compact(force=True)  # new segment set: rebuilt
    assert t.snapshot().stacked_leaves().num_segments == 1
    _check_stacked_matches_sequential(t, q, 3, "after compaction")


def test_background_compaction_stays_exact():
    m = MutableP2HIndex.from_data(
        _mkdata(60, seed=3), n0=16, device="cpu", background=True,
        policy=CompactionPolicy(delta_capacity=20, tombstone_frac=0.5,
                                max_segments=8))
    try:
        for c in range(6):
            m.insert_batch(_mkdata(20, seed=30 + c))
            m.delete(c * 7)
        m.wait_compaction()
        assert m.compaction_log and m.snapshot().segments
        q = _mkdata(5, seed=23, dim=DIM + 1)
        _check_stacked_matches_sequential(m, q, 4, "background")
        assert m.admission_stats()["compactor_leaked"] == 0
    finally:
        m.close()


def test_refusals(monkeypatch, pair, tmp_path):
    """What the mutable index still refuses: an engine over another index,
    the device-sharded forest's engine (ROADMAP.md queue 1 item 12), a
    missing checkpoint
    with or without a log, and no CUDA device without ``device=``."""
    from repro_torch.serve import P2HEngine

    t, _ = pair
    other = MutableP2HIndex(DIM, device="cpu")
    with pytest.raises(ValueError, match="different index"):
        t.query(np.ones((1, DIM + 1), np.float32), engine=P2HEngine(other))
    with pytest.raises(NotImplementedError, match="item 12"):
        P2HEngine(t, sharded=object())
    with pytest.raises(FileNotFoundError):
        MutableP2HIndex.load(str(tmp_path / "nowhere"), wal=object())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MutableP2HIndex(DIM)
    assert platform.resolve_device("cpu").type == "cpu"
