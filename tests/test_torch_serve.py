"""The port's serving engine (``repro_torch.serve``) against the JAX
package's, on the CPU.

The same index data and the same query trace go through both packages'
``P2HEngine``: on every dispatch route (``dfs``, ``sweep``, ``beam`` and
the forced ``pallas`` route -- the JAX package's through its plain
reference, the port's through its kernel's plain version) the answers
agree within the tie rule of ``_torch_parity``, and the eight counters,
the route counts and the lambda cache's stats are equal, cold and warm.
Inside the port the engine's answers equal the direct route's bit for
bit.  The batcher, the dispatch table and the lambda cache are held to the
JAX package's on identical inputs, also on clustered data, where each
package is held to the oracle on its own; the device-sharded forest and a
multi-device mesh stay refused (ROADMAP.md, queue 1, item 12).  The
sharded mutable index's serving is ``test_torch_sharded.py``'s.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_parity import assert_topk_parity, oracle  # noqa: E402
from repro.core import P2HIndex as JIndex  # noqa: E402
from repro.serve import DispatchPolicy as JPolicy  # noqa: E402
from repro.serve import LambdaCache as JCache  # noqa: E402
from repro.serve import MicroBatcher as JBatcher  # noqa: E402
from repro.serve import P2HEngine as JEngine  # noqa: E402
from repro.stream import CompactionPolicy as JCompaction  # noqa: E402
from repro.stream import MutableP2HIndex as JMutable  # noqa: E402
from repro_torch.core.api import P2HIndex  # noqa: E402
from repro_torch.core.balltree import append_ones, normalize_query  # noqa: E402
from repro_torch.core.exact import assert_exact_topk, exact_search  # noqa: E402
from repro_torch.data.pipeline import make_p2h_dataset  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    DispatchPolicy,
    LambdaCache,
    MicroBatcher,
    P2HEngine,
)
from repro_torch.stream import CompactionPolicy, MutableP2HIndex  # noqa: E402

N, D, K = 5000, 24, 10


@pytest.fixture(scope="module")
def setup():
    """(data, port index, JAX index, queries, oracle dists, oracle ids,
    oracle (k+1)-th)."""
    data, q = make_p2h_dataset(N, D, kind="planted", n_queries=16, seed=0)
    od, oi, nxt = oracle(append_ones(data), normalize_query(q), K + 1)
    return (data, P2HIndex.build(data, n0=128, device="cpu"),
            JIndex.build(data, n0=128), q, od[:, :K], oi[:, :K], od[:, K])


def _assert_same_stats(te, je):
    """Route counts, the eight counters per route and the lambda cache's
    stats of two engines are equal."""
    ts, js = te.stats(), je.stats()
    assert ts["routes"] == js["routes"]
    assert ts["counters"] == js["counters"]
    assert ts.get("lambda_cache") == js.get("lambda_cache")
    assert ts["batches"] == js["batches"] and ts["queries"] == js["queries"]


# ----------------------------------------------------------------- batcher
def test_batcher_static_shapes_and_fifo():
    tb, jb = MicroBatcher(d=5, slot_size=4), JBatcher(d=5, slot_size=4)
    for i in range(6):
        assert (tb.submit(np.full(5, i, np.float32), k=3)
                == jb.submit(np.full(5, i, np.float32), k=3))
    tbs, jbs = list(tb.drain()), list(jb.drain())
    assert [mb.occupancy for mb in tbs] == [4, 2]
    for t, j in zip(tbs, jbs, strict=True):
        assert t.queries.shape == (4, 5)  # static shape incl. padding
        np.testing.assert_array_equal(t.queries, j.queries)
        assert (t.tickets, t.occupancy, t.k) == (j.tickets, j.occupancy, j.k)
    assert tbs[0].tickets == [0, 1, 2, 3] and tbs[1].tickets == [4, 5]
    # padding replicates the first live slot
    np.testing.assert_array_equal(tbs[1].queries[2], tbs[1].queries[0])


def test_batcher_groups_by_k_and_recall():
    out = []
    for cls in (MicroBatcher, JBatcher):
        b = cls(d=3, slot_size=8)
        b.submit(np.zeros(3, np.float32), k=1)
        b.submit(np.zeros(3, np.float32), k=2)
        b.submit(np.zeros(3, np.float32), k=2, recall_target=0.9)
        out.append([(mb.k, mb.recall_target, mb.occupancy)
                    for mb in b.drain()])
    assert out[0] == out[1] == [(1, 1.0, 1), (2, 1.0, 1), (2, 0.9, 1)]


# ----------------------------------------------------------------- policy
_ROUTE_ARGS = [
    # (occupancy, k, recall_target, route kwargs)
    (1, 10, 1.0, {}), (2, 10, 1.0, {}), (3, 10, 1.0, {}), (8, 10, 1.0, {}),
    (8, 10, 0.9, {}), (8, 10, 0.99, {}), (8, 10, 0.5, {}),
    (8, 10, 1.0, dict(sharded=True)),
    (1, 10, 1.0, dict(segments=3)), (2, 10, 1.0, dict(segments=2)),
    (8, 10, 1.0, dict(segments=9, stackable=8)),
    (8, 10, 1.0, dict(segments=5, stackable=4, delta_frac=0.6)),
    (8, 10, 1.0, dict(segments=4, stackable=3, tombstone_frac=0.3)),
    (8, 10, 1.0, dict(segments=9, stackable=8, tile_density=0.4)),
    (8, 10, 1.0, dict(segments=3, stackable=2, mesh_devices=4)),
]


@pytest.mark.parametrize("knobs", [
    {}, dict(prefer_pallas=True), dict(prefer_pallas=False),
    dict(small_batch=4, prefer_pallas=True), dict(probe_tiles=0),
    dict(probe_dtype="int8", stacked_min_fanout=2)])
def test_dispatch_table_equals_jax_on_host(knobs):
    """The policy's table, the JAX package's defaults included
    (``small_batch=None`` reads as the JAX package's 2 on the host)."""
    tp, jp = DispatchPolicy(**knobs), JPolicy(**knobs)
    for occ, k, rt, kw in _ROUTE_ARGS:
        t, j = tp.route(occ, k, rt, **kw), jp.route(occ, k, rt, **kw)
        assert dataclasses.asdict(t) == dataclasses.asdict(j), (occ, rt, kw)
    for r in (1.0, 0.99, 0.95, 0.9, 0.5, 0.0):
        assert tp.frac_for_recall(r) == jp.frac_for_recall(r)
    assert tp.route(8, 10, recall_target=0.9).method == "beam"
    assert tp.frac_for_recall(0.99) == 0.5 and tp.frac_for_recall(0.5) == 0.05


def test_dispatch_resolution_by_device(setup):
    """``prefer_pallas`` and ``small_batch`` follow the index's device: the
    JAX package's host defaults on the CPU (plain sweep, a DFS window of
    2), the kernel route and no DFS window on a CUDA device."""
    _, tidx, _, _, _, _, _ = setup
    host = P2HEngine(tidx).policy
    assert (host.prefer_pallas, host.small_batch) == (False, 2)
    assert host.route(1, K).method == "dfs"
    assert host.route(8, K).method == "sweep"
    card = P2HEngine.resolve_policy(DispatchPolicy(), "cuda")
    assert (card.prefer_pallas, card.small_batch) == (True, 0)
    for occ in (1, 2, 8):
        assert card.route(occ, K).method == "pallas"
        assert card.route(occ, K, segments=9).method == "pallas"
    # an explicit choice is kept on either device
    kept = P2HEngine.resolve_policy(
        DispatchPolicy(small_batch=2, prefer_pallas=False), "cuda")
    assert (kept.prefer_pallas, kept.small_batch) == (False, 2)
    assert kept.route(1, K).method == "dfs"


# ------------------------------------------------------------ lambda cache
def test_lambda_cache_equals_jax(setup):
    """Identical traces give identical signatures, caps and stats: the
    planes come from the same seed, so the buckets are the JAX package's."""
    _, _, _, _, od, _, _ = setup
    rng = np.random.default_rng(5)  # spread normals: one bucket each
    qn = normalize_query(rng.normal(size=(16, D + 1))).astype(np.float32)
    tc, jc = LambdaCache(D + 1, max_norm=10.0), JCache(D + 1, max_norm=10.0)
    np.testing.assert_array_equal(tc.signatures(qn), jc.signatures(qn))
    np.testing.assert_array_equal(tc.signatures(qn), tc.signatures(-qn))
    kth = od[:, -1].astype(np.float32)
    for c in (tc, jc):
        c.update(qn[:8], K, kth[:8], epoch=2)
        c.update(qn[8:], K, kth[8:], epoch=3, min_epoch=1)
    for min_epoch in (0, 2, 3, 4):
        for kk in (K, K + 1):
            np.testing.assert_array_equal(
                tc.lookup(qn, kk, min_epoch=min_epoch),
                jc.lookup(qn, kk, min_epoch=min_epoch))
        assert tc.stats() == jc.stats()
    caps = LambdaCache(D + 1, max_norm=10.0)
    caps.update(qn, K, kth)
    got = caps.lookup(qn, K)
    # a hit upper-bounds the true k-th strictly but stays tight
    assert np.isfinite(got).all() and (got > kth).all()
    slack = 1e-5 * (1 + np.linalg.norm(qn, axis=1) * caps.max_norm)
    assert (got <= kth * (1 + 1e-4) + slack * (1 + 1e-6)).all()


def test_lambda_cache_skips_invalid_updates():
    cache = LambdaCache(4, max_norm=1.0)
    q = np.ones((1, 4), np.float32)
    cache.update(q, 3, np.array([np.inf]))  # <k results: not a valid bound
    assert not np.isfinite(cache.lookup(q, 3)).any()


def test_lambda_cache_epoch_invalidation_rules():
    """Entries older than ``min_epoch`` read as misses and are evicted; a
    newer re-update replaces a stale entry even with a larger lambda."""
    cache = LambdaCache(4, max_norm=1.0)
    q = np.ones((1, 4), np.float32)
    cache.update(q, 2, np.array([0.5]), epoch=3)
    assert np.isfinite(cache.lookup(q, 2, min_epoch=3)).all()
    assert not np.isfinite(cache.lookup(q, 2, min_epoch=4)).any()
    assert cache.stale_evictions == 1
    assert not np.isfinite(cache.lookup(q, 2, min_epoch=0)).any()
    cache.update(q, 2, np.array([0.5]), epoch=3)
    cache.update(q, 2, np.array([0.9]), epoch=6, min_epoch=5)
    caps = cache.lookup(q, 2, min_epoch=5)
    assert np.isfinite(caps).all() and caps[0] >= 0.9


# ---------------------------------------------------------- engine parity
@pytest.mark.parametrize("route", ["dfs", "sweep", "pallas", "beam"])
def test_engine_route_matches_jax_and_direct_cold_and_warm(setup, route):
    """On every forced route, cold and fully warm: the port's engine equals
    its direct route bit for bit, and the JAX package's engine within the
    tie rule with equal counters, route counts and cache stats."""
    data, tidx, jidx, q, od, oi, nxt = setup
    kw = dict(frac=0.1) if route == "beam" else {}
    dd, di = tidx.query(q, k=K, method=route, **kw)
    rt = dict(recall_target=0.9) if route == "beam" else {}
    exact = None if route == "beam" else nxt
    for use_cache in (False, True):
        te = P2HEngine(tidx, slot_size=8, use_cache=use_cache)
        je = JEngine(jidx, slot_size=8, use_cache=use_cache)
        for rep in range(2 if use_cache else 1):  # rep 1: every lookup hits
            gd, gi = te.query(q, k=K, method=route, **rt)
            jd, ji = je.query(q, k=K, method=route, **rt)
            assert np.array_equal(dd, gd) and np.array_equal(di, gi), (
                route, use_cache, rep)
            assert_topk_parity(gd, gi, jd, ji, exact)
            if exact is not None:
                assert_topk_parity(gd, gi, od, oi, nxt)
            _assert_same_stats(te, je)
        if use_cache and route != "beam":  # beam never consumes caps
            assert te.cache.hits > 0


def test_engine_kernel_is_the_pallas_route(setup):
    _, tidx, _, q, _, _, _ = setup
    a = P2HEngine(tidx, slot_size=8)
    b = P2HEngine(tidx, slot_size=8)
    da, ia = a.query(q, k=K, method="kernel")
    db, ib = b.query(q, k=K, method="pallas")
    assert np.array_equal(da, db) and np.array_equal(ia, ib)
    assert a.stats()["routes"] == b.stats()["routes"] == {"pallas": 2}


def test_engine_auto_dispatch_streaming_and_api_hook(setup):
    _, tidx, jidx, q, od, oi, nxt = setup
    te, je = P2HEngine(tidx, slot_size=8), JEngine(jidx, slot_size=8)
    for eng in (te, je):  # single query -> dfs; a full batch -> sweep
        eng.query(q[:1], k=K)
    assert te.stats()["routes"] == je.stats()["routes"] == {"dfs": 1}
    bd, bi, st = tidx.query(q, k=K, engine=te, return_stats=True)
    jd, ji, jst = jidx.query(q, k=K, engine=je, return_stats=True)
    assert_topk_parity(bd, bi, od, oi, nxt)
    assert st == jst
    _assert_same_stats(te, je)
    # the streaming API agrees with the batch API
    tickets = [te.submit(row, k=K) for row in q]
    assert te.flush() == 2
    got = [te.result(t) for t in tickets]
    np.testing.assert_array_equal(np.stack([g[0] for g in got]), bd)
    np.testing.assert_array_equal(np.stack([g[1] for g in got]), bi)
    assert te.result_meta(tickets[0])["complete"]


def test_engine_warm_cache_prunes_strictly_more():
    """On a hot-repeat trace a warm lambda cache skips strictly more tiles
    than cold dispatch, with the same answers, and the same counts as the
    JAX package's engine."""
    rng = np.random.default_rng(7)
    cents = rng.normal(size=(64, 32)) * 2.5
    data = (cents[rng.integers(0, 64, 30000)]
            + rng.normal(size=(30000, 32))).astype(np.float32)
    trace = np.stack([rng.normal(size=33).astype(np.float32)
                      for _ in range(4)] * 2)
    tidx = P2HIndex.build(data, n0=64, device="cpu")
    jidx = JIndex.build(data, n0=64)
    te = P2HEngine(tidx, slot_size=8,
                   policy=DispatchPolicy(prefer_pallas=False))
    je = JEngine(jidx, slot_size=8, policy=JPolicy(prefer_pallas=False))
    skips = []
    for _ in range(2):
        cd, ci = te.query(trace, k=60)
        jd, ji = je.query(trace, k=60)
        assert_topk_parity(cd, ci, jd, ji)
        _assert_same_stats(te, je)
        skips.append(te.stats()["counters"]["sweep"]["tiles_skipped"])
        te.reset_stats()
        je.reset_stats()
    assert skips[1] > skips[0], skips


def test_engine_warm_repeat_exact_at_zero_lambda():
    """Points exactly on the queried hyperplane: the cached k-th distance
    is 0 and the warm cap must still admit every true member."""
    rng = np.random.default_rng(0)
    data = rng.normal(size=(2000, 8)).astype(np.float32)
    data[:50, 0] = 0.0  # on the hyperplane x0 = 0
    tidx = P2HIndex.build(data, n0=128, device="cpu")
    q = np.zeros((4, 9), np.float32)
    q[:, 0] = 1.0
    for m in ("sweep", "dfs", "pallas"):
        eng = P2HEngine(tidx, slot_size=4)
        d1, i1 = eng.query(q, k=10, method=m)
        d2, i2 = eng.query(q, k=10, method=m)  # warm: cached lambda == 0
        assert (d1 == 0).all()
        assert np.array_equal(d1, d2) and np.array_equal(i1, i2), m
        assert (i2 >= 0).all() and eng.cache.hits > 0, m


def _mutable_pair(data, **kw):
    pol = dict(delta_capacity=64)
    return (MutableP2HIndex.from_data(data, n0=128, device="cpu",
                                      policy=CompactionPolicy(**pol), **kw),
            JMutable.from_data(data, n0=128, policy=JCompaction(**pol), **kw))


def _assert_live_exact(m, q, d, i):
    """``(d, i)`` is the float64 brute force over ``m``'s live set, ids
    (global) apart from ties."""
    X, G = m.snapshot().live_points()
    od, oi, nxt = oracle(X, normalize_query(q), K + 1)
    assert_topk_parity(d, i, od[:, :K], G[oi[:, :K]], od[:, K])


def test_engine_epoch_invalidation_delete_of_kth_neighbor(setup):
    """After warming the cache, deleting current top-k members grows the
    true k-th distance above the cached caps; the epoch-tagged cache reads
    them as stale, so the promoted neighbours still come back -- in both
    packages alike."""
    data, _, _, q, _, _, _ = setup
    tm, jm = _mutable_pair(data)
    te = P2HEngine(tm, slot_size=8,
                   policy=DispatchPolicy(prefer_pallas=False))
    je = JEngine(jm, slot_size=8, policy=JPolicy(prefer_pallas=False))
    d1, i1 = tm.query(q, k=K, engine=te)  # cold pass warms the cache
    jd1, ji1 = jm.query(q, k=K, engine=je)
    _assert_live_exact(tm, q, d1, i1)
    assert_topk_parity(d1, i1, jd1, ji1)
    assert te.cache.stats()["entries"] > 0
    for gid in ({int(g) for g in i1[:, K - 1]}
                | {int(g) for g in i1[:, 0]}):
        assert tm.delete(gid) and jm.delete(gid)
    d2, i2 = tm.query(q, k=K, engine=te)  # warm pass over mutated index
    jd2, ji2 = jm.query(q, k=K, engine=je)
    _assert_live_exact(tm, q, d2, i2)  # no stale cap excluded a neighbour
    assert_topk_parity(d2, i2, jd2, ji2)
    assert te.cache.stats()["stale_evictions"] > 0
    _assert_same_stats(te, je)
    # inserts alone never invalidate: the warm pass stays exact with hits
    before_hits = te.cache.stats()["hits"]
    for i in range(8):
        tm.insert(data[i] * 0.5)
        jm.insert(data[i] * 0.5)
    d3, i3 = tm.query(q, k=K, engine=te)
    jm.query(q, k=K, engine=je)
    _assert_live_exact(tm, q, d3, i3)
    assert te.cache.stats()["hits"] > before_hits
    _assert_same_stats(te, je)


def test_mutable_engine_stacked_route_matches_jax_and_direct():
    """A snapshot of 5 sealed segments crosses the stacked threshold: the
    engine dispatches the stacked route (bf16 probe), its answers equal the
    direct stacked query bit for bit and the JAX package's engine within
    the tie rule, with equal counters, cold and warm."""
    rng = np.random.default_rng(3)
    data = rng.normal(size=(600, 8)).astype(np.float32)
    q = rng.normal(size=(12, 9)).astype(np.float32)
    pol = dict(delta_capacity=120, tombstone_frac=0.95, max_segments=64)
    tm = MutableP2HIndex.from_data(data[:120], n0=16, device="cpu",
                                   policy=CompactionPolicy(**pol))
    jm = JMutable.from_data(data[:120], n0=16, policy=JCompaction(**pol))
    for m in (tm, jm):
        for c in range(1, 5):
            m.insert_batch(data[c * 120:(c + 1) * 120])
        m.insert_batch(data[:6] * 0.9)  # stays in the delta
        for g in range(0, 600, 11):
            assert m.delete(g)
    assert len(tm.snapshot().segments) == 5
    dd, di = tm.query(q, k=K, method="stacked", probe_dtype="bf16")
    te, je = P2HEngine(tm, slot_size=8), JEngine(jm, slot_size=8)
    for _ in range(2):
        gd, gi = te.query(q, k=K)
        jd, ji = je.query(q, k=K)
        assert np.array_equal(gd, dd) and np.array_equal(gi, di)
        assert_topk_parity(gd, gi, jd, ji)
        _assert_same_stats(te, je)
    assert te.stats()["routes"] == {"stacked": 4}
    assert te.cache.hits > 0
    dead = set(range(0, 600, 11))
    assert not dead & set(gi.ravel().tolist())
    _assert_live_exact(tm, q, gd, gi)


def test_engine_stats_shape(setup):
    _, tidx, _, q, _, _, _ = setup
    eng = P2HEngine(tidx, slot_size=8)
    eng.query(q, k=K)
    st = eng.stats()
    assert st["queries"] == len(q)
    assert st["batches"] == sum(st["routes"].values())
    assert np.isfinite(st["latency_p50_ms"])
    assert set(st["lambda_cache"]) == {"entries", "hits", "misses",
                                       "stale_evictions"}
    assert "mesh_devices" not in st  # no mesh: every batch is one program


# -------------------------------------------------------- clustered data
@pytest.fixture(scope="module")
def clustered():
    """Clustered data (norms near 25): the packages' f32 sums there differ
    by up to 1.4e-6, above the parity atol, so each package is held to the
    oracle on its own."""
    data, q = make_p2h_dataset(N, D, kind="clustered", n_queries=16, seed=0)
    pts = torch.from_numpy(append_ones(data))
    qn = torch.from_numpy(normalize_query(q))
    _, oi = exact_search(pts, qn, K + 1)
    return (P2HIndex.build(data, n0=128, device="cpu"),
            JIndex.build(data, n0=128), q, oi, pts, qn)


@pytest.mark.parametrize("route", [None, "dfs", "sweep", "pallas"])
def test_engine_on_clustered_data_equals_the_oracle(clustered, route):
    """Each package's engine, cold and warm, on every exact route (and
    auto-dispatch), holds its ids to the oracle's at float64 distances
    (``assert_exact_topk``); the routes taken and the warm cache's hits
    are the same in both."""
    tidx, jidx, q, oi, pts, qn = clustered
    te, je = P2HEngine(tidx, slot_size=8), JEngine(jidx, slot_size=8)
    for _ in range(2):  # cold, then warm
        for eng in (te, je):
            bd, bi = eng.query(q, k=K, method=route)
            assert_exact_topk(np.array(bd), np.array(bi), oi, pts, qn)
    assert te.stats()["routes"] == je.stats()["routes"]
    assert (te.stats()["lambda_cache"]["hits"]
            == je.stats()["lambda_cache"]["hits"] > 0)


# --------------------------------------------------------------- refusals
def test_engine_refuses_sharded_and_mesh_paths(setup, monkeypatch):
    """The device-sharded forest (``sharded=``, the ``"sharded"`` route)
    and a serving mesh of more than one device wait for ROADMAP.md queue 1
    item 12; each is refused, never half-served.  A front-end that only
    looks sharded is not a sharded index."""
    data, tidx, _, q, _, _, _ = setup
    with pytest.raises(NotImplementedError, match="item 12"):
        P2HEngine(tidx, sharded=object())

    class ShardedFrontEnd:  # holds shards, but is no sharded index
        shards = ()

    with pytest.raises(TypeError, match="ShardedMutableP2HIndex"):
        P2HEngine(ShardedFrontEnd())
    with pytest.raises(TypeError, match="P2HIndex"):
        P2HEngine(object())
    eng = P2HEngine(tidx, slot_size=8)
    with pytest.raises(NotImplementedError, match="item 12"):
        eng.query(q, k=K, method="sharded")
    m = MutableP2HIndex.from_data(data[:500], n0=64, device="cpu")
    meng = P2HEngine(m, slot_size=8)
    snap = m.snapshot()
    object.__setattr__(snap, "mesh", ["cpu", "cpu"])  # two devices
    monkeypatch.setattr(m, "snapshot", lambda: snap)
    with pytest.raises(NotImplementedError, match="item 12"):
        meng.query(q, k=K)
    object.__setattr__(snap, "mesh", "cpu")  # one device serves
    bd, bi = meng.query(q, k=K)
    assert np.isfinite(bd).all()


def test_engine_serves_only_its_own_index(setup):
    data, tidx, _, q, _, _, _ = setup
    other = P2HIndex.build(data[:1000], n0=64, device="cpu")
    with pytest.raises(ValueError, match="different index"):
        other.query(q, K, engine=P2HEngine(tidx))
    m = MutableP2HIndex.from_data(data[:500], n0=64, device="cpu")
    with pytest.raises(ValueError, match="different index"):
        m.query(q, K, engine=P2HEngine(tidx))
