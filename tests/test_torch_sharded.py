"""The port's sharded mutable index and two-round lambda exchange
(``repro_torch.stream.sharded``, ``repro_torch.core.distributed``) against
the JAX package's, on the CPU.

The same numpy inputs and the same op sequence go through both packages'
``ShardedMutableP2HIndex``: the hash router's assignments are equal; the
exchange's answers agree within the tie rule of ``_torch_parity`` with
equal counters and equal ``info`` (``lambda0``, ``round1_kth``,
``shard_kth``) on every method, round 2 stacked and sequential; the
engine's routes, counters and cache stats are equal cold and warm; the
degraded exchange reports the same ``missing_shards``/``complete`` over
every failure subset of three shards and equals the oracle over the live
shards.  A churn property (fixed seeds, a forced compaction in each) holds
every route to a float64 brute force, and on clustered data each package's
answers are held to the oracle through ``assert_exact_topk``.  Seeds are
fixed; nothing is drawn by hypothesis.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
from _torch_parity import assert_topk_parity, oracle  # noqa: E402
from repro.core.distributed import two_round_exchange as j_exchange  # noqa: E402
from repro.runtime.fault_tolerance import RetryPolicy as JRetry  # noqa: E402
from repro.serve import P2HEngine as JEngine  # noqa: E402
from repro.serve.resilience import FaultInjector as JInjector  # noqa: E402
from repro.serve.resilience import FaultSpec as JSpec  # noqa: E402
from repro.serve.resilience import ResilienceConfig as JConfig  # noqa: E402
from repro.serve.resilience import ShardSupervisor as JSupervisor  # noqa: E402
from repro.stream import CompactionPolicy as JPolicy  # noqa: E402
from repro.stream import HashRouter as JRouter  # noqa: E402
from repro.stream import ShardedMutableP2HIndex as JSharded  # noqa: E402
from repro_torch.core.balltree import normalize_query  # noqa: E402
from repro_torch.core.distributed import two_round_exchange  # noqa: E402
from repro_torch.core.exact import assert_exact_topk, exact_search  # noqa: E402
from repro_torch.data.pipeline import make_p2h_dataset  # noqa: E402
from repro_torch.runtime.fault_tolerance import RetryPolicy  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    FaultInjector,
    FaultSpec,
    P2HEngine,
    ResilienceConfig,
    ShardSupervisor,
)
from repro_torch.stream import (  # noqa: E402
    CompactionPolicy,
    HashRouter,
    ShardedMutableP2HIndex,
    ShardedSnapshot,
)

DIM, K, SHARDS = 12, 5, 3


def _mkdata(n, seed=0, dim=DIM):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(
        np.float32)


def _ops(pkg, *, seed=3, n=1500, more=420, shards=SHARDS):
    """The op sequence both packages run: a routed bulk load (one sealed
    segment per shard), routed inserts that fill each shard's delta once
    (a second segment each) and leave a live delta, deletes over every
    shard, segments and deltas alike."""
    port = pkg == "port"
    cls, pol = ((ShardedMutableP2HIndex, CompactionPolicy) if port
                else (JSharded, JPolicy))
    m = cls.from_data(_mkdata(n, seed=seed), shards, n0=32, seed=seed,
                      policy=pol(delta_capacity=100, tombstone_frac=0.95,
                                 max_segments=8),
                      **(dict(device="cpu") if port else {}))
    m.insert_batch(_mkdata(more, seed=seed + 1))
    for g in list(range(0, n, 13)) + [n + 3, n + more - 2]:
        assert m.delete(g)
    return m


@pytest.fixture(scope="module")
def pair():
    return _ops("port"), _ops("jax")


def _queries(b=7, seed=11):
    return normalize_query(_mkdata(b, seed=seed, dim=DIM + 1)).astype(
        np.float32)


def _live_oracle(snaps, qn, k):
    """float64 brute force over the live sets of ``snaps`` (normalised
    queries): ``(dists, gids, (k+1)-th)``."""
    Xs, Gs = zip(*(s.live_points() for s in snaps))
    X, G = np.concatenate(Xs), np.concatenate(Gs)
    d, i, nxt = oracle(X, qn, k)
    return d, G[i], nxt


def _assert_live_exact(bd, bi, snaps, qn, k):
    od, oi, nxt = _live_oracle(snaps, qn, k)
    assert_topk_parity(bd, bi, od, oi, nxt)


# ------------------------------------------------------------------ router
@pytest.mark.parametrize("num_shards", [2, 3, 4, 7])
def test_hash_router_equals_jax(num_shards):
    t, j = HashRouter(num_shards), JRouter(num_shards)
    gids = np.concatenate([np.arange(5000), [2**31 - 1, 2**32 + 5,
                                             2**40 + 17]])
    want = np.array([j.shard_of(int(g)) for g in gids])
    assert np.array_equal([t.shard_of(int(g)) for g in gids], want)
    assert np.array_equal(t.shard_of_many(gids), want)
    assert np.array_equal(t.shard_of_many(gids), j.shard_of_many(gids))
    assert t.spec() == j.spec()
    assert HashRouter.from_spec(j.spec()).shard_of(4321) == want[4321]


def test_index_state_equals_jax(pair):
    """Routing, compaction and deletes leave both packages' shards in the
    same state: live sets, epochs, segments, delta rows, compactions."""
    t, j = pair
    ts, js = t.stats(), j.stats()
    assert ts["per_shard"] == js["per_shard"]
    assert ts["epoch"] == js["epoch"] == t.epoch
    assert ts["live_count"] == js["live_count"] == t.live_count
    assert all(p["segments"] == 2 and p["delta_live"] > 0
               for p in ts["per_shard"])
    for a, b in zip(t.snapshot().shards, j.snapshot().shards):
        assert np.array_equal(np.sort(a.live_points()[1]),
                              np.sort(b.live_points()[1]))
    snap = t.snapshot()
    assert isinstance(snap, ShardedSnapshot) and snap.num_shards == SHARDS
    assert ts["mesh_devices"] == 1 and ts["misroutes"] == 0


# ---------------------------------------------------------------- exchange
EXCHANGE_CASES = [
    dict(method="sweep"),  # fan-out 6: round 2 auto-promoted to the stack
    dict(method="sweep", stacked=False),
    dict(method="pallas"),
    dict(method="pallas", stacked=False),  # one sweep-kernel call a segment
    dict(method="stacked"),
    dict(method="stacked", probe_tiles=2),
    dict(method="stacked", probe_dtype="bf16", probe_tiles=2),
    dict(method="beam", frac=0.5),
    dict(method="sweep", frac1=0.1),
]


@pytest.mark.parametrize("kw", EXCHANGE_CASES,
                         ids=lambda kw: "-".join(f"{v}" for v in kw.values()))
def test_exchange_matches_jax_and_oracle(pair, kw):
    t, j = pair
    qn = _queries()
    ts, js = t.snapshot(), j.snapshot()
    td, ti, tc, tinfo = two_round_exchange(ts.shards, qn, K,
                                           return_info=True, **kw)
    jd, ji, jc, jinfo = j_exchange(js.shards, qn, K, return_info=True,
                                   **kw)
    jd, ji = np.asarray(jd), np.asarray(ji)
    assert_topk_parity(td, ti, jd, ji)
    assert np.array_equal(tc, np.asarray(jc)), (tc, jc)
    if kw["method"] == "beam":
        assert tinfo["lambda0"] is None and jinfo["lambda0"] is None
    else:
        _assert_live_exact(td, ti, ts.shards, qn, K)
        np.testing.assert_allclose(tinfo["lambda0"], jinfo["lambda0"],
                                   rtol=1e-5, atol=1e-6)
    for key in ("round1_kth", "shard_kth"):
        assert tinfo[key].shape == (SHARDS, len(qn))
        np.testing.assert_allclose(tinfo[key], np.asarray(jinfo[key]),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


def test_exchange_lambda0_bounds_the_true_kth(pair):
    """The exchange's validity: lambda0 and every shard's reported k-th
    are >= the true global k-th (each is the distance of k real points of
    one shard)."""
    t, _ = pair
    qn = _queries(9, seed=12)
    snap = t.snapshot()
    _, _, _, info = two_round_exchange(snap.shards, qn, K, return_info=True)
    od, _, _ = _live_oracle(snap.shards, qn, K)
    true_kth = od[:, K - 1]
    assert (info["lambda0"] >= true_kth - 1e-6).all()
    assert (info["shard_kth"] >= true_kth[None] - 1e-6).all()
    assert (info["round1_kth"] >= info["shard_kth"]).all()


def test_round2_is_one_stacked_launch_over_every_shard(pair, monkeypatch):
    """Round 2 sweeps every shard's segments in ONE stacked call on the
    round-2 route, with the shards' segment counts as ``shard_bounds``."""
    from repro_torch.kernels import stacked_sweep as tss

    t, _ = pair
    calls, real = [], tss.stacked_sweep_query

    def spy(stk, *a, **kw):
        calls.append((stk.num_segments, kw.get("probe_route"),
                      kw.get("shard_bounds")))
        return real(stk, *a, **kw)

    monkeypatch.setattr(tss, "stacked_sweep_query", spy)
    t.query(_queries(), K)
    assert calls == [(6, "round2", (2, 2, 2))]
    calls.clear()
    t.query(_queries(), K, stacked=False)
    assert calls == []


def test_sharded_query_matches_jax_through_compaction(pair):
    """Direct ``query`` on each route, then a forced compaction of one
    shard and of all shards: answers and counters stay equal to the JAX
    package's and to the oracle."""
    t, j = _ops("port", seed=5), _ops("jax", seed=5)
    q = _mkdata(6, seed=21, dim=DIM + 1)
    qn = normalize_query(q)
    for step in ("before", "one", "all"):
        if step == "one":
            assert t.compact(force=True, shard=1)
            assert j.compact(force=True, shard=1)
        elif step == "all":
            t.compact(force=True)
            j.compact(force=True)
        assert t.stats()["per_shard"] == j.stats()["per_shard"]
        routes = [dict(), dict(method="sweep", stacked=False)]
        if step == "before":  # the DFS compiles per tree shape in JAX
            routes.append(dict(method="dfs"))
        for kw in routes:
            td, ti, tst = t.query(q, K, return_stats=True, **kw)
            jd, ji, jst = j.query(q, K, return_stats=True, **kw)
            assert_topk_parity(td, ti, np.asarray(jd), np.asarray(ji))
            assert tst == jst, (step, kw)
            _assert_live_exact(td, ti, t.snapshot().shards, qn, K)


# ------------------------------------------------------------------ engine
def test_engine_over_sharded_matches_jax_cold_and_warm(pair):
    """The engine over the sharded index: route counts, the eight
    counters and the lambda cache's stats equal the JAX package's, cold
    and warm; warm answers equal cold bit for bit; one batch of all the
    queries equals the direct query bit for bit."""
    t, j = pair
    q = _mkdata(12, seed=31, dim=DIM + 1)
    te, je = P2HEngine(t, slot_size=4), JEngine(j, slot_size=4)
    cold_t, cold_j = te.query(q, K), je.query(q, K)
    warm_t, warm_j = te.query(q, K), je.query(q, K)
    for (a, b), (c, d) in ((cold_t, cold_j), (warm_t, warm_j)):
        assert_topk_parity(a, b, np.asarray(c), np.asarray(d))
    assert np.array_equal(cold_t[0], warm_t[0])
    assert np.array_equal(cold_t[1], warm_t[1])
    ts, js = te.stats(), je.stats()
    assert ts["routes"] == js["routes"]
    assert ts["counters"] == js["counters"]
    assert ts["lambda_cache"] == js["lambda_cache"]
    assert ts["lambda_cache"]["hits"] > 0
    assert ts["router_version"] == js["router_version"] == 0
    assert ts["misroutes"] == js["misroutes"] == 0
    route = next(iter(ts["routes"]))
    whole = P2HEngine(t, slot_size=len(q))
    ed, ei = whole.query(q, K)
    dd, di = t.query(q, K, method=route, stacked=route == "stacked")
    assert np.array_equal(ed, dd) and np.array_equal(ei, di)
    _assert_live_exact(ed, ei, t.snapshot().shards, normalize_query(q), K)


def test_engine_delete_drops_only_its_shards_component():
    """Deleting a cached query's k-th neighbour in one shard invalidates
    only that shard's cache component: warm answers stay exact and the
    engine's cache stats equal the JAX package's."""
    t, j = _ops("port", seed=7), _ops("jax", seed=7)
    q = _mkdata(4, seed=41, dim=DIM + 1)
    te, je = P2HEngine(t, slot_size=4), JEngine(j, slot_size=4)
    _, ti = te.query(q, K)
    je.query(q, K)
    victim = int(ti[0, K - 1])
    assert t.delete(victim) and j.delete(victim)
    owner = t.router.shard_of(victim)
    epochs = t.epoch
    assert t.snapshot().last_delete_epoch[owner] == epochs[owner]
    td, ti2 = te.query(q, K)
    jd, ji2 = je.query(q, K)
    assert victim not in set(ti2.ravel().tolist())
    assert_topk_parity(td, ti2, np.asarray(jd), np.asarray(ji2))
    _assert_live_exact(td, ti2, t.snapshot().shards, normalize_query(q), K)
    assert te.stats()["lambda_cache"] == je.stats()["lambda_cache"]
    assert te.stats()["counters"] == je.stats()["counters"]


# ---------------------------------------------------------------- degraded
def _supervisors(subset):
    plans = {si: [("error", {})] for si in subset}
    t = ShardSupervisor(ResilienceConfig(
        shard_timeout_s=60.0, breaker_failures=99,
        fault_injector=FaultInjector(
            {s: [FaultSpec(kind) for kind, _ in p]
             for s, p in plans.items()}),
        retry=RetryPolicy(max_restarts=0)))
    j = JSupervisor(JConfig(
        shard_timeout_s=60.0, breaker_failures=99,
        fault_injector=JInjector(
            {s: [JSpec(kind) for kind, _ in p] for s, p in plans.items()}),
        retry=JRetry(max_restarts=0)))
    return t, j


@pytest.mark.parametrize("mask", range(2 ** SHARDS))
def test_degraded_exchange_matches_jax_and_live_oracle(pair, mask):
    """For every subset of failing shards: ``missing_shards`` is the
    subset, ``complete`` and ``degraded`` equal the JAX package's, and the
    answers equal the oracle over the live shards."""
    t, j = pair
    subset = {si for si in range(SHARDS) if mask >> si & 1}
    q = _mkdata(5, seed=51, dim=DIM + 1)
    tsup, jsup = _supervisors(subset)
    td, ti, tinfo = t.query(q, K, return_info=True, resilience=tsup)
    jd, ji, jinfo = j.query(q, K, return_info=True, resilience=jsup)
    assert tinfo["missing_shards"] == jinfo["missing_shards"] \
        == tuple(sorted(subset))
    assert tinfo["complete"] == jinfo["complete"] == (not subset)
    assert tinfo["degraded"] == jinfo["degraded"] == bool(subset)
    assert tsup.stats()["degraded_batches"] == (1 if subset else 0)
    if subset == set(range(SHARDS)):
        assert np.all(np.isinf(td)) and np.all(ti == -1)
        return
    live = [s for si, s in enumerate(t.snapshot().shards)
            if si not in subset]
    _assert_live_exact(td, ti, live, normalize_query(q), K)
    assert_topk_parity(td, ti, np.asarray(jd), np.asarray(ji))


def test_degraded_engine_meta_and_no_cache_update(pair):
    """An armed engine over a shard that fails: every ticket's meta names
    it, answers equal the live-shard oracle, and the cache learns nothing
    from a degraded batch."""
    t, _ = pair
    q = _mkdata(6, seed=61, dim=DIM + 1)
    inj = FaultInjector({1: [FaultSpec("error")]})
    eng = P2HEngine(t, slot_size=8, resilience=ResilienceConfig(
        shard_timeout_s=60.0, breaker_failures=99, fault_injector=inj,
        retry=RetryPolicy(max_restarts=0)))
    bd, bi, metas = eng.query(q, K, return_meta=True)
    assert all(mt["missing_shards"] == (1,) and mt["degraded"]
               and not mt["complete"] for mt in metas)
    live = [s for si, s in enumerate(t.snapshot().shards) if si != 1]
    _assert_live_exact(bd, bi, live, normalize_query(q), K)
    assert eng.cache.stats()["entries"] == 0
    assert eng.stats()["resilience"]["degraded_batches"] == 1


def test_resilient_path_refuses_lambda_cap(pair):
    t, _ = pair
    with pytest.raises(ValueError, match="lambda_cap"):
        t.query(_mkdata(1, dim=DIM + 1), K, deadline_s=5.0,
                lambda_cap=np.ones((1,), np.float32))


def test_failed_stacked_unit_isolates_members_on_the_stacked_route(
        pair, monkeypatch):
    """Shard 1 answers round 1, then fails round 2's one stacked call and
    its own: each other member gets its own supervised call on the stacked
    route, never a sequential segment sweep, and the answers equal the
    oracle over the live shards."""
    from repro_torch.stream import snapshot as tsnap

    t, _ = pair
    stacked, swept = [], []
    real_stk, real_seg = tsnap.Snapshot._stacked_query, tsnap._segment_query

    def stk_spy(self, *a, **kw):
        stacked.append(self)
        return real_stk(self, *a, **kw)

    def seg_spy(*a, **kw):
        swept.append(kw["method"])
        return real_seg(*a, **kw)

    monkeypatch.setattr(tsnap.Snapshot, "_stacked_query", stk_spy)
    monkeypatch.setattr(tsnap, "_segment_query", seg_spy)
    sup = ShardSupervisor(ResilienceConfig(
        shard_timeout_s=60.0, breaker_failures=99,
        fault_injector=FaultInjector({1: [FaultSpec("error", after=1)]}),
        retry=RetryPolicy(max_restarts=0)))
    q = _mkdata(5, seed=52, dim=DIM + 1)
    td, ti, info = t.query(q, K, return_info=True, resilience=sup)
    assert info["missing_shards"] == (1,) and not info["complete"]
    assert len(stacked) >= 2  # shards 0 and 2, one stacked query each
    assert set(swept) == {"beam"}  # round 1's beams only
    live = [s for si, s in enumerate(t.snapshot().shards) if si != 1]
    _assert_live_exact(td, ti, live, normalize_query(q), K)


@pytest.mark.parametrize("armed", [False, True])
def test_stacked_launch_error_is_raised_not_degraded(pair, monkeypatch,
                                                     armed):
    """An error of round 2's stacked launch itself is no shard's: the
    exchange raises it as ``DeviceFault``, armed with a supervisor or not,
    and answers no shard by another route instead."""
    from repro_torch.kernels import stacked_sweep as tss
    from repro_torch.serve import DeviceFault

    def broken(*a, **kw):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(tss, "stacked_sweep_query", broken)
    t, _ = pair
    kw = {}
    if armed:
        kw["resilience"] = ShardSupervisor(ResilienceConfig(
            shard_timeout_s=60.0, retry=RetryPolicy(max_restarts=1)))
    with pytest.raises(DeviceFault, match="launch failed"):
        t.query(_mkdata(4, seed=53, dim=DIM + 1), K, **kw)
    if armed:
        st = kw["resilience"].stats()
        assert st["errors"] == st["retries"] == 0
        assert set(st["breaker_states"].values()) == {"closed"}


# ------------------------------------------------------------------ churn
BACKENDS = ["dfs", "sweep", "pallas", "beam", "stacked"]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sharded_churn_exact_vs_oracle(seed):
    """Insert/delete/query interleavings across 2-4 shards with forced
    compactions (one at step 20 always, more drawn), every backend held to
    a float64 brute force on the union live set."""
    rng = np.random.default_rng(seed)
    num_shards = 2 + seed % 3
    m = ShardedMutableP2HIndex.from_data(
        _mkdata(150, seed=seed, dim=8), num_shards, n0=32, seed=seed,
        device="cpu", policy=CompactionPolicy(delta_capacity=12,
                                              tombstone_frac=0.3,
                                              max_segments=3))
    live = list(range(150))
    q = rng.normal(size=(3, 9)).astype(np.float32)
    qn = normalize_query(q)
    forced = 0
    for step in range(60):
        op = rng.random()
        if step == 20 or 0.72 <= op < 0.82:
            if rng.random() < 0.5:
                m.compact(force=True, shard=int(rng.integers(num_shards)))
            else:
                m.compact(force=True)
            forced += 1
        elif op < 0.45 or not live:
            live.append(m.insert(rng.normal(size=8).astype(np.float32)))
        elif op < 0.72:
            assert m.delete(live.pop(int(rng.integers(len(live)))))
        else:
            meth = BACKENDS[int(rng.integers(len(BACKENDS)))]
            kw = dict(frac=1.0) if meth == "beam" else {}
            bd, bi = m.query(q, K, method=meth, **kw)
            _assert_live_exact(bd, bi, m.snapshot().shards, qn, K)
    assert forced > 0
    assert m.live_count == len(live)
    assert sorted(m.snapshot().live_points()[1].tolist()) == sorted(live)
    for meth in BACKENDS:
        kw = dict(frac=1.0) if meth == "beam" else {}
        bd, bi = m.query(q, K, method=meth, **kw)
        _assert_live_exact(bd, bi, m.snapshot().shards, qn, K)


# --------------------------------------------------------------- clustered
@pytest.fixture(scope="module")
def clustered():
    x, q = make_p2h_dataset(5000, 24, kind="clustered", n_queries=8, seed=1)
    pol = dict(delta_capacity=600, tombstone_frac=0.95, max_segments=8)
    t = ShardedMutableP2HIndex.from_data(x[:4400], SHARDS, n0=64,
                                         device="cpu",
                                         policy=CompactionPolicy(**pol))
    j = JSharded.from_data(x[:4400], SHARDS, n0=64, policy=JPolicy(**pol))
    for m in (t, j):
        m.insert_batch(x[4400:])
        for g in range(0, 4400, 17):
            m.delete(g)
    return t, j, q


def _assert_oracle_exact(bd, bi, snap, q, k):
    """Held to the f32 oracle's ids at float64 distances."""
    X, G = snap.live_points()
    pts = torch.from_numpy(X)
    qn = torch.from_numpy(normalize_query(q))
    _, oi = exact_search(pts, qn, k + 1)
    by_gid = torch.zeros((int(G.max()) + 1, X.shape[1]))
    by_gid[torch.from_numpy(G.astype(np.int64))] = pts
    ref = torch.from_numpy(G.astype(np.int64))[oi.long()]
    assert_exact_topk(bd, bi, ref, by_gid, qn)


@pytest.mark.parametrize("kw", [dict(), dict(method="stacked"),
                                dict(method="pallas", stacked=False),
                                dict(method="dfs")],
                         ids=["auto", "stacked", "sequential", "dfs"])
def test_clustered_each_package_equals_the_oracle(clustered, kw):
    """On clustered data (norms near 25) the packages' f32 sums may differ
    by more than 1e-6, so each is held to the oracle on its own, at
    float64 distances."""
    t, j, q = clustered
    for m in (t, j):
        bd, bi = m.query(q, K, **kw)
        _assert_oracle_exact(np.array(bd), np.array(bi), t.snapshot(),
                             q, K)


# -------------------------------------------------------------------- mesh
def test_mesh_is_none_or_one_device(pair):
    """The serving mesh serves at any size: with ``None``, one position or
    two (``cpu`` twice), the index answers bit for bit as one program and
    ``stats()`` reports the positions and the signature; the exchange
    takes ``mesh=`` too.  A mesh of another device type is refused with
    ``ValueError``: it would move the work off the index's device."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel.sharding import mesh_devices, mesh_signature

    t, _ = pair
    assert mesh_signature()[:2] == ("default", "cpu")
    two = make_mesh((2,), ("shard",), devices=["cpu"] * 2)
    assert mesh_signature(two) == ("mesh", ("shard",), (2,), ("cpu", "cpu"),
                                   "cpu")
    assert mesh_devices(None) == 1 and mesh_devices(two) == 2
    q = _mkdata(2, seed=3, dim=DIM + 1)
    t.set_mesh(None)
    base = t.query(q, K)
    stacked = t.query(q, K, method="stacked")
    for mesh, n in ((None, 1), (make_mesh((1,), ("shard",),
                                          devices=["cpu"]), 1), (two, 2)):
        t.set_mesh(mesh)
        assert t.snapshot().mesh == mesh
        assert t.stats()["mesh_devices"] == n
        for want, got in ((base, t.query(q, K)),
                          (stacked, t.query(q, K, method="stacked"))):
            assert np.array_equal(want[0], got[0])
            assert np.array_equal(want[1], got[1])
    t.set_mesh(None)
    with pytest.raises(ValueError, match="device"):
        t.set_mesh(make_mesh((1,), ("shard",), devices=["cuda"]))
    d2, i2, _ = two_round_exchange(t.snapshot().shards, _queries(1), K,
                                   mesh=two, stacked=True)
    d1, i1, _ = two_round_exchange(t.snapshot().shards, _queries(1), K,
                                   stacked=True)
    assert np.array_equal(d1, d2) and np.array_equal(i1, i2)