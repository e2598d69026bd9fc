"""The port's hashing baselines (NH, FH) against the JAX package's, on the
CPU: the transforms and the tables bit for bit, the queries' ``verified``
counts equal and their answers within the tie rule, the same through
``from_arrays`` on the JAX package's tables, and the reference's own five
tests rerun on the port."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_topk_parity  # noqa: E402
from repro.core import transform as JT  # noqa: E402
from repro.core.fh import FHIndex as JFH  # noqa: E402
from repro.core.nh import NHIndex as JNH  # noqa: E402
from repro_torch.core import transform as T  # noqa: E402
from repro_torch.core.api import P2HIndex  # noqa: E402
from repro_torch.core.balltree import append_ones, normalize_query  # noqa: E402
from repro_torch.core.exact import exact_search, verify_candidates  # noqa: E402
from repro_torch.core.fh import FHIndex  # noqa: E402
from repro_torch.core.nh import NHIndex  # noqa: E402

D = 8  # data width; the points carry D + 1 coordinates
LAMS = [None, 4 * D]


def _data(n=600, d=D, seed=0, queries=9):
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(4, d)) * 3
    x = (cents[rng.integers(0, 4, n)] + rng.normal(size=(n, d))).astype(
        np.float32)
    return x, rng.normal(size=(queries, d + 1)).astype(np.float32)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_answers(got, want):
    """The port's ``query`` against the reference's: ``verified`` equal,
    distances within the tie rule's tolerance, ids equal apart from ties,
    inf / -1 in the same slots."""
    gd, gi, gs = got
    wd, wi, ws = want
    assert gs == ws
    np.testing.assert_array_equal(np.isinf(gd), np.isinf(wd))
    np.testing.assert_array_equal(gi < 0, np.asarray(wi) < 0)
    assert_topk_parity(gd, gi, wd, wi)


# ------------------------------------------------------------- transforms
def test_transforms_are_bit_equal():
    x, q = _data()
    X = append_ones(x)
    pairs = T.sample_pairs(D + 1, 4 * D, np.random.default_rng(3))
    np.testing.assert_array_equal(
        pairs, JT.sample_pairs(D + 1, 4 * D, np.random.default_rng(3)))
    for fx, jfx in ((T.lift(X), JT.lift(X)),
                    (T.sampled_lift(X, pairs), JT.sampled_lift(X, pairs))):
        assert fx.dtype == np.float32
        np.testing.assert_array_equal(fx, jfx)
        px, M = T.nh_data_transform(fx)
        jpx, jM = JT.nh_data_transform(jfx)
        np.testing.assert_array_equal(px, jpx)
        assert M == jM
    np.testing.assert_array_equal(T.nh_query_transform(T.lift(q)),
                                  JT.nh_query_transform(JT.lift(q)))
    assert T.lift_dim(D + 1) == JT.lift_dim(D + 1) == 45


# ----------------------------------------------------------------- tables
@pytest.mark.parametrize("lam", LAMS)
def test_nh_tables_are_bit_equal(lam):
    x, _ = _data()
    port = NHIndex.build(x, m=12, lam=lam, seed=5, device="cpu")
    ref = JNH.build(x, m=12, lam=lam, seed=5)
    for name in ("proj", "bias", "bucket_keys", "bucket_ids"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    if lam is None:
        assert port.lifted_pairs is None and ref.lifted_pairs is None
    else:
        np.testing.assert_array_equal(port.lifted_pairs, ref.lifted_pairs)
    np.testing.assert_array_equal(port.data.numpy(), ref.data)
    assert port.M == ref.M and port.width == ref.width
    assert port.index_bytes() == ref.index_bytes()
    assert port.build_seconds > 0 and port.upload_seconds >= 0


@pytest.mark.parametrize("lam", LAMS)
def test_fh_tables_are_bit_equal(lam):
    x, _ = _data(n=601)  # n / l not whole: Python's round splits it
    port = FHIndex.build(x, m=12, l=4, lam=lam, seed=5, device="cpu")
    ref = JFH.build(x, m=12, l=4, lam=lam, seed=5)
    assert port.part_slices == ref.part_slices
    for name in ("proj", "sorted_vals", "sorted_ids"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    np.testing.assert_array_equal(port.data.numpy(), ref.data)
    assert port.index_bytes() == ref.index_bytes()


def test_entry_points_need_a_device(monkeypatch):
    """No CUDA device and no ``device=``: an error, never the host."""
    x, _ = _data(n=64)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (NHIndex.build, FHIndex.build):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(x, m=4)
    ref = JNH.build(x, m=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        NHIndex.from_arrays(**_fields(ref))
    port = NHIndex.build(x, m=4, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.to(None)


# ---------------------------------------------------------------- queries
NH_CASES = {
    # name -> (build kwargs, query kwargs)
    "defaults": (dict(m=16), dict(k=5)),
    "no normalize": (dict(m=16), dict(k=5, normalize=False)),
    "subsample": (dict(m=16, lam=4 * D), dict(k=5, budget=40)),
    "early break": (dict(m=16, width=40.0), dict(k=5, budget=20)),
    "k above the candidates": (dict(m=16), dict(k=12, budget=7)),
    "empty rows": (dict(m=4, width=0.01), dict(k=3, probes=0)),
    "narrow windows": (dict(m=16, width=0.3), dict(k=5)),
}


@pytest.mark.parametrize("case", sorted(NH_CASES))
@pytest.mark.parametrize("tables", ["port build", "from_arrays"])
def test_nh_queries_match(case, tables):
    build_kw, query_kw = NH_CASES[case]
    x, q = _data()
    ref = JNH.build(x, seed=1, **build_kw)
    port = (NHIndex.build(x, seed=1, device="cpu", **build_kw)
            if tables == "port build"
            else NHIndex.from_arrays(**_fields(ref), device="cpu"))
    want = ref.query(q, **query_kw)
    got = port.query(q, **query_kw)
    _assert_answers(got, want)
    _, cand = port.candidates(q, **{k: v for k, v in query_kw.items()
                                     if k != "k"})
    lens = np.array([len(c) for c in cand])
    assert got[2]["verified"] == lens.sum()
    if case == "k above the candidates":
        assert (lens < query_kw["k"]).all() and (got[1] < 0).any()
    if case == "empty rows":
        assert (lens == 0).any() and (got[1] == -1).all(axis=1).any()
    if case == "subsample":
        budget = query_kw["budget"]
        assert (lens == budget).all()
        wide = port.candidates(q, budget=10 ** 6)[1]
        assert max(len(c) for c in wide) > budget


@pytest.mark.parametrize("case,wide", [("defaults", True),
                                       ("early break", True),
                                       ("subsample", True),
                                       ("narrow windows", False)])
def test_nh_candidates_are_the_reference_loops(case, wide):
    """The port's candidate sets, a bitmap's union of the windows, equal
    the JAX package's loop (``np.unique`` of the concatenated windows)
    written out here, for windows that hold an eighth of the points or
    more (``wide``) and for narrower ones."""
    build_kw, query_kw = NH_CASES[case]
    budget = query_kw.get("budget", 4096)
    x, q = _data()
    port = NHIndex.build(x, seed=1, device="cpu", **build_kw)
    qq, got = port.candidates(q, budget=budget)
    hq = np.floor((port._lift_query(qq) @ port.proj.T + port.bias)
                  / port.width).astype(np.int32)
    n = len(x)
    widths = set()
    for b in range(len(q)):
        cand, count = [], 0
        for t, keys in enumerate(port.bucket_keys):
            lo = np.searchsorted(keys, hq[b, t] - 2, "left")
            hi = np.searchsorted(keys, hq[b, t] + 2, "right")
            cand.append(port.bucket_ids[t, lo:hi])
            count += hi - lo
            if count >= budget * 4:
                break
        widths.add(8 * count >= n)
        c = np.unique(np.concatenate(cand))
        if len(c) > budget:
            c = c[np.random.default_rng(0).permutation(len(c))[:budget]]
        assert got[b].dtype == c.dtype
        np.testing.assert_array_equal(got[b], c)
    assert widths == {wide}  # every query's windows as wide as the case


def test_nh_early_break_fires():
    """The "early break" case stops probing before its last table."""
    build_kw, query_kw = NH_CASES["early break"]
    x, q = _data()
    port = NHIndex.build(x, seed=1, device="cpu", **build_kw)
    qq = normalize_query(q).astype(np.float32)
    hq = np.floor((port._lift_query(qq) @ port.proj.T + port.bias)
                  / port.width).astype(np.int32)
    sizes = np.array([[np.searchsorted(keys, hq[b, t] + 2, "right")
                       - np.searchsorted(keys, hq[b, t] - 2, "left")
                       for t, keys in enumerate(port.bucket_keys)]
                      for b in range(len(q))])
    stop = query_kw["budget"] * 4
    assert (np.cumsum(sizes, axis=1)[:, :-1] >= stop).any()


FH_CASES = {
    "defaults": (dict(m=8), dict(k=5)),
    "no normalize": (dict(m=8, lam=4 * D), dict(k=5, normalize=False)),
    "subsample": (dict(m=16, l=2), dict(k=5, budget=30)),
    "k above the candidates": (dict(m=2, l=2), dict(k=12, budget=8)),
}


@pytest.mark.parametrize("case", sorted(FH_CASES))
@pytest.mark.parametrize("tables", ["port build", "from_arrays"])
def test_fh_queries_match(case, tables):
    build_kw, query_kw = FH_CASES[case]
    x, q = _data(n=601)
    ref = JFH.build(x, seed=2, **build_kw)
    port = (FHIndex.build(x, seed=2, device="cpu", **build_kw)
            if tables == "port build"
            else FHIndex.from_arrays(**_fields(ref), device="cpu"))
    want = ref.query(q, **query_kw)
    got = port.query(q, **query_kw)
    _assert_answers(got, want)
    lens = np.array([len(c) for c in port.candidates(
        q, **{k: v for k, v in query_kw.items() if k != "k"})[1]])
    if case == "k above the candidates":
        assert (lens < query_kw["k"]).all() and (got[1] < 0).any()
    if case == "subsample":
        assert (lens == query_kw["budget"]).all()


def test_verify_candidates_is_the_top_k_of_each_set():
    """The batched pass equals a float64 top-k over each query's own set,
    across chunk edges and with empty and short sets."""
    rng = np.random.default_rng(7)
    pts = torch.from_numpy(rng.normal(size=(300, 5)).astype(np.float32))
    qs = torch.from_numpy(rng.normal(size=(7, 5)).astype(np.float32))
    cand = [rng.choice(300, size, replace=False).astype(np.int32)
            for size in (40, 0, 2, 300, 17, 5, 60)]
    bd, bi = verify_candidates(pts, qs, cand, 4, chunk=3)
    for b, c in enumerate(cand):
        d64 = np.abs(pts.double().numpy()[c] @ qs.double().numpy()[b])
        order = np.argsort(d64, kind="stable")[:4]
        want_d = np.full(4, np.inf)
        want_i = np.full(4, -1)
        want_d[:len(order)], want_i[:len(order)] = d64[order], c[order]
        assert_topk_parity(bd[b:b + 1].numpy(), bi[b:b + 1].numpy(),
                           want_d[None], want_i[None])


# ------------------------------------- the reference's five tests, on the port
def test_lift_identity():
    """<f(x), f(q)> == <x,q>^2 (the asymmetric-transform key identity)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(20, 9)).astype(np.float32)
    q = rng.normal(size=(5, 9)).astype(np.float32)
    np.testing.assert_allclose(T.lift(x) @ T.lift(q).T, (x @ q.T) ** 2,
                               rtol=1e-3, atol=1e-3)


def test_nh_transform_geometry():
    """All NH-transformed data share norm M; distance monotone in <x,q>^2."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(50, 6)).astype(np.float32)
    px, M = T.nh_data_transform(T.lift(x))
    np.testing.assert_allclose(np.linalg.norm(px, axis=1), M, rtol=1e-3)
    q = rng.normal(size=(1, 6)).astype(np.float32)
    qz = T.nh_query_transform(T.lift(q))
    de = ((px - qz) ** 2).sum(axis=1)
    order = np.argsort(((x @ q[0]) ** 2).astype(np.float64))
    assert (np.diff(de[order]) >= -1e-2 * (1 + de.max())).all()


def test_sampled_lift_unbiasedness():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 16)).astype(np.float32)
    q = rng.normal(size=(1, 16)).astype(np.float32)
    pairs = T.sample_pairs(16, 20000, rng)
    est = float((T.sampled_lift(x, pairs) * T.sampled_lift(q, pairs)).sum()
                * (16 * 16 / 20000))
    true = float((x @ q.T)[0, 0] ** 2)
    assert abs(est - true) < 0.35 * (1 + abs(true))


@pytest.mark.parametrize("builder", [NHIndex, FHIndex])
def test_hash_index_recall_increases_with_budget(builder):
    rng = np.random.default_rng(3)
    cents = rng.normal(size=(6, 20)) * 4
    data = (cents[rng.integers(0, 6, 4000)]
            + rng.normal(size=(4000, 20))).astype(np.float32)
    q = rng.normal(size=(8, 21)).astype(np.float32)
    idx = builder.build(data, m=32, device="cpu")
    _, ei = exact_search(torch.from_numpy(append_ones(data)),
                         torch.from_numpy(normalize_query(q)), k=10)
    ei = ei.numpy()

    def recall(budget):
        _, ni, _ = idx.query(q, k=10, budget=budget)
        return np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ei, ni)])

    r_small, r_big, r_full = recall(200), recall(2000), recall(4000)
    assert r_small <= r_big + 0.05
    assert r_full >= max(r_small, 0.15)


def test_index_size_gap_vs_tree():
    """Table III trend: hashing index orders of magnitude larger than tree."""
    data = np.random.default_rng(4).normal(size=(5000, 32)).astype(np.float32)
    bc = P2HIndex.build(data, n0=256, device="cpu")
    nh = NHIndex.build(data, m=64, device="cpu")
    assert nh.index_bytes() > 5 * bc.report.index_bytes


def test_exact_check_is_the_oracle():
    x, q = _data()
    port = NHIndex.build(x, m=4, device="cpu")
    want = JNH.build(x, m=4).exact_check(q, k=3)
    got = port.exact_check(q, k=3)
    assert_topk_parity(got[0].numpy(), got[1].numpy(), np.asarray(want[0]),
                       np.asarray(want[1]))
