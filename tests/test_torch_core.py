"""The PyTorch port's core against the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages as numpy
arrays; JAX stays on the CPU.  Tree arrays must be equal exactly (both
builds are the same host numpy); bounds, oracle and searches are held to
the parity rule of ``_torch_parity`` and the eight search counters must be
equal.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_topk_parity, oracle  # noqa: E402
from repro.core import balltree as jbt  # noqa: E402
from repro.core import bounds as jbounds  # noqa: E402
from repro.core import exact as jexact  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.data.pipeline import make_p2h_dataset as j_make  # noqa: E402
from repro_torch.core import balltree as tbt  # noqa: E402
from repro_torch.core import bounds as tbounds  # noqa: E402
from repro_torch.core import exact as texact  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.data.pipeline import make_p2h_dataset as t_make  # noqa: E402

KINDS = ("normal", "clustered", "planted", "unit", "heavy")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_tree_arrays(tree):
    return {f.name: np.asarray(getattr(tree, f.name))
            for f in dataclasses.fields(tree)
            if not f.metadata.get("static", False)}


def jax_tree_statics(tree):
    return {f.name: getattr(tree, f.name) for f in dataclasses.fields(tree)
            if f.metadata.get("static", False)}


def assert_trees_equal(ttree, jtree):
    jarr = jax_tree_arrays(jtree)
    assert set(jarr) == set(tbt.FlatTree.array_names())
    for name, ja in jarr.items():
        ta = getattr(ttree, name).numpy()
        assert ta.dtype == ja.dtype, name
        np.testing.assert_array_equal(ta, ja, err_msg=name)
    assert ttree.statics() == jax_tree_statics(jtree)


@pytest.fixture(scope="module")
def planted():
    """(raw data, normalized queries, port tree, jax tree), planted kind."""
    x, q = t_make(3000, 24, kind="planted", n_queries=12, seed=7)
    qn = tbt.normalize_query(q)
    return x, qn, tbt.build_tree(x, n0=64), jbt.build_tree(x, n0=64)


# ----------------------------------------------------------------------
# data, bounds, oracle
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_make_p2h_dataset_equal(kind):
    tx, tq = t_make(257, 12, kind=kind, n_queries=9, seed=3)
    jx, jq = j_make(257, 12, kind=kind, n_queries=9, seed=3)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(tq, jq)


@pytest.mark.parametrize("symmetric", [False, True])
def test_bounds_elementwise(symmetric):
    rng = np.random.default_rng(11)
    n = 4000
    ip = rng.normal(size=n).astype(np.float32) * 3
    qn = np.abs(rng.normal(size=n)).astype(np.float32) + 0.1
    r = np.abs(rng.normal(size=n)).astype(np.float32)
    cn = np.abs(rng.normal(size=n)).astype(np.float32)
    cn[:50] = 0.0  # the eps clamp
    xc = rng.normal(size=n).astype(np.float32)
    xs = np.abs(rng.normal(size=n)).astype(np.float32)
    close = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tbounds.node_ball_bound(_t(ip), _t(qn), _t(r)).numpy(),
        np.asarray(jbounds.node_ball_bound(ip, qn, r)), **close)
    np.testing.assert_allclose(
        tbounds.point_ball_bound(_t(ip), _t(qn), _t(r)).numpy(),
        np.asarray(jbounds.point_ball_bound(ip, qn, r)), **close)
    tc, ts = tbounds.query_angle_terms(_t(ip), _t(qn), _t(cn))
    jc, js = jbounds.query_angle_terms(ip, qn, cn)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **close)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **close)
    # both signs of q_cos and of x_cos, so every case of Theorem 3 is hit
    qc = rng.normal(size=n).astype(np.float32)
    qs = np.abs(rng.normal(size=n)).astype(np.float32)
    assert (qc <= 0).any() and (qc > 0).any()
    tcb = tbounds.point_cone_bound(_t(qc), _t(qs), _t(xc), _t(xs),
                                   symmetric=symmetric).numpy()
    jcb = np.asarray(jbounds.point_cone_bound(qc, qs, xc, xs,
                                              symmetric=symmetric))
    np.testing.assert_allclose(tcb, jcb, **close)
    assert (jcb > 0).any() and (jcb == 0).any()


@pytest.mark.parametrize("k", [1, 10])
def test_exact_search_matches_jax(k):
    x, q = t_make(2500, 20, kind="clustered", n_queries=16, seed=2)
    pts = tbt.append_ones(x)
    qn = tbt.normalize_query(q)
    td, ti = texact.exact_search(_t(pts), _t(qn), k=k, chunk=1024)
    jd, ji = jexact.exact_search(jnp.asarray(pts), jnp.asarray(qn), k=k,
                                 chunk=1024)
    _, _, nxt = oracle(pts, qn, k)
    assert ti.dtype == torch.int32
    assert_topk_parity(td.numpy(), ti.numpy(), np.asarray(jd),
                       np.asarray(ji), nxt)
    np.testing.assert_allclose(
        texact.p2h_dists(_t(pts), _t(qn)).numpy(),
        np.asarray(jexact.p2h_dists(jnp.asarray(pts), jnp.asarray(qn))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fault", [None, "dropped", "distance", "empty"])
def test_assert_exact_topk_holds_ids_at_float64(fault):
    """The exactness check of every exact route: the oracle's own f32
    answer passes (against the f32 and the float64 oracle's ids); a dropped
    true neighbour, a distance that is not its id's, and an empty slot
    fail."""
    x, q = t_make(2500, 20, kind="clustered", n_queries=16, seed=2)
    pts, qn = tbt.append_ones(x), tbt.normalize_query(q)
    k = 10
    d, i = (a.numpy() for a in texact.exact_search(_t(pts), _t(qn), k + 2))
    ans_d, ans_i = d[:, :k].copy(), i[:, :k].copy()
    # a row whose k-th, (k+1)-th and (k+2)-th distances are well apart
    gaps = np.minimum(d[:, k] - d[:, k - 1], d[:, k + 1] - d[:, k])
    r = int(np.argmax(gaps))
    assert gaps[r] > 1e-5
    if fault == "dropped":  # the (k+2)-th point in place of the k-th
        ans_d[r, -1], ans_i[r, -1] = d[r, k + 1], i[r, k + 1]
    elif fault == "distance":
        ans_d[r, 0] += 1e-3
    elif fault == "empty":
        ans_d[r, -1], ans_i[r, -1] = np.inf, -1
    args = (ans_d, ans_i, i[:, :k + 1], _t(pts), _t(qn))
    if fault is None:
        assert texact.assert_exact_topk(*args) < 1e-5
        assert texact.assert_exact_topk(ans_d, ans_i, oracle(pts, qn, k + 1)[1],
                                        _t(pts), _t(qn)) < 1e-5
        return
    match = {"dropped": "differ|row", "distance": "not an f32 evaluation",
             "empty": "empty"}[fault]
    with pytest.raises(AssertionError, match=match):
        texact.assert_exact_topk(*args)


# ----------------------------------------------------------------------
# tree build: equal arrays, exactly
# ----------------------------------------------------------------------


@pytest.mark.parametrize("kind,n,d,n0,seed", [
    ("planted", 3000, 32, 128, 0),
    ("clustered", 2000, 16, 64, 1),
    ("heavy", 700, 9, 32, 2),
    ("unit", 513, 7, 128, 3),
])
def test_build_tree_equal(kind, n, d, n0, seed):
    x, _ = t_make(n, d, kind=kind, n_queries=1, seed=seed)
    ttree = tbt.build_tree(x, n0=n0, seed=seed)
    jtree = jbt.build_tree(x, n0=n0, seed=seed)
    assert_trees_equal(ttree, jtree)
    assert ttree.index_bytes() == jtree.index_bytes()
    assert ttree.index_bytes(bc=False) == jtree.index_bytes(bc=False)
    # the carry-across function takes the JAX tree's arrays unchanged
    assert_trees_equal(tbt.FlatTree.from_numpy(
        jax_tree_arrays(jtree), jax_tree_statics(jtree)), jtree)
    # leaf padding
    L = ttree.num_leaves
    target = -(-(L + 1) // tbt.leaf_pad_quantum(L)) * tbt.leaf_pad_quantum(L)
    assert tbt.leaf_pad_quantum(L) == jbt.leaf_pad_quantum(L)
    assert_trees_equal(tbt.pad_tree_leaves(ttree, target),
                       jbt.pad_tree_leaves(jtree, target))
    assert tbt.built_leaves(tbt.pad_tree_leaves(ttree, target)) == \
        jbt.built_leaves(jbt.pad_tree_leaves(jtree, target)) == L


def test_query_helpers_equal():
    rng = np.random.default_rng(5)
    q = rng.normal(size=(6, 9)).astype(np.float32)
    q[0, :-1] = 0.0  # zero normal: scale guard
    np.testing.assert_array_equal(tbt.normalize_query(q),
                                  jbt.normalize_query(q))
    np.testing.assert_array_equal(tbt.append_ones(q), jbt.append_ones(q))
    for L in (1, 128, 129, 512, 513, 5000):
        assert tbt.leaf_pad_quantum(L) == jbt.leaf_pad_quantum(L)


def test_flat_tree_to_device_and_back(planted):
    _, _, ttree, jtree = planted
    moved = ttree.to("cpu")
    assert moved.device == torch.device("cpu")
    assert_trees_equal(moved, jtree)
    assert ttree.to_numpy().keys() == jax_tree_arrays(jtree).keys()


# ----------------------------------------------------------------------
# merge
# ----------------------------------------------------------------------


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(9)
    B, M, k = 5, 30, 6
    d = np.round(rng.uniform(0, 3, size=(B, M)), 1).astype(np.float32)
    i = rng.integers(0, 12, size=(B, M)).astype(np.int32)  # duplicate ids
    d[:, -3:] = np.inf
    i[:, -3:] = -1
    td, ti = tsearch.merge_topk(_t(d), _t(i), k)
    jd, ji = jsearch.merge_topk(jnp.asarray(d), jnp.asarray(i), k)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    planes_d = d.reshape(B, 3, 10).transpose(1, 0, 2).copy()
    planes_i = i.reshape(B, 3, 10).transpose(1, 0, 2).copy()
    td, ti = tsearch.merge_topk_planes(_t(planes_d), _t(planes_i), k,
                                       _t(d[:, :4]), _t(i[:, :4]))
    jd, ji = jsearch.merge_topk_planes(planes_d, planes_i, k,
                                       d[:, :4], i[:, :4])
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# ----------------------------------------------------------------------
# searches: answers and all eight counters
# ----------------------------------------------------------------------


def _check_search(planted, tout, jout, k, exact=True):
    x, qn, _, _ = planted
    td, ti, tc = tout
    jd, ji, jc = jout
    nxt = oracle(tbt.append_ones(x), qn, k)[2] if exact else None
    assert_topk_parity(td.numpy(), ti.numpy(), np.asarray(jd),
                       np.asarray(ji), nxt)
    assert tsearch.SearchStats(tc) == jsearch.SearchStats(jc)
    if exact:
        od, _, _ = oracle(tbt.append_ones(x), qn, k)
        np.testing.assert_allclose(td.numpy(), od, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kw", [
    dict(k=1),
    dict(k=10, order="bound"),
    dict(k=5, use_ball=False, use_cone=False),
    dict(k=5, use_cone=False),
    dict(k=10, frac=0.2),  # beam
    dict(k=10, lambda_cap="kth"),
], ids=lambda kw: "-".join(f"{a}={b}" for a, b in kw.items()))
def test_sweep_matches_jax(planted, kw):
    x, qn, ttree, jtree = planted
    kw = dict(kw)
    k = kw.pop("k")
    if kw.get("lambda_cap") == "kth":  # a valid cap: the true k-th, widened
        kw["lambda_cap"] = (oracle(tbt.append_ones(x), qn, k)[0][:, -1]
                            * 1.001).astype(np.float32)
    tkw = dict(kw)
    if "lambda_cap" in tkw:
        tkw["lambda_cap"] = _t(tkw["lambda_cap"])
    tout = tsearch.sweep_search(ttree, _t(qn), k, **tkw)
    jout = jsearch.sweep_search(jtree, jnp.asarray(qn), k, **kw)
    _check_search(planted, tout, jout, k, exact=kw.get("frac", 1.0) == 1.0)


def test_beam_is_budgeted_sweep(planted):
    _, qn, ttree, jtree = planted
    tout = tsearch.beam_search(ttree, _t(qn), 4, frac=0.1)
    jout = jsearch.beam_search(jtree, jnp.asarray(qn), 4, frac=0.1)
    _check_search(planted, tout, jout, 4, exact=False)


@pytest.mark.parametrize("kw", [
    dict(k=1),
    dict(k=10),
    dict(k=5, branch="bound"),
    dict(k=5, use_collab=False),
    dict(k=5, use_ball=False, use_cone=False),
    dict(k=10, max_candidates=150),
    dict(k=10, lambda_cap="kth"),
], ids=lambda kw: "-".join(f"{a}={b}" for a, b in kw.items()))
def test_dfs_matches_jax(planted, kw):
    x, qn, ttree, jtree = planted
    kw = dict(kw)
    k = kw.pop("k")
    if kw.get("lambda_cap") == "kth":
        kw["lambda_cap"] = (oracle(tbt.append_ones(x), qn, k)[0][:, -1]
                            * 1.001).astype(np.float32)
    tkw = dict(kw)
    if "lambda_cap" in tkw:
        tkw["lambda_cap"] = _t(tkw["lambda_cap"])
    tout = tsearch.dfs_search(ttree, _t(qn), k, **tkw)
    jout = jsearch.dfs_search(jtree, jnp.asarray(qn), k, **kw)
    _check_search(planted, tout, jout, k,
                  exact="max_candidates" not in kw)
