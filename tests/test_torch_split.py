"""The sweep kernels' split visit schedule, on the CPU.

``p2h_sweep_ref(split=S)`` is the plain version of the card's schedule: a
query block walked by ``S`` workers, worker ``s`` taking visit entry
``r * S + s`` in round ``r`` against the round's shared lambda (the k-th
smallest of the union of the workers' top-ks).  Pruning only by valid
bounds, every schedule must give the exact top-k of the visited tiles; and
``split=1`` must stay the JAX package's single walker, skip counts
included.  ``stacked_sweep_ref(split=S)`` runs the same schedule inside
each segment of a stack, with a merge of the workers' top-ks and the
``glob`` fold at each segment's end.  The block-size and split defaults
are pure functions, tested here; the kernels themselves run on the card
(``tests/test_torch_gpu.py``).  So do the two facts the stacked kernel's
single f32 engine rests on, tested here on their own: bf16 and int8
values widen to f32 exactly, and a column-ordered f32 FMA sum of widened
int8 products is the exact int32 dot.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_topk_parity  # noqa: E402
from repro.core import balltree as jbt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import stacked_sweep as jss  # noqa: E402
from repro_torch.core import balltree as tbt  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.core.exact import exact_search  # noqa: E402
from repro_torch.data.pipeline import make_p2h_dataset  # noqa: E402
from repro_torch.kernels import ops, p2h_scan, ref  # noqa: E402
from repro_torch.kernels import stacked_sweep as tss  # noqa: E402

BQS = (1, 8, 16, 32, 64)
SPLITS = (1, 2, 4, 8)


@pytest.fixture(scope="module", params=[(16, 32), (31, 64)],
                ids=["d16-n0_32", "d31-n0_64"])
def tree_data(request):
    """A small planted set: (points with the appended 1, normalised
    queries, tree)."""
    d, n0 = request.param
    x, q = make_p2h_dataset(3000, d, kind="planted", n_queries=70, seed=7)
    return (tbt.append_ones(x), tbt.normalize_query(q),
            tbt.build_tree(x, n0=n0, seed=7))


def _visited_oracle(pts, qn, ops_, bq, k, B0):
    """Float64 brute force over the points of each block's visited tiles:
    ``(dists, ids, kth_next)`` of the first ``B0`` queries."""
    ids = ops_["ids_tiles"].numpy()
    visit = ops_["visit"].numpy()
    d = np.abs(qn.astype(np.float64) @ pts.astype(np.float64).T)
    od = np.full((B0, k), np.inf)
    oi = np.full((B0, k), -1, np.int64)
    nxt = np.full(B0, np.inf)
    for b in range(B0):
        cand = ids[visit[b // bq]].ravel()
        cand = cand[cand >= 0]
        order = np.argsort(d[b, cand], kind="stable")[:k + 1]
        dd = d[b, cand[order]]
        m = min(k, len(order))
        od[b, :m], oi[b, :m] = dd[:m], cand[order[:m]]
        if len(order) > k:
            nxt[b] = dd[k]
    return od, oi, nxt


def _config(i):
    """The i-th mix of k, visit budget, cap and bound toggles."""
    k = (1, 5, 10, 23)[i % 4]
    frac = (1.0, 0.4, 1.0, 0.7, 1.0)[i % 5]
    capped = i % 3 == 1
    use_ball, use_cone = ((True, True), (True, False), (False, True),
                          (True, True), (False, False))[i % 5]
    return k, frac, capped, use_ball, use_cone


@pytest.mark.parametrize("bq", BQS)
@pytest.mark.parametrize("split", SPLITS)
def test_split_schedule_is_exact_and_split_free(tree_data, bq, split):
    """Every schedule answers the exact top-k of the visited tiles (frac <
    1 visits a prefix of each block's list; a valid finite cap prunes
    nothing of the answer), and the answer is the same for every split."""
    pts, qn, tree = tree_data
    i = BQS.index(bq) * len(SPLITS) + SPLITS.index(split)
    k, frac, capped, use_ball, use_cone = _config(i)
    B0 = len(qn)
    cap = None
    if capped:  # the true k-th, widened: a valid upper bound
        kth = np.sort(np.abs(qn.astype(np.float64) @ pts.T.astype(
            np.float64)), axis=1)[:, k - 1]
        cap = torch.from_numpy((kth * 1.01 + 1e-6).astype(np.float32))
    ops_, _ = ops.prepare_operands(tree, torch.from_numpy(qn), frac=frac,
                                   bq=bq, lambda_cap=cap)
    kw = dict(k=k, bq=bq, use_ball=use_ball, use_cone=use_cone)
    d, ids, skips = ref.p2h_sweep_ref(**ops_, split=split, **kw)
    od, oi, nxt = _visited_oracle(pts, qn, ops_, bq, k, B0)
    assert_topk_parity(d[:B0].numpy(), ids[:B0].numpy(), od, oi, nxt)
    d1, i1, _ = ref.p2h_sweep_ref(**ops_, split=1, **kw)
    assert torch.equal(d, d1)
    assert_topk_parity(d.numpy(), ids.numpy(), d1.numpy(), i1.numpy())
    assert skips.shape == (ops_["visit"].shape[0], 1)
    assert skips.dtype == torch.int32


@pytest.mark.parametrize("bq,split", [(8, 4), (16, 8), (64, 2), (1, 8)])
def test_split_skip_counts_are_deterministic(tree_data, bq, split):
    pts, qn, tree = tree_data
    ops_, _ = ops.prepare_operands(tree, torch.from_numpy(qn), bq=bq)
    a = ref.p2h_sweep_ref(**ops_, k=10, bq=bq, split=split,
                          return_live=True)
    b = ref.p2h_sweep_ref(**ops_, k=10, bq=bq, split=split,
                          return_live=True)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    # the skips are the visits the live mask leaves out
    np.testing.assert_array_equal((~a[3]).sum(1).numpy(),
                                  a[2][:, 0].numpy())


def test_split_prunes_more_than_nothing():
    """Shared lambda does its work: on a planted set whose blocks skip at
    split=1, the split schedules skip tiles too (fewer than or as many as
    one walker, which has the tightest lambda at every step)."""
    x, q = make_p2h_dataset(4000, 32, kind="planted", n_queries=13, seed=4)
    tree = tbt.build_tree(x, n0=32)
    ops_, _ = ops.prepare_operands(tree, torch.from_numpy(
        tbt.normalize_query(q)))
    one = int(ref.p2h_sweep_ref(**ops_, k=10, split=1)[2].sum())
    assert one > 0
    for split in (2, 4, 8):
        many = int(ref.p2h_sweep_ref(**ops_, k=10, split=split)[2].sum())
        assert 0 < many <= one


@pytest.mark.parametrize("bq", [1, 8, 16])
def test_split1_is_the_jax_schedule(bq):
    """``split=1`` equals the JAX package's plain sweep at the same block
    size, skip counts included."""
    x, q = make_p2h_dataset(4000, 32, kind="planted", n_queries=21, seed=4)
    qn = tbt.normalize_query(q)
    ttree, jtree = tbt.build_tree(x, n0=32), jbt.build_tree(x, n0=32)
    tops, _ = ops.prepare_operands(ttree, torch.from_numpy(qn), bq=bq)
    jop, _ = jops.prepare_operands(jtree, jnp.asarray(qn), bq=bq)
    td, ti, ts = ref.p2h_sweep_ref(**tops, k=10, bq=bq, split=1)
    jd, ji, js = jref.p2h_sweep_ref(**jop, k=10, bq=bq)
    assert_topk_parity(td.numpy(), ti.numpy(), np.asarray(jd),
                       np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts > 0).any()


def test_split_seed_goes_to_the_first_worker(tree_data):
    pts, qn, tree = tree_data
    ops_, _ = ops.prepare_operands(tree, torch.from_numpy(qn))
    B, k = ops_["queries"].shape[0], 5
    rng = np.random.default_rng(0)
    sd = torch.from_numpy(np.sort(rng.uniform(0.001, 0.01, (B, k)).astype(
        np.float32), 1))
    si = torch.from_numpy(rng.integers(10**6, 2 * 10**6, (B, k)).astype(
        np.int32))
    one = ref.p2h_sweep_ref(**ops_, k=k, split=1, seed_d=sd, seed_i=si)
    four = ref.p2h_sweep_ref(**ops_, k=k, split=4, seed_d=sd, seed_i=si)
    assert torch.equal(one[0], four[0])
    assert_topk_parity(one[0].numpy(), one[1].numpy(), four[0].numpy(),
                       four[1].numpy())


def test_wrapper_host_route_takes_split(tree_data):
    _, qn, tree = tree_data
    ops_, _ = ops.prepare_operands(tree, torch.from_numpy(qn), bq=16)
    a = p2h_scan.p2h_sweep(**ops_, k=7, bq=16, split=4)
    b = ref.p2h_sweep_ref(**ops_, k=7, bq=16, split=4)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    # split=None on the host is one walker
    c = p2h_scan.p2h_sweep(**ops_, k=7, bq=16)
    d = ref.p2h_sweep_ref(**ops_, k=7, bq=16, split=1)
    for u, v in zip(c, d):
        assert torch.equal(u, v)


@pytest.mark.parametrize("batch,want", [
    (1, 1), (2, 2), (3, 4), (5, 8), (8, 8), (9, 16), (17, 32), (33, 64),
    (64, 64), (65, 64), (1024, 64), (100_000, 64)])
def test_card_bq_rule(batch, want):
    assert p2h_scan.card_bq(batch) == want
    assert p2h_scan.resolve_bq(None, batch, torch.device("cuda")) == want
    assert p2h_scan.resolve_bq(None, batch, "cpu") == 8  # the JAX default
    assert p2h_scan.resolve_bq(4, batch, "cuda") == 4  # an explicit bq


@pytest.mark.parametrize("nqb,sms,clusters,want", [
    (16, 132, None, 8),        # 1024 queries at bq=64: 128 CTAs
    (16, 132, {8: 15}, 7),     # 15 clusters of 8 fit: 16 of 7 run at once
    (128, 132, None, 1),       # bq=8 on 1024 queries: one CTA per block
    (20, 132, None, 6),
    (33, 132, None, 4),
    (1, 132, None, 8),
    (200, 132, None, 1),       # more blocks than SMs
    (16, 132, {s: 0 for s in range(2, 9)}, 1),
])
def test_card_split_rule(nqb, sms, clusters, want):
    fn = None if clusters is None else (lambda s: clusters.get(s, 10**6))
    assert p2h_scan.card_split(nqb, sms, fn) == want
    assert p2h_scan.resolve_split(None, nqb, "cpu") == 1
    assert p2h_scan.resolve_split(3, nqb, "cpu") == 3


def test_kernel_backend_defaults_on_the_host(tree_data):
    """``sweep_search_kernel`` with ``bq=None`` runs the JAX package's
    block of 8 and one walker on the host: the same answers and counters
    as an explicit ``bq=8, split=1``."""
    _, qn, tree = tree_data
    q = torch.from_numpy(qn)
    a = ops.sweep_search_kernel(tree, q, 10)
    b = ops.sweep_search_kernel(tree, q, 10, bq=8, split=1)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    c = ops.sweep_search_kernel(tree, q, 10, bq=32, split=4)
    assert_topk_parity(c[0].numpy(), c[1].numpy(), a[0].numpy(),
                       a[1].numpy())


@pytest.mark.parametrize("split", [0, 9])
def test_wrapper_rejects_unsupported_split(tree_data, split):
    _, qn, tree = tree_data
    ops_, _ = ops.prepare_operands(tree, torch.from_numpy(qn))
    with pytest.raises(ValueError, match="split"):
        p2h_scan._check(ops_, k=3, bq=8, split=split)
    with pytest.raises(ValueError, match="bq"):
        p2h_scan._check(ops_, k=3, bq=128, split=1)


# ------------------------------------------- the stacked plain version
SDIM = 12


class _Seg:
    """Segment stand-in (uid/tree/gids) over one package's tree."""

    def __init__(self, uid, tree, gids):
        self.uid, self.tree, self.gids = uid, tree, np.asarray(gids, np.int32)


def _segments(N, n0, seed, sizes=(600, 230, 1, 410, 180)):
    """Both packages' segments over the same points, ``N`` of them: ragged
    tile counts, a dead tile (every point of segment 0's first leaf
    deleted), and from N = 3 on a single-point segment; at N = 5 the last
    segment is dead and the stack's bucket adds a pad row."""
    rng = np.random.default_rng(seed)
    sizes = sizes[:N]
    jsegs, tsegs, gid = [], [], 0
    for u, n in enumerate(sizes):
        pts = tbt.append_ones(rng.normal(size=(n, SDIM)).astype(np.float32))
        jt = jbt.build_tree(pts, n0=n0, append_one=False)
        tt = tbt.build_tree(pts, n0=n0, append_one=False)
        pid = np.array(tt.point_ids.numpy())
        if u == 0:
            pid[:n0] = -1  # the first leaf's tile
        if u == 4:
            pid[:] = -1
        jt = dataclasses.replace(jt, point_ids=jnp.asarray(pid))
        tt = tt.with_point_ids(torch.from_numpy(pid))
        gids = np.arange(gid, gid + n)
        jsegs.append(_Seg(u, jt, gids))
        tsegs.append(_Seg(u, tt, gids))
        gid += n
    return jsegs, tsegs


@pytest.fixture(scope="module", params=[(1, 32), (3, 64), (5, 32)],
                ids=["N1-n0_32", "N3-n0_64", "N5-n0_32"])
def stack(request):
    """(torch stack, JAX stack, bucket-padded torch grid + its quantised
    planes) of ``N`` segments."""
    N, n0 = request.param
    jsegs, tsegs = _segments(N, n0, seed=N)
    ts = tss.StackedLeaves.from_segments(tsegs)
    js = jss.StackedLeaves.from_segments(jsegs)
    return ts, js


def _stack_ops(ts, q, bq, probe_dtype, cap=None):
    """The host route's operands of ``q`` against ``ts``'s bucket-padded
    grid, at ``bq``: ``(ops, kw)`` as ``_run_stacked`` builds them."""
    arrays, _ = tss._bucketed_arrays(ts, use_kernel=False,
                                     probe_dtype=probe_dtype)
    qpts, qscale = arrays.pop("qpts", None), arrays.pop("qscale", None)
    grid = tss.StackedLeaves(**arrays, uids=(), n0=ts.n0, d=ts.d)
    ops_, _ = tss.prepare_stacked_operands(grid, torch.from_numpy(q), bq=bq,
                                           lambda_cap=cap)
    kw = {}
    if probe_dtype != "f32":
        ops_, kw = tss._quant_probe_operands(
            probe_dtype, ops_, qpts, qscale, grid.leaf_radii,
            grid.leaf_cnorm, ts.d)
    return ops_, kw


def _live_oracle(ts, q, k):
    """Float32 exact top-k over the stack's live points, global ids."""
    ids = ts.ids.reshape(-1)
    live = ids >= 0
    pts = ts.pts.reshape(-1, ts.d)[live]
    d, i = exact_search(pts, torch.from_numpy(q), k + 1)
    return d, ids[live][i.long()]


@pytest.mark.parametrize("bq", BQS)
@pytest.mark.parametrize("split", SPLITS)
def test_stacked_split_schedule_is_exact_and_split_free(stack, bq, split):
    """Every schedule of the stacked plain version gives the same planes
    as one walker (values bit for bit, ids apart from ties), in each probe
    mode, cold or seeded with a probe pass's planes (pass B's start), with
    or without a finite valid cap; in f32 the merged planes are the exact
    top-k of the live points, and a widened probe never undercuts it."""
    ts, _ = stack
    i = BQS.index(bq) * len(SPLITS) + SPLITS.index(split)
    probe_dtype = ("f32", "bf16", "int8")[i % 3]
    seeded, capped = (i // 3) % 2 == 1, i % 4 == 1
    k = (1, 4, 9)[i % 3]
    q = tbt.normalize_query(np.random.default_rng(i).normal(
        size=(37, SDIM + 1)).astype(np.float32))
    od, oi = _live_oracle(ts, q, k)
    cap = (od[:, k - 1] * 1.01 + 1e-6) if capped else None
    ops_, kw = _stack_ops(ts, q, bq, probe_dtype, cap)
    visit = ops_["visit"]
    if seeded:  # a probe of 2 tiles, then the rest seeded with it
        sd, si, _ = ref.stacked_sweep_ref(
            **dict(ops_, visit=visit[:, :, :2].contiguous()), k=k, bq=bq,
            **kw)
        kw = dict(kw, seed_d=sd, seed_i=si,
                  global_seed=tsearch.merge_topk_planes(sd, si, k)[0])
        ops_ = dict(ops_, visit=visit[:, :, 2:].contiguous())
    d, ids, skips = ref.stacked_sweep_ref(**ops_, k=k, bq=bq, split=split,
                                          **kw)
    d1, i1, _ = ref.stacked_sweep_ref(**ops_, k=k, bq=bq, split=1, **kw)
    assert torch.equal(d, d1)
    assert_topk_parity(d.reshape(-1, k).numpy(), ids.reshape(-1, k).numpy(),
                       d1.reshape(-1, k).numpy(), i1.reshape(-1, k).numpy())
    assert skips.shape == (visit.shape[0], visit.shape[1], 1)
    md, mi = tsearch.merge_topk_planes(d, ids, k)
    B0 = len(q)
    if probe_dtype == "f32":
        assert_topk_parity(md[:B0].numpy(), mi[:B0].numpy(), od[:, :k].numpy(),
                           oi[:, :k].numpy(), od[:, k].numpy())
    else:
        assert (md[:B0] >= od[:, :k] - 1e-6).all()


@pytest.mark.parametrize("bq,split,probe_dtype", [
    (8, 4, "f32"), (64, 2, "bf16"), (1, 8, "int8"), (16, 8, "f32")])
def test_stacked_split_skip_counts_are_deterministic(stack, bq, split,
                                                     probe_dtype):
    ts, _ = stack
    q = tbt.normalize_query(np.random.default_rng(3).normal(
        size=(70, SDIM + 1)).astype(np.float32))
    ops_, kw = _stack_ops(ts, q, bq, probe_dtype)
    a = ref.stacked_sweep_ref(**ops_, k=6, bq=bq, split=split,
                              return_live=True, **kw)
    b = ref.stacked_sweep_ref(**ops_, k=6, bq=bq, split=split,
                              return_live=True, **kw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    # the skips are the visits the live mask leaves out, pad and dead
    # tiles among them
    np.testing.assert_array_equal((~a[3]).sum(2).numpy(), a[2][..., 0])
    assert (a[2] > 0).any()


@pytest.fixture(scope="module")
def small_stack():
    """Five small segments (a dead tile, a single point, a dead segment
    and a bucket-pad row) in both packages: the JAX plain version walks
    tile by tile in Python, so the parity test keeps its stack small."""
    jsegs, tsegs = _segments(5, 16, seed=9, sizes=(200, 57, 1, 90, 40))
    return (tss.StackedLeaves.from_segments(tsegs),
            jss.StackedLeaves.from_segments(jsegs))


@pytest.mark.parametrize("bq,probe_dtype", [
    (1, "f32"), (8, "bf16"), (16, "int8"), (8, "f32")])
def test_stacked_split1_is_the_jax_schedule(small_stack, bq, probe_dtype):
    """``split=1`` equals the JAX package's stacked plain version at the
    same block size, skip counts included, seeded as pass B is."""
    ts, js = small_stack
    q = tbt.normalize_query(np.random.default_rng(5).normal(
        size=(21, SDIM + 1)).astype(np.float32))
    k = 5
    tops, _ = tss.prepare_stacked_operands(ts, torch.from_numpy(q), bq=bq)
    jop, _ = jss.prepare_stacked_operands(js, jnp.asarray(q), bq=bq)
    np.testing.assert_array_equal(tops["visit"].numpy(),
                                  np.asarray(jop["visit"]))
    tkw, jkw = {}, {}
    if probe_dtype != "f32":
        tq, tscale = ts.quantized_pts(probe_dtype, lane_pad=False)
        jq, jscale = js.quantized_pts(probe_dtype, lane_pad=False)
        tops, tkw = tss._quant_probe_operands(
            probe_dtype, tops, tq, tscale, ts.leaf_radii, ts.leaf_cnorm,
            ts.d)
        jop, jkw = jss._quant_probe_operands(
            probe_dtype, jop, jq, jscale, js.leaf_radii, js.leaf_cnorm,
            js.d)
    sd, si, _ = jref.stacked_sweep_ref(
        **dict(jop, visit=jop["visit"][:, :, :2]), k=k, bq=bq, **jkw)
    gs = np.sort(np.asarray(sd).min(axis=0), axis=1)
    tkw = dict(tkw, seed_d=torch.from_numpy(np.array(sd)),
               seed_i=torch.from_numpy(np.array(si)),
               global_seed=torch.from_numpy(gs))
    jkw = dict(jkw, seed_d=sd, seed_i=si, global_seed=jnp.asarray(gs))
    td, ti, tsk = ref.stacked_sweep_ref(**tops, k=k, bq=bq, split=1, **tkw)
    jd, ji, jsk = jref.stacked_sweep_ref(**jop, k=k, bq=bq, **jkw)
    assert_topk_parity(td.reshape(-1, k).numpy(), ti.reshape(-1, k).numpy(),
                       np.asarray(jd).reshape(-1, k),
                       np.asarray(ji).reshape(-1, k))
    np.testing.assert_array_equal(tsk.numpy(), np.asarray(jsk))


def test_stacked_wrapper_host_route_takes_split(stack):
    ts, _ = stack
    q = tbt.normalize_query(np.random.default_rng(6).normal(
        size=(40, SDIM + 1)).astype(np.float32))
    ops_, kw = _stack_ops(ts, q, 16, "bf16")
    a = tss.stacked_sweep(**ops_, k=7, bq=16, split=4, **kw)
    b = ref.stacked_sweep_ref(**ops_, k=7, bq=16, split=4, **kw)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    c = tss.stacked_sweep(**ops_, k=7, bq=16, **kw)  # split=None: one walker
    d = ref.stacked_sweep_ref(**ops_, k=7, bq=16, split=1, **kw)
    for u, v in zip(c, d):
        assert torch.equal(u, v)


def test_stacked_query_defaults_on_the_host(stack):
    """``stacked_sweep_query`` with ``bq=None, split=None`` runs the JAX
    package's block of 8 and one walker on the host: the same answers,
    counters and info as explicit ``bq=8, split=1``; another schedule
    gives the same answer."""
    ts, _ = stack
    q = torch.from_numpy(tbt.normalize_query(np.random.default_rng(7).normal(
        size=(30, SDIM + 1)).astype(np.float32)))
    a = tss.stacked_sweep_query(ts, q, 6)
    b = tss.stacked_sweep_query(ts, q, 6, bq=8, split=1)
    for u, v in zip(a[:3], b[:3]):
        assert torch.equal(u, v)
    np.testing.assert_array_equal(a[3]["forced_skips"], b[3]["forced_skips"])
    c = tss.stacked_sweep_query(ts, q, 6, bq=32, split=4)
    assert torch.equal(c[0], a[0])
    assert_topk_parity(c[0].numpy(), c[1].numpy(), a[0].numpy(),
                       a[1].numpy())


@pytest.mark.parametrize("d", [129, 7])
def test_int8_widened_fma_sum_is_the_exact_int32_dot(d):
    """The stacked kernel's int8 probe widens int8 points and queries to
    f32 and sums ``fmaf(q[c], x[c], acc)`` in column order.  Every product
    (at most 127^2) and every partial sum (at most d * 127^2 < 2^24 for
    d <= 1040) is an integer that f32 holds exactly, so the sum is the
    exact int32 dot, at the extremes (all +-127) too."""
    rng = np.random.default_rng(d)
    rows = [np.full(d, 127), np.full(d, -127),
            np.where(np.arange(d) % 2, 127, -127),
            rng.integers(-127, 128, d), rng.integers(-127, 128, d)]
    assert d * 127 ** 2 < 2 ** 24
    for q in rows:
        for x in rows:
            exact = int(np.dot(q.astype(np.int64), x.astype(np.int64)))
            acc = np.float32(0.0)
            for c in range(d):  # fmaf: one rounding of q*x + acc; both are
                #                 exact in float64 here, so round once
                acc = np.float32(np.float64(np.float32(q[c]))
                                 * np.float64(np.float32(x[c]))
                                 + np.float64(acc))
            assert float(acc) == exact
            # the int32 the plain version's chunked product gives
            qt = torch.from_numpy(q.astype(np.int8))[None, None]
            xt = torch.from_numpy(x.astype(np.int8))[None, None]
            assert int(ref._int8_dot(qt, xt)) == exact


def test_bf16_widening_is_the_top_half_of_an_f32():
    """bf16 values widen to f32 by placing their 16 bits on top (the
    kernel's widening), which is exactly ``Tensor.float()``; and the
    product of two widened bf16 values is exact in f32 (8 + 8 significant
    bits), so an FMA of it rounds only the sum, as an f32 sum of exact
    products does."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.normal(size=4096).astype(np.float32) * 3.0)
    v = torch.cat([v, torch.tensor([0.0, -0.0, 1e-38, -3e38, 65504.0])])
    b = v.to(torch.bfloat16)
    bits = b.view(torch.int16).to(torch.int32) & 0xFFFF
    widened = (bits << 16).view(torch.float32)
    assert torch.equal(widened.view(torch.int32), b.float().view(torch.int32))
    a, c = b.float()[:-1], b.float()[1:]
    prod = a * c
    exact = a.double() * c.double()
    finite = torch.isfinite(exact) & (exact.abs() < 3e38)
    assert torch.equal(prod.double()[finite], exact[finite])


def test_visit_rows_counts_rows_to_the_last_valid_point(stack):
    """The rows each kernel loads per visit entry: up to a tile's last
    non-pad point (deleted points inside the prefix stay), 0 for a pad or
    dead tile; one tree and a stack alike."""
    ts, _ = stack
    ids = ts.ids.clone()
    ids[0, 1, 3] = -1  # a hole before the tile's last point
    visit = torch.stack([torch.randperm(ts.num_tiles, generator=torch.
                                        Generator().manual_seed(s))[None]
                         for s in range(ts.num_segments)]).to(torch.int32)
    want = torch.zeros(visit.shape, dtype=torch.int32)
    for s in range(visit.shape[0]):
        for j in range(visit.shape[2]):
            valid = torch.nonzero(ids[s, int(visit[s, 0, j])] >= 0)
            want[s, 0, j] = int(valid.max()) + 1 if len(valid) else 0
    assert torch.equal(p2h_scan.visit_rows(ids, visit), want)
    assert torch.equal(p2h_scan.visit_rows(ids[0], visit[0]), want[0])
    assert (want == 0).any() and (want > 0).any()
