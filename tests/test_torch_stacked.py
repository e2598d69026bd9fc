"""The stacked (segment-parallel) sweep of the port against the JAX
package's, on the CPU.

Both packages stack the same numpy segments: the stacked tile grids, the
bucket padding and the quantised planes must be equal exactly; the port's
plain version of the stacked kernel, ``stacked_sweep_ref``, is held to the
JAX package's (and once to its Pallas kernel in interpret mode) with equal
skip counts; ``stacked_sweep_query`` to the JAX one with its counters and
``info``.  The CUDA kernel itself runs only on the card
(``tests/test_torch_gpu.py``); here its wrapper's host route and operand
checks are tested.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_topk_parity  # noqa: E402
from repro.core import balltree as jbt  # noqa: E402
from repro.core import search as jsearch  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import stacked_sweep as jss  # noqa: E402
from repro_torch.core import balltree as tbt  # noqa: E402
from repro_torch.core import search as tsearch  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import stacked_sweep as tss  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
DIM = 8


class _Seg:
    """Segment stand-in (uid/tree/gids) over one package's tree."""

    def __init__(self, uid, tree, gids):
        self.uid, self.tree, self.gids = uid, tree, np.asarray(gids, np.int32)


def _segments(seed=0, *, n0=16, sizes=(200, 57, 1, 90, 40), dead=(4,),
              dim=DIM):
    """Both packages' segments over the same points: ragged tile counts, a
    single-point segment and all-tombstone segments (``dead``)."""
    rng = np.random.default_rng(seed)
    jsegs, tsegs, gid = [], [], 0
    for u, n in enumerate(sizes):
        pts = tbt.append_ones(rng.normal(size=(n, dim)).astype(np.float32))
        jt = jbt.build_tree(pts, n0=n0, append_one=False)
        tt = tbt.build_tree(pts, n0=n0, append_one=False)
        if u in dead:
            pid = np.full(tt.point_ids.shape, -1, np.int32)
            jt = dataclasses.replace(jt, point_ids=jnp.asarray(pid))
            tt = tt.with_point_ids(torch.from_numpy(pid))
        gids = np.arange(gid, gid + n)
        jsegs.append(_Seg(u, jt, gids))
        tsegs.append(_Seg(u, tt, gids))
        gid += n
    return jsegs, tsegs


def _eq(t, j, what=""):
    np.testing.assert_array_equal(t.numpy() if isinstance(t, torch.Tensor)
                                  else np.asarray(t), np.asarray(j),
                                  err_msg=what)


_STACK_FIELDS = ("pts", "ids", "rx", "xc", "xs", "leaf_centers",
                 "leaf_radii", "leaf_cnorm", "valid", "n_leaves")


def _assert_stacks_equal(ts, js):
    for name in _STACK_FIELDS:
        _eq(getattr(ts, name), getattr(js, name), name)
    assert ts.uids == js.uids and (ts.n0, ts.d) == (js.n0, js.d)


@pytest.fixture(scope="module")
def stacks():
    jsegs, tsegs = _segments(seed=3)
    return (jss.StackedLeaves.from_segments(jsegs),
            tss.StackedLeaves.from_segments(tsegs), jsegs, tsegs)


def _queries(B, seed, dim=DIM):
    q = np.random.default_rng(seed).normal(size=(B, dim + 1))
    return tbt.normalize_query(q.astype(np.float32))


# ------------------------------------------------------ the tile grid
def test_from_segments_matches_jax(stacks):
    js, ts, _, _ = stacks
    _assert_stacks_equal(ts, js)
    assert ts.num_tiles % tss._tile_quantum(max(
        s.tree.num_leaves for s in stacks[3])) == 0


def test_with_updated_ids_matches_jax_and_shares_geometry(stacks):
    js, ts, jsegs, tsegs = stacks
    ts.padded_pts()
    ts.quantized_pts("int8")
    pid = tsegs[1].tree.point_ids.clone()
    pid[pid % 3 == 0] = -1
    tseg = _Seg(1, tsegs[1].tree.with_point_ids(pid), tsegs[1].gids)
    jseg = _Seg(1, dataclasses.replace(jsegs[1].tree,
                                       point_ids=jnp.asarray(pid.numpy())),
                jsegs[1].gids)
    tu = ts.with_updated_ids({1: tseg})
    ju = js.with_updated_ids({1: jseg})
    _assert_stacks_equal(tu, ju)
    for name in ("pts", "rx", "xc", "xs", "leaf_centers", "leaf_radii",
                 "leaf_cnorm"):
        assert getattr(tu, name) is getattr(ts, name), name
    assert tu._derived["pts_lane"] is ts._derived["pts_lane"]
    assert tu.quantized_pts("int8") is ts.quantized_pts("int8")
    assert not torch.equal(tu.ids, ts.ids)


def test_concat_matches_jax():
    jsegs, tsegs = _segments(seed=5)
    jsmall, tsmall = _segments(seed=6, sizes=(20, 33), dead=())
    ja = jss.StackedLeaves.from_segments(jsegs)
    jb = jss.StackedLeaves.from_segments(jsmall)
    ta = tss.StackedLeaves.from_segments(tsegs)
    tb = tss.StackedLeaves.from_segments(tsmall)
    assert ta.num_tiles != tb.num_tiles  # the concat re-pads
    _assert_stacks_equal(tss.StackedLeaves.concat([tb, ta]),
                         jss.StackedLeaves.concat([jb, ja]))
    cached = tss.concat_cached([tb, ta])
    assert tss.concat_cached([tb, ta]) is cached
    assert tss.concat_cached([ta]) is ta


@pytest.mark.parametrize("probe_dtype", ["f32", "bf16", "int8"])
def test_bucketed_arrays_match_jax(stacks, probe_dtype):
    js, ts, _, _ = stacks
    assert ts.num_segments == 5  # bucketed to 6: one dead pad row
    ta, tn = tss._bucketed_arrays(ts, use_kernel=False,
                                  probe_dtype=probe_dtype)
    ja, jn = jss._bucketed_arrays(js, use_kernel=False,
                                  probe_dtype=probe_dtype)
    assert tn == jn == 6 and sorted(ta) == sorted(ja)
    for name in ta:
        t, j = ta[name], ja[name]
        if t.dtype == torch.bfloat16:
            t, j = t.float(), np.asarray(j, np.float32)
        _eq(t, j, name)
    # the kernel's points are padded to 16-byte rows (4 f32, 8 bf16 or 16
    # int8 columns), the TPU's to 128 columns
    tk, _ = tss._bucketed_arrays(ts, use_kernel=True, probe_dtype=probe_dtype)
    jk, _ = jss._bucketed_arrays(js, use_kernel=True, probe_dtype=probe_dtype)
    for name in ("pts", "qpts") if probe_dtype != "f32" else ("pts",):
        unit = 16 // tk[name].element_size()
        t = tk[name].float()
        assert t.shape[-1] == -(-ts.d // unit) * unit
        assert not t[..., ts.d:].any()
        _eq(t[..., :ts.d], np.asarray(jk[name], np.float32)[..., :ts.d],
            name)
    assert tss._bucketed_arrays(ts, use_kernel=True,
                                probe_dtype=probe_dtype)[0]["pts"] is tk["pts"]


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_quantized_pts_and_slack_match_jax(stacks, dtype):
    js, ts, _, _ = stacks
    tq, tscale = ts.quantized_pts(dtype, lane_pad=False)
    jq, jscale = js.quantized_pts(dtype, lane_pad=False)
    if dtype == "bf16":
        assert tq.dtype == torch.bfloat16 and tscale is None is jscale
        _eq(tq.float(), np.asarray(jq, np.float32))
    else:
        assert tq.dtype == torch.int8
        _eq(tq, jq)
        _eq(tscale, jscale)
        assert (tscale > 0).all()  # the zero-scale guard on pad tiles
    for a, b in zip(
            tss.quantization_slack(dtype, d=ts.d, leaf_cnorm=ts.leaf_cnorm,
                                   leaf_radii=ts.leaf_radii,
                                   tile_scale=tscale),
            jss.quantization_slack(dtype, d=js.d, leaf_cnorm=js.leaf_cnorm,
                                   leaf_radii=js.leaf_radii,
                                   tile_scale=jscale)):
        _eq(a, b)


def test_rounding_matches_jax():
    """Half-way values round to even in both packages, and so does the
    bf16 cast."""
    x = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, 126.5, -126.5, 3.49],
                 np.float32)
    _eq(torch.round(torch.from_numpy(x)), jnp.round(jnp.asarray(x)))
    rng = np.random.default_rng(0)
    y = (rng.normal(size=4096) * 10).astype(np.float32)
    halfway = (y.view(np.uint32) & ~np.uint32(0xFFFF)) | np.uint32(0x8000)
    y = np.concatenate([y, halfway.view(np.float32)])
    _eq(torch.from_numpy(y).to(torch.bfloat16).float(),
        np.asarray(jnp.asarray(y).astype(jnp.bfloat16), np.float32))


def test_probe_knob_rules_match_jax():
    for dt in ("f32", "bf16", "int8"):
        assert (tss.probe_bytes_per_tile(dt, 64, 33)
                == jss.probe_bytes_per_tile(dt, 64, 33))
    for args in [(None, 10), (None, 10, "round2"), (3, 2), (-1, 5), (7, 9)]:
        assert tss.resolve_probe_tiles(*args) == jss.resolve_probe_tiles(
            *args)
    for args in [(None, 4), ("auto", 4), ("int8", 0), ("bf16", 2)]:
        assert tss.resolve_probe_dtype(*args) == jss.resolve_probe_dtype(
            *args)
    with pytest.raises(ValueError, match="probe_dtype"):
        tss.resolve_probe_dtype("fp8", 4)
    for n in (1, 4, 5, 9, 17, 33, 70):
        assert tss._bucket_segments(n) == jss._bucket_segments(n)
    assert tss.STACKED_FANOUT_DEFAULT == jss.STACKED_FANOUT_DEFAULT
    assert tss.STACKED_PROBE_TILES_DEFAULT == jss.STACKED_PROBE_TILES_DEFAULT


def test_tile_density_matches_jax(stacks):
    _, _, jsegs, tsegs = stacks
    assert tss.tile_density(tsegs) == jss.tile_density(jsegs)


# --------------------------------------- the plain version of the kernel
def _both_ops(js, ts, q, **kw):
    tops, tb0 = tss.prepare_stacked_operands(ts, torch.from_numpy(q), **kw)
    jops, jb0 = jss.prepare_stacked_operands(js, jnp.asarray(q), **kw)
    assert tb0 == jb0
    _eq(tops["visit"], jops["visit"], "visit")
    for name in ("leaf_ip", "leaf_lb", "qnorm"):
        np.testing.assert_allclose(tops[name].numpy(),
                                   np.asarray(jops[name]), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    return tops, jops


def _assert_planes(t, j, *, skips=True):
    td, ti, tsk = t
    jd, ji, jsk = j
    k = td.shape[-1]
    assert_topk_parity(td.reshape(-1, k).numpy(), ti.reshape(-1, k).numpy(),
                       np.asarray(jd).reshape(-1, k),
                       np.asarray(ji).reshape(-1, k))
    if skips:
        _eq(tsk, jsk, "skips")


@pytest.mark.parametrize("probe_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("start", ["cold", "seeded", "global"])
def test_stacked_ref_matches_jax_ref(stacks, probe_dtype, start):
    js, ts, _, _ = stacks
    q = _queries(13, seed=4)  # 13: the last block repeats a query
    tops, jops = _both_ops(js, ts, q, bq=8)
    k = 5
    tkw, jkw = {}, {}
    if probe_dtype != "f32":
        d = ts.d
        tq, tscale = ts.quantized_pts(probe_dtype, lane_pad=False)
        jq, jscale = js.quantized_pts(probe_dtype, lane_pad=False)
        tops, tkw = tss._quant_probe_operands(
            probe_dtype, tops, tq, tscale, ts.leaf_radii, ts.leaf_cnorm, d)
        jops, jkw = jss._quant_probe_operands(
            probe_dtype, jops, jq, jscale, js.leaf_radii, js.leaf_cnorm, d)
        if probe_dtype == "int8":
            _eq(tops["queries"], jops["queries"], "int8 queries")
            _eq(tkw["sq"], jkw["sq"], "query scales")
    if start != "cold":
        # seeds from a cold pass over the first 2 tiles of every list
        sd, si, _ = jref.stacked_sweep_ref(
            **dict(jops, visit=jops["visit"][:, :, :2]), k=k, **jkw)
        sd, si = np.array(sd), np.array(si)
        if start == "seeded":
            tkw = dict(tkw, seed_d=torch.from_numpy(sd),
                       seed_i=torch.from_numpy(si))
            jkw = dict(jkw, seed_d=jnp.asarray(sd), seed_i=jnp.asarray(si))
        else:
            gs = np.sort(sd.min(axis=0), axis=1) * 1.5
            tkw = dict(tkw, global_seed=torch.from_numpy(gs))
            jkw = dict(jkw, global_seed=jnp.asarray(gs))
    t = ref.stacked_sweep_ref(**tops, k=k, **tkw)
    j = jref.stacked_sweep_ref(**jops, k=k, **jkw)
    _assert_planes(t, j)
    skips = t[2].numpy()
    assert (skips[4] == tops["visit"].shape[2]).all()  # all-tombstone
    assert skips[:4].sum() > 0


@pytest.mark.parametrize("use_ball,use_cone", [(False, False), (True, True)])
def test_stacked_ref_matches_pallas_kernel_interpret(use_ball, use_cone):
    jsegs, tsegs = _segments(seed=7, sizes=(40, 13, 25), dead=(1,))
    js = jss.StackedLeaves.from_segments(jsegs)
    ts = tss.StackedLeaves.from_segments(tsegs)
    q = _queries(8, seed=8)
    tops, _ = tss.prepare_stacked_operands(ts, torch.from_numpy(q))
    jops, _ = jss.prepare_stacked_operands(js, jnp.asarray(q),
                                           lane_pad=True)  # the TPU shape
    kw = dict(k=3, use_ball=use_ball, use_cone=use_cone)
    gs = np.full((8, 3), 0.9, np.float32)
    t = ref.stacked_sweep_ref(**tops, global_seed=torch.from_numpy(gs), **kw)
    jd, ji, jsk = jss.stacked_sweep(**jops, global_seed=jnp.asarray(gs),
                                    interpret=True, **kw)
    order = np.argsort(np.asarray(jd), axis=2, kind="stable")
    j = (np.take_along_axis(np.asarray(jd), order, 2),
         np.take_along_axis(np.asarray(ji), order, 2), jsk)
    _assert_planes(t, j)


def test_stacked_sweep_host_route_is_the_plain_version(stacks):
    _, ts, _, _ = stacks
    tops, _ = tss.prepare_stacked_operands(ts, torch.from_numpy(
        _queries(8, seed=9)))
    a = tss.stacked_sweep(**tops, k=4)
    b = ref.stacked_sweep_ref(**tops, k=4)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tss.stacked_sweep(**{n: t.to("meta") for n, t in tops.items()}, k=3)


def _kernel_operands(ts, probe_dtype="f32"):
    arrays, _ = tss._bucketed_arrays(ts, use_kernel=True,
                                     probe_dtype=probe_dtype)
    stk = tss.StackedLeaves(**{n: v for n, v in arrays.items()
                               if n not in ("qpts", "qscale")},
                            uids=(), n0=ts.n0, d=ts.d)
    ops, _ = tss.prepare_stacked_operands(
        stk, torch.from_numpy(_queries(16, seed=10)), lane_pad=True)
    N, L = stk.num_segments, stk.num_tiles
    B, k = 16, 4
    ops.update(seed_d=torch.full((N, B, k), float("inf")),
               seed_i=torch.full((N, B, k), -1, dtype=torch.int32),
               global_seed=torch.full((B, k), float("inf")),
               sq=torch.zeros((B, 1)), tile_scale=torch.ones((N, L, 1)),
               slack_a=torch.zeros((N, L, 1)),
               slack_b=torch.zeros((N, L, 1)))
    if probe_dtype != "f32":
        qops, kw = tss._quant_probe_operands(
            probe_dtype, ops, arrays["qpts"], arrays.get("qscale"),
            stk.leaf_radii, stk.leaf_cnorm, ts.d)
        ops = dict(qops, **{n: kw[n] for n in ("sq", "slack_a", "slack_b")})
        if kw["tile_scale"] is not None:
            ops["tile_scale"] = kw["tile_scale"]
    return ops


@pytest.mark.parametrize("probe_dtype", ["f32", "bf16", "int8"])
def test_kernel_operands_pass_the_wrapper_checks(stacks, probe_dtype):
    """What the two-pass program hands the kernel is what it takes."""
    _, ts, _, _ = stacks
    ops = _kernel_operands(ts, probe_dtype)
    assert tss._check(ops, k=4, bq=8, probe_dtype=probe_dtype)[0] == 6


@pytest.mark.parametrize("change,match", [
    (lambda o: o.update(rx_tiles=o["rx_tiles"].double()), "must be"),
    (lambda o: o.update(pts_tiles=o["pts_tiles"].to(torch.bfloat16)),
     "must be"),
    (lambda o: o.update(leaf_ip=o["leaf_ip"].transpose(1, 2).contiguous()
                        .transpose(1, 2)), "contiguous"),
    (lambda o: o.update(seed_d=o["seed_d"][:, :-1].contiguous()),
     "shape"),
    (lambda o: o.update(visit=o["visit"][:-1].contiguous()), "shape"),
    (lambda o: o.update(queries=o["queries"][:, :-1].contiguous()),
     "multiple of 4"),
])
def test_wrapper_operand_checks(stacks, change, match):
    _, ts, _, _ = stacks
    ops = _kernel_operands(ts)
    change(ops)
    with pytest.raises((ValueError, TypeError), match=match):
        tss._check(ops, k=4, bq=8, probe_dtype="f32")


def test_wrapper_checks_bq_and_mode(stacks):
    _, ts, _, _ = stacks
    ops = _kernel_operands(ts)
    with pytest.raises(ValueError, match="bq"):
        tss._check(ops, k=4, bq=3, probe_dtype="f32")
    with pytest.raises(ValueError, match="probe_dtype"):
        tss._check(ops, k=4, bq=8, probe_dtype="fp8")


# ----------------------------------------------- the two-pass program
@pytest.mark.parametrize("probe_tiles,probe_dtype,capped,extra", [
    (None, None, False, False),
    (0, None, True, False),
    (2, "f32", False, True),
    (1000, "f32", True, True),
    (3, "bf16", True, True),
    (3, "int8", False, True),
])
def test_stacked_sweep_query_matches_jax(stacks, probe_tiles, probe_dtype,
                                         capped, extra):
    js, ts, jsegs, _ = stacks
    q = _queries(11, seed=11)
    k = 5
    kw = dict(probe_tiles=probe_tiles, probe_dtype=probe_dtype,
              shard_bounds=(2, 3))
    tkw, jkw = dict(kw), dict(kw)
    if capped:
        cap = np.full((11,), 0.8, np.float32)
        tkw["lambda_cap"], jkw["lambda_cap"] = torch.from_numpy(cap), cap
    if extra:  # a delta's candidates: real points, in no segment
        rng = np.random.default_rng(12)
        ed = np.sort(rng.uniform(0.05, 1.0, (11, k)).astype(np.float32), 1)
        ei = (10_000 + np.arange(11 * k, dtype=np.int32)).reshape(11, k)
        tkw.update(extra_d=torch.from_numpy(ed), extra_i=torch.from_numpy(ei))
        jkw.update(extra_d=jnp.asarray(ed), extra_i=jnp.asarray(ei))
    td, ti, tc, tinfo = tss.stacked_sweep_query(ts, q, k, **tkw)
    jd, ji, jc, jinfo = jss.stacked_sweep_query(js, jnp.asarray(q), k,
                                                **jkw)
    assert_topk_parity(td.numpy(), ti.numpy(), np.asarray(jd),
                       np.asarray(ji))
    _eq(tc, jc, "counters")
    _eq(tinfo["seg_skips"], jinfo["seg_skips"], "seg_skips")
    _eq(tinfo["forced_skips"], jinfo["forced_skips"], "forced_skips")
    np.testing.assert_allclose(tinfo["shard_kth"].numpy(),
                               np.asarray(jinfo["shard_kth"]), rtol=1e-5,
                               atol=1e-6)
    assert tinfo["probe"] == jinfo["probe"]
    assert tinfo["mesh_devices"] == jinfo["mesh_devices"] == 1
    # exact: the merged distances are the brute force over the live union
    # and the extra candidates (with a cap, rows whose k-th lies above it
    # may stay short)
    X = np.concatenate([np.asarray(s.tree.points)[
        np.asarray(s.tree.point_ids) >= 0] for s in jsegs])
    bd = np.abs(q.astype(np.float64) @ X.astype(np.float64).T)
    if extra:
        bd = np.concatenate([bd, ed], 1)
    if not capped:
        np.testing.assert_allclose(td.numpy(), np.sort(bd, axis=1)[:, :k],
                                   rtol=1e-5, atol=1e-6)


def test_stacked_sweep_search_matches_jax(stacks):
    js, ts, _, _ = stacks
    q = _queries(9, seed=13)
    tb, tbi, tc, tsk = tss.stacked_sweep_search(ts, q, 4, probe_tiles=2)
    jb, jbi, jc, jsk = jss.stacked_sweep_search(js, jnp.asarray(q), 4,
                                                probe_tiles=2)
    _assert_planes((tb, tbi, tsk), (jb, jbi, jsk))
    _eq(tc, jc, "counters")


def test_finish_stacked_matches_jax_on_ties_and_empty_slots():
    """The cross-segment merge (``merge_topk_planes``) and per-shard k-ths
    of ``_finish_stacked`` on planes with exact ties, repeated ids and -1
    slots."""
    rng = np.random.default_rng(14)
    N, B, k = 4, 6, 5
    bd = np.round(rng.uniform(0, 1, (N, B, k)), 1).astype(np.float32)
    bi = rng.integers(0, 9, (N, B, k)).astype(np.int32)
    bd[1, :, 3:] = np.inf
    bi[1, :, 3:] = -1
    sk = rng.integers(0, 3, (N, 1, 1)).astype(np.int32)
    ed = np.round(rng.uniform(0, 1, (B, k)), 1).astype(np.float32)
    ei = rng.integers(0, 9, (B, k)).astype(np.int32)
    shard = np.array([0, 0, 1, -1], np.int32)
    nl = np.array([3, 2, 4, 0], np.int32)
    kw = dict(k=k, B0=B - 1, num_shards=2, sort_planes=True, nqb=1,
              n_visit=7)
    t = tss._finish_stacked(*(torch.from_numpy(a) for a in (bd, bi, sk)),
                            torch.tensor(0), torch.from_numpy(ed),
                            torch.from_numpy(ei), torch.from_numpy(shard), 3,
                            torch.from_numpy(nl), **kw)
    j = jss._finish_stacked(*(jnp.asarray(a) for a in (bd, bi, sk)), 0,
                            jnp.asarray(ed), jnp.asarray(ei),
                            jnp.asarray(shard), jnp.asarray(3),
                            jnp.asarray(nl), **kw)
    for name, a, b in zip(("planes_d", "planes_i", "d", "i", "counters",
                           "seg_skips", "shard_kth"), t, j):
        _eq(a, b, name)
    md, mi = tsearch.merge_topk_planes(torch.from_numpy(bd),
                                       torch.from_numpy(bi), k)
    jd, ji = jsearch.merge_topk_planes(jnp.asarray(bd), jnp.asarray(bi), k)
    _eq(md, jd)
    _eq(mi, ji)


def test_compile_registry_keeps_the_jax_keys(stacks):
    _, ts, _, _ = stacks
    tss.reset_stacked_compile_stats(full=True)
    q = _queries(8, seed=15)
    tss.stacked_sweep_query(ts, q, 3)
    tss.stacked_sweep_query(ts, q, 3)
    st = tss.stacked_compile_stats()
    jst = jss.stacked_compile_stats()
    assert sorted(st) == sorted(jst)
    assert (st["misses"], st["hits"], st["signatures"]) == (1, 1, 1)
    assert tss.warm_stacked(ts) == 1
    st = tss.stacked_compile_stats()
    assert (st["warm_hits"], st["compile_count"], st["cache_hit"]) == (1, 1,
                                                                       1)
    tss.reset_stacked_compile_stats(full=True)
    assert tss.stacked_compile_stats()["signatures"] == 0


def test_multi_device_mesh_is_refused(stacks):
    """A mesh of two positions serves (one launch a position and pass), bit
    for bit the single launch; a one-position mesh is the single launch."""
    from repro_torch.launch.mesh import make_mesh

    _, ts, _, _ = stacks
    q = _queries(8, seed=16)
    d0, i0, _, _ = tss.stacked_sweep_query(ts, q, 3)
    d2, i2, _, info = tss.stacked_sweep_query(
        ts, q, 3, mesh=make_mesh((2,), ("shard",), devices=["cpu"] * 2))
    assert info["mesh_devices"] == 2
    assert torch.equal(d0, d2) and torch.equal(i0, i2)
    _, _, _, info = tss.stacked_sweep_query(
        ts, q, 3, mesh=make_mesh((1,), ("shard",), devices=["cpu"]))
    assert info["mesh_devices"] == 1


# ------------------------------------------------------ the package rules
def test_build_lists_every_kernel_source():
    assert _build.SOURCES == ("p2h_sweep", "stacked_sweep")
    paths = {_build.library_path(n) for n in _build.SOURCES}
    assert len(paths) == 2
    assert _build.library_path("stacked_sweep").name.startswith(
        "libstacked_sweep-")
    with pytest.raises(ValueError, match="no kernel source"):
        _build.library_path("nope")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    bad = [(f.relative_to(REPO).as_posix(), m) for f in files
           for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
