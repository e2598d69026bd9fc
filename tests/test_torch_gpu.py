"""The CUDA kernels against their plain versions, on the card.

Run on a machine with an NVIDIA H100 (builds the kernel with nvcc):

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Every test takes the ``cuda`` fixture, which skips where there is no CUDA
device.  This file imports no JAX: the card's machine need not have it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_topk_parity, oracle  # noqa: E402
from repro_torch.core import search  # noqa: E402
from repro_torch.core.api import P2HIndex  # noqa: E402
from repro_torch.core.balltree import (  # noqa: E402
    append_ones,
    build_tree,
    normalize_query,
)
from repro_torch.core.exact import assert_exact_topk, exact_search  # noqa: E402
from repro_torch.data.pipeline import make_p2h_dataset  # noqa: E402
from repro_torch.kernels import ops, p2h_scan, ref  # noqa: E402
from repro_torch.kernels import stacked_sweep as tss  # noqa: E402
from repro_torch.stream import CompactionPolicy, MutableP2HIndex  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _setup(n, d, n0, nq, seed=0, kind="planted"):
    x, q = make_p2h_dataset(n, d, kind=kind, n_queries=nq, seed=seed)
    return x, normalize_query(q), build_tree(x, n0=n0, seed=seed)


def _kernel_vs_plain(opnds, k, bq, **kw):
    before = p2h_scan.p2h_sweep.launches
    kd, ki, ks = p2h_scan.p2h_sweep(**opnds, k=k, bq=bq, **kw)
    torch.cuda.synchronize()
    assert p2h_scan.p2h_sweep.launches == before + 1
    order = torch.argsort(kd, dim=1, stable=True)
    kd, ki = torch.gather(kd, 1, order), torch.gather(ki, 1, order)
    rd, ri, rs = ref.p2h_sweep_ref(**opnds, k=k, bq=bq, **kw)
    assert_topk_parity(kd.cpu().numpy(), ki.cpu().numpy(), rd.cpu().numpy(),
                       ri.cpu().numpy())
    assert torch.equal(ks, rs)
    return ks


@pytest.mark.parametrize("n,d,n0,k,bq,nq", [
    (5000, 16, 64, 10, 8, 16),
    (5000, 36, 128, 40, 8, 13),   # k > a warp; d+1 = 37 pads to 40
    (3000, 20, 256, 64, 8, 8),    # whole-block tiles of 256 points
    (2000, 9, 32, 5, 4, 12),      # bq 4
    (4000, 24, 100, 10, 16, 32),  # n0 not a multiple of 32; bq 16
    (1500, 11, 48, 3, 1, 5),      # bq 1
    (1500, 11, 48, 7, 2, 6),      # bq 2
])
def test_kernel_matches_plain(cuda, n, d, n0, k, bq, nq):
    _, qn, tree = _setup(n, d, n0, nq)
    opnds, _ = ops.prepare_operands(tree.to(cuda),
                                    torch.from_numpy(qn).to(cuda), bq=bq)
    _kernel_vs_plain(opnds, k, bq)


@pytest.mark.parametrize("use_ball,use_cone,frac", [
    (False, False, 1.0), (True, False, 1.0), (False, True, 1.0),
    (True, True, 0.3)])
def test_kernel_bound_toggles_and_budget(cuda, use_ball, use_cone, frac):
    _, qn, tree = _setup(4000, 32, 32, 16, seed=4)
    opnds, _ = ops.prepare_operands(tree.to(cuda),
                                    torch.from_numpy(qn).to(cuda), frac=frac)
    _kernel_vs_plain(opnds, 10, 8, use_ball=use_ball, use_cone=use_cone)


def test_kernel_all_skipped_block(cuda):
    """A zero cap makes every tile of block 0 a skip: nothing is scored and
    the block's top-k stays empty; block 1 (no cap) is scanned normally."""
    _, qn, tree = _setup(3000, 16, 64, 16, seed=2)
    cap = torch.full((16,), float("inf"))
    cap[:8] = 0.0
    opnds, _ = ops.prepare_operands(tree.to(cuda),
                                    torch.from_numpy(qn).to(cuda),
                                    lambda_cap=cap)
    ks = _kernel_vs_plain(opnds, 10, 8)
    n_visit = opnds["visit"].shape[1]
    assert int(ks[0, 0]) == n_visit and int(ks[1, 0]) < n_visit
    kd, ki, _ = p2h_scan.p2h_sweep(**opnds, k=10)
    assert torch.isinf(kd[:8]).all() and (ki[:8] == -1).all()
    assert torch.isfinite(kd[8:]).all()


def test_kernel_refuses_what_it_cannot_take(cuda):
    _, qn, tree = _setup(1000, 8, 32, 8)
    opnds, _ = ops.prepare_operands(tree.to(cuda),
                                    torch.from_numpy(qn).to(cuda))
    with pytest.raises(ValueError, match="shared memory"):
        p2h_scan.p2h_sweep(**opnds, k=200_000)
    mixed = dict(opnds, visit=opnds["visit"].cpu())
    with pytest.raises(ValueError, match="is on"):
        p2h_scan.p2h_sweep(**mixed, k=3)
    with pytest.raises(ValueError, match="bq"):
        p2h_scan.p2h_sweep(**opnds, k=3, bq=3)


@pytest.mark.parametrize("method", ["kernel", "sweep", "dfs", "beam"])
def test_index_on_card_matches_host_and_oracle(cuda, method):
    x, q = make_p2h_dataset(6000, 24, kind="planted", n_queries=19, seed=3)
    on_card = P2HIndex.build(x, n0=64, device=cuda)
    on_host = P2HIndex.build(x, n0=64, device="cpu")
    k, kw = 10, dict(frac=0.2) if method == "beam" else {}
    cd, ci, cs = on_card.query(q, k, method=method, return_stats=True, **kw)
    hd, hi, hs = on_host.query(q, k, method=method, return_stats=True, **kw)
    assert_topk_parity(cd, ci, hd, hi)
    assert cs == hs
    if method != "beam":
        pts, qn = append_ones(x), normalize_query(q)
        assert_exact_topk(cd, ci, oracle(pts, qn, k + 1)[1],
                          torch.from_numpy(pts).to(cuda),
                          torch.from_numpy(qn).to(cuda))


def test_exact_search_on_card(cuda):
    x, q = make_p2h_dataset(20000, 32, kind="clustered", n_queries=33)
    pts, qn = append_ones(x), normalize_query(q)
    pts_t, qn_t = torch.from_numpy(pts).to(cuda), torch.from_numpy(qn).to(cuda)
    d, i = exact_search(pts_t, qn_t, 10, chunk=4096)
    assert_exact_topk(d, i, oracle(pts, qn, 11)[1], pts_t, qn_t)
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_merge_topk_on_card_matches_host(cuda):
    rng = np.random.default_rng(1)
    d = torch.from_numpy(np.round(rng.uniform(0, 2, (4, 40)), 1).astype(
        np.float32))
    i = torch.from_numpy(rng.integers(0, 15, (4, 40)).astype(np.int32))
    hd, hi = search.merge_topk(d, i, 8)
    cd, ci = search.merge_topk(d.to(cuda), i.to(cuda), 8)
    assert torch.equal(cd.cpu(), hd) and torch.equal(ci.cpu(), hi)


# ------------------------------------------------ the stacked kernel (K2)
class _Seg:
    def __init__(self, uid, tree, gids):
        self.uid, self.tree, self.gids = uid, tree, np.asarray(gids, np.int32)


def _stack(device, *, sizes=(300, 57, 1, 180, 90), dim=16, n0=32, seed=0,
           dead=(4,)):
    """A ragged stack on ``device``: a single-point segment, an
    all-tombstone one, and a bucket-pad row (5 segments -> 6 rows)."""
    rng = np.random.default_rng(seed)
    segs, gid = [], 0
    for u, n in enumerate(sizes):
        pts = append_ones(rng.normal(size=(n, dim)).astype(np.float32))
        tree = build_tree(pts, n0=n0, append_one=False)
        if u in dead:
            tree = tree.with_point_ids(torch.full_like(tree.point_ids, -1))
        segs.append(_Seg(u, tree.to(device), np.arange(gid, gid + n)))
        gid += n
    return tss.StackedLeaves.from_segments(segs)


def _stacked_operands(stk, nq, bq, probe_dtype="f32", seed=1):
    arrays, _ = tss._bucketed_arrays(stk, use_kernel=True,
                                     probe_dtype=probe_dtype)
    qpts, qscale = arrays.pop("qpts", None), arrays.pop("qscale", None)
    grid = tss.StackedLeaves(**arrays, uids=(), n0=stk.n0, d=stk.d)
    q = normalize_query(np.random.default_rng(seed).normal(
        size=(nq, stk.d)).astype(np.float32))
    ops_, _ = tss.prepare_stacked_operands(
        grid, torch.from_numpy(q).to(stk.device), bq=bq, lane_pad=True)
    kw = {}
    if probe_dtype != "f32":
        ops_, kw = tss._quant_probe_operands(
            probe_dtype, ops_, qpts, qscale, grid.leaf_radii,
            grid.leaf_cnorm, stk.d)
    return ops_, kw


def _stacked_vs_plain(ops_, kw, k, bq):
    before = tss.LAUNCHES
    kd, ki, ks = tss.stacked_sweep(**ops_, k=k, bq=bq, **kw)
    torch.cuda.synchronize()
    assert tss.LAUNCHES == before + 1
    order = torch.argsort(kd, dim=2, stable=True)
    kd, ki = torch.gather(kd, 2, order), torch.gather(ki, 2, order)
    rd, ri, rs = ref.stacked_sweep_ref(**ops_, k=k, bq=bq, **kw)
    assert_topk_parity(kd.reshape(-1, k).cpu().numpy(),
                       ki.reshape(-1, k).cpu().numpy(),
                       rd.reshape(-1, k).cpu().numpy(),
                       ri.reshape(-1, k).cpu().numpy())
    assert torch.equal(ks, rs)
    return kd, rd, ks


@pytest.mark.parametrize("probe_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("start", ["cold", "seeded"])
@pytest.mark.parametrize("k,bq,nq", [(5, 8, 21), (40, 4, 8), (3, 16, 32),
                                     (7, 1, 3)])
def test_stacked_kernel_matches_plain(cuda, probe_dtype, start, k, bq, nq):
    stk = _stack(cuda)
    ops_, kw = _stacked_operands(stk, nq, bq, probe_dtype)
    Bp = ops_["queries"].shape[0]
    if start == "seeded":  # pass A's state of a cold probe of 2 tiles
        sd, si, _ = ref.stacked_sweep_ref(
            **dict(ops_, visit=ops_["visit"][:, :, :2].contiguous()), k=k,
            bq=bq, **kw)
        kw = dict(kw, seed_d=sd, seed_i=si,
                  global_seed=torch.full((Bp, k), 2.0, device=cuda))
    kd, rd, ks = _stacked_vs_plain(ops_, kw, k, bq)
    if bq > 1:  # the same sums in the same order; cuBLAS sums a batch of
        #         single-row products (bq=1) in another order
        assert torch.equal(kd, rd)
    n_visit = ops_["visit"].shape[2]
    assert (ks[4:] == n_visit).all()  # all-tombstone and bucket-pad rows


@pytest.mark.parametrize("use_ball,use_cone", [(False, False), (True, False),
                                               (False, True)])
def test_stacked_kernel_bound_toggles(cuda, use_ball, use_cone):
    stk = _stack(cuda, seed=2)
    ops_, kw = _stacked_operands(stk, 16, 8)
    _stacked_vs_plain(ops_, dict(kw, use_ball=use_ball, use_cone=use_cone),
                      10, 8)


def test_stacked_kernel_raises_and_never_falls_back(cuda, monkeypatch):
    stk = _stack(cuda, seed=3)
    ops_, _ = _stacked_operands(stk, 16, 8)

    def plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "stacked_sweep_ref", plain)
    before = tss.LAUNCHES
    broken = [dict(ops_, rx_tiles=ops_["rx_tiles"].double()),
              dict(ops_, visit=ops_["visit"].cpu()),
              dict(ops_, leaf_lb=ops_["leaf_lb"][:, :, :-1].contiguous()),
              dict(ops_, pts_tiles=ops_["pts_tiles"].to(torch.bfloat16))]
    for bad in broken:
        with pytest.raises((ValueError, TypeError)):
            tss.stacked_sweep(**bad, k=5)
    with pytest.raises(ValueError, match="bq"):
        tss.stacked_sweep(**ops_, k=5, bq=3)
    with pytest.raises(ValueError, match="shared memory"):
        tss.stacked_sweep(**ops_, k=100_000)
    assert tss.LAUNCHES == before


def _mutable(device, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(1200, 16)).astype(np.float32)
    m = MutableP2HIndex.from_data(
        data[:200], n0=32, device=device,
        policy=CompactionPolicy(delta_capacity=200, tombstone_frac=0.95,
                                max_segments=32))
    for c in range(1, 6):
        m.insert_batch(data[c * 200:(c + 1) * 200])
    m.insert_batch(rng.normal(size=(17, 16)).astype(np.float32))
    for g in range(0, 1200, 7):
        m.delete(g)
    return m


@pytest.mark.parametrize("kw", [dict(method="stacked"),
                                dict(method="stacked", probe_dtype="bf16"),
                                dict(method="stacked", probe_dtype="int8"),
                                dict(method="stacked", probe_tiles=0),
                                dict(method="pallas", stacked=False)])
def test_mutable_index_on_card_matches_host(cuda, kw):
    on_card, on_host = _mutable(cuda), _mutable("cpu")
    q = np.random.default_rng(5).normal(size=(19, 17)).astype(np.float32)
    before = tss.LAUNCHES
    cd, ci, cs = on_card.query(q, 10, return_stats=True, **kw)
    hd, hi, hs = on_host.query(q, 10, return_stats=True, **kw)
    assert_topk_parity(cd, ci, hd, hi)
    assert cs == hs
    launched = tss.LAUNCHES - before
    assert launched == (0 if kw.get("stacked") is False
                        else 1 if kw.get("probe_tiles") == 0 else 2)
    X, G = on_card.snapshot().live_points()
    qn = normalize_query(q)
    assert_exact_topk(cd, ci,
                      G[oracle(X, qn, 11)[1]],
                      torch.from_numpy(_by_gid(X, G)).to(cuda),
                      torch.from_numpy(qn).to(cuda))


def _by_gid(X, G):
    """Rows of ``X`` placed at their gids (a table ``assert_exact_topk``
    can index by the answers' global ids)."""
    out = np.zeros((int(G.max()) + 1, X.shape[1]), np.float32)
    out[G] = X
    return out


def test_tombstone_reuploads_only_the_ids_plane(cuda):
    m = _mutable(cuda, seed=1)
    q = np.random.default_rng(6).normal(size=(8, 17)).astype(np.float32)
    for dt in ("f32", "bf16", "int8"):
        m.query(q, 5, method="stacked", probe_dtype=dt)
    stk = m.snapshot().stacked_leaves()
    geometry = {name: getattr(stk, name).data_ptr() for name in (
        "pts", "rx", "xc", "xs", "leaf_centers", "leaf_radii", "leaf_cnorm")}
    derived = {key: id(v) for key, v in stk._derived.items()
               if key.startswith("geom:") or key == "pts_lane"}
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(cuda)
    victim = int(m.snapshot().segments[3].gids[5])
    assert m.delete(victim)
    new = m.snapshot().stacked_leaves()
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated(cuda) - before
    assert {name: getattr(new, name).data_ptr()
            for name in geometry} == geometry
    assert {key: id(new._derived[key]) for key in derived} == derived
    assert new.ids.data_ptr() != stk.ids.data_ptr()
    # the new ids and valid planes (and the ids plane of the tombstoned
    # segment's tree): nothing the size of the points
    assert grown < 4 * stk.ids.nbytes + 4 * stk.valid.nbytes
    assert victim not in set(new.ids.flatten().tolist())
