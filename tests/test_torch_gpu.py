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
from repro_torch.core.exact import (  # noqa: E402
    assert_exact_topk,
    assert_topk_close,
    dists64,
    exact_search,
)
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


def _kernel_vs_plain(opnds, k, bq, split=None, exact=False, **kw):
    """The kernel and its plain version at the same schedule (``split``:
    the wrapper's default for the card when None): ids under the tie rule,
    skip counts equal, and with ``exact`` distances bit for bit."""
    if split is None:
        split = p2h_scan.default_split(opnds, k=k, bq=bq)
    before = p2h_scan.p2h_sweep.launches
    kd, ki, ks = p2h_scan.p2h_sweep(**opnds, k=k, bq=bq, split=split, **kw)
    torch.cuda.synchronize()
    assert p2h_scan.p2h_sweep.launches == before + 1
    order = torch.argsort(kd, dim=1, stable=True)
    kd, ki = torch.gather(kd, 1, order), torch.gather(ki, 1, order)
    rd, ri, rs = ref.p2h_sweep_ref(**opnds, k=k, bq=bq, split=split, **kw)
    assert_topk_parity(kd.cpu().numpy(), ki.cpu().numpy(), rd.cpu().numpy(),
                       ri.cpu().numpy())
    assert torch.equal(ks, rs)
    if exact:
        assert torch.equal(kd, rd)
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


@pytest.mark.parametrize("split", [1, 2, 8])
def test_kernel_all_skipped_block(cuda, split):
    """A zero cap makes every tile of block 0 a skip (on every CTA of its
    cluster): the block's top-k stays empty; block 1 (no cap) is scanned
    normally."""
    _, qn, tree = _setup(3000, 16, 64, 16, seed=2)
    cap = torch.full((16,), float("inf"))
    cap[:8] = 0.0
    opnds, _ = ops.prepare_operands(tree.to(cuda),
                                    torch.from_numpy(qn).to(cuda),
                                    lambda_cap=cap)
    ks = _kernel_vs_plain(opnds, 10, 8, split)
    n_visit = opnds["visit"].shape[1]
    assert int(ks[0, 0]) == n_visit and int(ks[1, 0]) < n_visit
    kd, ki, _ = p2h_scan.p2h_sweep(**opnds, k=10, split=split)
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


# ---------------------------------- the redesigned K1: bq and split schedules
@pytest.mark.parametrize("bq,split,n0,k", [
    (1, 1, 64, 1), (1, 2, 256, 10), (1, 8, 512, 64),
    (8, 1, 256, 10), (8, 2, 512, 1), (8, 8, 64, 64),
    (16, 1, 512, 64), (16, 2, 64, 10), (16, 8, 256, 1),
    (32, 1, 64, 64), (32, 2, 256, 10), (32, 8, 512, 10),
    (64, 1, 256, 64), (64, 2, 512, 10), (64, 8, 64, 1),
    (64, 6, 256, 32), (8, 6, 256, 33),  # the register top-k's limit
])
def test_kernel_matches_plain_at_every_schedule(cuda, bq, split, n0, k):
    """Three query blocks at every supported block size and split, tiles of
    64 to 512 rows (up to two passes of the slab ring), k from 1 to 64.
    Distances are bit for bit where the plain version's cuBLAS ``bmm`` is a
    batch of several multi-row products (it sums in column order there, as
    the kernel does); a batch of single-row products or a single product
    takes other algorithms, and is held at the tie rule's tolerance."""
    _, qn, tree = _setup(6000, 20, n0, 3 * bq, seed=bq + split)
    opnds, _ = ops.prepare_operands(tree.to(cuda),
                                    torch.from_numpy(qn).to(cuda), bq=bq)
    _kernel_vs_plain(opnds, k, bq, split, exact=bq > 1)


@pytest.mark.parametrize("split", [1, 2, 8])
@pytest.mark.parametrize("kw", [dict(frac=0.3), dict(capped=True),
                                dict(use_ball=False), dict(use_cone=False)])
def test_kernel_budget_caps_and_bounds_at_bq64(cuda, split, kw):
    kw = dict(kw)
    x, qn, tree = _setup(5000, 24, 64, 128, seed=11)
    cap = None
    if kw.pop("capped", False):  # the true 10th, widened: a valid bound
        cap = torch.from_numpy(oracle(append_ones(x), qn, 10)[0][:, -1]
                               * 1.001).float()
    frac = kw.pop("frac", 1.0)
    opnds, _ = ops.prepare_operands(tree.to(cuda),
                                    torch.from_numpy(qn).to(cuda), bq=64,
                                    frac=frac, lambda_cap=cap)
    _kernel_vs_plain(opnds, 10, 64, split, exact=True, **kw)


def test_kernel_default_schedule_on_card(cuda):
    """``bq=None`` is the card's block and ``split=None`` the largest split
    whose clusters all run at once; the result equals the oracle."""
    x, q = make_p2h_dataset(20000, 32, kind="planted", n_queries=200, seed=9)
    tree = build_tree(x, n0=128, seed=9)
    qn = normalize_query(q)
    q_t = torch.from_numpy(qn).to(cuda)
    assert p2h_scan.resolve_bq(None, 200, cuda) == 64
    opnds, _ = ops.prepare_operands(tree.to(cuda), q_t, bq=64)
    split = p2h_scan.default_split(opnds, k=10, bq=64)
    nqb = opnds["visit"].shape[0]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert 1 <= split <= 8 and nqb * split <= sms
    assert nqb <= p2h_scan.max_active_clusters(
        bq=64, split=split, n0=128, dp=opnds["queries"].shape[1], k=10)
    _kernel_vs_plain(opnds, 10, 64, exact=True)
    before = p2h_scan.p2h_sweep.launches
    d, i, _ = ops.sweep_search_kernel(tree.to(cuda), q_t, 10)
    assert p2h_scan.p2h_sweep.launches == before + 1
    pts = append_ones(x)
    assert_exact_topk(d, i, oracle(pts, qn, 11)[1],
                      torch.from_numpy(pts).to(cuda), q_t)


def test_kernel_refusals_never_fall_back(cuda, monkeypatch):
    """An unsupported bq or split, too much shared memory and a refused
    cluster launch (16 CTAs, past the portable 8) raise; the plain version
    is never reached from a CUDA tensor, and nothing counts as a launch."""
    _, qn, tree = _setup(2000, 12, 64, 64, seed=5)
    opnds, _ = ops.prepare_operands(tree.to(cuda),
                                    torch.from_numpy(qn).to(cuda), bq=64)

    def plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "p2h_sweep_ref", plain)
    before = p2h_scan.p2h_sweep.launches
    with pytest.raises(ValueError, match="bq"):
        p2h_scan.p2h_sweep(**opnds, k=5, bq=128)
    with pytest.raises(ValueError, match="split"):
        p2h_scan.p2h_sweep(**opnds, k=5, bq=64, split=9)
    with pytest.raises(ValueError, match="shared memory"):
        p2h_scan.p2h_sweep(**opnds, k=50_000, bq=64, split=1)
    with pytest.raises(RuntimeError, match="launch failed"):
        p2h_scan._launch(opnds, k=5, bq=64, split=16, use_ball=True,
                         use_cone=True)
    assert p2h_scan.p2h_sweep.launches == before
    kd, _, _ = p2h_scan.p2h_sweep(**opnds, k=5, bq=64, split=2)  # still fine
    assert torch.isfinite(kd).all()


@pytest.mark.parametrize("method", ["kernel", "sweep", "dfs", "beam"])
def test_index_on_card_matches_host_and_oracle(cuda, method):
    x, q = make_p2h_dataset(6000, 24, kind="planted", n_queries=19, seed=3)
    on_card = P2HIndex.build(x, n0=64, device=cuda)
    on_host = P2HIndex.build(x, n0=64, device="cpu")
    k, kw = 10, dict(frac=0.2) if method == "beam" else {}
    if method == "kernel":  # the host's schedule, so the counters compare
        kw = dict(bq=8, split=1)
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


def _stacked_vs_plain(ops_, kw, k, bq, split=None):
    """K2 and its plain version at the same schedule (``split``: the
    wrapper's default for the card when None): ids under the tie rule and
    skip counts equal; returns the sorted distances of both and the
    skips."""
    if split is None:
        split = tss.default_split(ops_, k=k, bq=bq,
                                  probe_dtype=kw.get("probe_dtype", "f32"))
    before = tss.LAUNCHES
    kd, ki, ks = tss.stacked_sweep(**ops_, k=k, bq=bq, split=split, **kw)
    torch.cuda.synchronize()
    assert tss.LAUNCHES == before + 1
    rd, ri, rs = ref.stacked_sweep_ref(**ops_, k=k, bq=bq, split=split, **kw)
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


@pytest.mark.parametrize("start", ["cold", "seeded", "global"])
@pytest.mark.parametrize("probe_dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("split", [1, 2, 6])
@pytest.mark.parametrize("bq", [1, 8, 64])
def test_stacked_kernel_matches_plain_at_every_schedule(cuda, bq, split,
                                                        probe_dtype, start):
    """The redesigned K2 at every block size and split of the card, in
    each probe mode, cold, seeded with pass A's planes, and seeded with
    pass A's planes and a global seed (pass B's start), on ragged stacks
    with a dead segment and a bucket-pad row; tiles of 64 or 256 rows and
    k of 1 or 10 rotate through the cases.  Distances are bit for bit
    where the plain version's ``bmm`` is a batch of multi-row products
    (bq > 1); single-row products (bq = 1) take another cuBLAS order and
    are held at the tie rule's tolerance."""
    i = [1, 8, 64].index(bq) * 3 + [1, 2, 6].index(split)
    n0, k = (64, 256)[i % 2], (1, 10)[(i // 2) % 2]
    sizes = (1500, 420, 1, 900, 700) if n0 == 64 else (4000, 1100, 1, 2600,
                                                        1800)
    stk = _stack(cuda, sizes=sizes, n0=n0, seed=i)
    ops_, kw = _stacked_operands(stk, 2 * bq + 3, bq, probe_dtype, seed=i)
    if start != "cold":  # pass A's state of a cold probe of 2 tiles
        sd, si, _ = ref.stacked_sweep_ref(
            **dict(ops_, visit=ops_["visit"][:, :, :2].contiguous()), k=k,
            bq=bq, **kw)
        kw = dict(kw, seed_d=sd, seed_i=si)
        if start == "global":
            kw["global_seed"] = search.merge_topk_planes(sd, si, k)[0]
    kd, rd, ks = _stacked_vs_plain(ops_, kw, k, bq, split)
    if bq > 1:
        assert torch.equal(kd, rd)
    n_visit = ops_["visit"].shape[2]
    assert (ks[4:] == n_visit).all()  # all-tombstone and bucket-pad rows


@pytest.mark.parametrize("k", [32, 33])
@pytest.mark.parametrize("probe_dtype", ["f32", "int8"])
def test_stacked_kernel_at_the_register_topk_limit(cuda, k, probe_dtype):
    """k = 32 is the largest top-k a warp holds in registers while it
    inserts, k = 33 the smallest held in shared memory: both equal the
    plain version, seeded as pass B is."""
    stk = _stack(cuda, sizes=(4000, 1100, 1, 2600, 1800), n0=256, seed=k)
    ops_, kw = _stacked_operands(stk, 131, 64, probe_dtype, seed=k)
    sd, si, _ = ref.stacked_sweep_ref(
        **dict(ops_, visit=ops_["visit"][:, :, :2].contiguous()), k=k,
        bq=64, **kw)
    kw = dict(kw, seed_d=sd, seed_i=si)
    kd, rd, _ = _stacked_vs_plain(ops_, kw, k, 64, 6)
    assert torch.equal(kd, rd)


def test_stacked_kernel_refusals(cuda, monkeypatch):
    """An unsupported split, too much shared memory and a refused cluster
    launch (16 CTAs, past the portable 8) raise; nothing counts as a
    launch, and the plain version is never reached."""
    stk = _stack(cuda, seed=4)
    ops_, _ = _stacked_operands(stk, 130, 64)

    def plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ref, "stacked_sweep_ref", plain)
    before = tss.LAUNCHES
    with pytest.raises(ValueError, match="split"):
        tss.stacked_sweep(**ops_, k=5, bq=64, split=9)
    with pytest.raises(ValueError, match="bq"):
        tss.stacked_sweep(**ops_, k=5, bq=128)
    with pytest.raises(ValueError, match="shared memory"):
        tss.stacked_sweep(**ops_, k=50_000, bq=64, split=1)
    monkeypatch.setattr(tss, "SUPPORTED_SPLIT", tuple(range(1, 17)))
    with pytest.raises(RuntimeError, match="launch failed"):
        tss.stacked_sweep(**ops_, k=5, bq=64, split=16)
    assert tss.LAUNCHES == before
    kd, _, _ = tss.stacked_sweep(**ops_, k=5, bq=64, split=2)  # still fine
    assert torch.isfinite(kd[0]).all()


def test_stacked_query_default_schedule_on_card(cuda):
    """``stacked_sweep_query`` with ``bq=None, split=None`` takes the
    card's block of 64 and the cluster rule's split, and its answer equals
    the host's at the JAX package's schedule (bq = 8, split = 1)."""
    stk = _stack(cuda, sizes=(2500, 900, 1, 1700, 1200), n0=64, seed=7)
    host = _stack("cpu", sizes=(2500, 900, 1, 1700, 1200), n0=64, seed=7)
    q = normalize_query(np.random.default_rng(8).normal(
        size=(150, stk.d)).astype(np.float32))
    before = tss.LAUNCHES
    cd, ci, _, cinfo = tss.stacked_sweep_query(stk, torch.from_numpy(q).to(
        cuda), 10)
    assert tss.LAUNCHES == before + 2
    hd, hi, _, _ = tss.stacked_sweep_query(host, torch.from_numpy(q), 10)
    assert_topk_parity(cd.cpu().numpy(), ci.cpu().numpy(), hd.numpy(),
                       hi.numpy())
    assert cinfo["forced_skips"].sum() > 0
    assert p2h_scan.resolve_bq(None, 150, cuda) == 64


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


@pytest.mark.parametrize("kw", [dict(method="stacked", bq=8, split=1),
                                dict(method="stacked", probe_dtype="bf16",
                                     bq=8, split=1),
                                dict(method="stacked", probe_dtype="int8",
                                     bq=8, split=1),
                                dict(method="stacked", probe_tiles=0, bq=8,
                                     split=1),
                                dict(method="pallas", stacked=False, bq=8,
                                     split=1)])
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


# ----------------------------------------------------------------- serving
def test_engine_dispatch_resolves_to_the_kernel_on_card(cuda):
    """On a CUDA index the engine prefers the kernel route and opens no DFS
    window: a lone query launches K1 (the ``"pallas"`` route)."""
    from repro_torch.serve import P2HEngine

    x, q = make_p2h_dataset(3000, 16, kind="planted", n_queries=4, seed=2)
    idx = P2HIndex.build(x, n0=64, device=cuda)
    eng = P2HEngine(idx)
    assert (eng.policy.prefer_pallas, eng.policy.small_batch) == (True, 0)
    before = p2h_scan.p2h_sweep.launches
    bd, bi = eng.query(q[:1], 5)
    assert p2h_scan.p2h_sweep.launches == before + 1
    assert eng.stats()["routes"] == {"pallas": 1}
    dd, di = idx.query(q[:1], 5, method="dfs")
    assert_topk_parity(bd, bi, dd, di)


@pytest.mark.parametrize("index", ["frozen", "mutable"])
def test_engine_equals_direct_route_cold_and_warm(cuda, index):
    """The engine's answers equal the direct route's bit for bit on the
    card -- the kernel route on a frozen index, the stacked route on a
    mutable one -- cold, and warm from the lambda cache (a valid cap never
    changes an answer)."""
    from repro_torch.serve import P2HEngine

    if index == "frozen":
        x, q = make_p2h_dataset(5000, 24, kind="planted", n_queries=40,
                                seed=3)
        idx = P2HIndex.build(x, n0=64, device=cuda)
        dd, di = idx.query(q, 10, method="kernel")
        route = "pallas"
    else:
        idx = _mutable(cuda, seed=2)
        q = np.random.default_rng(8).normal(size=(40, 17)).astype(np.float32)
        dd, di = idx.query(q, 10, method="stacked", probe_dtype="bf16")
        route = "stacked"
    eng = P2HEngine(idx, slot_size=len(q))
    for _ in range(2):  # cold, then every lookup hits
        bd, bi = eng.query(q, 10)
        assert np.array_equal(bd, dd) and np.array_equal(bi, di)
    assert eng.stats()["routes"] == {route: 2}
    assert eng.cache.hits == len(q)
    small = P2HEngine(idx, slot_size=8)  # 5 batches at bq = 8
    for _ in range(2):
        bd, bi = small.query(q, 10)
        assert_topk_parity(bd, bi, dd, di)


# ------------------------------------------- the sharded index's round 2
def _sharded(device, seed=0):
    """3 hashed shards of 2 sealed segments each, live deltas, deletes."""
    from repro_torch.stream import ShardedMutableP2HIndex

    rng = np.random.default_rng(seed)
    m = ShardedMutableP2HIndex.from_data(
        rng.normal(size=(1800, 16)).astype(np.float32), 3, n0=32,
        device=device, policy=CompactionPolicy(
            delta_capacity=120, tombstone_frac=0.95, max_segments=8))
    m.insert_batch(rng.normal(size=(450, 16)).astype(np.float32))
    for g in range(0, 1800, 11):
        m.delete(g)
    return m


def _recording(monkeypatch):
    """Keep each K2 launch's operands; returns the list they land in."""
    recs, real = [], tss.stacked_sweep

    def recording(*args, **kw):
        recs.append(kw)
        return real(*args, **kw)

    monkeypatch.setattr(tss, "stacked_sweep", recording)
    return recs, real


@pytest.mark.parametrize("kw", [dict(), dict(bq=8, split=1),
                                dict(method="stacked", probe_tiles=2),
                                dict(method="stacked", probe_dtype="bf16",
                                     probe_tiles=2)])
def test_round2_launch_matches_plain(cuda, monkeypatch, kw):
    """Round 2 of the exchange is one K2 launch per batch (two with a probe
    pass) over every shard's segments, with ``shard_bounds``; each launch
    equals its plain version at its schedule, skips included."""
    m = _sharded(cuda)
    q = np.random.default_rng(9).normal(size=(40, 17)).astype(np.float32)
    recs, real = _recording(monkeypatch)
    before = p2h_scan.p2h_sweep.launches
    bd, bi, info = m.query(q, 10, return_info=True, **kw)
    torch.cuda.synchronize()
    assert len(recs) == (2 if kw.get("probe_tiles") else 1)
    assert p2h_scan.p2h_sweep.launches == before  # round 1 is no kernel
    assert info["shard_kth"].shape == (3, len(q))
    for rec in recs:
        split = rec["split"] or tss.default_split(
            rec, k=rec["k"], bq=rec["bq"],
            probe_dtype=rec.get("probe_dtype", "f32"))
        rec = dict(rec, split=split)
        kd, ki, ks = real(**rec)
        rd, ri, rs = ref.stacked_sweep_ref(**rec)
        assert torch.equal(ks, rs)
        assert torch.equal(kd, rd)
        rd2 = rd.reshape(-1, 10).cpu().numpy()
        assert_topk_parity(kd.reshape(-1, 10).cpu().numpy(),
                           ki.reshape(-1, 10).cpu().numpy(), rd2,
                           ri.reshape(-1, 10).cpu().numpy(), rd2[:, -1])
    X, G = m.snapshot().live_points()
    qn = normalize_query(q)
    assert_exact_topk(bd, bi, G[oracle(X, qn, 11)[1]],
                      torch.from_numpy(_by_gid(X, G)).to(cuda),
                      torch.from_numpy(qn).to(cuda))
    assert (info["lambda0"] >= oracle(X, qn, 10)[0][:, -1] - 1e-6).all()


@pytest.mark.parametrize("kw", [dict(bq=8, split=1),
                                dict(method="pallas", stacked=False, bq=8,
                                     split=1)])
def test_sharded_on_card_matches_host(cuda, kw):
    """The exchange on the card equals the host's at the host's schedule:
    answers within the tie rule, counters and per-shard k-ths equal; the
    sequential round 2 launches K1 once per live segment."""
    on_card, on_host = _sharded(cuda, seed=1), _sharded("cpu", seed=1)
    q = np.random.default_rng(10).normal(size=(24, 17)).astype(np.float32)
    before = p2h_scan.p2h_sweep.launches
    cd, ci, cs, cinfo = on_card.query(q, 10, return_stats=True,
                                      return_info=True, **kw)
    launched = p2h_scan.p2h_sweep.launches - before
    hd, hi, hs, hinfo = on_host.query(q, 10, return_stats=True,
                                      return_info=True, **kw)
    assert_topk_parity(cd, ci, hd, hi)
    assert cs == hs
    np.testing.assert_allclose(cinfo["shard_kth"], hinfo["shard_kth"],
                               rtol=1e-5, atol=1e-6)
    live_segs = sum(1 for s in on_card.snapshot().segments if s.live)
    assert launched == (live_segs if kw.get("stacked") is False else 0)


def _failing_supervisor(plans):
    from repro_torch.runtime.fault_tolerance import RetryPolicy
    from repro_torch.serve import (FaultInjector, FaultSpec,
                                   ResilienceConfig, ShardSupervisor)

    return ShardSupervisor(ResilienceConfig(
        shard_timeout_s=60.0, breaker_failures=99,
        fault_injector=FaultInjector(
            {s: [FaultSpec("error", **kw)] for s, kw in plans.items()}),
        retry=RetryPolicy(max_restarts=0)))


@pytest.mark.parametrize("armed", [False, True])
def test_round2_launch_error_raises_on_card(cuda, monkeypatch, armed):
    """A K2 wrapper that raises on the card surfaces from the exchange as
    ``DeviceFault``, armed with a supervisor or not: no shard is answered
    by a plain sweep instead, and K1 never launches."""
    from repro_torch.serve import DeviceFault

    m = _sharded(cuda, seed=2)

    def broken(*a, **kw):
        raise RuntimeError("K2 launch failed")

    monkeypatch.setattr(tss, "stacked_sweep", broken)
    q = np.random.default_rng(12).normal(size=(16, 17)).astype(np.float32)
    kw = {"resilience": _failing_supervisor({})} if armed else {}
    before = p2h_scan.p2h_sweep.launches
    with pytest.raises(DeviceFault, match="K2 launch failed"):
        m.query(q, 10, **kw)
    assert p2h_scan.p2h_sweep.launches == before


def test_failed_round2_unit_isolates_on_the_kernel_on_card(cuda,
                                                           monkeypatch):
    """Shard 1 answers round 1, then fails round 2's one K2 launch and its
    own call: shards 0 and 2 are each answered by a K2 launch of their
    own, never by a plain sweep, and equal the live-shard oracle."""
    from repro_torch.stream import snapshot as tsnap

    m = _sharded(cuda, seed=3)
    swept, real_seg = [], tsnap._segment_query

    def seg_spy(*a, **kw):
        swept.append(kw["method"])
        return real_seg(*a, **kw)

    monkeypatch.setattr(tsnap, "_segment_query", seg_spy)
    recs, _ = _recording(monkeypatch)
    q = np.random.default_rng(13).normal(size=(16, 17)).astype(np.float32)
    bd, bi, info = m.query(q, 10, return_info=True,
                           resilience=_failing_supervisor({1: {"after": 1}}))
    torch.cuda.synchronize()
    assert info["missing_shards"] == (1,)
    assert len(recs) >= 2 and set(swept) == {"beam"}
    snaps = [s for si, s in enumerate(m.snapshot().shards) if si != 1]
    X = np.concatenate([s.live_points()[0] for s in snaps])
    G = np.concatenate([s.live_points()[1] for s in snaps])
    qn = normalize_query(q)
    assert_exact_topk(bd, bi, G[oracle(X, qn, 11)[1]],
                      torch.from_numpy(_by_gid(X, G)).to(cuda),
                      torch.from_numpy(qn).to(cuda))


@pytest.mark.parametrize("kind", ["nh", "fh"])
@pytest.mark.parametrize("budget", [256, 2048])
def test_hash_baselines_on_card_match_host(cuda, kind, budget):
    """NH and FH: the card's batched verification equals the host's on the
    same tables (``from_arrays`` of one build), ``verified`` equal, across
    several 256-query chunks.  The two sum each f32 product in another
    order, each a few ``u S`` off float64 (``u = 2**-24``, ``S`` the row's
    largest ``sum_j |q_j x_j|``: ~20 here, so ~1e-6 a unit), so a row's
    ties are judged at 6 ``u S``, the tolerance ``chip_smoke.py`` holds
    them to."""
    from repro_torch.core.fh import FHIndex
    from repro_torch.core.nh import NHIndex

    x, q = make_p2h_dataset(20_000, 32, kind="planted", n_queries=600,
                            seed=4)
    cls = NHIndex if kind == "nh" else FHIndex
    host = cls.build(x, m=16, lam=128, device="cpu")
    fields = {f: getattr(host, f) for f in (
        ("proj", "bias", "width", "bucket_keys", "bucket_ids", "M")
        if kind == "nh" else ("proj", "part_slices", "sorted_vals",
                              "sorted_ids"))}
    card = cls.from_arrays(**fields, lifted_pairs=host.lifted_pairs,
                           data=host.data.numpy(), device=cuda)
    assert card.data.device.type == "cuda"
    hd, hi, hs = host.query(q, 10, budget=budget)
    cd, ci, cs = card.query(q, 10, budget=budget)
    assert cs == hs
    qn = torch.from_numpy(normalize_query(q))
    mag = dists64(host.data, qn, torch.from_numpy(hi).long())[1]
    tol = np.maximum(6 * 2.0 ** -24 * mag.amax(1).numpy(), 1e-6)
    assert_topk_close(cd, ci, hd, hi, rtol=1e-5, atol=tol)


# -------------------------------------------------------------- the mesh
@pytest.mark.parametrize("kw", [dict(), dict(probe_tiles=0),
                                dict(probe_dtype="bf16"),
                                dict(probe_dtype="int8")])
def test_mutable_index_on_a_card_mesh_equals_one_launch(cuda, kw):
    """The card named at 4 mesh positions, a stream each: the stacked route
    launches K2 once a position and pass and answers bit for bit as the
    one launch."""
    from repro_torch.launch.mesh import make_mesh

    m = _mutable(cuda)
    mesh = make_mesh((4,), ("shard",), devices=[cuda] * 4)
    q = np.random.default_rng(7).normal(size=(19, 17)).astype(np.float32)
    before = tss.LAUNCHES
    d0, i0 = m.query(q, 10, method="stacked", **kw)
    one = tss.LAUNCHES - before
    d1, i1 = m.query(q, 10, method="stacked", mesh=mesh, **kw)
    torch.cuda.synchronize()
    assert tss.LAUNCHES - before - one == 4 * one
    assert np.array_equal(d0, d1) and np.array_equal(i0, i1)


def test_sharded_forest_on_a_card_mesh(cuda):
    """One tree a position on the card: K1 at every position in both
    rounds (8 launches), the host forest's answers within the tie rule, the
    oracle at float64, and the engine's ``"sharded"`` route bit for bit
    the direct query."""
    from repro_torch.core.distributed import ShardedP2HIndex
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serve import P2HEngine

    x, q = make_p2h_dataset(4000, 16, kind="planted", n_queries=37, seed=3)
    idx = ShardedP2HIndex.build(x, make_mesh((4,), ("data",),
                                             devices=[cuda] * 4), n0=64)
    before = p2h_scan.p2h_sweep.launches
    bd, bi, _ = idx.query(q, 10)
    torch.cuda.synchronize()
    assert p2h_scan.p2h_sweep.launches == before + 8
    host = ShardedP2HIndex.build(x, make_mesh((4,), ("data",),
                                              devices=["cpu"] * 4), n0=64)
    hd, hi, _ = host.query(q, 10)
    assert_topk_parity(bd, bi, hd, hi)
    pts = append_ones(x)
    qn = normalize_query(q)
    assert_exact_topk(bd, bi, oracle(pts, qn, 11)[1],
                      torch.from_numpy(pts).to(cuda),
                      torch.from_numpy(qn).to(cuda))
    eng = P2HEngine(P2HIndex.build(x, n0=64, device=cuda), sharded=idx,
                    slot_size=len(q))
    ed, ei = eng.query(q, 10)
    assert eng.stats()["routes"] == {"sharded": 1}
    assert np.array_equal(ed, bd) and np.array_equal(ei, bi)


# ------------------------------------------------- the LM substrate (slice 9)
def _plain_attention(q, k, v, scale):
    S, G = q.shape[1], q.shape[2] // k.shape[2]
    kr = k.float().repeat_interleave(G, dim=2)
    vr = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kr)
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vr)


@pytest.mark.parametrize("dtype,bound", [(torch.float32, 2e-5),
                                         (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("S,chunk", [(512, 128), (300, 128)])
def test_lm_attention_on_card_matches_plain(cuda, dtype, bound, S, chunk):
    """``gqa_attention``'s forward and its ``autograd.Function`` backward
    on the card against dense attention written plainly (normwise: f32
    sums in another order; in bf16 the probabilities, outputs and
    gradients are rounded to bf16)."""
    from repro_torch.models.attention import gqa_attention

    gen = torch.Generator().manual_seed(0)
    q, k, v, ct = (torch.randn(s, generator=gen).to(cuda) for s in (
        (2, S, 8, 64), (2, S, 2, 64), (2, S, 2, 64), (2, S, 8, 64)))
    q, k, v = (t.to(dtype).requires_grad_(True) for t in (q, k, v))
    pos = torch.arange(S, device=cuda)
    got = gqa_attention(q, k, v, pos, pos, causal=True, q_chunk=chunk,
                        kv_chunk=chunk, compute_dtype=dtype)
    want = _plain_attention(q, k, v, 1 / 8)
    gg = torch.autograd.grad((got.float() * ct).sum(), (q, k, v))
    gw = torch.autograd.grad((want * ct).sum(), (q, k, v))
    assert got.dtype == dtype and got.device.type == "cuda"
    for a, b in zip((got, *gg), (want, *gw)):
        a, b = a.detach().float(), b.detach().float()
        assert float((a - b).abs().max() / b.abs().max()) <= bound


def test_lm_train_step_on_card_matches_host(cuda):
    """One ``make_train_step`` step of the same smoke model (the same seed
    draws the same parameters on both devices) on the same batch, f32
    compute: the card's loss, gradient norm and parameters against the
    host's."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import get_config
    from repro_torch.models.transformer import StackedLM
    from repro_torch.optim import adamw_init, cosine_schedule

    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype=torch.float32)
    batch = SyntheticLMDataset(vocab=cfg.vocab, seq=64, global_batch=4,
                               seed=0).global_batch_arrays(0)
    out = {}
    for dev in ("cpu", cuda):
        model = StackedLM(cfg, seed=0, device=dev)
        step = make_train_step(model, cfg, lr_fn=lambda s: cosine_schedule(
            s, peak_lr=1e-3, warmup_steps=1, total_steps=2))
        m = step(adamw_init(dict(model.named_parameters())),
                 {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        out[str(dev)] = ({k: float(x) for k, x in m.items()},
                         [p.detach().cpu() for p in model.parameters()])
    (mh, ph), (mc, pc) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(mc["loss"], mh["loss"], rtol=1e-5)
    np.testing.assert_allclose(mc["grad_norm"], mh["grad_norm"], rtol=1e-4)
    for a, b in zip(pc, ph):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=2 * mh["lr"])


def test_lm_entry_points_default_to_the_card(cuda):
    from repro_torch.models.registry import get_model

    model, cfg = get_model("llama3.2-1b", smoke=True)
    assert model.device.type == "cuda"
    assert not torch.backends.cuda.matmul.allow_tf32


# ------------------------------------- the LM substrate's other families
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "llama4-scout-17b-a16e", "mamba2-780m",
                                  "recurrentgemma-9b", "whisper-tiny",
                                  "phi-3-vision-4.2b"])
def test_lm_family_train_step_on_card_matches_host(cuda, arch):
    """Each family's smoke model (the same seed draws the same parameters
    on both devices), one ``make_train_step`` step on the same batch with
    its seeded extras, f32 compute: the card's loss, aux, gradient norm
    and parameters against the host's."""
    import dataclasses

    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.optim import adamw_init, cosine_schedule

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=torch.float32)
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq=32, global_batch=2, seed=0)
    batch = ds.global_batch_arrays(0)
    batch.update(ds.extra_arrays(0, cfg))
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, seed=0, device=dev)
        step = make_train_step(model, cfg, lr_fn=lambda s: cosine_schedule(
            s, peak_lr=1e-3, warmup_steps=1, total_steps=2))
        m = step(adamw_init(dict(model.named_parameters())),
                 {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        out[str(dev)] = ({k: float(x) for k, x in m.items()},
                         [p.detach().cpu() for p in model.parameters()])
    (mh, ph), (mc, pc) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(mc["loss"], mh["loss"], rtol=1e-5)
    np.testing.assert_allclose(mc["aux_load"], mh["aux_load"], rtol=1e-5)
    np.testing.assert_allclose(mc["grad_norm"], mh["grad_norm"], rtol=1e-4)
    for a, b in zip(pc, ph):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=2 * mh["lr"])


def test_lm_local_attention_on_card_matches_windowed(cuda):
    """The two-block ``local_attention`` on the card against
    ``gqa_attention(window=)`` on the same operands, forward and
    gradients (normwise, f32)."""
    from repro_torch.models.attention import gqa_attention, local_attention

    gen = torch.Generator().manual_seed(0)
    q, k, v, ct = (torch.randn(s, generator=gen).to(cuda) for s in (
        (1, 700, 4, 64), (1, 700, 1, 64), (1, 700, 1, 64), (1, 700, 4, 64)))
    q, k, v = (t.requires_grad_(True) for t in (q, k, v))
    pos = torch.arange(700, device=cuda)
    got = local_attention(q, k, v, pos, window=256,
                          compute_dtype=torch.float32)
    want = gqa_attention(q, k, v, pos, pos, causal=True, window=256,
                         q_chunk=128, kv_chunk=128,
                         compute_dtype=torch.float32)
    gg = torch.autograd.grad((got * ct).sum(), (q, k, v))
    gw = torch.autograd.grad((want * ct).sum(), (q, k, v))
    for a, b in zip((got, *gg), (want, *gw)):
        a, b = a.detach(), b.detach()
        assert float((a - b).abs().max() / b.abs().max()) <= 2e-5


def test_lm_moe_dispatch_on_card_is_repeatable(cuda):
    """The MoE FFN's scatter on the card: two runs on the same inputs give
    the same bits, output and gradients (each slot receives one nonzero
    value, and the combine sums in a fixed order)."""
    from repro_torch.models.layers import ParamInit
    from repro_torch.models.moe import moe_apply, moe_init

    p = moe_init(ParamInit(torch.float32, cuda), 64, 128, 8, shared_ff=32)
    ParamInit.fill(p, 0)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((4, 256, 64), generator=gen).to(cuda)
    runs = []
    for _ in range(2):
        xx = x.clone().requires_grad_(True)
        out, aux = moe_apply(p, xx, top_k=2, capacity_factor=1.0,
                             compute_dtype=torch.bfloat16)
        g = torch.autograd.grad(out.float().square().sum()
                                + aux["load_loss"], [xx, *p.parameters()])
        runs.append([out.detach(), *g])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# ------------------------------------------------- the LM serving path
@pytest.mark.parametrize("hkv", [1, 2])
@pytest.mark.parametrize("mode", ["cache_len", "key_pos_window"])
def test_lm_decode_attention_on_card_matches_host(cuda, hkv, mode):
    """``decode_attention`` on the card against the host on the same
    operands, f32: a valid prefix, and a ring's slot positions under a
    window; one KV head (MQA) and two."""
    from repro_torch.models.attention import decode_attention

    gen = torch.Generator().manual_seed(0)
    B, Smax, Hq, D = 3, 40, 8, 32
    q = torch.randn((B, 1, Hq, D), generator=gen)
    k = torch.randn((B, Smax, hkv, D), generator=gen)
    v = torch.randn((B, Smax, hkv, D), generator=gen)
    if mode == "cache_len":
        args, kw = (torch.tensor([1, 17, 40], dtype=torch.int32),), {}
    else:
        kp = torch.stack([torch.randperm(Smax, generator=gen)
                          for _ in range(B)]).to(torch.int32)
        kp[0, :5] = -1
        args = ()
        kw = dict(key_pos=kp, pos_q=torch.tensor([30, 39, 12],
                                                 dtype=torch.int32),
                  window=16)
    out = {}
    for dev in ("cpu", cuda):
        out[str(dev)] = decode_attention(
            q.to(dev), k.to(dev), v.to(dev), *(a.to(dev) for a in args),
            compute_dtype=torch.float32,
            **{n: (x.to(dev) if torch.is_tensor(x) else x)
               for n, x in kw.items()}).cpu()
    np.testing.assert_allclose(out[str(cuda)].numpy(), out["cpu"].numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "recurrentgemma-9b",
                                  "granite-moe-3b-a800m"])
def test_lm_serve_batch_on_card_matches_host(cuda, arch):
    """``serve_batch`` of one smoke model (the same seed draws the same
    parameters on both devices), f32 compute and cache, on the card and on
    the host; then the host's tokens fed to both: the prefill's and every
    step's logits within rtol 1e-4 and a floor of 1e-4 x max|host|."""
    import dataclasses

    from repro_torch.launch.serve import (
        ServeConfig,
        decode_steps,
        serve_batch,
        serve_inputs,
        serve_len,
    )
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models.registry import build_model, get_config

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=torch.float32,
                              cache_dtype=torch.float32)
    B, P, G = 2, 20, 6
    models = {str(d): build_model(cfg, seed=0, device=d)
              for d in ("cpu", cuda)}
    scfg = {d: ServeConfig(arch=arch, batch=B, prompt_len=P, gen_len=G,
                           device=d) for d in models}
    gens = {d: serve_batch(scfg[d], model=m)[0] for d, m in models.items()}
    assert gens[str(cuda)].shape == (B, G)
    pos0, max_len = serve_len(cfg, P, G)
    logits = {}
    for d, m in models.items():
        lg, cache = make_prefill_step(m, cfg, max_len=max_len)(
            serve_inputs(scfg[d], cfg))
        logits[d] = [lg[:, -1].cpu()] + [
            lg[:, -1].cpu() for _, lg, _ in decode_steps(
                m, cfg, cache, None, pos0=pos0, steps=G, forced=gens["cpu"])]
    for got, want in zip(logits[str(cuda)], logits["cpu"]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()))


# ------------------------------------------------------- LM placement
def _smoke_llama(device):
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.models.registry import get_model

    model, cfg = get_model("llama3.2-1b", smoke=True, seed=0, device=device)
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq=32, global_batch=8, seed=5)
    batches = [{k: torch.from_numpy(v) for k, v in
                ds.global_batch_arrays(s).items()} for s in range(3)]
    return model, cfg, batches


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_lm_placed_step_on_card_matches_one_device(cuda, shape):
    """The placed step on the card named at 4 positions against the
    one-device step on the card: (1, 4) bit for bit over 3 steps (the
    same products on the same device), (2, 2) within the JAX package's
    bars (loss rtol 5e-3, parameters max-abs 5e-2)."""
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import (make_placed_train_step,
                                          make_train_step)
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.placement import gather

    model, cfg, batches = _smoke_llama(cuda)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(model, cfg, lr_fn=lambda s: 1e-3)
    want = [step(opt, {k: v.to(cuda) for k, v in b.items()})
            for b in batches]
    mesh = make_test_mesh(shape, devices=[cuda] * 4)
    placed = make_placed_train_step(build_model(cfg, device="meta"), cfg,
                                    mesh=mesh, params=init,
                                    lr_fn=lambda s: 1e-3)
    popt = adamw_init(placed.params)
    got = [placed(popt, b) for b in batches]
    assert all(s.device.type == "cuda" for p in placed.params.values()
               for s in p.shards.flat)
    for name, p in model.named_parameters():
        g = gather(placed.params[name], cuda)
        if shape == (1, 4):
            assert torch.equal(g, p.detach()), name
            assert torch.equal(gather(popt.mu[name], cuda), opt.mu[name])
            assert torch.equal(gather(popt.nu[name], cuda), opt.nu[name])
        else:
            assert float((g - p.detach()).abs().max()) < 5e-2, name
    for a, b in zip(want, got):
        if shape == (1, 4):
            assert float(a["loss"]) == float(b["loss"])
            assert float(a["grad_norm"]) == float(b["grad_norm"])
        else:
            np.testing.assert_allclose(float(b["loss"]), float(a["loss"]),
                                       rtol=5e-3)


def test_lm_placement_on_card_restores_and_remeshes(cuda):
    """A checkpoint written with no mesh restores placed on the card's
    (2, 2) mesh, and ``elastic_remesh`` moves it to (1, 4) and (4, 1), bit
    for bit, each position holding its resolved bytes on the card; a mesh
    of the card and the host refuses a placed step."""
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_placed_train_step
    from repro_torch.parallel.placement import gather
    from repro_torch.runtime.elastic import elastic_remesh, specs_for_mesh

    model, cfg, _ = _smoke_llama("cpu")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    logical = {n: p.logical for n, p in model.named_parameters()}
    mesh = make_test_mesh((2, 2), devices=[cuda] * 4)
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td)
        mgr.save(1, params, blocking=True)
        tree = mgr.restore(1, params, shardings=specs_for_mesh(
            logical, params, mesh, cfg.rules))
    for shape in ((1, 4), (4, 1), (2, 2)):
        tree = elastic_remesh(tree, logical,
                              make_test_mesh(shape, devices=[cuda] * 4),
                              cfg.rules)
        for name, want in params.items():
            pt = tree[name]
            assert torch.equal(gather(pt, "cpu"), want), (shape, name)
            nbytes = pt.sharding.shard_nbytes(tuple(want.shape), want.dtype)
            assert (pt.nbytes_by_position() == nbytes).all()
            assert all(s.device.type == "cuda" for s in pt.shards.flat)
    mixed = make_test_mesh((2,), ("model",), devices=[cuda, "cpu"])
    with pytest.raises(ValueError, match="one device type"):
        make_placed_train_step(model, cfg, mesh=mixed, params=params,
                               lr_fn=lambda s: 1e-3)
