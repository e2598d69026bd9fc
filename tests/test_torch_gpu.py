"""The CUDA sweep kernel against its plain version, on the card.

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
