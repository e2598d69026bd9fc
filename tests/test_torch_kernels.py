"""The sweep kernel's plain version and its backend against the JAX
package, on the CPU.

Both packages prepare their own operands from the same numpy tree and
queries (the port pads ``d`` to a multiple of 4, the JAX package to 128;
zero columns change no product), then the port's ``p2h_sweep_ref`` is held
to ``repro``'s ``p2h_sweep_ref`` -- and once to the Pallas kernel in
interpret mode -- with equal skip counts.  The CUDA kernel itself runs only
on the card (``tests/test_torch_gpu.py``); here the wrapper's host route,
its operand checks and its build errors are tested.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from _torch_parity import assert_topk_parity, oracle  # noqa: E402
from repro.core import balltree as jbt  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.p2h_scan import p2h_sweep as j_p2h_sweep  # noqa: E402
from repro_torch.core import balltree as tbt  # noqa: E402
from repro_torch.core.search import SearchStats  # noqa: E402
from repro_torch.data.pipeline import make_p2h_dataset  # noqa: E402
from repro_torch.kernels import _build, ops, p2h_scan, ref  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    """Planted data whose query blocks skip tiles (13 queries: 2 blocks,
    the second padded by repeating the last query)."""
    x, q = make_p2h_dataset(4000, 32, kind="planted", n_queries=13, seed=4)
    qn = tbt.normalize_query(q)
    return x, qn, tbt.build_tree(x, n0=32), jbt.build_tree(x, n0=32)


def _both_operands(setup, **kw):
    _, qn, ttree, jtree = setup
    tkw = dict(kw)
    if tkw.get("lambda_cap") is not None:
        tkw["lambda_cap"] = torch.from_numpy(tkw["lambda_cap"])
    tops, tb0 = ops.prepare_operands(ttree, torch.from_numpy(qn), **tkw)
    jop, jb0 = jops.prepare_operands(jtree, jnp.asarray(qn), **kw)
    assert tb0 == jb0 == len(qn)
    return tops, jop


def _cap(setup, k, widen=1.001):
    x, qn, _, _ = setup
    return (oracle(tbt.append_ones(x), qn, k)[0][:, -1] * widen).astype(
        np.float32)


def test_prepare_operands_match(setup):
    tops, jop = _both_operands(setup, frac=0.5)
    d = setup[2].d
    assert tops["queries"].shape[1] % 4 == 0 and tops["queries"].shape[1] >= d
    np.testing.assert_array_equal(tops["visit"].numpy(),
                                  np.asarray(jop["visit"]))
    for name in ("ids_tiles", "rx_tiles", "xc_tiles", "xs_tiles",
                 "leaf_cnorm", "cap"):
        np.testing.assert_array_equal(tops[name].numpy(),
                                      np.asarray(jop[name]), err_msg=name)
    for name in ("qnorm", "leaf_ip", "leaf_lb"):
        np.testing.assert_allclose(tops[name].numpy(), np.asarray(jop[name]),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tops["queries"][:, :d].numpy(),
                                  np.asarray(jop["queries"])[:, :d])
    np.testing.assert_array_equal(tops["pts_tiles"][..., :d].numpy(),
                                  np.asarray(jop["pts_tiles"])[..., :d])
    assert not tops["queries"][:, d:].any()


def test_points_padded_once_per_tree(setup):
    """The kernel's operands pad the points once per tree, not per query
    batch; a tree moved to another device pads its own copy."""
    _, qn, ttree, _ = setup
    assert ttree.d % 4  # this tree needs the pad
    a, _ = ops.prepare_operands(ttree, torch.from_numpy(qn))
    b, _ = ops.prepare_operands(ttree, torch.from_numpy(qn[:5]))
    assert a["pts_tiles"].data_ptr() == b["pts_tiles"].data_ptr()
    assert a["pts_tiles"].shape[-1] == ttree.d + (-ttree.d % 4)
    moved = ttree.to("cpu")
    assert moved.points_padded.data_ptr() != ttree.points_padded.data_ptr()
    np.testing.assert_array_equal(moved.points_padded.numpy(),
                                  ttree.points_padded.numpy())


@pytest.mark.parametrize("k,use_ball,use_cone,frac,capped", [
    (1, True, True, 1.0, False),
    (10, True, True, 1.0, False),
    (40, True, True, 1.0, False),
    (10, False, False, 1.0, False),
    (10, True, False, 1.0, False),
    (10, False, True, 1.0, False),
    (10, True, True, 0.3, False),
    (10, True, True, 1.0, True),
])
def test_ref_matches_jax_ref(setup, k, use_ball, use_cone, frac, capped):
    cap = _cap(setup, k) if capped else None
    tops, jop = _both_operands(setup, frac=frac, lambda_cap=cap)
    td, ti, ts = ref.p2h_sweep_ref(**tops, k=k, use_ball=use_ball,
                                   use_cone=use_cone)
    jd, ji, js = jref.p2h_sweep_ref(**jop, k=k, use_ball=use_ball,
                                    use_cone=use_cone)
    assert_topk_parity(td.numpy(), ti.numpy(), np.asarray(jd),
                       np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts.dtype == torch.int32 and ts.shape == (tops["visit"].shape[0], 1)
    if frac == 1.0:  # every block skips, so the counts compared are real
        assert (ts > 0).all()


def test_ref_seeded_matches_jax_ref(setup):
    tops, jop = _both_operands(setup)
    B, k = tops["queries"].shape[0], 5
    rng = np.random.default_rng(0)
    sd = np.sort(rng.uniform(0.05, 0.5, size=(B, k)).astype(np.float32), 1)
    si = rng.integers(10_000, 20_000, size=(B, k)).astype(np.int32)
    td, ti, ts = ref.p2h_sweep_ref(**tops, k=k, seed_d=torch.from_numpy(sd),
                                   seed_i=torch.from_numpy(si))
    jd, ji, js = jref.p2h_sweep_ref(**jop, k=k, seed_d=jnp.asarray(sd),
                                    seed_i=jnp.asarray(si))
    assert_topk_parity(td.numpy(), ti.numpy(), np.asarray(jd),
                       np.asarray(ji))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_ref_live_mask_counts_scanned_tiles(setup):
    tops, _ = _both_operands(setup)
    *_, skips, live = ref.p2h_sweep_ref(**tops, k=10, return_live=True)
    assert live.shape == tops["visit"].shape
    np.testing.assert_array_equal((~live).sum(1).numpy(),
                                  skips[:, 0].numpy())


def test_ref_matches_pallas_kernel_interpret():
    x, q = make_p2h_dataset(600, 12, kind="clustered", n_queries=8, seed=1)
    qn = tbt.normalize_query(q)
    ttree, jtree = tbt.build_tree(x, n0=32), jbt.build_tree(x, n0=32)
    tops, _ = ops.prepare_operands(ttree, torch.from_numpy(qn))
    jop, _ = jops.prepare_operands(jtree, jnp.asarray(qn))
    td, ti, ts = ref.p2h_sweep_ref(**tops, k=4)
    kd, ki, ks = j_p2h_sweep(**jop, k=4, interpret=True)
    order = np.argsort(np.asarray(kd), axis=1, kind="stable")
    assert_topk_parity(td.numpy(), ti.numpy(),
                       np.take_along_axis(np.asarray(kd), order, 1),
                       np.take_along_axis(np.asarray(ki), order, 1))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(ks))


@pytest.mark.parametrize("k,frac", [(10, 1.0), (3, 0.25)])
def test_kernel_backend_matches_jax_backend(setup, k, frac):
    """``sweep_search_kernel`` on host tensors (the plain route) against
    ``repro``'s ``sweep_search_pallas`` on its plain route: answers and the
    kernel path's counter conventions."""
    x, qn, ttree, jtree = setup
    before = p2h_scan.p2h_sweep.launches
    td, ti, tc = ops.sweep_search_kernel(ttree, torch.from_numpy(qn), k,
                                         frac=frac)
    jd, ji, jc = jops.sweep_search_pallas(jtree, jnp.asarray(qn), k,
                                          frac=frac, use_ref=True)
    assert p2h_scan.p2h_sweep.launches == before  # no kernel on the host
    nxt = oracle(tbt.append_ones(x), qn, k)[2] if frac == 1.0 else None
    assert_topk_parity(td.numpy(), ti.numpy(), np.asarray(jd),
                       np.asarray(ji), nxt)
    stats = SearchStats(tc)
    assert stats == {name: int(v) for name, v in
                     zip(SearchStats(np.zeros(8)), np.asarray(jc))}
    assert stats["tiles_skipped"] > 0 or frac < 1.0


def test_wrapper_host_route_is_the_plain_version(setup):
    tops, _ = _both_operands(setup)
    a = p2h_scan.p2h_sweep(**tops, k=7)
    b = ref.p2h_sweep_ref(**tops, k=7)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_wrapper_refuses_other_devices(setup):
    tops, _ = _both_operands(setup)
    meta = {name: t.to("meta") for name, t in tops.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        p2h_scan.p2h_sweep(**meta, k=3)


@pytest.mark.parametrize("change,match", [
    (lambda o: o.update(rx_tiles=o["rx_tiles"].double()), "must be"),
    (lambda o: o.update(leaf_ip=o["leaf_ip"].T.contiguous().T),
     "contiguous"),
    (lambda o: o.update(cap=o["cap"][:-1]), "shape"),
    (lambda o: o.update(queries=o["queries"][:, :-1].contiguous()),
     "multiple of 4"),
])
def test_wrapper_operand_checks(setup, change, match):
    tops, _ = _both_operands(setup)
    change(tops)
    with pytest.raises((ValueError, TypeError), match=match):
        p2h_scan._check(tops, k=3, bq=8)


def test_wrapper_checks_bq_and_n0(setup):
    tops, _ = _both_operands(setup)
    p2h_scan._check(tops, k=3, bq=8)  # the main path's operands pass
    with pytest.raises(ValueError, match="bq"):
        p2h_scan._check(tops, k=3, bq=3)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name, path: None)
    monkeypatch.setattr(_build, "_BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(force=True)
    assert not list(tmp_path.iterdir())


def test_build_targets_hopper_and_hashes_source(monkeypatch):
    assert "arch=compute_90a,code=sm_90a" in _build._FLAGS
    path = _build.library_path()
    assert path.name.startswith("libp2h_sweep-") and path.suffix == ".so"
    assert path.parent.parts[-2:] == ("build", "kernels")
    # a changed flag names another library, so a stale one is never loaded
    monkeypatch.setattr(_build, "_FLAGS", [*_build._FLAGS, "-lineinfo"])
    assert _build.library_path() != path
