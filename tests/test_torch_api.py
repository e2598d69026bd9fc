"""The port's slice as a whole: ``P2HIndex`` against the JAX package's and
the brute-force oracle, the shared on-disk format in both directions, and
the device policy (no CUDA and no ``device=`` -> an error, never the CPU).
"""
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_topk_parity, oracle  # noqa: E402
from repro.core.api import P2HIndex as JIndex  # noqa: E402
from repro_torch.core.api import P2HIndex  # noqa: E402
from repro_torch.core.balltree import append_ones, normalize_query  # noqa: E402
from repro_torch.core.exact import assert_exact_topk  # noqa: E402
from repro_torch.data.pipeline import make_p2h_dataset  # noqa: E402
from repro_torch.launch import platform  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

DATA = {
    # name -> (n, d, n0, kind, seed, k)
    "planted": (4000, 32, 32, "planted", 0, 10),
    "clustered": (3000, 16, 64, "clustered", 1, 1),
    "normal": (1500, 8, 64, "normal", 2, 5),
}


@pytest.fixture(scope="module", params=sorted(DATA))
def pair(request):
    """(data, queries, port index, JAX index, k) on one dataset."""
    n, d, n0, kind, seed, k = DATA[request.param]
    x, q = make_p2h_dataset(n, d, kind=kind, n_queries=11, seed=seed)
    return (x, q, P2HIndex.build(x, n0=n0, seed=seed, device="cpu"),
            JIndex.build(x, n0=n0, seed=seed), k)


@pytest.mark.parametrize("method,kw", [
    ("dfs", {}),
    ("sweep", {}),
    ("beam", dict(frac=0.1)),
    ("kernel", {}),
])
def test_query_matches_jax_and_oracle(pair, method, kw):
    x, q, tidx, jidx, k = pair
    td, ti, ts = tidx.query(q, k, method=method, return_stats=True, **kw)
    # repro's kernel route on its jnp reference (use_ref): the Pallas
    # interpreter itself is held to it in tests/test_torch_kernels.py
    jkw = dict(kw, use_ref=True) if method == "kernel" else kw
    jd, ji, js = jidx.query(q, k, method="pallas" if method == "kernel"
                            else method, return_stats=True, **jkw)
    assert isinstance(td, np.ndarray) and ti.dtype == np.int32
    pts, qn = append_ones(x), normalize_query(q)
    od, oi, _ = oracle(pts, qn, k + 1)  # top-(k+1): the boundary tie
    exact = method != "beam"
    assert_topk_parity(td, ti, jd, ji, od[:, k] if exact else None)
    assert ts == js
    if exact:
        assert_exact_topk(td, ti, oi, torch.from_numpy(pts),
                          torch.from_numpy(qn))


def test_kernel_route_takes_no_plain_option(pair):
    """On the card the kernel route launches the kernel or raises: it has no
    switch to the plain version."""
    _, q, tidx, _, _ = pair
    with pytest.raises(TypeError, match="use_ref"):
        tidx.query(q, 3, method="kernel", use_ref=True)


def test_pallas_is_the_kernel_route(pair):
    _, q, tidx, _, _ = pair
    a = tidx.query(q, 5, method="kernel", return_stats=True)
    b = tidx.query(q, 5, method="pallas", return_stats=True)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]


def test_ball_variant_matches_jax():
    x, q = make_p2h_dataset(2000, 16, kind="clustered", n_queries=9, seed=5)
    tidx = P2HIndex.build(x, n0=64, variant="ball", device="cpu")
    jidx = JIndex.build(x, n0=64, variant="ball")
    assert tidx.report.index_bytes == jidx.report.index_bytes
    for method in ("dfs", "sweep"):
        td, ti, ts = tidx.query(q, 3, method=method, return_stats=True)
        jd, ji, js = jidx.query(q, 3, method=method, return_stats=True)
        assert_topk_parity(td, ti, jd, ji)
        assert ts == js
        assert ts["ball_pruned"] == ts["cone_pruned"] == 0


def test_jax_saved_index_loads_in_port(tmp_path, pair):
    _, q, tidx, jidx, _ = pair
    path = tmp_path / "jax.npz"
    jidx.save(str(path))
    loaded = P2HIndex.load(str(path), device="cpu")
    assert loaded.variant == jidx.variant
    assert loaded.report == tidx.report.__class__(**vars(jidx.report))
    for name, arr in loaded.tree.to_numpy().items():
        np.testing.assert_array_equal(arr, np.asarray(getattr(jidx.tree, name)))
    assert loaded.tree.statics() == tidx.tree.statics()
    a = loaded.query(q, 4, method="sweep")
    b = jidx.query(q, 4, method="sweep")
    assert_topk_parity(*a, *b)


def test_port_saved_index_loads_in_jax(tmp_path, pair):
    _, q, tidx, _, _ = pair
    path = tmp_path / "port.npz"
    tidx.save(str(path))
    back = JIndex.load(str(path))
    assert back.variant == tidx.variant
    for name, arr in tidx.tree.to_numpy().items():
        np.testing.assert_array_equal(np.asarray(getattr(back.tree, name)),
                                      arr)
        assert np.asarray(getattr(back.tree, name)).dtype == arr.dtype
    assert back.report.num_leaves == tidx.report.num_leaves
    a = tidx.query(q, 4, method="dfs")
    b = back.query(q, 4, method="dfs")
    assert_topk_parity(*a, *b)
    # and the port reads its own file back
    again = P2HIndex.load(str(path), device="cpu")
    np.testing.assert_array_equal(again.query(q, 4, method="dfs")[1], a[1])


def test_load_rejects_foreign_files(tmp_path):
    bad = tmp_path / "legacy.pkl"
    bad.write_bytes(b"not a zip")
    with pytest.raises(ValueError, match="not a p2h-index"):
        P2HIndex.load(str(bad), device="cpu")
    other = tmp_path / "other.npz"
    with open(other, "wb") as fh:
        np.savez(fh, __header__=np.asarray('{"format": "x"}'))
    with pytest.raises(ValueError, match="not a p2h-index"):
        P2HIndex.load(str(other), device="cpu")


def test_device_none_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x, _ = make_p2h_dataset(200, 4, n_queries=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        platform.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P2HIndex.build(x, n0=32)
    assert platform.resolve_device("cpu") == torch.device("cpu")


def test_full_precision_policy():
    platform.ensure_full_precision()
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"
    report = platform.device_report()
    assert set(report) == {"name", "count", "allow_tf32", "matmul_precision"}
    assert report["matmul_precision"] == "highest"


def test_engine_and_recall_target_are_refused(pair):
    """An engine serves only its own index, and ``recall_target`` needs an
    engine; through its own engine both are served (the budgeted route)."""
    from repro_torch.serve import P2HEngine

    x, q, tidx, _, _ = pair
    other = P2HIndex.build(x[:500], n0=32, device="cpu")
    with pytest.raises(ValueError, match="different index"):
        tidx.query(q, 1, engine=P2HEngine(other))
    with pytest.raises(ValueError, match="recall_target"):
        tidx.query(q, 1, recall_target=0.9)
    eng = P2HEngine(tidx)
    bd, bi = tidx.query(q, 1, engine=eng, recall_target=0.9)
    assert bd.shape == bi.shape == (len(q), 1)
    assert set(eng.stats()["routes"]) == {"beam"}
    with pytest.raises(ValueError, match="unknown method"):
        tidx.query(q, 1, method="nope")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """``chip_smoke.py`` exits non-zero and prints no result line where
    there is no CUDA device, and where the rest of the repo is missing."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
