"""The port's three P2HNNS examples on the CPU, held to the JAX package's
examples at the same seeds: quickstart's lines, active learning's
per-round accuracies, and the serving example's answers against the
oracle."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_parity import assert_topk_parity, oracle  # noqa: E402
from repro_torch.core.balltree import append_ones, normalize_query  # noqa: E402

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _result_lines(text):
    """The printed lines that hold results (not the build's timing)."""
    return [line for line in text.splitlines()
            if not line.startswith("built BC-Tree")]


def test_quickstart_matches_the_jax_example(capsys):
    _load("quickstart").main()
    want = _result_lines(capsys.readouterr().out)
    out = _load("quickstart_torch").main(["--device", "cpu"])
    got = _result_lines(capsys.readouterr().out)
    assert out["dfs_equals_exact"] and out["sweep_equals_exact"]
    assert got == want  # dfs/sweep == exact, beam recall, distances
    assert f"beam(5%) recall: {out['beam_recall']:.2f}" in want


def test_active_learning_matches_the_jax_example(monkeypatch):
    jal = _load("active_learning")
    real, seen = jal.accuracy, []

    def accuracy(*args):  # records what the JAX example prints
        seen.append(real(*args))
        return seen[-1]

    monkeypatch.setattr(jal, "accuracy", accuracy)
    jal.main(rounds=3)
    got = _load("active_learning_torch").main(rounds=3, device="cpu")
    assert got == {"margin (BC-Tree)": seen[:3], "random": seen[3:]}
    assert len(seen) == 6


def test_serve_batch_serves_every_query():
    out = _load("serve_batch_torch").main(
        ["--n", "2000", "--queries", "24", "--device", "cpu"])
    assert len(out["results"]) == 24
    assert sum(out["stats"]["routes"].values()) == 3  # 24 in slots of 8
    # the example's data, rebuilt from its seed, and the oracle over it
    rng = np.random.default_rng(0)
    cents = rng.normal(size=(32, 32)) * 3
    data = (cents[rng.integers(0, 32, 2000)]
            + rng.normal(size=(2000, 32))).astype(np.float32)
    od, oi, nxt = oracle(append_ones(data), normalize_query(out["trace"]), 10)
    bd = np.stack([d for d, _ in out["results"]])
    bi = np.stack([i for _, i in out["results"]])
    assert np.isfinite(bd).all() and bd.shape == (24, 10)
    assert_topk_parity(bd, bi, od, oi, nxt)


def test_train_lm_example_learns_and_restarts(tmp_path):
    """The port's LM training example at a few steps on the host, with its
    injected crash: it resumes once and the loss falls."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = _load("train_lm_torch").main(
            ["--steps", "24", "--batch", "4", "--seq", "32", "--device",
             "cpu", "--demo-crash", "--ckpt", str(tmp_path / "ckpt")])
    finally:
        torch.set_num_threads(threads)
    assert out["restarts"] == 1
    assert out["last_loss"] < out["first_loss"]
    assert out["history"][-1]["step"] == 23
