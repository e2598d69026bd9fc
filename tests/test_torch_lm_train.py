"""The port's training loop (``launch/train.py``) on the host: the
counterparts of ``tests/test_fault_tolerance.py``'s training tests -- the
loss decreases, an injected crash resumes from the checkpoint to the
uninterrupted run's final loss (rtol 1e-5, the reference's own bar), and
the restart budget runs out -- plus its refusal to run without a device
it was given or a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch.train import TrainConfig, train  # noqa: E402
from repro_torch.runtime import RetryPolicy, run_with_restarts  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps several
    test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(tmp_path, **kw):
    kw = {"steps": 120, "log_every": 20, **kw}
    return TrainConfig(arch="smollm-360m", smoke=True, global_batch=8,
                       seq=32, ckpt_dir=str(tmp_path), ckpt_every=40,
                       peak_lr=3e-3, warmup=15, device="cpu", **kw)


def test_train_decreases_loss(tmp_path):
    model, hist, restarts = train(_cfg(tmp_path / "a"))
    assert restarts == 0
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert [h["step"] for h in hist] == [0, 20, 40, 60, 80, 100, 119]
    assert model.device.type == "cpu"
    assert sorted(hist[0]) == sorted(["loss", "nll", "grad_norm", "lr",
                                      "aux_load", "aux_z", "step", "sec",
                                      "straggler"])


def test_crash_restart_resumes_identically(tmp_path):
    """Kill at step 57 (after the step-40 checkpoint): the supervised rerun
    restores the parameters and the optimiser state and replays the same
    batches to the uninterrupted run's final loss."""
    clean, hist_clean, _ = train(_cfg(tmp_path / "clean"))
    crash, hist_crash, restarts = train(_cfg(tmp_path / "crash"),
                                        fail_at_step=57)
    assert restarts == 1
    assert hist_crash[-1]["step"] == hist_clean[-1]["step"]
    np.testing.assert_allclose(hist_crash[-1]["loss"], hist_clean[-1]["loss"],
                               rtol=1e-5)
    for a, b in zip(clean.parameters(), crash.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_restart_budget_exhausted():
    def make_state():
        return {}

    def body(state):
        raise RuntimeError("always down")

    with pytest.raises(RuntimeError):
        run_with_restarts(make_state, body,
                          policy=RetryPolicy(max_restarts=2))


def test_train_without_a_device_needs_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    cfg = _cfg(tmp_path, steps=2)
    cfg.device = None
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(cfg)


def test_train_f32_compute_override(tmp_path):
    model, hist, _ = train(_cfg(tmp_path, steps=3, log_every=1,
                                compute_dtype=torch.float32))
    assert model.cfg.compute_dtype == torch.float32
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
