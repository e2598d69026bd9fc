"""The training loop: deterministic data -> train step -> checkpoint and
restart -- the PyTorch counterpart of the JAX package's
``launch/train.py``.

Fault tolerance, as there:

  * a checkpoint every ``ckpt_every`` steps and at the last step (async,
    atomic: ``checkpoint.CheckpointManager``);
  * ``make_state`` draws the model from the seed and restores the latest
    checkpoint onto the model's device; with the (seed, step, row)-pure
    data pipeline a crash replays the same steps;
  * a ``StepWatchdog`` turns a hang into a failure and a
    ``StragglerMonitor`` flags slow steps; ``run_with_restarts``
    supervises the whole.

``TrainConfig.device`` None means the card (raising without one);
``device="cpu"`` runs on the host.  ``compute_dtype`` overrides the
config's compute dtype (None keeps it).  Every ``--arch`` trains; a VLM's
batch carries seeded ``image_embeds`` and an encoder-decoder's seeded
``frames`` (``SyntheticLMDataset.extra_arrays``).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.data.pipeline import SyntheticLMDataset
from repro_torch.launch.platform import resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.registry import ARCH_IDS, build_model, get_config
from repro_torch.optim import adamw_init
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.runtime import (
    RetryPolicy,
    StepWatchdog,
    StragglerMonitor,
    run_with_restarts,
)

__all__ = ["TrainConfig", "train", "main"]


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainConfig:
    arch: str = "smollm-360m"
    smoke: bool = True
    steps: int = 200
    global_batch: int = 8
    seq: int = 64
    peak_lr: float = 1e-3
    warmup: int = 20
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    ckpt_every: int = 50
    seed: int = 0
    log_every: int = 10
    watchdog_s: float = 300.0
    device: Any = None
    compute_dtype: Any = None


def _make_batch(ds, step, device, model_cfg):
    b = ds.global_batch_arrays(step)
    b.update(ds.extra_arrays(step, model_cfg))
    return {k: torch.from_numpy(v).to(device) for k, v in b.items()}


def train(cfg: TrainConfig, *, fail_at_step: int | None = None):
    """Returns (the model, metrics history, restarts used).

    ``fail_at_step`` injects a one-shot failure (fault-tolerance tests).
    """
    device = resolve_device(cfg.device)
    mcfg = get_config(cfg.arch, cfg.smoke)
    if cfg.compute_dtype is not None:
        mcfg = dataclasses.replace(mcfg, compute_dtype=cfg.compute_dtype)
    ds = SyntheticLMDataset(vocab=mcfg.vocab, seq=cfg.seq,
                            global_batch=cfg.global_batch, seed=cfg.seed)
    mgr = CheckpointManager(cfg.ckpt_dir, keep=2)
    injected = {"armed": fail_at_step is not None}

    def lr_fn(s):
        return cosine_schedule(s, peak_lr=cfg.peak_lr,
                               warmup_steps=cfg.warmup,
                               total_steps=cfg.steps)

    def make_state():
        model = build_model(mcfg, seed=cfg.seed, device=device)
        params = dict(model.named_parameters())
        opt = adamw_init(params)
        start = 0
        latest = mgr.latest_step()
        if latest is not None:
            saved_params, saved_opt = mgr.restore(
                latest, [params, {"count": opt.count, "mu": opt.mu,
                                  "nu": opt.nu}])
            with torch.no_grad():
                for name, p in params.items():
                    p.copy_(saved_params[name])
            opt.mu, opt.nu = saved_opt["mu"], saved_opt["nu"]
            opt.count = saved_opt["count"]
            start = latest
        step_fn = make_train_step(model, mcfg, lr_fn=lr_fn)
        return {"model": model, "params": params, "opt": opt,
                "step_fn": step_fn, "start": start}

    history: list[dict] = []

    def body(state):
        params, opt, step_fn = state["params"], state["opt"], state["step_fn"]
        mon = StragglerMonitor()
        dog = StepWatchdog(cfg.watchdog_s)
        try:
            for step in range(state["start"], cfg.steps):
                dog.beat()
                if injected["armed"] and step == fail_at_step:
                    injected["armed"] = False
                    raise RuntimeError(
                        "injected failure (simulated node loss)")
                t0 = time.perf_counter()
                metrics = step_fn(opt, _make_batch(ds, step, device, mcfg))
                last = step + 1 == cfg.steps
                logged = step % cfg.log_every == 0 or last
                if logged:  # reading the metrics waits for the step
                    m = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - t0
                straggler = mon.record(step, dt)
                if (step + 1) % cfg.ckpt_every == 0 or last:
                    mgr.save(step + 1, [params, {"count": opt.count,
                                                 "mu": opt.mu,
                                                 "nu": opt.nu}])
                if logged:
                    m.update(step=step, sec=round(dt, 4), straggler=straggler)
                    history.append(m)
                    print(f"step {step:5d} loss {m['loss']:.4f} "
                          f"nll {m['nll']:.4f} gnorm {m['grad_norm']:.3f} "
                          f"{dt * 1e3:.0f} ms", flush=True)
        finally:
            dog.stop()
        mgr.wait()
        return state["model"]

    model, restarts = run_with_restarts(
        make_state, body, policy=RetryPolicy(max_restarts=3))
    return model, history, restarts


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCH_IDS)
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: the smoke config)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=_default_ckpt_dir())
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = TrainConfig(arch=args.arch, smoke=not args.full, steps=args.steps,
                      global_batch=args.batch, seq=args.seq,
                      ckpt_dir=args.ckpt, device=args.device)
    _, hist, restarts = train(cfg)
    print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} "
          f"({restarts} restarts)")


if __name__ == "__main__":
    main()
