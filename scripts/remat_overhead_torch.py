"""What a remat policy costs beside what it saves, on the card: the train
step of a full-width model under ``remat="full"``, under selective
checkpointing that keeps nothing (``sac_none``: the policies' machinery
alone, a Python dispatch mode over every operator of a period, with
``full``'s recompute), and under ``"dots_no_batch"`` and ``"dots"``.

Usage, from the repository's root on a machine with a CUDA card::

    python3 scripts/remat_overhead_torch.py                 # both models
    PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True \\
        python3 scripts/remat_overhead_torch.py --arch llama3.2-1b
    python3 scripts/remat_overhead_torch.py --count-ops     # no card needed

For each model (llama3.2-1b at 4 x 2048 tokens; whisper-tiny at 1,500
frames and 448 decoder tokens), phase 13's and 14's seed and first batch,
each variant runs one warm-up step and ``--steps`` timed steps (CUDA
events), in turns (the variants in order, then in reverse), and prints
per variant its step ms, the host's ms until the step call returns (it
waits for the card inside, so this is not the host's own work),
``max_memory_allocated``, ``max_memory_reserved``, the allocator's
retries (``num_alloc_retries``: a cudaMalloc that failed, freed the
cached blocks and tried again), its cudaMalloc and cudaFree calls during
the timed steps, and the Python garbage collections in them.
``--count-ops`` instead counts, on ``meta`` tensors (no card), the
operators a forward dispatches inside the remat periods of each model
(and of granite-moe): what the selective checkpoint's Python dispatch
mode sees twice a step, in the forward and in the recompute.
llama's ``dots`` and the ``full`` it is compared with run at 2
micro-batches, as in ``chip_smoke.py`` phase 17.  ``--profile`` adds one
more step a variant under ``torch.profiler``: the kernels' device time
(user ranges left out), their count, and the kernels that take the most.
"""
import argparse
import collections
import dataclasses
import gc
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils.checkpoint import CheckpointPolicy  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    batch_specs,
    lm_loss,
    make_train_step,
)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import (  # noqa: E402
    build_model,
    get_config,
    get_model,
)
from repro_torch.optim import adamw_init  # noqa: E402

_POLICY = T._remat_policy


def _policy(name):
    """The port's policies, and ``sac_none``: keep nothing."""
    if name == "sac_none":
        return lambda ctx, op, *args, **kwargs: (
            CheckpointPolicy.PREFER_RECOMPUTE)
    return _POLICY(name)


VARIANTS = {
    "llama3.2-1b": (("full", 1), ("sac_none", 1), ("dots_no_batch", 1),
                    ("full", 2), ("sac_none", 2), ("dots_no_batch", 2),
                    ("dots", 2)),
    "whisper-tiny": (("full", 1), ("sac_none", 1), ("dots_no_batch", 1),
                     ("dots", 1)),
}
SEQ = {"llama3.2-1b": cs.LM_SEQ, "whisper-tiny": cs.FAM_DEC_SEQ}


def profiled(fn, card, arch, policy, n_micro, top=6):
    """One step under ``torch.profiler``: its CUDA-event ms beside the
    device time of its kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, ms = cs.timed_call(fn, torch.device("cuda", 0))
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = collections.Counter()
    count = collections.Counter()
    for e in kernels:
        busy[e.name] += e.device_time
        count[e.name] += 1
    total = sum(busy.values()) / 1e3
    cs.log("remat-profile", card=repr(card), arch=arch, policy=policy,
           n_micro=n_micro, step_ms=f"{ms:.1f}", kernel_ms=f"{total:.1f}",
           kernels=sum(count.values()), idle_share=f"{1 - total / ms:.3f}")
    for name, t in busy.most_common(top):
        cs.log("remat-profile", kernel=repr(name[:90]), count=count[name],
               ms=f"{t / 1e3:.1f}")


class _Count(TorchDispatchMode):
    """Counts the operators dispatched, and those inside a period."""

    def __init__(self):
        super().__init__()
        self.inside, self.period_ops, self.ops = False, 0, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.period_ops += self.inside
        return func(*args, **(kwargs or {}))


def count_ops(arch):
    """The forward's operators inside remat periods, on ``meta``."""
    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    specs = batch_specs(cfg, "train", cs.LM_BATCH, SEQ.get(arch, cs.LM_SEQ))
    count, real = _Count(), T.checkpoint

    def checkpoint(fn, *args, **kw):
        count.inside = True
        try:
            return real(fn, *args, **kw)
        finally:
            count.inside = False

    T.checkpoint = checkpoint
    try:
        with count:
            lm_loss(model, cfg, specs)
    finally:
        T.checkpoint = real
    cs.log("remat-ops", arch=arch, batch=cs.LM_BATCH,
           seq=SEQ.get(arch, cs.LM_SEQ), forward_ops=count.ops,
           period_ops=count.period_ops)


def run(arch, device, card, steps, profile=False):
    model, cfg = get_model(arch, seed=cs.SEED, device=device)
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq=SEQ[arch],
                            global_batch=cs.LM_BATCH, seed=cs.SEED)
    arrays = ds.global_batch_arrays(0)
    arrays.update(ds.extra_arrays(0, cfg))
    batch = {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}
    variants = VARIANTS[arch]
    got = {v: [] for v in variants}
    for v in variants + tuple(reversed(variants)):
        policy, n_micro = v
        pcfg = dataclasses.replace(cfg, remat=policy)
        model.cfg = pcfg
        cs.free_device(device)
        torch.cuda.reset_accumulated_memory_stats()
        opt = adamw_init(dict(model.named_parameters()))
        step = make_train_step(model, pcfg, lr_fn=lambda s: cs.PLACE_LR,
                               n_micro=n_micro)
        cs.timed_call(lambda: step(opt, batch), device)  # warm-up
        before = torch.cuda.memory_stats()
        collections_before = sum(g["collections"] for g in gc.get_stats())
        host = []

        def issued():
            t0 = time.perf_counter()
            step(opt, batch)
            host.append((time.perf_counter() - t0) * 1e3)

        got[v] += [cs.timed_call(issued, device)[1] for _ in range(steps)]
        stats = torch.cuda.memory_stats()
        cs.log("remat-overhead", card=repr(card), arch=arch, policy=policy,
               n_micro=n_micro,
               step_ms=",".join(f"{x:.1f}" for x in got[v][-steps:]),
               host_ms=",".join(f"{x:.1f}" for x in host),
               max_memory_allocated_gib=(
                   f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"),
               max_memory_reserved_gib=(
                   f"{torch.cuda.max_memory_reserved() / 2 ** 30:.2f}"),
               num_alloc_retries=stats.get("num_alloc_retries", 0),
               cuda_mallocs=(stats.get("num_device_alloc", 0)
                             - before.get("num_device_alloc", 0)),
               cuda_frees=(stats.get("num_device_free", 0)
                           - before.get("num_device_free", 0)),
               gc_collections=(sum(g["collections"] for g in gc.get_stats())
                               - collections_before))
        if profile:
            profiled(lambda: step(opt, batch), card, arch, policy, n_micro)
        del opt, step
    for (policy, n_micro), ms in got.items():
        cs.log("remat-overhead", card=repr(card), arch=arch, policy=policy,
               n_micro=n_micro, steps=len(ms),
               step_ms_median=f"{statistics.median(ms):.1f}")
    model.cfg = cfg
    del model
    cs.free_device(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", action="append", choices=sorted(VARIANTS))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--count-ops", action="store_true")
    args = ap.parse_args(argv)
    if args.count_ops:
        for arch in args.arch or sorted(VARIANTS) + ["granite-moe-3b-a800m"]:
            count_ops(arch)
        return 0
    if not torch.cuda.is_available():
        print("remat_overhead_torch: needs a CUDA device", file=sys.stderr)
        return 2
    T._remat_policy = _policy
    device = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    for arch in args.arch or sorted(VARIANTS):
        run(arch, device, card, args.steps, args.profile)
    return 0


if __name__ == "__main__":
    sys.exit(main())
