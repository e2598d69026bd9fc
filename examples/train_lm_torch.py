"""End-to-end LM training on the PyTorch + CUDA port: trains a smoke-scale
model of any architecture (``--arch``: dense, MoE, Mamba-2, RG-LRU hybrid,
VLM, Whisper) with checkpointing and, with ``--demo-crash``, injects a
failure mid-run and resumes from the last checkpoint.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300             # card
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --demo-crash
    PYTHONPATH=src python examples/train_lm_torch.py --device cpu --arch mamba2-780m
"""
import argparse
import os
import shutil
import tempfile

from repro_torch.launch.train import TrainConfig, train
from repro_torch.models.registry import ARCH_IDS


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--demo-crash", action="store_true",
                    help="inject a failure mid-run to demo restart")
    args = ap.parse_args(argv)
    shutil.rmtree(args.ckpt, ignore_errors=True)

    cfg = TrainConfig(arch=args.arch, smoke=True, steps=args.steps,
                      global_batch=args.batch, seq=args.seq,
                      ckpt_dir=args.ckpt, ckpt_every=max(args.steps // 4, 1),
                      peak_lr=3e-3, warmup=args.steps // 10,
                      device=args.device)
    fail_at = args.steps // 2 + 3 if args.demo_crash else None
    model, hist, restarts = train(cfg, fail_at_step=fail_at)
    print(f"\nloss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f} over "
          f"{args.steps} steps ({restarts} restart(s)) on {model.device}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise RuntimeError("training did not learn")
    return {"first_loss": hist[0]["loss"], "last_loss": hist[-1]["loss"],
            "restarts": restarts, "history": hist}


if __name__ == "__main__":
    main()
