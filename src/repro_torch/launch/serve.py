"""Batched serving: prefill once, decode greedily -- the PyTorch
counterpart of the JAX package's ``launch/serve.py``.

``serve_batch`` draws the prompts (unless given) and a VLM's
``image_embeds`` or an encoder-decoder's ``frames`` from
``np.random.default_rng(seed)`` in the JAX package's order, so one seed
gives both packages the same inputs; the parameters are the port's own
draw from the seed, or the ``model`` passed in.  Decoding starts at
``pos0 = prompt_len + vlm_patches`` and the caches are sized for
``pos0 + gen_len + 1`` positions, so every step has a slot of its own.
(The JAX package sizes them for ``prompt_len + gen_len + 1``: a VLM's image
prefix then leaves its last decode steps writing past the cache's end,
which ``lax.dynamic_update_slice`` clamps onto the last slot.)

``ServeConfig.device`` None means the card (raising without one);
``device="cpu"`` serves on the host.  On the card every clock read
follows ``torch.cuda.synchronize``, so the times cover the device's work.

    python -m repro_torch.launch.serve --arch llama3.2-1b --batch 2 \\
        --gen 4 --device cpu
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.launch.platform import resolve_device
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models.registry import ARCH_IDS, get_model

__all__ = ["ServeConfig", "serve_inputs", "serve_len", "decode_steps",
           "serve_batch", "main"]


@dataclasses.dataclass
class ServeConfig:
    arch: str = "llama3.2-1b"
    smoke: bool = True
    batch: int = 4
    prompt_len: int = 16
    gen_len: int = 16
    seed: int = 0
    device: Any = None


def _clock(device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def serve_inputs(cfg: ServeConfig, mcfg, prompts=None) -> dict:
    """The batch that ``serve_batch`` prefills, on ``cfg.device``:
    ``tokens`` (the prompts: given, or (``batch``, ``prompt_len``) drawn)
    and a VLM's ``image_embeds`` or an encoder-decoder's ``frames``, drawn
    from ``np.random.default_rng(cfg.seed)`` in the JAX package's order."""
    device = resolve_device(cfg.device)
    rng = np.random.default_rng(cfg.seed)
    if prompts is None:
        prompts = rng.integers(0, mcfg.vocab,
                               size=(cfg.batch, cfg.prompt_len))
    batch = {"tokens": torch.as_tensor(np.asarray(prompts),
                                       dtype=torch.int32, device=device)}
    B = batch["tokens"].shape[0]
    if mcfg.vlm_patches:
        batch["image_embeds"] = torch.as_tensor(rng.normal(
            size=(B, mcfg.vlm_patches, mcfg.d_model)), dtype=torch.float32,
            device=device)
    if mcfg.enc_dec:
        batch["frames"] = torch.as_tensor(rng.normal(
            size=(B, mcfg.enc_frames, mcfg.d_model)), dtype=torch.float32,
            device=device)
    return batch


def serve_len(mcfg, prompt_len: int, gen_len: int) -> tuple[int, int]:
    """``(pos0, max_len)``: the first decode position, after the prompt
    and a VLM's image prefix, and the caches' length, one past the last
    step's position."""
    pos0 = prompt_len + (mcfg.vlm_patches or 0)
    return pos0, pos0 + gen_len + 1


def decode_steps(model, mcfg, cache, first, *, pos0: int, steps: int,
                 forced=None):
    """``steps`` greedy decode steps after a prefill, step i at position
    ``pos0 + i``: yields ``(fed (B,) int32, logits (B, 1, V), cache)``
    after each.  Step 0 is fed ``first`` (the prefill's argmax), each later
    step the one before's argmax -- or, with ``forced`` (B, steps), step i
    is fed ``forced[:, i]`` (teacher forcing: one run's logits held to
    another's on the same tokens)."""
    step = make_decode_step(model, mcfg)
    tok = first
    for i in range(steps):
        if forced is not None:
            tok = torch.as_tensor(forced[:, i], dtype=torch.int32,
                                  device=model.device)
        pos = torch.full((tok.shape[0],), pos0 + i, dtype=torch.int32,
                         device=model.device)
        nxt, logits, cache = step(cache, {"tokens": tok[:, None],
                                          "pos": pos})
        yield tok, logits, cache
        tok = nxt


def serve_batch(cfg: ServeConfig, prompts=None, *, model=None):
    """Greedy-decode ``gen_len`` tokens for a batch of prompts.

    ``prompts``: (B, P) token ids (default: drawn from the seed, B =
    ``batch``, P = ``prompt_len``).  ``model``: the model to serve, on
    ``cfg.device`` (default: ``get_model(arch, smoke, seed=seed)`` there).
    Returns (generated (B, gen_len) int32 numpy, stats: ``prefill_s``,
    ``decode_s``, ``tok_per_s``).
    """
    device = resolve_device(cfg.device)
    if model is None:
        model, mcfg = get_model(cfg.arch, cfg.smoke, seed=cfg.seed,
                                device=device)
    else:
        mcfg = model.cfg
        if model.device != device:
            raise ValueError(f"the model is on {model.device}, the config "
                             f"serves on {device}")
    batch = serve_inputs(cfg, mcfg, prompts)
    B, P = batch["tokens"].shape
    pos0, max_len = serve_len(mcfg, P, cfg.gen_len)

    t0 = _clock(device)
    logits, cache = make_prefill_step(model, mcfg, max_len=max_len)(batch)
    first = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    t_prefill = _clock(device) - t0

    t0 = _clock(device)
    gen = torch.stack([tok for tok, _, _ in decode_steps(
        model, mcfg, cache, first, pos0=pos0, steps=cfg.gen_len)], dim=1)
    t_decode = _clock(device) - t0
    return gen.cpu().numpy(), {
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "tok_per_s": B * cfg.gen_len / max(t_decode, 1e-9),
    }


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    gen, stats = serve_batch(ServeConfig(arch=args.arch, batch=args.batch,
                                         gen_len=args.gen,
                                         device=args.device))
    print("generated shape", gen.shape, stats)


if __name__ == "__main__":
    main()
