"""Architecture registry: maps ``--arch`` ids to their config and model,
as the JAX package's ``models/registry.py`` does.

Only the dense family is ported (ROADMAP.md, queue 1, item 15.1); the
other architectures raise ``NotImplementedError`` naming the item that
brings them.
"""
from __future__ import annotations

import importlib

__all__ = ["get_model", "get_config", "ARCH_IDS", "MODEL_FAMILIES"]

ARCH_IDS = [
    "granite-moe-3b-a800m",
    "llama4-scout-17b-a16e",
    "phi-3-vision-4.2b",
    "mamba2-780m",
    "gemma-2b",
    "smollm-360m",
    "glm4-9b",
    "llama3.2-1b",
    "whisper-tiny",
    "recurrentgemma-9b",
]

MODEL_FAMILIES = {
    "granite-moe-3b-a800m": "moe",
    "llama4-scout-17b-a16e": "moe",
    "phi-3-vision-4.2b": "vlm",
    "mamba2-780m": "ssm",
    "gemma-2b": "dense",
    "smollm-360m": "dense",
    "glm4-9b": "dense",
    "llama3.2-1b": "dense",
    "whisper-tiny": "audio",
    "recurrentgemma-9b": "hybrid",
}

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}


def get_config(arch: str, smoke: bool = False):
    if arch not in MODEL_FAMILIES:
        raise KeyError(f"unknown arch {arch!r}; one of {ARCH_IDS}")
    if MODEL_FAMILIES[arch] != "dense":
        raise NotImplementedError(
            f"{arch} ({MODEL_FAMILIES[arch]} family) is not ported yet "
            "(ROADMAP.md, queue 1, item 15.2)")
    mod = importlib.import_module(_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG


def get_model(arch: str, smoke: bool = False, *, seed: int = 0,
              device=None):
    """Returns (model, config): a ``StackedLM`` on ``device`` (the card
    when None; raises without one), its parameters drawn from ``seed``."""
    from repro_torch.models.transformer import StackedLM

    cfg = get_config(arch, smoke)
    return StackedLM(cfg, seed=seed, device=device), cfg
