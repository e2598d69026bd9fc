"""Architecture registry: maps ``--arch`` ids to their config and model,
as the JAX package's ``models/registry.py`` does: a ``StackedLM`` for the
decoder-only families, a ``WhisperED`` for the encoder-decoder.
"""
from __future__ import annotations

import importlib

__all__ = ["get_model", "get_config", "build_model", "ARCH_IDS",
           "MODEL_FAMILIES"]

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
    mod = importlib.import_module(_MODULES[arch])
    return mod.SMOKE if smoke else mod.CONFIG


def build_model(cfg, *, seed: int = 0, device=None):
    """The model of ``cfg`` on ``device`` (the card when None; raises
    without one), its parameters drawn from ``seed``: a ``WhisperED`` for
    an encoder-decoder config, else a ``StackedLM``."""
    if cfg.enc_dec:
        from repro_torch.models.whisper import WhisperED
        return WhisperED(cfg, seed=seed, device=device)
    from repro_torch.models.transformer import StackedLM
    return StackedLM(cfg, seed=seed, device=device)


def get_model(arch: str, smoke: bool = False, *, seed: int = 0,
              device=None):
    """Returns (model, config): the arch's model on ``device`` (the card
    when None; raises without one), its parameters drawn from ``seed``."""
    cfg = get_config(arch, smoke)
    return build_model(cfg, seed=seed, device=device), cfg
