"""StackedLM: the decoder-only backbone of the dense, MoE, SSM, hybrid
and VLM families -- the PyTorch counterpart of the JAX package's
``models/transformer.py``.

A model is ``n_periods`` repetitions of a *period pattern* (a tuple of
:class:`LayerSpec`) plus a tail of leftover layers.  The JAX package
stacks each pattern slot's parameters on a leading layer axis and scans
over the periods; the port keeps one module per layer
(``StackedLM.layers``, period by period, then the tail) and runs them in a
Python loop, each period under ``torch.utils.checkpoint`` when the config
asks for ``remat="full"``.  :mod:`repro_torch.models.convert` maps the two
layouts onto each other.

Ported here: the training forward (``apply``) of every family -- the
``attn`` (global or windowed, with or without RoPE), ``ssm`` (Mamba-2) and
``rec`` (RG-LRU) mixers, the dense and the MoE FFN with its auxiliary
losses, the tail layers, and the VLM's image prefix (``image_embeds``,
prepended in the compute dtype).  The encoder-decoder family is
:class:`repro_torch.models.whisper.WhisperED`.  ``prefill``/``decode_step``
and the caches are serving (ROADMAP.md, queue 1, item 15.3).  The JAX
package's ``shard(...)`` layout constraints have no counterpart: one card,
and placement is item 15.4.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.platform import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as R
from repro_torch.models import ssm as SSM

__all__ = ["LayerSpec", "ArchConfig", "StackedLM"]


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"          # attn | rec | ssm
    window: int | None = None    # sliding-window size for local attention
    rope: bool = True
    moe: bool = False
    mlp: bool = True             # has an FFN sublayer at all


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """The JAX package's ``ArchConfig``, field for field; dtypes are
    ``torch`` dtypes."""

    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    act: str = "silu"
    gated_mlp: bool = True
    pattern: tuple[LayerSpec, ...] = (LayerSpec(),)
    # moe
    num_experts: int = 0
    top_k: int = 0
    shared_expert_ff: int = 0
    capacity_factor: float = 1.25
    # ssm / rnn
    ssm_state: int = 0
    ssm_headdim: int = 64
    rnn_width: int = 0
    # misc
    rope_theta: float = 10000.0
    tie_embed: bool = True
    embed_scale: bool = False    # gemma-style sqrt(d) embedding scale
    norm: str = "rms"
    qkv_bias: bool = False
    logit_softcap: float | None = None
    vlm_patches: int = 0
    enc_dec: bool = False
    enc_frames: int = 0
    # numerics / schedule
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    cache_dtype: Any = torch.bfloat16
    remat: str | None = "full"
    kv_chunk: int = 1024
    ssd_chunk: int = 256
    ssd_unroll: int = 1
    rules: dict | None = None
    moe_aux_weight: float = 0.01
    pad_heads_to: int = 0
    n_micro: int = 1

    @property
    def hq_padded(self) -> int:
        if self.pad_heads_to <= 1:
            return self.n_heads
        return -(-self.n_heads // self.pad_heads_to) * self.pad_heads_to

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_periods(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def tail_specs(self) -> tuple[LayerSpec, ...]:
        return self.pattern[: self.n_layers % len(self.pattern)]

    def param_count(self) -> int:
        """Parameter count from the shapes alone (no allocation)."""
        return StackedLM(self, device="meta").param_count()


class Norm(nn.Module):
    """RMSNorm (``scale``) or LayerNorm (``scale``, ``bias``) parameters."""

    def __init__(self, pi: L.ParamInit, d_model: int, kind: str):
        super().__init__()
        self.scale = pi.ones((d_model,))
        self.bias = pi.zeros((d_model,)) if kind != "rms" else None


class Slot(nn.Module):
    """One layer: ``ln1``; the mixer under its kind's name (``attn``,
    ``ssm`` or ``rec``); with an FFN, ``ln2`` and ``ffn`` (an ``MLP`` or a
    ``MoE``)."""

    def __init__(self, ln1, mixer: str, module, ln2=None, ffn=None):
        super().__init__()
        self.ln1 = ln1
        setattr(self, mixer, module)
        self.ln2, self.ffn = ln2, ffn


def _remat_wrap(fn, remat):
    """A period's function under the config's remat policy: ``"full"``
    saves only the period's input (``jax.checkpoint_policies.
    nothing_saveable``), None saves everything."""
    if remat is None:
        return fn
    if remat != "full":
        raise NotImplementedError(
            f"remat={remat!r}: the JAX package's dot-saving policies are not "
            "ported, and no config uses them (ROADMAP.md, queue 1, "
            "item 15)")

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False)

    return wrapped


class StackedLM(nn.Module):
    """The decoder-only model on ``device`` (the card when None;
    ``"meta"`` for shapes alone), its parameters drawn from ``seed``."""

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device=None):
        super().__init__()
        self.cfg = cfg
        if str(device) != "meta":
            device = resolve_device(device)
        pi = L.ParamInit(cfg.param_dtype, device)
        self.embed = L.embed_init(pi, cfg.vocab, cfg.d_model)
        self.final_norm = self._norm_init(pi)
        self.head = (None if cfg.tie_embed
                     else pi.normal((cfg.d_model, cfg.vocab)))
        specs = list(cfg.pattern) * cfg.n_periods + list(cfg.tail_specs)
        self.layers = nn.ModuleList(self._slot_init(pi, s) for s in specs)
        self.init(seed)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # ------------------------------------------------------------------
    # init
    # ------------------------------------------------------------------
    def init(self, seed: int) -> "StackedLM":
        """Draw every parameter from ``seed`` (in place)."""
        L.ParamInit.fill(self, seed)
        return self

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def _norm_init(self, pi):
        return Norm(pi, self.cfg.d_model, self.cfg.norm)

    def _norm(self, p: Norm, x):
        if self.cfg.norm == "rms":
            return L.rmsnorm(x, p.scale)
        return L.layernorm(x, p.scale, p.bias)

    def _slot_init(self, pi, spec: LayerSpec) -> Slot:
        c = self.cfg
        if spec.mixer == "attn":
            mixer = A.attn_init(pi, c.d_model, c.hq_padded, c.n_kv, c.hd,
                                qkv_bias=c.qkv_bias, out_bias=c.qkv_bias)
        elif spec.mixer == "ssm":
            mixer = SSM.mamba2_init(pi, c.d_model, d_state=c.ssm_state,
                                    headdim=c.ssm_headdim)
        elif spec.mixer == "rec":
            mixer = R.rglru_init(pi, c.d_model, c.rnn_width or c.d_model)
        else:
            raise ValueError(spec.mixer)
        ln1 = self._norm_init(pi)
        if not spec.mlp:
            return Slot(ln1, spec.mixer, mixer)
        if spec.moe:
            ffn = MOE.moe_init(pi, c.d_model, c.d_ff, c.num_experts,
                               gated=c.gated_mlp,
                               shared_ff=c.shared_expert_ff)
        else:
            ffn = L.mlp_init(pi, c.d_model, c.d_ff, gated=c.gated_mlp)
        return Slot(ln1, spec.mixer, mixer, self._norm_init(pi), ffn)

    # ------------------------------------------------------------------
    # forward pieces
    # ------------------------------------------------------------------
    def _slot_apply(self, spec: LayerSpec, p: Slot, x, sin, cos):
        """One layer in ``mode="train"``: (x, aux (2,) f32, the MoE's load
        and z losses or zeros)."""
        c = self.cfg
        cd = c.compute_dtype
        aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
        h = self._norm(p.ln1, x)
        if spec.mixer == "attn":
            nvh = c.n_heads if c.hq_padded != c.n_heads else None
            o, _ = A.attn_apply(p.attn, h, sin, cos, causal=True,
                                window=spec.window, q_chunk=c.kv_chunk,
                                kv_chunk=c.kv_chunk, compute_dtype=cd,
                                rope_on=spec.rope, n_valid_heads=nvh)
        elif spec.mixer == "ssm":
            o = SSM.mamba2_apply(p.ssm, h, chunk=c.ssd_chunk,
                                 compute_dtype=cd, unroll=c.ssd_unroll)
        elif spec.mixer == "rec":
            o = R.rglru_apply(p.rec, h, compute_dtype=cd)
        else:
            raise ValueError(spec.mixer)
        x = x + o
        if spec.mlp:
            h2 = self._norm(p.ln2, x)
            if spec.moe:
                o2, mo = MOE.moe_apply(p.ffn, h2, top_k=c.top_k, act=c.act,
                                       capacity_factor=c.capacity_factor,
                                       compute_dtype=cd)
                aux = aux + torch.stack([mo["load_loss"], mo["z_loss"]])
            else:
                o2 = L.mlp_apply(p.ffn, h2, act=c.act, compute_dtype=cd)
            x = x + o2.to(x.dtype)
        return x, aux

    # ------------------------------------------------------------------
    # embedding / head
    # ------------------------------------------------------------------
    def _embed(self, tokens, extra=None):
        c = self.cfg
        # the table is cast to the compute dtype before the gather
        x = nn.functional.embedding(tokens, self.embed.to(c.compute_dtype))
        if c.embed_scale:
            x = x * torch.tensor(math.sqrt(c.d_model), dtype=x.dtype,
                                 device=x.device)
        if c.vlm_patches and extra is not None:
            # the image prefix: patch embeddings before the text positions
            x = torch.cat([extra.to(c.compute_dtype), x], dim=1)
        return x

    def _logits(self, x):
        """Logits stay in the compute dtype; the loss upcasts inside its
        log-sum-exp."""
        c = self.cfg
        x = self._norm(self.final_norm, x)
        w = self.embed.T if c.tie_embed else self.head
        logits = L.dense(x.to(c.compute_dtype), w.to(c.compute_dtype))
        if c.logit_softcap:
            logits = torch.tanh(logits / c.logit_softcap) * c.logit_softcap
        return logits.to(c.compute_dtype)

    # ------------------------------------------------------------------
    # modes
    # ------------------------------------------------------------------
    def apply(self, tokens, *, image_embeds=None):
        """Training forward: (B, S) tokens [and, for a VLM, (B, P, d_model)
        ``image_embeds``] -> (logits (B, P + S, V) in the compute dtype,
        aux (2,) f32: the MoE layers' summed load and z losses)."""
        c = self.cfg
        if c.enc_dec:
            raise ValueError(f"{c.name} is an encoder-decoder: build it "
                             "as repro_torch.models.whisper.WhisperED")
        x = self._embed(tokens, image_embeds)
        S = x.shape[1]
        sin, cos = L.rope(torch.arange(S, device=x.device), c.hd,
                          c.rope_theta)
        n = len(c.pattern)

        def period(h, aux, *layers):
            for spec, lp in zip(c.pattern, layers):
                h, a = self._slot_apply(spec, lp, h, sin, cos)
                aux = aux + a
            return h, aux

        period = _remat_wrap(period, c.remat)
        aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
        for i in range(c.n_periods):
            x, aux = period(x, aux, *self.layers[i * n:(i + 1) * n])
        for spec, lp in zip(c.tail_specs, self.layers[c.n_periods * n:]):
            x, a = self._slot_apply(spec, lp, x, sin, cos)
            aux = aux + a
        return self._logits(x), aux
