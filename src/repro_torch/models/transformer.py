"""StackedLM: the decoder-only backbone of the dense, MoE, SSM, hybrid
and VLM families -- the PyTorch counterpart of the JAX package's
``models/transformer.py``.

A model is ``n_periods`` repetitions of a *period pattern* (a tuple of
:class:`LayerSpec`) plus a tail of leftover layers.  The JAX package
stacks each pattern slot's parameters on a leading layer axis and scans
over the periods; the port keeps one module per layer
(``StackedLM.layers``, period by period, then the tail) and runs them in a
Python loop, each period under the config's remat policy
(:func:`_remat_policy`: ``"full"``, ``"dots"``, ``"dots_no_batch"`` or
None, as there).  :mod:`repro_torch.models.convert` maps the two layouts
onto each other.

Modes, as there:
  * ``apply``        -- the training forward of every family: the ``attn``
    (global or windowed, with or without RoPE), ``ssm`` (Mamba-2) and
    ``rec`` (RG-LRU) mixers, the dense and the MoE FFN with its auxiliary
    losses, the tail layers, and the VLM's image prefix (``image_embeds``,
    prepended in the compute dtype);
  * ``prefill``      -- the forward over a prompt and the decode cache it
    leaves (a contiguous KV cache for global attention, a ring for
    windowed attention, O(1) states for ``rec``/``ssm``, the MoE's
    capacity carry);
  * ``decode_step``  -- one token a row against that cache.

The cache is a dict keyed by the layer's index in ``layers``, where the
JAX package stacks each pattern slot's cache on the period axis
(``convert.cache_from_reference``/``cache_to_reference`` map the two).
The serving horizon ``max_len`` is passed down the prefill's call; the
JAX package sets it on the model.  The encoder-decoder family is
:class:`repro_torch.models.whisper.WhisperED`.

Placement: every parameter carries its logical axes (``ParamInit``), the
JAX package's less the leading ``"stack"`` axis of a period-stacked leaf,
which has no counterpart in per-layer parameters (``RULES["stack"]`` is
None, so it only ever adds a replicated dimension; ``convert.py`` puts it
back).  ``abstract_params`` gives shapes and axes on the ``meta`` device,
``cache_logical`` the cache's axes.  The model code calls
``parallel.sharding.shard`` where the JAX package does (the attention's
q/k/v and output, the MLP's hidden layer, the residual stream as
``"seq_res"``, the logits as ``"vocab"``): under an ambient mesh it
resolves the activation's spec and logs its fallbacks, and returns the
tensor.  The layout itself is :meth:`StackedLM.apply_tensor`, the
training forward of the attention-and-MLP decoders over the positions of
one data index (``parallel/tensor.py``'s ``Group``): each position runs
its part of every product on its view of the parameters, the residual
stream is joined after each sublayer (all-reduce, or with ``seqshard``
the sequence split and reduce-scatter/all-gather pairs around each
sublayer), and the embedding and logits are vocab-parallel.  Under an
ambient mesh with a model axis above 1 the families and layers without a
layout yet (MoE, Mamba-2, RG-LRU, windowed attention) and prefill and
decode raise ``NotImplementedError`` (``tensor.check_scope``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    set_checkpoint_early_stop,
)

from repro_torch.launch.platform import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as R
from repro_torch.models import ssm as SSM
from repro_torch.parallel import sharding as SH
from repro_torch.parallel import tensor as TP

__all__ = ["LayerSpec", "ArchConfig", "StackedLM", "_remat_policy"]


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
        self.scale = pi.ones((d_model,), ("embed",))
        self.bias = (pi.zeros((d_model,), ("embed",)) if kind != "rms"
                     else None)


class Slot(nn.Module):
    """One layer: ``ln1``; the mixer under its kind's name (``attn``,
    ``ssm`` or ``rec``); with an FFN, ``ln2`` and ``ffn`` (an ``MLP`` or a
    ``MoE``)."""

    def __init__(self, ln1, mixer: str, module, ln2=None, ffn=None):
        super().__init__()
        self.ln1 = ln1
        setattr(self, mixer, module)
        self.ln2, self.ffn = ln2, ffn


# the matrix products as they reach the dispatcher: ``tensordot``,
# ``matmul`` and ``einsum`` lower to ``mm``/``bmm``, ``addmm``/``baddbmm``
# with a bias fused in
_PRODUCT_OPS = frozenset([torch.ops.aten.mm, torch.ops.aten.addmm,
                          torch.ops.aten.bmm, torch.ops.aten.baddbmm])


def _save_products(batched: bool, ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of ``dots`` (``batched``) and
    ``dots_no_batch``: a product's output is kept (``MUST_SAVE``) when its
    :class:`layers.product` tag allows, everything else is recomputed.  A
    ``residual`` product in a period's last sublayer is not kept: only the
    period's output reads it, and the recompute stops before it (the JAX
    package's partial evaluation drops it the same way).  A product with
    no tag raises: its structure is unknown, so the policy cannot be
    honoured."""
    del ctx, args, kwargs
    if op.overloadpacket not in _PRODUCT_OPS:
        return CheckpointPolicy.PREFER_RECOMPUTE
    tag = L.product_tag()
    if tag is None:
        raise RuntimeError(
            f"{op} runs in a remat period outside layers.product(): the "
            "dot-saving policies need each product's structure")
    is_batched, residual, at_end = tag
    if (residual and at_end) or (is_batched and not batched):
        return CheckpointPolicy.PREFER_RECOMPUTE
    return CheckpointPolicy.MUST_SAVE


def _remat_policy(name):
    """The remat policy by name, as the JAX package's ``_remat_policy``:
    ``"full"`` saves nothing but the period's input (``nothing_saveable``;
    None here: plain checkpointing), ``"dots"`` also every product's
    output (``checkpoint_dots``), ``"dots_no_batch"`` the outputs of the
    products without batch dimensions, the weight products
    (``checkpoint_dots_with_no_batch_dims``).  An unknown name raises
    ``KeyError``."""
    return {
        "full": None,
        "dots": functools.partial(_save_products, True),
        "dots_no_batch": functools.partial(_save_products, False),
    }[name]


def _remat_wrap(fn, remat):
    """A period's function under the config's remat policy: one
    non-reentrant ``torch.utils.checkpoint`` a period, which keeps the
    period's input; under ``"dots"``/``"dots_no_batch"`` selective
    checkpointing also keeps the products the policy saves, and the
    backward's recompute reads them in place of running them again.
    None keeps everything (no checkpoint)."""
    if remat is None:
        return fn
    policy = _remat_policy(remat)
    kw = {}
    if policy is not None:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, policy)

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kw)

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
                     else pi.normal((cfg.d_model, cfg.vocab),
                                    ("embed", "vocab")))
        # each layer's spec: the pattern period by period, then the tail
        self.specs = tuple(cfg.pattern) * cfg.n_periods + cfg.tail_specs
        self.layers = nn.ModuleList(self._slot_init(pi, s)
                                    for s in self.specs)
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
    def _slot_apply(self, spec: LayerSpec, p: Slot, x, sin, cos, *,
                    mode="train", cache=None, pos_dec=None, max_len=None,
                    last=False):
        """One layer: (x, the layer's cache, aux (2,) f32 -- the MoE's load
        and z losses or zeros).

        ``mode="train"`` returns no cache (None); ``"prefill"`` builds the
        layer's cache for a serving horizon of ``max_len`` positions;
        ``"decode"`` takes one token at positions ``pos_dec`` (B,) against
        ``cache`` and returns it updated.  ``last``: the layer ends a remat
        period (:class:`layers.period_end` around its last sublayer)."""
        with L.period_end(last and not spec.mlp):
            x, new_cache, moe_state = self._mixer_apply(
                spec, p, x, sin, cos, mode=mode, cache=cache,
                pos_dec=pos_dec, max_len=max_len)
        aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
        if spec.mlp:
            with L.period_end(last):
                x, new_cache, aux = self._ffn_apply(
                    spec, p, x, aux, mode=mode, new_cache=new_cache,
                    moe_state=moe_state, max_len=max_len)
        return x, (None if mode == "train" else new_cache), aux

    def _mixer_apply(self, spec: LayerSpec, p: Slot, x, sin, cos, *, mode,
                     cache, pos_dec, max_len):
        """The mixer sublayer and its residual add: (x, the layer's cache
        so far, the MoE's capacity carry from ``cache`` or None)."""
        c = self.cfg
        cd = c.compute_dtype
        h = self._norm(p.ln1, x)
        # the MoE capacity carry rides in the layer's cache beside the
        # mixer's entries; the mixer's decoders see only their own
        moe_state = None
        if cache is not None and "moe_cnt" in cache:
            moe_state = (cache["moe_cnt"], cache["moe_cap"])
            cache = {k: v for k, v in cache.items()
                     if k not in ("moe_cnt", "moe_cap")}
        new_cache = cache
        if spec.mixer == "attn":
            nvh = c.n_heads if c.hq_padded != c.n_heads else None
            if mode in ("train", "prefill"):
                o, (k, v) = A.attn_apply(
                    p.attn, h, sin, cos, causal=True, window=spec.window,
                    q_chunk=c.kv_chunk, kv_chunk=c.kv_chunk,
                    compute_dtype=cd, rope_on=spec.rope, n_valid_heads=nvh)
                if mode == "prefill":
                    new_cache = self._attn_prefill_cache(spec, k, v,
                                                         max_len)
            elif spec.window is not None:
                o, new_cache = self._ring_decode(spec, p.attn, h, sin, cos,
                                                 cache, pos_dec)
            else:
                o, new_cache = A.attn_decode(
                    p.attn, h, sin, cos, cache, pos_dec, compute_dtype=cd,
                    rope_on=spec.rope, n_valid_heads=nvh)
        elif spec.mixer == "ssm":
            if mode == "train":
                o = SSM.mamba2_apply(p.ssm, h, chunk=c.ssd_chunk,
                                     compute_dtype=cd, unroll=c.ssd_unroll)
            elif mode == "prefill":
                o, st = SSM.mamba2_apply(p.ssm, h, chunk=c.ssd_chunk,
                                         compute_dtype=cd, return_state=True,
                                         unroll=c.ssd_unroll)
                new_cache = self._ssm_prefill_cache(p.ssm, h, st)
            else:
                o, new_cache = SSM.mamba2_decode(p.ssm, h, cache,
                                                 compute_dtype=cd)
        elif spec.mixer == "rec":
            if mode == "train":
                o = R.rglru_apply(p.rec, h, compute_dtype=cd)
            elif mode == "prefill":
                o, hstate = R.rglru_apply(p.rec, h, compute_dtype=cd,
                                          return_state=True)
                new_cache = self._rec_prefill_cache(p.rec, h, hstate)
            else:
                o, new_cache = R.rglru_decode(p.rec, h, cache,
                                              compute_dtype=cd)
        else:
            raise ValueError(spec.mixer)
        return x + o, new_cache, moe_state

    def _ffn_apply(self, spec: LayerSpec, p: Slot, x, aux, *, mode,
                   new_cache, moe_state, max_len):
        """The FFN sublayer (dense or MoE) and its residual add: (x, the
        layer's cache, aux plus the MoE's losses)."""
        c = self.cfg
        cd = c.compute_dtype
        h2 = self._norm(p.ln2, x)
        if spec.moe:
            moe_kw = dict(top_k=c.top_k, act=c.act,
                          capacity_factor=c.capacity_factor,
                          compute_dtype=cd)
            if mode == "prefill":
                # the pre-drop expert counts and the serving horizon's
                # capacity ride on, so prefill and decode apply one
                # first-come rule: the full-length forward's
                cap = MOE.moe_capacity(max_len, c.top_k, c.num_experts,
                                       c.capacity_factor)
                o2, mo, cnts = MOE.moe_apply(p.ffn, h2, capacity=cap,
                                             return_counts=True, **moe_kw)
                new_cache = dict(new_cache)
                new_cache["moe_cnt"] = cnts
                new_cache["moe_cap"] = torch.full(
                    (), cap, dtype=torch.int32, device=x.device)
            elif mode == "decode" and moe_state is not None:
                cnts, cap = moe_state
                o2, mo, cnts = MOE.moe_apply(p.ffn, h2,
                                             expert_counts=cnts,
                                             capacity_ref=cap,
                                             return_counts=True, **moe_kw)
                new_cache = dict(new_cache)
                new_cache["moe_cnt"] = cnts
                new_cache["moe_cap"] = cap
            else:
                o2, mo = MOE.moe_apply(p.ffn, h2, **moe_kw)
            aux = aux + torch.stack([mo["load_loss"], mo["z_loss"]])
        else:
            o2 = L.mlp_apply(p.ffn, h2, act=c.act, compute_dtype=cd)
        return x + o2.to(x.dtype), new_cache, aux

    def _attn_prefill_cache(self, spec: LayerSpec, k, v, max_len: int):
        """An attention layer's cache from the prefix's keys and values
        (B, S, Hkv, hd).  Global: zero-padded to ``max_len`` positions.
        Windowed: a ring of W slots, position p in slot p % W, ``pos`` the
        position a slot holds (-1 empty; a prefix shorter than W fills
        slots 0..S-1)."""
        c = self.cfg
        B, S = k.shape[:2]
        if spec.window is None:
            pad = (0, 0, 0, 0, 0, max_len - S)
            return {"k": F.pad(k.to(c.cache_dtype), pad),
                    "v": F.pad(v.to(c.cache_dtype), pad)}
        W = spec.window
        ks, vs = k[:, -W:], v[:, -W:]
        ps = torch.arange(S, device=k.device)[-W:]
        if S < W:
            ks = F.pad(ks, (0, 0, 0, 0, 0, W - S))
            vs = F.pad(vs, (0, 0, 0, 0, 0, W - S))
            ps = F.pad(ps, (0, W - S), value=-1)
            roll = torch.arange(W, device=k.device)
        else:
            roll = torch.argsort(ps % W)
        return {"k": ks[:, roll].to(c.cache_dtype),
                "v": vs[:, roll].to(c.cache_dtype),
                "pos": ps[roll].to(torch.int32).expand(B, W).contiguous()}

    def _ssm_prefill_cache(self, p, h, s):
        """The SSM state and the conv ring: the prefix's last K-1
        post-in-projection xBC rows (zero rows before a shorter prefix)."""
        c = self.cfg
        d_inner = p.norm.shape[0]
        K = p.conv_w.shape[0]
        gn = (p.conv_w.shape[1] - d_inner) // 2
        zx = L.dense(h[:, -(K - 1):], p.in_proj, c.compute_dtype)
        xBC = zx[..., d_inner:2 * d_inner + 2 * gn]
        S = h.shape[1]
        if S < K - 1:
            xBC = F.pad(xBC, (0, 0, K - 1 - S, 0))
        return {"ssm": s, "conv": xBC.to(c.cache_dtype)}

    def _rec_prefill_cache(self, p, h, hstate):
        """The RG-LRU's last hidden state and its conv ring, as
        :meth:`_ssm_prefill_cache`."""
        c = self.cfg
        K = p.conv_w.shape[0]
        x = L.dense(h[:, -(K - 1):], p.wx, c.compute_dtype)
        S = h.shape[1]
        if S < K - 1:
            x = F.pad(x, (0, 0, K - 1 - S, 0))
        return {"h": hstate, "conv": x.to(c.cache_dtype)}

    def _ring_decode(self, spec: LayerSpec, p, h, sin, cos, cache, pos_dec):
        """Sliding-window decode against a ring cache: the new key, value
        and position go to slot ``pos % W`` (in place)."""
        c = self.cfg
        cd = c.compute_dtype
        W = cache["k"].shape[1]
        q = A._proj(h, p.wq, p.bq, cd)
        k = A._proj(h, p.wk, p.bk, cd)
        v = A._proj(h, p.wv, p.bv, cd)
        if spec.rope:
            q = L.apply_rope(q, sin, cos)
            k = L.apply_rope(k, sin, cos)
        slot = pos_dec % W
        A.write_rows(cache["k"], k, slot)
        A.write_rows(cache["v"], v, slot)
        A.write_rows(cache["pos"], pos_dec[:, None], slot)
        o = A.decode_attention(q.to(cd), cache["k"], cache["v"],
                               key_pos=cache["pos"], pos_q=pos_dec, window=W,
                               compute_dtype=cd)
        o = A._mask_pad_heads(o, c.n_heads if c.hq_padded != c.n_heads
                              else None)
        return A._out_proj(p, o, cd).to(h.dtype), cache

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
        return SH.shard(x, "batch", "seq_res", "embed", rules=c.rules)

    def _logits(self, x):
        """Logits stay in the compute dtype; the loss upcasts inside its
        log-sum-exp."""
        c = self.cfg
        with L.span("logits"):
            x = self._norm(self.final_norm, x)
            w = self.embed.T if c.tie_embed else self.head
            logits = L.dense(x.to(c.compute_dtype), w.to(c.compute_dtype))
            if c.logit_softcap:
                logits = (torch.tanh(logits / c.logit_softcap)
                          * c.logit_softcap)
            return SH.shard(logits.to(c.compute_dtype), "batch", "seq",
                            "vocab", rules=c.rules)

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
        TP.check_scope(c)
        with SH.activation_context(rules=c.rules):
            return self._train_forward(tokens, image_embeds)

    def _train_forward(self, tokens, image_embeds):
        c = self.cfg
        x = self._embed(tokens, image_embeds)
        S = x.shape[1]
        sin, cos = L.rope(torch.arange(S, device=x.device), c.hd,
                          c.rope_theta)
        n = len(c.pattern)

        def period(h, aux, *layers):
            for j, (spec, lp) in enumerate(zip(c.pattern, layers)):
                h, _, a = self._slot_apply(spec, lp, h, sin, cos,
                                           last=j == n - 1)
                h = SH.shard(h, "batch", "seq_res", "embed", rules=c.rules)
                aux = aux + a
            return h, aux

        period = _remat_wrap(period, c.remat)
        aux = torch.zeros((2,), dtype=torch.float32, device=x.device)
        for i in range(c.n_periods):
            x, aux = period(x, aux, *self.layers[i * n:(i + 1) * n])
        for spec, lp in zip(c.tail_specs, self.layers[c.n_periods * n:]):
            x, _, a = self._slot_apply(spec, lp, x, sin, cos)
            aux = aux + a
        return self._logits(x), aux

    # ------------------------------------------------------------------
    # the training forward under the tensor layout
    # ------------------------------------------------------------------
    def apply_tensor(self, group, tokens, *, image_embeds=None):
        """:meth:`apply` over the positions of one data index under the
        tensor layout: ``group`` is a ``parallel.tensor.Group`` (the
        positions along the model axis and their views of the parameters;
        this module gives the structure only and may live on ``meta``),
        ``tokens`` and ``image_embeds`` one tensor a position.  Returns
        (each position's logits over its vocabulary rows, aux (2,) f32).

        A remat period takes the positions' residuals and runs under the
        config's policy; the recompute runs the whole period again (no
        early stop), so it issues the period's collectives once more,
        which the dry run counts."""
        c = self.cfg
        TP.check_scope(c)
        xs = group.embed(tokens, image_embeds)
        S = xs[0].shape[1] * (group.size if group.seqshard else 1)
        rope = [L.rope(torch.arange(S, device=d), c.hd, c.rope_theta)
                for d in group.devices]
        n, T = len(c.pattern), group.size

        def period(*args):
            hs, aux, first = list(args[:T]), args[T], args[T + 1]
            for j, spec in enumerate(c.pattern):
                hs = self._slot_tensor(spec, group, first + j, hs, rope,
                                       last=j == n - 1)
            return (*hs, aux)

        period = _remat_wrap(period, c.remat)
        aux = torch.zeros((2,), dtype=torch.float32,
                          device=group.devices[0])
        with set_checkpoint_early_stop(False):
            for i in range(c.n_periods):
                out = period(*xs, aux, i * n)
                xs, aux = list(out[:T]), out[T]
        for k, spec in enumerate(c.tail_specs):
            xs = self._slot_tensor(spec, group, c.n_periods * n + k, xs,
                                   rope)
        return group.logits(self._norm, xs), aux

    def _slot_tensor(self, spec: LayerSpec, group, idx: int, xs, rope, *,
                     last=False):
        """Layer ``idx`` at every position of ``group``: each sublayer's
        input gathered (``seqshard``), its part computed on the position's
        view, joined into the residual."""
        c = self.cfg
        cd = c.compute_dtype
        views = [v.layers[idx] for v in group.views]
        nvh = c.n_heads if c.hq_padded != c.n_heads else None
        with L.period_end(last and not spec.mlp):
            hs = group.to_mixer([self._norm(v.ln1, x)
                                 for v, x in zip(views, xs)])
            os = [A.attn_apply(v.attn, h, sin, cos, causal=True,
                               window=spec.window, q_chunk=c.kv_chunk,
                               kv_chunk=c.kv_chunk, compute_dtype=cd,
                               rope_on=spec.rope, n_valid_heads=nvh)[0]
                  for v, h, (sin, cos) in zip(views, hs, rope)]
            os = group.join(os, group.split["attn"])
            if views[0].attn_bo is not None:
                os = [o + v.attn_bo.to(o.dtype) for o, v in zip(os, views)]
            xs = [x + o for x, o in zip(xs, os)]
        if spec.mlp:
            with L.period_end(last):
                hs = group.to_mixer([self._norm(v.ln2, x)
                                     for v, x in zip(views, xs)])
                os = [L.mlp_apply(v.ffn, h, act=c.act, compute_dtype=cd)
                      for v, h in zip(views, hs)]
                os = group.join(os, group.split["mlp"])
                xs = [x + o.to(x.dtype) for x, o in zip(xs, os)]
        return [SH.shard(x, "batch", "seq_res", "embed", rules=c.rules)
                for x in xs]

    @torch.no_grad()
    def prefill(self, tokens, *, image_embeds=None, max_len=None):
        """The forward over a prompt and the decode cache it leaves:
        (B, S) tokens [and a VLM's ``image_embeds``] -> (logits (B, 1, V)
        at the last position, in the compute dtype; the cache).

        The cache is a dict from each layer's index in ``layers`` to its
        tensors: ``k``/``v`` (B, max_len, Hkv, hd) zero-padded past the
        prefix for a global attention layer; ``k``/``v`` (B, W, Hkv, hd)
        and ``pos`` (B, W) int32 for a windowed one (a ring, position p in
        slot p % W, -1 empty); ``ssm`` (B, H, N, P) f32 and ``conv`` for
        Mamba-2; ``h`` (B, d_rnn) f32 and ``conv`` for the RG-LRU; and,
        for an MoE layer, ``moe_cnt`` (B, E) int32 and ``moe_cap``.
        ``max_len`` sizes the global caches for the decoding that follows;
        it is at least the prefix (a VLM's image positions included) + 1.
        """
        c = self.cfg
        if c.enc_dec:
            raise ValueError(f"{c.name} is an encoder-decoder: build it "
                             "as repro_torch.models.whisper.WhisperED")
        TP.check_scope(c, serving=True)
        x = self._embed(tokens, image_embeds)
        S = x.shape[1]
        max_len = max(max_len or 0, S + 1)
        sin, cos = L.rope(torch.arange(S, device=x.device), c.hd,
                          c.rope_theta)
        cache = {}
        for i, (spec, lp) in enumerate(zip(self.specs, self.layers)):
            x, cache[i], _ = self._slot_apply(spec, lp, x, sin, cos,
                                              mode="prefill",
                                              max_len=max_len)
        return self._logits(x[:, -1:]), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """One token a row: tokens (B, 1) at positions ``pos`` (B,) int32
        -> (logits (B, 1, V) in the compute dtype, the cache).  The
        attention caches are written in place; the returned dict holds
        them and the recurrent states and MoE counts of this step."""
        c = self.cfg
        TP.check_scope(c, serving=True)
        pos = torch.as_tensor(pos, device=self.device)
        x = self._embed(tokens)
        sin, cos = L.rope(pos[:, None], c.hd, c.rope_theta)
        new = {}
        for i, (spec, lp) in enumerate(zip(self.specs, self.layers)):
            x, new[i], _ = self._slot_apply(spec, lp, x, sin, cos,
                                            mode="decode", cache=cache[i],
                                            pos_dec=pos)
        return self._logits(x), new

    # ------------------------------------------------------------------
    # cache constructors
    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *, device=None):
        """A zero decode cache for ``batch`` rows and ``max_len``
        positions, laid out as :meth:`prefill`'s, on ``device`` (the
        model's when None)."""
        c = self.cfg
        dev = self.device if device is None else torch.device(device)

        def zeros(shape, dtype):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def layer(spec: LayerSpec):
            if spec.mixer == "attn":
                n = spec.window if spec.window is not None else max_len
                out = {"k": zeros((batch, n, c.n_kv, c.hd), c.cache_dtype),
                       "v": zeros((batch, n, c.n_kv, c.hd), c.cache_dtype)}
                if spec.window is not None:
                    out["pos"] = torch.full((batch, n), -1,
                                            dtype=torch.int32, device=dev)
            elif spec.mixer == "ssm":
                d_inner = 2 * c.d_model
                out = {"ssm": zeros((batch, d_inner // c.ssm_headdim,
                                     c.ssm_state, c.ssm_headdim),
                                    torch.float32),
                       "conv": zeros((batch, 3, d_inner + 2 * c.ssm_state),
                                     c.cache_dtype)}
            elif spec.mixer == "rec":
                r = c.rnn_width or c.d_model
                out = {"h": zeros((batch, r), torch.float32),
                       "conv": zeros((batch, 3, r), c.cache_dtype)}
            else:
                raise ValueError(spec.mixer)
            if spec.mlp and spec.moe:
                out["moe_cnt"] = zeros((batch, c.num_experts), torch.int32)
                out["moe_cap"] = torch.full(
                    (), MOE.moe_capacity(max_len, c.top_k, c.num_experts,
                                         c.capacity_factor),
                    dtype=torch.int32, device=dev)
            return out

        return {i: layer(spec) for i, spec in enumerate(self.specs)}

    def abstract_cache(self, batch: int, max_len: int):
        """:meth:`init_cache`'s shapes and dtypes on the ``meta`` device
        (no allocation)."""
        return self.init_cache(batch, max_len, device="meta")

    def cache_logical(self, batch: int, max_len: int):
        """Logical axes congruent with :meth:`init_cache`'s dict (the JAX
        package's, less the leading ``"stack"`` axis of its period-stacked
        slots)."""
        del batch, max_len

        def layer(spec: LayerSpec):
            if spec.mixer == "attn":
                kv = ("batch", "cache_seq", "kv_heads", None)
                out = {"k": kv, "v": kv}
                if spec.window is not None:
                    out["pos"] = ("batch", None)
            elif spec.mixer == "ssm":
                out = {"ssm": ("batch", "heads", None, None),
                       "conv": ("batch", None, "rnn")}
            elif spec.mixer == "rec":
                out = {"h": ("batch", "rnn"), "conv": ("batch", None, "rnn")}
            else:
                raise ValueError(spec.mixer)
            if spec.mlp and spec.moe:
                out["moe_cnt"] = ("batch", None)
                out["moe_cap"] = ()
            return out

        return {i: layer(spec) for i, spec in enumerate(self.specs)}

    def abstract_params(self):
        """(name -> ``meta`` tensor, name -> logical axes) of the
        parameters, built on the ``meta`` device (no allocation)."""
        model = (self if self.device.type == "meta"
                 else StackedLM(self.cfg, device="meta"))
        return L.abstract_params(model)
