"""Attention, the training half: GQA/MQA self-attention with RoPE as a
double-chunked online-softmax (flash-style) forward and a blockwise
backward that recomputes each block's probabilities from the saved
log-sum-exp -- the PyTorch counterpart of the JAX package's
``models/attention.py`` (``_flash_fwd``, ``_flash_bwd`` and their
``custom_vjp``, here one ``torch.autograd.Function``).

Dtypes as in the JAX package: scores, the running max and sum and the
output accumulator in f32; the probabilities cast to the compute dtype
before ``p @ V``; the output in the compute dtype.  Every block is
computed, masked ones included, so the arithmetic is the reference's.

Inside the function the operands are laid out (B, H, S, D), so each block
product is one batched matrix product over batch and heads.

``local_attention`` is the two-block sliding window, plain torch operations
under autograd; ``attn_apply`` takes it for a windowed self-attention layer
and ``gqa_attention`` for causal, bidirectional and cross-attention.

Serving: ``decode_attention`` attends one query token to a
(B, Smax, Hkv, D) cache, masked by a valid prefix or by each slot's
absolute position (the ring caches of windowed layers); ``attn_decode`` is
the one-token sublayer, writing the new key and value into the cache in
place; ``init_kv_cache`` makes a zero cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.platform import resolve_device
from repro_torch.models.layers import ParamInit, apply_rope, span

__all__ = ["Attention", "attn_init", "gqa_attention", "local_attention",
           "decode_attention", "attn_apply", "attn_decode", "init_kv_cache"]

_NEG = -1e30


def _mask_pad_heads(o, n_valid):
    """Zero the outputs of padded attention heads (config
    ``pad_heads_to``), so the padded model computes the unpadded one."""
    if n_valid is None or n_valid >= o.shape[-2]:
        return o
    mask = (torch.arange(o.shape[-2], device=o.device) < n_valid).to(o.dtype)
    return o * mask[..., :, None]


class Attention(nn.Module):
    """The attention sublayer's parameters: ``wq`` (d_model, H, hd),
    ``wk``/``wv`` (d_model, Hkv, hd), ``wo`` (H, hd, d_model), and with
    biases ``bq``/``bk``/``bv`` (heads, hd) and ``bo`` (d_model,)."""

    def __init__(self, pi: ParamInit, d_model, n_heads, n_kv, head_dim, *,
                 qkv_bias=False, out_bias=False):
        super().__init__()
        q, kv = ("heads", "head_dim"), ("kv_heads", "head_dim")
        self.wq = pi.normal((d_model, n_heads, head_dim), ("embed",) + q)
        self.wk = pi.normal((d_model, n_kv, head_dim), ("embed",) + kv)
        self.wv = pi.normal((d_model, n_kv, head_dim), ("embed",) + kv)
        self.wo = pi.normal((n_heads, head_dim, d_model), q + ("embed",))
        self.bq = pi.zeros((n_heads, head_dim), q) if qkv_bias else None
        self.bk = pi.zeros((n_kv, head_dim), kv) if qkv_bias else None
        self.bv = pi.zeros((n_kv, head_dim), kv) if qkv_bias else None
        self.bo = pi.zeros((d_model,), ("embed",)) if out_bias else None


def attn_init(pi: ParamInit, d_model, n_heads, n_kv, head_dim, *,
              qkv_bias=False, out_bias=False) -> Attention:
    return Attention(pi, d_model, n_heads, n_kv, head_dim,
                     qkv_bias=qkv_bias, out_bias=out_bias)


def _proj(x, w, b=None, compute_dtype=torch.bfloat16):
    """(B, S, d) x (d, H, k) -> (B, S, H, k) in the compute dtype."""
    y = torch.tensordot(x.to(compute_dtype), w.to(compute_dtype),
                        dims=([2], [0]))
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def _repeat_kv(k, n_heads, compute_dtype):
    """(B, S, Hkv, D) -> (B, S, Hq, D): query head h reads KV head
    h // (Hq / Hkv)."""
    B, S, Hkv, D = k.shape
    G = n_heads // Hkv
    k = k.to(compute_dtype)
    if G > 1:
        k = k[:, :, :, None, :].expand(B, S, Hkv, G, D).reshape(
            B, S, Hkv * G, D)
    return k


def _mask_block(pq, pk, causal, window):
    """(B, Cq), (Ck,) -> (B, 1, Cq, Ck) validity mask from absolute
    positions (-1 marks padding)."""
    pqb = pq[:, None, :, None]
    pkb = pk[None, None, None, :]
    mask = (pkb >= 0) & (pqb >= 0)
    if causal:
        mask = mask & (pkb <= pqb)
    if window is not None:
        mask = mask & (pqb - pkb < window)
    return mask


def _dot32(a, b):
    """``a @ b`` with f32 results: products of compute-dtype operands
    accumulated in f32 (XLA's ``preferred_element_type=f32``); f64
    operands stay f64."""
    if a.dtype not in (torch.float32, torch.float64):
        a, b = a.float(), b.float()
    return torch.matmul(a, b)


def _flash_fwd(q, k, v, pos_q, pos_k, *, causal, window, nq, nk, Cq, Ck,
               compute_dtype):
    """Double-chunked online-softmax forward; q pre-scaled and padded.

    q, k, v: (B, H, S, D).  Returns out (B, H, Sq, D) in the compute dtype
    and lse (B, H, Sq) in f32.
    """
    B, H, Sq, D = q.shape
    out = torch.empty((B, H, Sq, D), dtype=compute_dtype, device=q.device)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    for i in range(nq):
        qs = slice(i * Cq, (i + 1) * Cq)
        qc, pq = q[:, :, qs], pos_q[:, qs]
        m = torch.full((B, H, Cq), _NEG, dtype=torch.float32,
                       device=q.device)
        lsum = torch.zeros((B, H, Cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, H, Cq, D), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            ks = slice(j * Ck, (j + 1) * Ck)
            kc, vc = k[:, :, ks], v[:, :, ks]
            s = _dot32(qc, kc.transpose(-1, -2))
            s = torch.where(_mask_block(pq, pos_k[ks], causal, window), s,
                            _NEG)
            m_new = torch.maximum(m, torch.amax(s, dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + torch.sum(p, dim=-1)
            pv = _dot32(p.to(compute_dtype), vc)
            acc = acc * corr[..., None] + pv
            m = m_new
        lse[:, :, qs] = m + torch.log(torch.clamp_min(lsum, 1e-30))
        lt = torch.clamp_min(lsum, 1e-30)
        out[:, :, qs] = (acc / lt[..., None]).to(compute_dtype)
    return out, lse


def _flash_bwd(do, q, k, v, pos_q, pos_k, out, lse, *, causal, window,
               nq, nk, Cq, Ck, compute_dtype):
    """Blockwise backward: each block's probabilities recomputed from
    ``lse``, so no block's probabilities outlive its step.  Returns dq, dk,
    dv in f32, (B, H, S, D)."""
    B, H, Sq, D = q.shape
    delta = torch.sum(do.float() * out.float(), dim=-1)        # (B, H, Sq)
    do = do.to(compute_dtype)
    dq = torch.empty((B, H, Sq, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    for i in range(nq):
        qs = slice(i * Cq, (i + 1) * Cq)
        qc, pq, doc = q[:, :, qs], pos_q[:, qs], do[:, :, qs]
        lsec, dltc = lse[:, :, qs], delta[:, :, qs]
        dqc = torch.zeros((B, H, Cq, D), dtype=torch.float32,
                          device=q.device)
        for j in range(nk):
            ks = slice(j * Ck, (j + 1) * Ck)
            kc, vc = k[:, :, ks], v[:, :, ks]
            s = _dot32(qc, kc.transpose(-1, -2))
            s = torch.where(_mask_block(pq, pos_k[ks], causal, window), s,
                            2.0 * _NEG)
            p = torch.exp(s - lsec[..., None])                 # (B,H,Cq,Ck)
            pc = p.to(compute_dtype)
            dv[:, :, ks] += _dot32(pc.transpose(-1, -2), doc)
            dp = _dot32(doc, vc.transpose(-1, -2))
            ds = (p * (dp - dltc[..., None])).to(compute_dtype)
            dqc += _dot32(ds, kc)
            dk[:, :, ks] += _dot32(ds.transpose(-1, -2), qc)
        dq[:, :, qs] = dqc
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Padded flash attention on (B, H, S, D) operands, q pre-scaled; the
    backward recomputes each block from the saved ``lse``.  ``static`` is
    ``(causal, window, nq, nk, Cq, Ck, compute_dtype)``."""

    @staticmethod
    def forward(ctx, q, k, v, pos_q, pos_k, static):
        causal, window, nq, nk, Cq, Ck, cd = static
        out, lse = _flash_fwd(q, k, v, pos_q, pos_k, causal=causal,
                              window=window, nq=nq, nk=nk, Cq=Cq, Ck=Ck,
                              compute_dtype=cd)
        ctx.save_for_backward(q, k, v, pos_q, pos_k, out, lse)
        ctx.static = static
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, pos_q, pos_k, out, lse = ctx.saved_tensors
        causal, window, nq, nk, Cq, Ck, cd = ctx.static
        with span("attention"):
            dq, dk, dv = _flash_bwd(do, q, k, v, pos_q, pos_k, out, lse,
                                    causal=causal, window=window, nq=nq,
                                    nk=nk, Cq=Cq, Ck=Ck, compute_dtype=cd)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def gqa_attention(q, k, v, pos_q, pos_k, *, causal=True, window=None,
                  kv_len=None, q_chunk=1024, kv_chunk=1024, scale=None,
                  compute_dtype=torch.bfloat16):
    """Double-chunked online-softmax attention with a flash-style backward
    (:class:`FlashAttention`).

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D); Hq % Hkv == 0.
    pos_q: (Sq,) or (B, Sq); pos_k: (Sk,) global positions.
    ``kv_len``: optional (B,) valid prefix of k/v; keys at or past its
    largest entry are masked, through the forward alone (no gradient).
    Returns (B, Sq, Hq, D) in the compute dtype.
    """
    B, Sq, Hq, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    k = _repeat_kv(k, Hq, compute_dtype)
    v = _repeat_kv(v, Hq, compute_dtype)
    Sk = k.shape[1]
    q = q.to(compute_dtype) * torch.tensor(scale, dtype=compute_dtype,
                                           device=q.device)
    pos_q = torch.as_tensor(pos_q, device=q.device)
    if pos_q.dim() <= 1:
        pos_q = pos_q.expand(B, Sq)
    pos_k = torch.as_tensor(pos_k, device=q.device)

    Cq = min(q_chunk, Sq)
    Ck = min(kv_chunk, Sk)
    padq = (-Sq) % Cq
    padk = (-Sk) % Ck
    if padq:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, padq))
        pos_q = torch.nn.functional.pad(pos_q, (0, padq), value=-1)
    if padk:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, padk))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, padk))
        pos_k = torch.nn.functional.pad(pos_k, (0, padk), value=-1)
    nq, nk = q.shape[1] // Cq, k.shape[1] // Ck
    if kv_len is not None:
        # a ragged cache: keys past the longest row's prefix are invalid
        idx = torch.arange(k.shape[1], device=q.device)
        pos_k = torch.where(idx < torch.max(torch.as_tensor(
            kv_len, device=q.device)), pos_k, -1)
        with span("attention"), torch.no_grad():
            out, _ = _flash_fwd(
                q.transpose(1, 2).contiguous(),
                k.transpose(1, 2).contiguous(),
                v.transpose(1, 2).contiguous(), pos_q.contiguous(), pos_k,
                causal=causal, window=window, nq=nq, nk=nk, Cq=Cq, Ck=Ck,
                compute_dtype=compute_dtype)
        return out.transpose(1, 2)[:, :Sq]
    static = (causal, window, nq, nk, Cq, Ck, compute_dtype)
    with span("attention"):
        out = FlashAttention.apply(
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), pos_q.contiguous(), pos_k,
            static)
    return out.transpose(1, 2)[:, :Sq]


def local_attention(q, k, v, pos, *, window: int, scale=None,
                    compute_dtype=torch.bfloat16):
    """Exact sliding-window causal attention by the two-block trick: each
    query block of W = min(window, S) positions attends to its own block
    and the one before (2W keys) under the mask ``0 <= pq - pk < W``.  The
    same results as ``gqa_attention(..., window=W)`` at ~2W/S of the
    products.  Scores, softmax and ``p @ V`` accumulate in f32, the
    probabilities cast to the compute dtype first; the gradient is
    autograd's through these operations.

    q: (B, S, Hq, D); k, v: (B, S, Hkv, D); pos: (S,).  Returns
    (B, S, Hq, D) in the compute dtype.
    """
    with span("attention"):
        B, S, Hq, D = q.shape
        scale = scale if scale is not None else 1.0 / math.sqrt(D)
        k = _repeat_kv(k, Hq, compute_dtype)
        v = _repeat_kv(v, Hq, compute_dtype)
        W = min(window, S)
        pad = (-S) % W
        far = -10 * S  # a position no query can see
        q = q.to(compute_dtype) * torch.tensor(scale, dtype=compute_dtype,
                                               device=q.device)
        pos = torch.as_tensor(pos, device=q.device)
        if pad:
            q = F.pad(q, (0, 0, 0, 0, 0, pad))
            k = F.pad(k, (0, 0, 0, 0, 0, pad))
            v = F.pad(v, (0, 0, 0, 0, 0, pad))
            pos = F.pad(pos, (0, pad), value=far)
        Sp = q.shape[1]
        nb = Sp // W

        qb = q.reshape(B, nb, W, Hq, D)
        kb = k.reshape(B, nb, W, Hq, D)
        vb = v.reshape(B, nb, W, Hq, D)
        before = (0, 0, 0, 0, 0, 0, 1, 0)  # one block of zeros before block 0
        k2 = torch.cat([F.pad(kb, before)[:, :-1], kb], dim=2)  # (B,nb,2W,H,D)
        v2 = torch.cat([F.pad(vb, before)[:, :-1], vb], dim=2)
        pb = pos.reshape(nb, W)
        p2 = torch.cat([F.pad(pb, (0, 0, 1, 0), value=far)[:-1], pb], dim=1)

        s = torch.einsum("bnqhd,bnkhd->bnhqk", qb.float(), k2.float())
        dq = pb[None, :, None, :, None]
        dk = p2[None, :, None, None, :]
        mask = (dq >= dk) & (dq - dk < W)
        s = torch.where(mask, s, _NEG)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bnhqk,bnkhd->bnqhd", p.to(compute_dtype).float(),
                           v2.float())
        return out.reshape(B, Sp, Hq, D)[:, :S].to(compute_dtype)


def decode_attention(q, k_cache, v_cache, cache_len=None, *, window=None,
                     key_pos=None, pos_q=None, scale=None,
                     compute_dtype=torch.bfloat16):
    """One query token against a (B, Smax, Hkv, D) cache.  q: (B, 1, Hq, D).

    Masking: by the valid prefix ``cache_len`` (B,) of a contiguous cache,
    or by each slot's absolute position ``key_pos`` (B, Smax) with the
    query at ``pos_q`` (B,) (the ring caches of windowed layers; -1 marks
    an empty slot); ``window`` narrows either.  Scores, softmax and
    ``p @ V`` in f32, the probabilities cast to the compute dtype first.

    Query head h reads KV head h // (Hq / Hkv), contracted in place of the
    JAX package's repeat of the cache to Hq heads (the same products);
    with one KV head (MQA) the scores contract against it directly.
    Returns (B, 1, Hq, D) in the compute dtype.
    """
    with span("attention.decode"):
        B, _, Hq, D = q.shape
        Smax, Hkv = k_cache.shape[1], k_cache.shape[2]
        cd = compute_dtype
        scale = scale if scale is not None else 1.0 / math.sqrt(D)
        qh = (q.to(cd) * torch.tensor(scale, dtype=cd, device=q.device)
              ).reshape(B, Hq, D)
        if Hkv == 1:
            kr = k_cache[:, :, 0].to(cd)                       # (B, Smax, D)
            s = _dot32(qh, kr.transpose(1, 2))                 # (B, Hq, Smax)
        else:
            G = Hq // Hkv
            kr = k_cache.to(cd).permute(0, 2, 3, 1)            # (B,Hkv,D,Smax)
            s = _dot32(qh.reshape(B, Hkv, G, D), kr).reshape(B, Hq, Smax)
        if key_pos is not None:
            kp = key_pos[:, None, :]
            pq = torch.as_tensor(pos_q, device=q.device)[:, None, None]
            mask = (kp >= 0) & (kp <= pq)
            if window is not None:
                mask &= kp > pq - window
        else:
            idx = torch.arange(Smax, device=q.device)[None, None, :]
            cl = torch.as_tensor(cache_len, device=q.device)[:, None, None]
            mask = idx < cl
            if window is not None:
                mask &= idx >= cl - window
        s = torch.where(mask, s, _NEG)
        p = torch.softmax(s, dim=-1).to(cd)
        if Hkv == 1:
            out = _dot32(p, v_cache[:, :, 0].to(cd))           # (B, Hq, D)
        else:
            out = _dot32(p.reshape(B, Hkv, G, Smax),
                         v_cache.to(cd).transpose(1, 2))       # (B,Hkv,G,D)
        return out.reshape(B, 1, Hq, D).to(cd)


# ----------------------------------------------------------------------
# the attention sublayer (projections + rope + attend + out-projection)
# ----------------------------------------------------------------------


def attn_apply(p: Attention, x, sin, cos, *, causal=True, window=None,
               kv=None, pos_q=None, pos_k=None, kv_len=None,
               use_local_path=True, q_chunk=1024, kv_chunk=1024, scale=None,
               compute_dtype=torch.bfloat16, rope_on=True,
               n_valid_heads=None):
    """Self- (``kv=None``) or cross- (``kv=`` the encoder's output)
    attention sublayer on (B, S, E).  Returns (out (B, S, E) in x's
    dtype, (k, v)) -- k/v before the repeat, Hkv heads.

    A self-attention layer with a window takes the two-block
    :func:`local_attention` (``use_local_path``, the default), else
    ``gqa_attention``'s masked path.  Cross-attention is bidirectional,
    and no rotary embedding touches its queries or keys."""
    B, S, E = x.shape
    q = _proj(x, p.wq, p.bq, compute_dtype)
    src = x if kv is None else kv
    k = _proj(src, p.wk, p.bk, compute_dtype)
    v = _proj(src, p.wv, p.bv, compute_dtype)
    if rope_on and kv is None:
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)
    q = q.to(compute_dtype)
    k = k.to(compute_dtype)
    v = v.to(compute_dtype)
    if pos_q is None:
        pos_q = torch.arange(S, device=x.device)
    if pos_k is None:
        pos_k = torch.arange(k.shape[1], device=x.device)
    if window is not None and kv is None and use_local_path:
        o = local_attention(q, k, v, pos_q, window=window, scale=scale,
                            compute_dtype=compute_dtype)
    else:
        o = gqa_attention(q, k, v, pos_q, pos_k,
                          causal=causal and kv is None, window=window,
                          kv_len=kv_len, q_chunk=q_chunk, kv_chunk=kv_chunk,
                          scale=scale, compute_dtype=compute_dtype)
    o = _mask_pad_heads(o, n_valid_heads)
    return _out_proj(p, o, compute_dtype).to(x.dtype), (k, v)


def _out_proj(p: Attention, o, compute_dtype):
    """(B, S, H, hd) -> (B, S, E): the out-projection and its bias."""
    B, S, H, hd = o.shape
    out = torch.matmul(o.to(compute_dtype).reshape(B, S, H * hd),
                       p.wo.to(compute_dtype).reshape(H * hd, -1))
    if p.bo is not None:
        out = out + p.bo.to(out.dtype)
    return out


def write_rows(cache, new, idx):
    """``cache[b, idx[b]] = new[b, 0]`` for every row b, in place.  The
    index is clamped into the cache, as ``lax.dynamic_update_slice``
    clamps the JAX package's start index."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = torch.as_tensor(idx, device=cache.device).long().clamp(
        0, cache.shape[1] - 1)
    cache[rows, at] = new[:, 0].to(cache.dtype)


def attn_decode(p: Attention, x, sin, cos, cache, cache_len, *, window=None,
                scale=None, compute_dtype=torch.bfloat16, rope_on=True,
                cross=False, kv_len=None, n_valid_heads=None):
    """The one-token sublayer.  x: (B, 1, E); cache: dict(k, v), each
    (B, Smax, Hkv, hd).  Returns (out (B, 1, E) in x's dtype, the cache).

    Self-attention writes the new key and value into the cache at
    ``cache_len`` (B,), in place, and attends to ``cache_len + 1`` slots;
    cross-attention reads the cache (the encoder's projected keys and
    values) and leaves it as it is, all of it valid unless ``kv_len``."""
    B = x.shape[0]
    cd = compute_dtype
    q = _proj(x, p.wq, p.bq, cd)
    if rope_on and not cross:
        q = apply_rope(q, sin, cos)
    q = q.to(cd)
    if cross:
        eff_len = kv_len if kv_len is not None else torch.full(
            (B,), cache["k"].shape[1], dtype=torch.int32, device=x.device)
    else:
        k = _proj(x, p.wk, p.bk, cd)
        v = _proj(x, p.wv, p.bv, cd)
        if rope_on:
            k = apply_rope(k, sin, cos)
        write_rows(cache["k"], k, cache_len)
        write_rows(cache["v"], v, cache_len)
        eff_len = cache_len + 1
    o = decode_attention(q, cache["k"], cache["v"], eff_len, window=window,
                         scale=scale, compute_dtype=cd)
    o = _mask_pad_heads(o, n_valid_heads)
    return _out_proj(p, o, cd).to(x.dtype), cache


def init_kv_cache(n_layers, batch, max_len, n_kv, head_dim,
                  dtype=torch.bfloat16, device=None):
    """Zero keys and values, (n_layers, batch, max_len, n_kv, head_dim)
    each, on ``device`` (the card when None; raises without one)."""
    device = resolve_device(device)
    shape = (n_layers, batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
