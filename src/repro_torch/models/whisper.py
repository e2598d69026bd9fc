"""Whisper-style encoder-decoder backbone (arXiv:2212.04356) -- the PyTorch
counterpart of the JAX package's ``models/whisper.py``, its training half.

The audio frontend (log-mel + conv downsampling) is a stub, as there: the
caller gives precomputed frame embeddings (B, F, d_model).  The module is
the transformer backbone: a bidirectional encoder over the frames with
learned positional embeddings, and a causal decoder with self- and
cross-attention (LayerNorm and biased projections, Whisper's
parameterisation), its logits tied to the decoder's embedding.

The JAX package stacks each layer kind's parameters and scans; the port
keeps one module per layer (``enc_layers``, ``dec_layers``) and runs them
in a loop, each under ``torch.utils.checkpoint`` when the config asks for
``remat="full"``.  Each parameter carries the JAX package's logical axes
less its stacked leaves' leading ``"stack"`` axis (``abstract_params``),
and ``cache_logical`` gives the cache's.

Serving: ``prefill`` encodes the frames once, projects the encoder's
output through every decoder layer's cross-attention keys and values
(cached), and fills the decoder's self-attention cache; ``decode_step`` is
then the decoder alone.  The cache is a dict from each decoder layer's
index to ``k``/``v`` (self-attention, (B, max_len, Hkv, hd)) and
``cross_k``/``cross_v`` ((B, F, Hkv, hd)); the JAX package stacks them as
``self``/``cross`` on the layer axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.platform import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import ArchConfig, Norm, _remat_wrap

__all__ = ["WhisperED"]


class EncoderLayer(nn.Module):
    def __init__(self, pi: L.ParamInit, c: ArchConfig):
        super().__init__()
        self.ln1 = Norm(pi, c.d_model, "ln")
        self.attn = A.attn_init(pi, c.d_model, c.n_heads, c.n_kv, c.hd,
                                qkv_bias=True, out_bias=True)
        self.ln2 = Norm(pi, c.d_model, "ln")
        self.ffn = L.mlp_init(pi, c.d_model, c.d_ff, gated=False)


class DecoderLayer(nn.Module):
    def __init__(self, pi: L.ParamInit, c: ArchConfig):
        super().__init__()
        self.ln1 = Norm(pi, c.d_model, "ln")
        self.self_attn = A.attn_init(pi, c.d_model, c.n_heads, c.n_kv, c.hd,
                                     qkv_bias=True, out_bias=True)
        self.ln_x = Norm(pi, c.d_model, "ln")
        self.cross_attn = A.attn_init(pi, c.d_model, c.n_heads, c.n_kv,
                                      c.hd, qkv_bias=True, out_bias=True)
        self.ln2 = Norm(pi, c.d_model, "ln")
        self.ffn = L.mlp_init(pi, c.d_model, c.d_ff, gated=False)


def _ln(p: Norm, x):
    return L.layernorm(x, p.scale, p.bias)


class WhisperED(nn.Module):
    """Encoder-decoder; ``cfg.n_layers`` encoder layers and as many decoder
    layers, on ``device`` (the card when None; ``"meta"`` for shapes
    alone), its parameters drawn from ``seed``.  ``max_dec_len`` sizes the
    decoder's positional table (32768 covers the JAX package's largest
    serving shape, so the two parameter counts agree)."""

    def __init__(self, cfg: ArchConfig, *, seed: int = 0, device=None,
                 max_dec_len: int = 32768):
        super().__init__()
        if not cfg.enc_dec:
            raise ValueError(f"{cfg.name} is not an encoder-decoder config")
        self.cfg = cfg
        if str(device) != "meta":
            device = resolve_device(device)
        pi = L.ParamInit(cfg.param_dtype, device)
        c = cfg
        self.enc_pos = pi.normal((c.enc_frames, c.d_model), (None, "embed"),
                                 scale=0.02)
        self.dec_embed = L.embed_init(pi, c.vocab, c.d_model)
        self.dec_pos = pi.normal((max_dec_len, c.d_model), (None, "embed"),
                                 scale=0.02)
        self.enc_layers = nn.ModuleList(EncoderLayer(pi, c)
                                        for _ in range(c.n_layers))
        self.dec_layers = nn.ModuleList(DecoderLayer(pi, c)
                                        for _ in range(c.n_layers))
        self.enc_ln = Norm(pi, c.d_model, "ln")
        self.dec_ln = Norm(pi, c.d_model, "ln")
        self.init(seed)

    @property
    def device(self) -> torch.device:
        return self.dec_embed.device

    def init(self, seed: int) -> "WhisperED":
        """Draw every parameter from ``seed`` (in place)."""
        L.ParamInit.fill(self, seed)
        return self

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # ------------------------------------------------------------------
    def encode(self, frames):
        """(B, F, d_model) frame embeddings -> the encoder's output, in the
        compute dtype."""
        c = self.cfg
        cd = c.compute_dtype
        F_ = frames.shape[1]
        x = frames.to(cd) + self.enc_pos[:F_].to(cd)[None]

        def body(h, lp):
            a = _ln(lp.ln1, h)
            o, _ = A.attn_apply(lp.attn, a, None, None, causal=False,
                                rope_on=False, kv_chunk=c.kv_chunk,
                                compute_dtype=cd)
            h = h + o
            m = _ln(lp.ln2, h)
            return h + L.mlp_apply(lp.ffn, m, act="gelu",
                                   compute_dtype=cd).to(h.dtype)

        body = _remat_wrap(body, c.remat)
        for lp in self.enc_layers:
            x = body(x, lp)
        return _ln(self.enc_ln, x)

    def _dec_body(self, tokens, enc_out, *, collect_cache=False,
                  max_len=None):
        """The decoder over (B, S) tokens against the encoder's output ->
        (logits (B, S, V) f32, the cache when ``collect_cache``, else None):
        self-attention keys and values zero-padded to ``max_len``
        positions, and the cross-attention's."""
        c = self.cfg
        cd = c.compute_dtype
        S = tokens.shape[1]
        x = nn.functional.embedding(tokens, self.dec_embed).to(cd)
        x = x + self.dec_pos[:S].to(cd)[None]

        def body(h, enc, lp):
            a = _ln(lp.ln1, h)
            o, (k, v) = A.attn_apply(lp.self_attn, a, None, None,
                                     causal=True, rope_on=False,
                                     kv_chunk=c.kv_chunk, compute_dtype=cd)
            h = h + o
            xx = _ln(lp.ln_x, h)
            o, (ck, cv) = A.attn_apply(lp.cross_attn, xx, None, None,
                                       kv=enc, rope_on=False,
                                       kv_chunk=c.kv_chunk, compute_dtype=cd)
            h = h + o
            m = _ln(lp.ln2, h)
            h = h + L.mlp_apply(lp.ffn, m, act="gelu",
                                compute_dtype=cd).to(h.dtype)
            if not collect_cache:
                return h
            pad = (0, 0, 0, 0, 0, max_len - S)
            return h, {"k": F.pad(k.to(c.cache_dtype), pad),
                       "v": F.pad(v.to(c.cache_dtype), pad),
                       "cross_k": ck.to(c.cache_dtype),
                       "cross_v": cv.to(c.cache_dtype)}

        cache = None
        if collect_cache:
            cache = {}
            for i, lp in enumerate(self.dec_layers):
                x, cache[i] = body(x, enc_out, lp)
        else:
            body = _remat_wrap(body, c.remat)
            for lp in self.dec_layers:
                x = body(x, enc_out, lp)
        x = _ln(self.dec_ln, x)
        logits = L.dense(x.to(cd), self.dec_embed.T.to(cd))
        return logits.float(), cache

    def apply(self, tokens, *, frames):
        """Training forward: (B, S) tokens and (B, F, d_model) frames ->
        (logits (B, S, V) f32, aux (2,) zeros)."""
        enc = self.encode(frames)
        logits, _ = self._dec_body(tokens, enc)
        return logits, torch.zeros((2,), dtype=torch.float32,
                                   device=logits.device)

    @torch.no_grad()
    def prefill(self, tokens, *, frames, max_len=None):
        """Encode ``frames`` and run the decoder over the prompt ->
        (logits (B, 1, V) f32 at the last position, the cache).
        ``max_len`` (at least the prompt + 1) sizes the self-attention
        cache."""
        max_len = max(max_len or 0, tokens.shape[1] + 1)
        enc = self.encode(frames)
        logits, cache = self._dec_body(tokens, enc, collect_cache=True,
                                       max_len=max_len)
        return logits[:, -1:], cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos):
        """tokens (B, 1) at ``pos`` (B,) int32, which is both the row of
        the decoder's positional table and the self-attention cache's
        length -> (logits (B, 1, V) f32, the cache).  The self-attention
        cache is written in place; the cross-attention's is read."""
        c = self.cfg
        cd = c.compute_dtype
        pos = torch.as_tensor(pos, device=self.device)
        x = nn.functional.embedding(tokens, self.dec_embed).to(cd)
        x = x + self.dec_pos[pos.long()].to(cd)[:, None, :]
        for i, lp in enumerate(self.dec_layers):
            cc = cache[i]
            a = _ln(lp.ln1, x)
            o, _ = A.attn_decode(lp.self_attn, a, None, None,
                                 {"k": cc["k"], "v": cc["v"]}, pos,
                                 rope_on=False, compute_dtype=cd)
            x = x + o
            xx = _ln(lp.ln_x, x)
            o, _ = A.attn_decode(lp.cross_attn, xx, None, None,
                                 {"k": cc["cross_k"], "v": cc["cross_v"]},
                                 pos, rope_on=False, cross=True,
                                 compute_dtype=cd)
            x = x + o
            m = _ln(lp.ln2, x)
            x = x + L.mlp_apply(lp.ffn, m, act="gelu",
                                compute_dtype=cd).to(x.dtype)
        x = _ln(self.dec_ln, x)
        logits = L.dense(x.to(cd), self.dec_embed.T.to(cd))
        return logits.float(), cache

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int, *, device=None):
        """A zero decode cache for ``batch`` rows, ``max_len`` decoder
        positions and the config's ``enc_frames``, laid out as
        :meth:`prefill`'s, on ``device`` (the model's when None)."""
        c = self.cfg
        dev = self.device if device is None else torch.device(device)

        def zeros(n):
            return torch.zeros((batch, n, c.n_kv, c.hd), dtype=c.cache_dtype,
                               device=dev)

        return {i: {"k": zeros(max_len), "v": zeros(max_len),
                    "cross_k": zeros(c.enc_frames),
                    "cross_v": zeros(c.enc_frames)}
                for i in range(c.n_layers)}

    def abstract_cache(self, batch: int, max_len: int):
        """:meth:`init_cache`'s shapes and dtypes on the ``meta`` device
        (no allocation)."""
        return self.init_cache(batch, max_len, device="meta")

    def cache_logical(self, batch: int, max_len: int):
        """Logical axes congruent with :meth:`init_cache`'s dict (the JAX
        package's less the leading ``"stack"`` axis of its stacked
        layers)."""
        del batch, max_len
        kv = ("batch", "cache_seq", "kv_heads", None)
        return {i: {"k": kv, "v": kv, "cross_k": kv, "cross_v": kv}
                for i in range(self.cfg.n_layers)}

    def abstract_params(self):
        """(name -> ``meta`` tensor, name -> logical axes) of the
        parameters, built on the ``meta`` device (no allocation)."""
        model = self if self.device.type == "meta" else WhisperED(
            self.cfg, device="meta", max_dec_len=self.dec_pos.shape[0])
        return L.abstract_params(model)
