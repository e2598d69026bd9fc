"""Mixture-of-Experts FFN: top-k token-choice routing with a per-row
capacity, sort-based dispatch, grouped expert products and an optional
shared expert (llama4-style) -- the PyTorch counterpart of the JAX
package's ``models/moe.py``.

Routing arithmetic (f32), as there: a softmax router, the top-k gates
renormalised, the Switch load-balance loss and the router z-loss, and a
deterministic capacity drop (first come, by token order, within each
expert).

Summation order.  The dispatch scatter-adds each kept assignment into its
own (row, expert, slot): no two kept assignments share a slot, and a
dropped one adds an exact zero, so the sum is the same in any order and
the result does not depend on the order of the card's atomic adds.  The
combine does not scatter: each token's ``top_k`` expert outputs are
gathered back in assignment order and summed over the choice axis, a
fixed order (the JAX package scatter-adds them, in its sorted order).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (
    _ACTS,
    MLP,
    ParamInit,
    dense,
    mlp_apply,
    product,
    span,
)

__all__ = ["MoE", "moe_init", "moe_apply", "moe_capacity"]


def moe_capacity(seq_len: int, top_k: int, num_experts: int,
                 capacity_factor: float) -> int:
    """Per-row expert capacity (static): cf * S * k / E, 8-aligned, >= 8,
    and never above the row's S * k assignments."""
    A = seq_len * top_k
    C = int(capacity_factor * seq_len * top_k / num_experts)
    C = max(8, -(-C // 8) * 8)
    return min(C, A)


def _gdot(eq, a, b):
    """Grouped expert product.  On the card the compute-dtype operands go
    to the tensor cores, which accumulate in f32; on the host both are
    upcast to f32 (the JAX package's CPU branch).  A batched product (the
    expert axis)."""
    with span("moe.experts"):
        if a.device.type != "cuda":
            a, b = a.float(), b.float()
        with product(True):
            return torch.einsum(eq, a, b)


class MoE(nn.Module):
    """The MoE FFN's parameters: ``router`` (d_model, E), ``wi``/``wg``
    (E, d_model, d_ff), ``wo`` (E, d_ff, d_model) and, with a shared
    expert, ``shared`` (a gated :class:`MLP` of width ``shared_ff``)."""

    def __init__(self, pi: ParamInit, d_model: int, d_ff: int,
                 num_experts: int, *, gated: bool = True,
                 shared_ff: int = 0):
        super().__init__()
        up = ("expert", "embed", "expert_mlp")
        self.router = pi.normal((d_model, num_experts), ("embed", None),
                                scale=0.02)
        self.wi = pi.normal((num_experts, d_model, d_ff), up)
        self.wo = pi.normal((num_experts, d_ff, d_model),
                            ("expert", "expert_mlp", "embed"))
        self.wg = (pi.normal((num_experts, d_model, d_ff), up) if gated
                   else None)
        self.shared = (MLP(pi, d_model, shared_ff, gated=True) if shared_ff
                       else None)


def moe_init(pi: ParamInit, d_model: int, d_ff: int, num_experts: int, *,
             gated: bool = True, shared_ff: int = 0) -> MoE:
    return MoE(pi, d_model, d_ff, num_experts, gated=gated,
               shared_ff=shared_ff)


def moe_apply(p: MoE, x, *, top_k: int, act: str = "silu",
              capacity_factor: float = 1.25, compute_dtype=torch.bfloat16,
              expert_counts=None, capacity=None, capacity_ref=None,
              return_counts: bool = False):
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux dict(load_loss,
    z_loss)) [, counts (B, E) int32].

    Dispatch is per row: capacity cf * S * k / E per sequence.  A row's
    (token, choice) assignments are stably sorted by expert; the rank
    within the expert is the slot; slots beyond the capacity drop; the
    kept ones are scattered into (B, E, C, D), go through the grouped
    expert products, and are gathered back with their gate weights.

    The capacity carry (a chunked forward equal to the full one):
    ``expert_counts`` (B, E) are the assignments each expert already
    received (before drops), from which first-come positions continue;
    ``capacity`` (int) replaces both the drop threshold and the buffer
    size with the reference forward's; ``capacity_ref`` (a tensor)
    replaces only the drop threshold; ``return_counts`` also returns the
    updated counts.
    """
    with span("moe.dispatch"):
        B, S, D = x.shape
        E = p.router.shape[1]
        a = _ACTS[act]
        dev = x.device

        # ---- router (f32) ----
        logits = dense(x, p.router, torch.float32)        # (B, S, E)
        probs = torch.softmax(logits.float(), dim=-1)
        gate_v, gate_e = torch.topk(probs, top_k, dim=-1)  # (B, S, k)
        gate_v = gate_v / torch.clamp_min(gate_v.sum(-1, keepdim=True),
                                          1e-9)

        # auxiliary losses (Switch): load balance + z-loss
        me = probs.mean(dim=(0, 1))                       # (E,)
        ce = F.one_hot(gate_e, E).float().sum(2).mean(dim=(0, 1))
        load_loss = E * torch.sum(me * ce)
        z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

        # ---- per-row dispatch indices, in (token, choice) order ----
        A = S * top_k
        if capacity is None:
            C = moe_capacity(S, top_k, E, capacity_factor)
        else:  # the reference forward's capacity; never more than A slots
            C = min(int(capacity), A)
        flat_e = gate_e.reshape(B, A)
        order = torch.argsort(flat_e, dim=1, stable=True)
        se = torch.gather(flat_e, 1, order)
        seg_start = torch.searchsorted(
            se, torch.arange(E, device=dev).expand(B, E).contiguous())
        rank = (torch.arange(A, device=dev)[None]       # in sorted order
                - torch.gather(seg_start, 1, se))
        pos = torch.empty_like(rank).scatter_(1, order, rank)  # (B, A)
        if expert_counts is not None:
            eff_pos = pos + torch.gather(expert_counts.long(), 1, flat_e)
        else:
            eff_pos = pos
        if capacity_ref is not None:
            cap = capacity_ref
        elif capacity is not None:
            cap = int(capacity)  # un-clamped: eff_pos < cap implies pos < C
        else:
            cap = C
        keep = (eff_pos < cap) & (pos < C)
        dest = ((torch.arange(B, device=dev)[:, None] * E + flat_e) * C
                + torch.clamp_max(pos, C - 1)).reshape(B * A)

        # ---- scatter -> (B, E, C, D) ----
        xv = torch.repeat_interleave(x.to(compute_dtype), top_k, dim=1)
        vals = xv * keep[..., None].to(compute_dtype)     # (B, A, D)
        buf = torch.zeros((B * E * C, D), dtype=compute_dtype, device=dev)
        buf = buf.index_add(0, dest, vals.reshape(B * A, D)).view(
            B, E, C, D)

        # ---- grouped expert FFN ----
        h = _gdot("becd,edf->becf", buf, p.wi.to(compute_dtype))
        if p.wg is not None:
            g = _gdot("becd,edf->becf", buf, p.wg.to(compute_dtype))
            h = a(g) * h
        else:
            h = a(h)
        y = _gdot("becf,efd->becd", h.to(compute_dtype),
                  p.wo.to(compute_dtype))                 # (B, E, C, D)

        # ---- combine: a token's k outputs, summed over the choice axis --
        back = y.reshape(B * E * C, D).index_select(0, dest).view(B, A, D)
        wk = (gate_v.reshape(B, A) * keep)[..., None]     # f32
        out = (back * wk).view(B, S, top_k, D).sum(dim=2)  # f32
        if p.shared is not None:
            with span("moe.shared"):
                out = out + mlp_apply(p.shared, x, act=act,
                                      compute_dtype=compute_dtype)
        aux = {"load_loss": load_loss, "z_loss": z_loss}
        if return_counts:
            hist = torch.zeros((B, E), dtype=torch.int32, device=dev)
            hist.scatter_add_(1, flat_e, torch.ones_like(flat_e,
                                                         dtype=torch.int32))
            counts = hist if expert_counts is None else expert_counts + hist
            return out.to(x.dtype), aux, counts
        return out.to(x.dtype), aux
