"""AdamW with f32 moments, the JAX package's formula and order of
operations: the bias-corrected ``m_hat / (sqrt(v_hat) + eps)`` plus
``weight_decay * p`` on every parameter (norms and biases too), and
``p - lr * step`` in f32.  ``torch.optim.AdamW`` computes the same step in
another order (decay first, bias corrections folded into the step size),
so its f32 results drift from the JAX package's; this module's do not.

The state is a plain dataclass of name -> tensor dicts, so it checkpoints
like the parameters.  Where the JAX package returns new arrays, the port
updates the parameters and the state in place, as ``torch.optim`` does,
and returns them.

Placed parameters (name -> :class:`repro_torch.parallel.placement.
PlacedTensor`, all on one mesh): the moments are placed as the parameters
are and the count is replicated, one copy a position; an update runs the
same formula at every position on that position's shards alone, so each
element is computed exactly as on one device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.parallel.placement import (
    NamedSharding,
    PlacedTensor,
    device_put,
)
from repro_torch.parallel.sharding import PartitionSpec

__all__ = ["OptState", "adamw_init", "adamw_update"]


@dataclasses.dataclass
class OptState:
    mu: Any       # name -> f32 tensor
    nu: Any       # name -> f32 tensor
    count: Any    # 0-d int32 tensor


def _placed_zeros(p: PlacedTensor) -> PlacedTensor:
    shards = np.empty(p.shards.shape, dtype=object)
    for coord in np.ndindex(p.shards.shape):
        s = p.shards[coord]
        shards[coord] = torch.zeros(s.shape, dtype=torch.float32,
                                    device=s.device)
    return PlacedTensor(p.sharding, p.shape, torch.float32, shards)


def _placed(params: dict) -> bool:
    return any(isinstance(p, PlacedTensor) for p in params.values())


def adamw_init(params: dict) -> OptState:
    """Zero moments in f32 beside each parameter, and a zero step count
    (placed parameters: placed moments, the count at every position)."""
    if _placed(params):
        mesh = next(iter(params.values())).mesh
        return OptState(
            mu={k: _placed_zeros(p) for k, p in params.items()},
            nu={k: _placed_zeros(p) for k, p in params.items()},
            count=device_put(torch.zeros((), dtype=torch.int32),
                             NamedSharding(mesh, PartitionSpec())))
    device = next(iter(params.values())).device if params else "cpu"
    return OptState(
        mu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


@torch.no_grad()
def adamw_update(grads: dict, state: OptState, params: dict, *, lr,
                 b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1):
    """One step in place; returns (params, state).  ``lr`` may be a 0-d
    tensor.  Placed parameters take placed gradients on the same mesh;
    each position then steps its own shards (and its count)."""
    if _placed(params):
        mesh = next(iter(params.values())).mesh
        for coord in np.ndindex(mesh.devices.shape):
            at = {k: p.shards[coord] for k, p in params.items()}
            dev = next(iter(at.values())).device
            sub = OptState(mu={k: m.shards[coord]
                               for k, m in state.mu.items()},
                           nu={k: v.shards[coord]
                               for k, v in state.nu.items()},
                           count=state.count.shards[coord])
            adamw_update({k: g.shards[coord] for k, g in grads.items()},
                         sub, at, lr=lr.to(dev) if torch.is_tensor(lr)
                         else lr, b1=b1, b2=b2, eps=eps,
                         weight_decay=weight_decay)
            state.count.shards[coord] = sub.count
        return params, state
    c = state.count + 1
    cf = c.float()
    bc1 = 1.0 - b1 ** cf
    bc2 = 1.0 - b2 ** cf
    for name, p in params.items():
        g = grads[name].float()
        m, v = state.mu[name], state.nu[name]
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * g * g)
        step = (m / bc1) / (torch.sqrt(v / bc2) + eps)
        step = step + weight_decay * p.float()
        p.copy_((p.float() - lr * step).to(p.dtype))
    state.count = c
    return params, state
