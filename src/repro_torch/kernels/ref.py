"""Plain PyTorch version of the P2H sweep kernel.

Same operands, visit order, block-granular skip rule and pruning math as
:func:`repro_torch.kernels.p2h_scan.p2h_sweep`, so the kernel can be held
against it on the card, skip counts included.  The query blocks advance
together, one visited tile per step.
"""
from __future__ import annotations

import torch

from repro_torch.core.bounds import _cone_cases
from repro_torch.core.exact import topk_smallest

__all__ = ["p2h_sweep_ref"]


def p2h_sweep_ref(
    pts_tiles, ids_tiles, rx_tiles, xc_tiles, xs_tiles, leaf_cnorm,
    queries, qnorm, cap, leaf_ip, leaf_lb, visit,
    *, k: int, bq: int = 8, use_ball: bool = True, use_cone: bool = True,
    seed_d=None, seed_i=None, return_live: bool = False,
):
    """Returns ``(dists (B,k), ids (B,k), skips (nqb,1) i32)``; dists/ids are
    sorted ascending (callers sort the kernel's unsorted output before
    comparing).  ``skips`` counts, per query block, the tiles whose node
    ball bound is >= lambda for every query of the block.
    ``seed_d``/``seed_i`` ((B, k)) seed the running top-k; ``None`` starts
    cold (+inf / -1).  ``return_live=True`` also returns the
    ``(nqb, n_visit)`` bool mask of the tiles each block scanned."""
    B, dp = queries.shape
    L, n0 = ids_tiles.shape
    nqb, n_visit = visit.shape
    if B != nqb * bq:
        raise ValueError(f"{B} queries do not make {nqb} blocks of {bq}")
    dev = queries.device
    qb = queries.view(nqb, bq, dp)
    qn = qnorm.view(nqb, bq)
    capb = cap.view(nqb, bq)
    ipb = leaf_ip.view(nqb, bq, L)
    lbb = leaf_lb.view(nqb, bq, L)
    if seed_d is None:
        td = torch.full((nqb, bq, k), float("inf"), dtype=torch.float32,
                        device=dev)
        ti = torch.full((nqb, bq, k), -1, dtype=torch.int32, device=dev)
    else:
        td = seed_d.to(torch.float32).reshape(nqb, bq, k)
        ti = seed_i.to(torch.int32).reshape(nqb, bq, k)
    ns = torch.zeros(nqb, dtype=torch.int32, device=dev)
    live = torch.zeros((nqb, n_visit), dtype=torch.bool, device=dev)
    visit = visit.long()
    for j in range(n_visit):
        leaf = visit[:, j]  # (nqb,)
        at = leaf[:, None, None].expand(nqb, bq, 1)
        lam = torch.minimum(td.max(dim=2).values, capb)  # (nqb, bq)
        active = lbb.gather(2, at)[..., 0] < lam
        any_active = active.any(dim=1)
        ns += (~any_active).to(torch.int32)
        live[:, j] = any_active
        ids = ids_tiles[leaf]  # (nqb, n0)
        keep = (ids >= 0)[:, None, :] & active[:, :, None]
        ip = ipb.gather(2, at)[..., 0]  # (nqb, bq)
        if use_ball:
            pb = torch.clamp(torch.abs(ip)[..., None]
                             - qn[..., None] * rx_tiles[leaf][:, None, :],
                             min=0.0)
            keep &= pb < lam[..., None]
        if use_cone:
            cn = torch.clamp(leaf_cnorm[leaf, 0], min=1e-12)  # (nqb,)
            qcos = ip / cn[:, None]
            qsin = torch.sqrt(torch.clamp(qn * qn - qcos * qcos, min=0.0))
            cb = _cone_cases(qcos[..., None], qsin[..., None],
                             xc_tiles[leaf][:, None, :],
                             xs_tiles[leaf][:, None, :])
            keep &= cb < lam[..., None]
        absip = torch.abs(torch.bmm(qb, pts_tiles[leaf].transpose(1, 2)))
        cand = torch.where(keep, absip, torch.full_like(absip, float("inf")))
        td, ti = topk_smallest(
            torch.cat([td, cand], dim=2),
            torch.cat([ti, ids[:, None, :].expand(nqb, bq, n0)], dim=2), k)
    out = (td.reshape(B, k), ti.reshape(B, k), ns.view(nqb, 1))
    return out + (live,) if return_live else out
