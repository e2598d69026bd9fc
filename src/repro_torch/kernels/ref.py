"""Plain PyTorch versions of the sweep kernels.

:func:`p2h_sweep_ref` has the same operands, visit order, block-granular
skip rule and pruning math as :func:`repro_torch.kernels.p2h_scan.p2h_sweep`,
so the kernel can be held against it on the card, skip counts included.
The query blocks advance together, one round of ``split`` visited tiles
per step.
:func:`stacked_sweep_ref` is the same sweep run over a leading segment axis,
the plain version of :func:`repro_torch.kernels.stacked_sweep.stacked_sweep`.
"""
from __future__ import annotations

import torch

from repro_torch.core.bounds import _cone_cases
from repro_torch.core.exact import topk_smallest

__all__ = ["p2h_sweep_ref", "stacked_sweep_ref"]

_INT_CHUNK = 1024  # columns whose int8 x int8 sum is exact in f32 (< 2**24)


def p2h_sweep_ref(
    pts_tiles, ids_tiles, rx_tiles, xc_tiles, xs_tiles, leaf_cnorm,
    queries, qnorm, cap, leaf_ip, leaf_lb, visit,
    *, k: int, bq: int = 8, split: int = 1, use_ball: bool = True,
    use_cone: bool = True, seed_d=None, seed_i=None,
    return_live: bool = False, probe_dtype: str = "f32", sq=None,
    tile_scale=None, slack_a=None, slack_b=None,
):
    """Returns ``(dists (B,k), ids (B,k), skips (nqb,1) i32)``; dists/ids are
    sorted ascending.  ``skips`` counts, per query block, the tiles whose
    node ball bound is >= lambda for every query of the block.
    ``seed_d``/``seed_i`` ((B, k)) seed the running top-k; ``None`` starts
    cold (+inf / -1).  ``return_live=True`` also returns the
    ``(nqb, n_visit)`` bool mask of the tiles each block scanned.

    ``split`` is the kernel's visit schedule: each query block is walked by
    ``split`` workers, each with its own running top-k.  In round ``r``
    worker ``s`` takes visit entry ``r * split + s`` and tests it against
    the round's shared lambda, ``min(cap, k-th smallest of the union of the
    workers' top-ks at the round's start)``; at the end the workers' top-ks
    are merged in worker order (equal values: the lower worker first).
    ``split=1`` is one walker, the JAX package's schedule.  A seed goes to
    worker 0.

    ``probe_dtype`` != "f32" is the quantized probe pass: ``pts_tiles`` and
    ``queries`` arrive as bf16, or as int8 with the per-query scale ``sq``
    (B, 1) and the per-tile scale ``tile_scale`` (L, 1), and every scored
    candidate is widened by ``qnorm * slack_a[leaf] + sq * slack_b[leaf]``
    before it enters the top-k.  bf16 products are exact in f32 and summed
    in f32; int8 sums are exact integers, dequantised as
    ``float(acc) * (sq * tile_scale)``.  The pruning bounds stay f32."""
    B, dp = queries.shape
    L, n0 = ids_tiles.shape
    nqb, n_visit = visit.shape
    S = split
    if B != nqb * bq:
        raise ValueError(f"{B} queries do not make {nqb} blocks of {bq}")
    if S < 1:
        raise ValueError(f"split={S}: need at least one worker per block")
    dev = queries.device
    qb = queries.view(nqb, 1, bq, dp)
    qn = qnorm.view(nqb, 1, bq)
    capb = cap.view(nqb, bq)
    ipb = leaf_ip.view(nqb, bq, L)
    lbb = leaf_lb.view(nqb, bq, L)
    td = torch.full((nqb, S, bq, k), float("inf"), dtype=torch.float32,
                    device=dev)
    ti = torch.full((nqb, S, bq, k), -1, dtype=torch.int32, device=dev)
    if seed_d is not None:
        td[:, 0] = seed_d.to(torch.float32).reshape(nqb, bq, k)
        ti[:, 0] = seed_i.to(torch.int32).reshape(nqb, bq, k)
    if probe_dtype != "f32":
        zeros = torch.zeros((L, 1), dtype=torch.float32, device=dev)
        sqb = (torch.zeros_like(qn) if sq is None
               else sq.to(torch.float32).view(nqb, 1, bq))
        ts = torch.ones_like(zeros) if tile_scale is None else tile_scale
        sa = zeros if slack_a is None else slack_a
        sb = zeros if slack_b is None else slack_b
    ns = torch.zeros(nqb, dtype=torch.int32, device=dev)
    live = torch.zeros((nqb, n_visit), dtype=torch.bool, device=dev)
    visit = visit.long()
    for j0 in range(0, n_visit, S):
        leaf = visit[:, j0:j0 + S]  # (nqb, R): worker s takes entry j0 + s
        R = leaf.shape[1]
        union = td.permute(0, 2, 1, 3).reshape(nqb, bq, S * k)
        kth = torch.sort(union, dim=2).values[..., k - 1]
        lam = torch.minimum(kth, capb)[:, None, :]  # (nqb, 1, bq)
        at = leaf[:, None, :].expand(nqb, bq, R)
        active = lbb.gather(2, at).transpose(1, 2) < lam  # (nqb, R, bq)
        any_active = active.any(dim=2)
        ns += (~any_active).sum(dim=1, dtype=torch.int32)
        live[:, j0:j0 + R] = any_active
        ids = ids_tiles[leaf]  # (nqb, R, n0)
        keep = (ids >= 0)[:, :, None, :] & active[..., None]
        ip = ipb.gather(2, at).transpose(1, 2)  # (nqb, R, bq)
        if use_ball:
            pb = torch.clamp(torch.abs(ip)[..., None]
                             - qn[..., None] * rx_tiles[leaf][:, :, None, :],
                             min=0.0)
            keep &= pb < lam[..., None]
        if use_cone:
            cn = torch.clamp(leaf_cnorm[leaf, 0], min=1e-12)  # (nqb, R)
            qcos = ip / cn[..., None]
            qsin = torch.sqrt(torch.clamp(qn * qn - qcos * qcos, min=0.0))
            cb = _cone_cases(qcos[..., None], qsin[..., None],
                             xc_tiles[leaf][:, :, None, :],
                             xs_tiles[leaf][:, :, None, :])
            keep &= cb < lam[..., None]
        x = pts_tiles[leaf].reshape(nqb * R, n0, dp)
        q = qb.expand(nqb, R, bq, dp).reshape(nqb * R, bq, dp)
        if probe_dtype == "f32":
            absip = torch.abs(torch.bmm(q, x.transpose(1, 2)))
        else:
            if probe_dtype == "bf16":
                raw = torch.bmm(q.float(), x.float().transpose(1, 2))
            elif probe_dtype == "int8":
                raw = _int8_dot(q, x).to(torch.float32) * (
                    sqb[..., None] * ts[leaf, 0][:, :, None, None]
                ).reshape(nqb * R, bq, 1)
            else:
                raise ValueError(f"unknown probe_dtype {probe_dtype!r}")
            err = qn * sa[leaf, 0][..., None] + sqb * sb[leaf, 0][..., None]
            absip = torch.abs(raw) + err.reshape(nqb * R, bq, 1)
        absip = absip.view(nqb, R, bq, n0)
        cand = torch.where(keep, absip, torch.full_like(absip, float("inf")))
        nd, ni = topk_smallest(
            torch.cat([td[:, :R], cand], dim=3),
            torch.cat([ti[:, :R], ids[:, :, None, :].expand(nqb, R, bq, n0)],
                      dim=3), k)
        td = torch.cat([nd, td[:, R:]], dim=1)
        ti = torch.cat([ni, ti[:, R:]], dim=1)
    # worker-major, so a stable sort puts the lower worker first
    td, ti = topk_smallest(td.permute(0, 2, 1, 3).reshape(nqb, bq, S * k),
                           ti.permute(0, 2, 1, 3).reshape(nqb, bq, S * k), k)
    out = (td.reshape(B, k), ti.reshape(B, k), ns.view(nqb, 1))
    return out + (live,) if return_live else out


def _int8_dot(q, x):
    """Exact int64 ``q @ x^T`` of int8 batches (nqb, bq, dp) x (nqb, n0, dp):
    f32 products summed in chunks whose every partial sum is an integer
    below 2**24, hence exact in any order, on the host and on the card."""
    acc = None
    for c0 in range(0, q.shape[-1], _INT_CHUNK):
        part = torch.bmm(q[..., c0:c0 + _INT_CHUNK].float(),
                         x[..., c0:c0 + _INT_CHUNK].float().transpose(1, 2))
        part = part.to(torch.int64)
        acc = part if acc is None else acc + part
    return acc


def stacked_sweep_ref(
    pts_tiles, ids_tiles, rx_tiles, xc_tiles, xs_tiles, leaf_cnorm,
    queries, qnorm, cap, leaf_ip, leaf_lb, visit,
    *, k: int, bq: int = 8, split: int = 1, use_ball: bool = True,
    use_cone: bool = True, seed_d=None, seed_i=None, global_seed=None,
    probe_dtype: str = "f32", sq=None, tile_scale=None, slack_a=None,
    slack_b=None, return_live: bool = False,
):
    """:func:`p2h_sweep_ref` over the leading segment axis of the tile
    operands (``(N, L, n0, dp)``, ``(N, L, n0)``, ``(N, L, 1)``,
    ``leaf_ip``/``leaf_lb`` ``(N, B, L)``, ``visit`` ``(N, nqb, n_visit)``),
    with the stacked kernel's in-launch global top-k of values carried from
    segment to segment: each segment's cap is ``min(cap, k-th of glob)``
    (``glob`` changes only between segments, so folding it into the cap is
    the kernel's per-tile ``min``), and the segment's top-k values are then
    merged into ``glob``.  ``seed_d``/``seed_i`` ``(N, B, k)`` seed each
    segment's top-k, ``global_seed`` ``(B, k)`` seeds ``glob``; ``None``
    starts cold.  ``split`` is the kernel's schedule inside each segment,
    as in :func:`p2h_sweep_ref`: rounds of ``split`` tiles tested against
    the round's union lambda (the cap folded with ``glob``), the workers'
    top-ks merged at the segment's end, then folded into ``glob``; the
    segment's seed goes to worker 0.  Returns ``(dists (N, B, k)
    ascending, ids (N, B, k), skips (N, nqb, 1) i32)``, and with
    ``return_live=True`` also the ``(N, nqb, n_visit)`` bool mask of the
    tiles each block scanned."""
    N = pts_tiles.shape[0]
    B, dev = queries.shape[0], queries.device
    glob = (torch.full((B, k), float("inf"), dtype=torch.float32, device=dev)
            if global_seed is None else global_seed.to(torch.float32))
    out_d, out_i, out_s, live = [], [], [], []
    for s in range(N):
        capg = torch.minimum(cap, glob.max(dim=1, keepdim=True).values)
        td, ti, ns, lv = p2h_sweep_ref(
            pts_tiles[s], ids_tiles[s], rx_tiles[s], xc_tiles[s],
            xs_tiles[s], leaf_cnorm[s], queries, qnorm, capg, leaf_ip[s],
            leaf_lb[s], visit[s], k=k, bq=bq, split=split,
            use_ball=use_ball, use_cone=use_cone,
            seed_d=None if seed_d is None else seed_d[s],
            seed_i=None if seed_i is None else seed_i[s],
            probe_dtype=probe_dtype, sq=sq,
            tile_scale=None if tile_scale is None else tile_scale[s],
            slack_a=None if slack_a is None else slack_a[s],
            slack_b=None if slack_b is None else slack_b[s],
            return_live=True)
        glob = torch.sort(torch.cat([glob, td], dim=1), dim=1).values[:, :k]
        out_d.append(td)
        out_i.append(ti)
        out_s.append(ns)
        live.append(lv)
    out = (torch.stack(out_d), torch.stack(out_i), torch.stack(out_s))
    return out + (torch.stack(live),) if return_live else out
