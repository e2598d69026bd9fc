"""Sweep search through the fused sweep kernel.

``sweep_search_kernel`` is the kernel backend of
:func:`repro_torch.core.search.sweep_search` (``method="kernel"`` on
:class:`repro_torch.core.api.P2HIndex`):

  1. pad ``d`` to a multiple of 4 (zero columns leave inner products
     unchanged; 16-byte rows for the kernel's loads) -- the points once per
     tree (:attr:`FlatTree.points_padded`), the queries per call -- and the
     query batch to a block multiple by repeating the last query (the
     repeats are dropped on return);
  2. phase 1 (plain torch, one matmul): ``<q, leaf.c>`` for all leaves ->
     node ball bounds and the per-query-block center-preference visit
     order (a tile is as promising as its most interested query);
  3. phase 2: the fused sweep, :func:`repro_torch.kernels.p2h_scan.p2h_sweep`.

Unlike ``sweep_search``, phase 1 here does not force tiles without a valid
point to +inf: such tiles are skipped only when lambda falls below their
geometric bound, as in the JAX package's kernel path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import bounds
from repro_torch.core.balltree import FlatTree
from repro_torch.kernels import p2h_scan
from repro_torch.launch.platform import ensure_full_precision

__all__ = ["sweep_search_kernel", "prepare_operands"]


def prepare_operands(tree: FlatTree, queries, *, frac=1.0, bq=8,
                     lambda_cap=None):
    """Phase-1 prep shared by the kernel and its plain version; returns
    ``(operands, B0)`` with ``B0`` the number of real queries."""
    ensure_full_precision(queries.device)
    L, n0, d = tree.num_leaves, tree.n0, tree.d
    pts = tree.points_padded
    dp = pts.shape[1]
    B0 = queries.shape[0]
    Bp = -(-B0 // bq) * bq
    q = queries.to(torch.float32)
    if Bp != B0:  # replicate the last query (results discarded on return)
        q = torch.cat([q, q[-1:].expand(Bp - B0, d)], dim=0)
    qn = torch.sqrt(torch.sum(q * q, dim=1, keepdim=True))  # (Bp, 1)
    if lambda_cap is None:
        cap = torch.full((Bp, 1), float("inf"), dtype=torch.float32,
                         device=q.device)
    else:
        cap = F.pad(torch.as_tensor(lambda_cap, dtype=torch.float32,
                                    device=q.device).reshape(B0, 1),
                    (0, 0, 0, Bp - B0), value=float("inf"))

    ipc = q @ tree.leaf_centers.T  # (Bp, L)
    lb = bounds.node_ball_bound(ipc, qn, tree.leaf_radii[None, :])
    pref = torch.abs(ipc).view(Bp // bq, bq, L).min(dim=1).values  # (nqb, L)
    visit = torch.argsort(pref, dim=1, stable=True).to(torch.int32)
    n_visit = max(1, min(L, int(round(frac * L))))
    visit = visit[:, :n_visit].contiguous()

    ops = dict(
        pts_tiles=pts.view(L, n0, dp),
        ids_tiles=tree.point_ids.view(L, n0),
        rx_tiles=tree.rx.view(L, n0),
        xc_tiles=tree.xcos.view(L, n0),
        xs_tiles=tree.xsin.view(L, n0),
        leaf_cnorm=tree.leaf_cnorm.view(L, 1),
        queries=F.pad(q, (0, dp - d)).contiguous(),
        qnorm=qn,
        cap=cap,
        leaf_ip=ipc,
        leaf_lb=lb,
        visit=visit,
    )
    return ops, B0


def sweep_search_kernel(tree: FlatTree, queries, k: int = 1, *,
                        frac: float = 1.0, bq: int | None = None,
                        split: int | None = None, use_ball: bool = True,
                        use_cone: bool = True, lambda_cap=None):
    """Exact (frac=1) / budgeted P2HNNS via the fused sweep kernel.

    ``bq=None`` and ``split=None`` take the device's defaults
    (:func:`repro_torch.kernels.p2h_scan.resolve_bq` and ``resolve_split``):
    on the card the smallest block of at least the batch, up to 64, and as
    many CTAs per block as fill the SMs, up to 8; on the host the JAX
    package's block of 8 and one walker.

    Returns ``(dists (B,k) ascending, ids (B,k), counters (8,))``; the counters
    follow :mod:`repro_torch.core.search` where the kernel can tell them:
    tile skips and scanned leaves are per query *block*, and ``ip_ops`` is
    the phase-1 matmul's ``B * L``.
    """
    queries = torch.atleast_2d(queries)
    bq = p2h_scan.resolve_bq(bq, queries.shape[0], queries.device)
    ops, B0 = prepare_operands(tree, queries, frac=frac, bq=bq,
                               lambda_cap=lambda_cap)
    bd, bi, skips = p2h_scan.p2h_sweep(**ops, k=k, bq=bq, split=split,
                                       use_ball=use_ball, use_cone=use_cone)
    bd, bi = bd[:B0], bi[:B0]  # sorted ascending by the kernel
    n_visit = ops["visit"].numel()
    nskip = skips.sum()
    counters = torch.zeros(8, dtype=torch.long, device=bd.device)
    counters[3] = queries.shape[0] * tree.num_leaves
    counters[2] = n_visit - nskip
    counters[7] = nskip
    return bd, bi, counters
