"""P2HNNS search schemes over :class:`~repro_torch.core.balltree.FlatTree`.

Three schedules, one semantics:

``dfs_search``
    Paper-faithful branch-and-bound (Algorithms 3 & 5): depth first, with
    an explicit per-query stack, node-level ball bound pruning,
    center/lower-bound branch preference, collaborative inner products
    (Lemma 2) and point-level ball+cone pruning in leaves.  Exact.  The
    queries of a batch advance together, one node each per step; the loop
    ends when every stack is empty.

``sweep_search``
    Node bounds for *all* leaves in one (B, L) matmul, then leaves visited
    in preference order while a running per-query top-k threshold (lambda)
    prunes whole tiles and single points.  Exact at ``frac=1.0``;
    ``frac<1`` is the paper's candidate-fraction knob (``beam_search``).
    The sweep kernel in ``repro_torch.kernels`` runs the same schedule per
    query block with real tile skipping; this module is the plain path.

Counters (returned as an int64 (8,) tensor, summed over the batch):
nodes_visited, nodes_pruned, leaves_scanned, ip_ops (O(d) center inner
products -- Theorem 5's C_N), ball_pruned, cone_pruned, verified
(candidates whose |<x,q>| was computed and compared), tiles_skipped.
"""
from __future__ import annotations

import torch

from repro_torch.core import bounds
from repro_torch.core.balltree import FlatTree
from repro_torch.core.exact import topk_smallest
from repro_torch.launch.platform import ensure_full_precision

__all__ = ["dfs_search", "sweep_search", "beam_search", "merge_topk",
           "merge_topk_planes", "SearchStats"]

# counter indices
C_NODES, C_PRUNED, C_LEAVES, C_IP, C_BALL, C_CONE, C_VERIFIED, C_TILE_SKIP = range(8)
_COUNTER_NAMES = (
    "nodes_visited",
    "nodes_pruned",
    "leaves_scanned",
    "ip_ops",
    "ball_pruned",
    "cone_pruned",
    "verified",
    "tiles_skipped",
)

_INF = float("inf")


def SearchStats(counters) -> dict:
    c = counters.tolist() if isinstance(counters, torch.Tensor) else counters
    return {k: int(v) for k, v in zip(_COUNTER_NAMES, c)}


def _lexsort2(secondary, primary):
    """``jnp.lexsort((secondary, primary), axis=-1)``: two stable sorts."""
    o = torch.argsort(secondary, dim=-1, stable=True)
    o2 = torch.argsort(torch.gather(primary, -1, o), dim=-1, stable=True)
    return torch.gather(o, -1, o2)


def merge_topk(dists, ids, k: int):
    """Merge per-source candidate lists into a global top-k, de-duplicated
    by id.

    ``dists``/``ids`` are (B, M), the concatenation of any number of
    (B, k_i) partial lists (invalid slots: id -1, dist +inf).  Rows are
    sorted by (id, dist) so repeats of an id keep only their smallest
    distance; the repeats are masked to +inf and a top-k finishes.
    """
    B = dists.shape[0]
    order = _lexsort2(dists, ids)
    md = torch.gather(dists, 1, order)
    mi = torch.gather(ids, 1, order)
    dup = torch.cat([torch.zeros((B, 1), dtype=torch.bool, device=md.device),
                     mi[:, 1:] == mi[:, :-1]], dim=1)
    md = torch.where(dup, torch.full_like(md, _INF), md)
    return topk_smallest(md, mi, k)


def merge_topk_planes(dists, ids, k: int, extra_d=None, extra_i=None):
    """:func:`merge_topk` over stacked per-source planes ``(N, B, k_s)``,
    flattened to ``(B, N * k_s)``; ``extra_d``/``extra_i`` ((B, M)) append
    one more candidate list to the same merge."""
    N, B, ks = dists.shape
    md = dists.movedim(0, 1).reshape(B, N * ks)
    mi = ids.movedim(0, 1).reshape(B, N * ks)
    if extra_d is not None:
        md = torch.cat([md, extra_d], dim=1)
        mi = torch.cat([mi, extra_i], dim=1)
    return merge_topk(md, mi, k)


def _caps(lambda_cap, queries):
    if lambda_cap is None:
        return torch.full((queries.shape[0],), _INF, dtype=queries.dtype,
                          device=queries.device)
    return torch.as_tensor(lambda_cap, dtype=queries.dtype,
                           device=queries.device).reshape(-1)


# ======================================================================
# Exact DFS (paper Algorithms 3 / 5)
# ======================================================================


def dfs_search(
    tree: FlatTree,
    queries,
    k: int = 1,
    *,
    branch: str = "center",
    use_collab: bool = True,
    use_ball: bool = True,
    use_cone: bool = True,
    max_candidates: int | None = None,
    lambda_cap=None,
):
    """Exact top-k P2HNNS via paper-faithful branch-and-bound.

    ``use_ball=use_cone=False`` gives the plain Ball-Tree of Algorithm 3;
    the defaults give BC-Tree (Algorithm 5).  ``lambda_cap`` (optional,
    (B,)) is an upper bound on each query's global k-th distance; pruning
    with ``min(running k-th, cap)`` stays exact for any valid cap.
    Returns ``(dists (B,k), ids (B,k), counters (8,))``.

    Each step pops one node from every non-empty stack; a query's step is
    masked out once its stack is empty (or its ``max_candidates`` budget is
    spent), so its state and counters stop changing exactly where the
    per-query loop of the JAX package stops.  The loop asks the host once
    per step whether any query is still live.
    """
    q = queries
    ensure_full_precision(q.device)
    B, dev = q.shape[0], q.device
    n0, d, L = tree.n0, tree.d, tree.num_leaves
    S = tree.max_depth + 3
    rows = torch.arange(B, device=dev)
    qn = torch.sqrt(torch.sum(q * q, dim=1))  # (B,)
    caps = _caps(lambda_cap, q)
    left, right = tree.left.long(), tree.right.long()
    counts = tree.counts.to(q.dtype)
    pts = tree.points.view(L, n0, d)
    pids = tree.point_ids.view(L, n0)
    rxs = tree.rx.view(L, n0)
    xcs = tree.xcos.view(L, n0)
    xsn = tree.xsin.view(L, n0)

    sp = torch.ones(B, dtype=torch.long, device=dev)
    stack_n = torch.zeros((B, S), dtype=torch.long, device=dev)
    stack_ip = torch.zeros((B, S), dtype=q.dtype, device=dev)
    stack_ip[:, 0] = q @ tree.centers[0]
    best_d = torch.full((B, k), _INF, dtype=q.dtype, device=dev)
    best_i = torch.full((B, k), -1, dtype=torch.int32, device=dev)
    cnt = torch.zeros((B, 8), dtype=torch.long, device=dev)
    cnt[:, C_IP] = 1

    while True:
        live = sp > 0
        if max_candidates is not None:
            live &= cnt[:, C_VERIFIED] < max_candidates
        if not bool(live.any()):
            break
        sp = sp - live.long()
        top = sp.clamp(min=0)
        node = stack_n[rows, top]
        ip = stack_ip[rows, top]
        lam = torch.minimum(best_d[:, k - 1], caps)
        lb = bounds.node_ball_bound(ip, qn, tree.radii[node])
        pruned = lb >= lam
        is_leaf = left[node] < 0
        cnt[:, C_NODES] += live.long()
        cnt[:, C_PRUNED] += (live & pruned).long()
        go_leaf = live & is_leaf & ~pruned
        go_int = live & ~is_leaf & ~pruned
        any_leaf, any_int = torch.stack([go_leaf.any(), go_int.any()]).tolist()

        if any_leaf:
            slot = tree.node_leaf[node].long().clamp(min=0)
            ids = pids[slot]  # (B, n0)
            valid = ids >= 0
            keep = valid
            m = go_leaf[:, None]
            if use_ball:
                pb = bounds.point_ball_bound(ip[:, None], qn[:, None], rxs[slot])
                ball_ok = pb < lam[:, None]
                cnt[:, C_BALL] += ((valid & ~ball_ok) & m).sum(1)
                keep = keep & ball_ok
            if use_cone:
                qcos, qsin = bounds.query_angle_terms(
                    ip, qn, tree.leaf_cnorm[slot])
                cb = bounds.point_cone_bound(
                    qcos[:, None], qsin[:, None], xcs[slot], xsn[slot])
                cone_ok = cb < lam[:, None]
                cnt[:, C_CONE] += ((keep & ~cone_ok) & m).sum(1)
                keep = keep & cone_ok
            absip = torch.abs(torch.einsum("bnd,bd->bn", pts[slot], q))
            cand = torch.where(keep, absip, torch.full_like(absip, _INF))
            cnt[:, C_VERIFIED] += (keep & m).sum(1)
            cnt[:, C_LEAVES] += go_leaf.long()
            nd, ni = topk_smallest(torch.cat([best_d, cand], dim=1),
                                   torch.cat([best_i, ids], dim=1), k)
            best_d = torch.where(m, nd, best_d)
            best_i = torch.where(m, ni, best_i)

        if any_int:
            lc = left[node].clamp(min=0)
            rc = right[node].clamp(min=0)
            ip_lc = torch.sum(tree.centers[lc] * q, dim=1)
            if use_collab:  # Lemma 2
                ip_rc = (counts[node] * ip - counts[lc] * ip_lc) / counts[rc]
                cnt[:, C_IP] += go_int.long()
            else:
                ip_rc = torch.sum(tree.centers[rc] * q, dim=1)
                cnt[:, C_IP] += 2 * go_int.long()
            if branch == "center":  # paper's default (Section III-C)
                left_first = torch.abs(ip_lc) < torch.abs(ip_rc)
            else:  # lower-bound preference (Fig. 7 ablation)
                lb_lc = bounds.node_ball_bound(ip_lc, qn, tree.radii[lc])
                lb_rc = bounds.node_ball_bound(ip_rc, qn, tree.radii[rc])
                left_first = lb_lc < lb_rc
            first_n = torch.where(left_first, lc, rc)
            first_ip = torch.where(left_first, ip_lc, ip_rc)
            sec_n = torch.where(left_first, rc, lc)
            sec_ip = torch.where(left_first, ip_rc, ip_lc)
            p0 = sp.clamp(max=S - 2)
            for pos, n_val, ip_val in ((p0, sec_n, sec_ip),
                                       (p0 + 1, first_n, first_ip)):
                stack_n[rows, pos] = torch.where(go_int, n_val,
                                                 stack_n[rows, pos])
                stack_ip[rows, pos] = torch.where(go_int, ip_val,
                                                  stack_ip[rows, pos])
            sp = sp + 2 * go_int.long()

    return best_d, best_i, cnt.sum(0)


# ======================================================================
# Leaf sweep (plain path; the sweep kernel lives in repro_torch.kernels)
# ======================================================================


def sweep_search(
    tree: FlatTree,
    queries,
    k: int = 1,
    *,
    order: str = "center",
    frac: float = 1.0,
    use_ball: bool = True,
    use_cone: bool = True,
    lambda_cap=None,
):
    """Exact (frac=1.0) or budgeted (frac<1) sweep search.

    Phase 1: node-level bounds for all leaves in one (B, L) matmul.
    Phase 2: visit leaves in preference order with a running per-query
    top-k threshold; tiles whose node bound >= lambda are skipped, points
    are pruned with the point-level ball+cone bounds.

    ``order="center"`` visits by ascending |<q, leaf.c>| (paper's center
    preference); ``order="bound"`` by ascending node bound.  ``lambda_cap``
    (optional, (B,)) is an upper bound on the global k-th distance that
    pruning also uses.
    """
    q = queries
    ensure_full_precision(q.device)
    B = q.shape[0]
    L, n0, d = tree.num_leaves, tree.n0, tree.d
    qn = torch.sqrt(torch.sum(q * q, dim=1))  # (B,)
    ipc = q @ tree.leaf_centers.T  # (B, L)
    lb_all = bounds.node_ball_bound(ipc, qn[:, None], tree.leaf_radii[None, :])
    # tiles with no valid point (leaf padding, fully deleted tiles): force
    # their bound to +inf so they sort after every live tile and the lambda
    # test always skips them
    tile_dead = ~(tree.point_ids.view(L, n0) >= 0).any(dim=1)  # (L,)
    lb_all = torch.where(tile_dead[None, :], _INF, lb_all)
    if order == "center":
        visit = torch.argsort(
            torch.where(tile_dead[None, :], _INF, torch.abs(ipc)), dim=1,
            stable=True)
    else:
        visit = _lexsort2(torch.abs(ipc), lb_all)
    n_visit = max(1, min(L, int(round(frac * L))))
    visit = visit[:, :n_visit]  # (B, n_visit)
    caps = None if lambda_cap is None else _caps(lambda_cap, q)

    pts = tree.points.view(L, n0, d)
    ids = tree.point_ids.view(L, n0)
    rx = tree.rx.view(L, n0)
    xcs = tree.xcos.view(L, n0)
    xsn = tree.xsin.view(L, n0)

    bd = torch.full((B, k), _INF, dtype=q.dtype, device=q.device)
    bi = torch.full((B, k), -1, dtype=torch.int32, device=q.device)
    cnt = torch.zeros(8, dtype=torch.long, device=q.device)
    for j in range(n_visit):
        leaf = visit[:, j]
        lam = bd[:, k - 1]
        if caps is not None:
            lam = torch.minimum(lam, caps)
        lbt = lb_all.gather(1, leaf[:, None])[:, 0]
        ipct = ipc.gather(1, leaf[:, None])[:, 0]
        skip = lbt >= lam
        idst = ids[leaf]  # (B, n0)
        valid = idst >= 0
        keep = valid
        live = ~skip[:, None]
        if use_ball:
            pb = bounds.point_ball_bound(ipct[:, None], qn[:, None], rx[leaf])
            ball_ok = pb < lam[:, None]
            cnt[C_BALL] += ((valid & ~ball_ok) & live).sum()
            keep = keep & ball_ok
        if use_cone:
            qcos, qsin = bounds.query_angle_terms(
                ipct, qn, tree.leaf_cnorm[leaf])
            cb = bounds.point_cone_bound(
                qcos[:, None], qsin[:, None], xcs[leaf], xsn[leaf])
            cone_ok = cb < lam[:, None]
            cnt[C_CONE] += ((keep & ~cone_ok) & live).sum()
            keep = keep & cone_ok
        keep = keep & live
        absip = torch.abs(torch.einsum("bnd,bd->bn", pts[leaf], q))
        cand = torch.where(keep, absip, torch.full_like(absip, _INF))
        cnt[C_VERIFIED] += keep.sum()
        # dead tiles are forced skips, not pruning wins: count neither a
        # skip nor a scanned leaf for them
        cnt[C_TILE_SKIP] += (skip & ~tile_dead[leaf]).sum()
        cnt[C_LEAVES] += (~skip).sum()
        bd, bi = topk_smallest(torch.cat([bd, cand], dim=1),
                               torch.cat([bi, idst], dim=1), k)
    # phase-1 cost: one center IP per leaf per query
    cnt[C_IP] += B * L
    return bd, bi, cnt


def beam_search(tree: FlatTree, queries, k: int = 1, *, frac: float = 0.1,
                **kw):
    """Budgeted sweep: the paper's candidate-fraction recall/time knob."""
    return sweep_search(tree, queries, k, frac=frac, **kw)
