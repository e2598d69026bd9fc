"""Churn parity of the serving mesh against one program.

One routine, :func:`run_churn_parity`, drives a
:class:`~repro_torch.stream.sharded.ShardedMutableP2HIndex` through the
mutation states that exercise every stacked-launch input shape -- a fresh
multi-segment load, a live delta, scattered tombstones, a whole segment
tombstoned to zero, after compaction -- and after every phase holds the
mesh's stacked query **bit for bit** (same distances, same ids) to the
single launch over the same pinned snapshot, and close to the brute-force
oracle over the union live set.

It also pins a mid-churn epoch vector and checks it again after further
mutations: the pinned view must keep answering from its own state, on both
placements, while the index moves underneath it.

The index lives on the mesh's first device, so a mesh of ``cpu`` positions
runs the plain versions and a mesh of CUDA positions the kernels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["run_churn_parity"]


def _with_mesh(snap, mesh, axis):
    """The same pinned epoch vector under a different placement."""
    return dataclasses.replace(snap, mesh=mesh, mesh_axis=axis)


def _oracle(snap, qn, k):
    from repro_torch.core.exact import exact_search

    X, G = snap.live_points()
    B = qn.shape[0]
    if len(X) == 0:
        return (np.full((B, k), np.inf, np.float32),
                np.full((B, k), -1, np.int32))
    dev = snap.device
    ed, ei = exact_search(torch.from_numpy(X).to(dev),
                          torch.from_numpy(qn).to(dev), k=k)
    ed, ei = ed.cpu().numpy(), ei.cpu().numpy()
    return ed, np.where(ei >= 0, G[np.clip(ei, 0, len(G) - 1)], -1)


def _check_phase(snap, mesh, axis, qn, k, phase, *, oracle=True):
    """One parity check: the mesh against one program on the *same* pin."""
    bd0, bi0 = _with_mesh(snap, None, axis).query(qn, k, method="stacked")
    bd1, bi1 = _with_mesh(snap, mesh, axis).query(qn, k, method="stacked")
    if not np.array_equal(bd0, bd1):
        raise AssertionError(f"{phase}: mesh dists differ from one "
                             f"program's")
    if not np.array_equal(bi0, bi1):
        raise AssertionError(f"{phase}: mesh ids differ from one program's")
    if oracle:
        ed, _ = _oracle(snap, qn, k)
        np.testing.assert_allclose(bd1, ed, rtol=1e-4, atol=1e-5,
                                   err_msg=phase)
    return {"phase": phase, "live": int(snap.live_count),
            "segments": len(snap.segments), "exact": True}


def run_churn_parity(mesh, *, dim: int = 16, num_shards: int = 2,
                     n0: int = 32, seed: int = 0, k: int = 5,
                     nq: int = 8, mesh_axis: str = "shard") -> dict:
    """Drive churn; hold the mesh to one program at every state.

    Raises ``AssertionError`` at the first divergence; returns a report of
    the phases checked (live counts, segment fan-outs) on success.
    """
    from repro_torch.core.balltree import normalize_query
    from repro_torch.stream.compaction import CompactionPolicy
    from repro_torch.stream.sharded import ShardedMutableP2HIndex

    rng = np.random.default_rng(seed)
    qn = normalize_query(
        rng.normal(size=(nq, dim + 1))).astype(np.float32)

    idx = ShardedMutableP2HIndex.from_data(
        rng.normal(size=(600, dim)).astype(np.float32), num_shards,
        n0=n0, seed=seed, device=mesh.devices.flat[0],
        policy=CompactionPolicy(delta_capacity=64, max_segments=8))
    try:
        return _churn(idx, rng, mesh, mesh_axis, qn, k, dim)
    finally:
        idx.close()


def _churn(idx, rng, mesh, mesh_axis, qn, k, dim) -> dict:
    live = list(range(600))
    phases = []

    # multi-segment bulk state: split each shard's seed segment
    gids = idx.insert_batch(rng.normal(size=(200, dim)).astype(np.float32))
    live += [int(g) for g in gids]
    idx.compact(force=True)
    phases.append(_check_phase(idx.snapshot(), mesh, mesh_axis, qn, k,
                               "bulk+compact"))

    # auto-sealed inserts widen the segment fan-out (the axis the mesh
    # spreads), leaving a live delta tail over the sealed stack
    for _ in range(4):
        gids = idx.insert_batch(
            rng.normal(size=(100, dim)).astype(np.float32))
        live += [int(g) for g in gids]
    phases.append(_check_phase(idx.snapshot(), mesh, mesh_axis, qn, k,
                               "delta"))

    # pin mid-churn: this epoch vector must stay answerable (and mesh
    # parity must hold on it) through everything below
    pinned = idx.snapshot()
    pinned_d, pinned_i = _with_mesh(pinned, None, mesh_axis).query(
        qn, k, method="stacked")

    # scattered tombstones across segments and the delta
    for victim in rng.choice(live, size=60, replace=False):
        if not idx.delete(int(victim)):
            raise AssertionError(f"gid {victim} was not live")
        live.remove(int(victim))
    phases.append(_check_phase(idx.snapshot(), mesh, mesh_axis, qn, k,
                               "tombstones"))

    # a whole segment tombstoned to zero live rows (ids planes all -1:
    # the stacked grid carries its tiles, every row masked)
    snap = idx.snapshot()
    seg = max(snap.segments, key=lambda s: s.live)
    for g in [int(g) for g in seg.live_rows()[1]]:
        if not idx.delete(g):
            raise AssertionError(f"gid {g} was not live")
        live.remove(g)
    phases.append(_check_phase(idx.snapshot(), mesh, mesh_axis, qn, k,
                               "segment-tombstone"))

    # compaction folds the survivors into fresh segments
    idx.compact(force=True)
    phases.append(_check_phase(idx.snapshot(), mesh, mesh_axis, qn, k,
                               "post-compact"))

    # pinned-vector isolation: the mid-churn pin still answers from its
    # own state, identically on both placements
    pd, pi = _with_mesh(pinned, mesh, mesh_axis).query(
        qn, k, method="stacked")
    if not (np.array_equal(pd, pinned_d) and np.array_equal(pi, pinned_i)):
        raise AssertionError("pinned snapshot: the mesh's answer drifted "
                             "under churn")

    if idx.live_count != len(live):
        raise AssertionError(f"{idx.live_count} live, {len(live)} expected")
    return {"phases": phases, "pinned_isolation": True,
            "final_live": int(idx.live_count)}
