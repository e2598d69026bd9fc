"""Inputs of the port's mesh tests, and the JAX package's answers to them.

The JAX package's mesh programs need several devices, which XLA makes on
the host only when ``XLA_FLAGS=--xla_force_host_platform_device_count`` is
set before ``jax`` is imported.  So the references are computed in a child
process::

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \\
        python tests/_torch_mesh_ref.py {mesh|forest} OUT.npz

which writes every answer to ``OUT.npz``.  The inputs are made here from
seeds with numpy; the tests import the same functions to give the port the
same inputs.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

DIM, K = 8, 5
#: the stacked cases: (name, probe_tiles, probe_dtype, capped, extra,
#: shard_bounds)
STACKED_CASES = (
    ("f32-two-pass", None, None, False, False, None),
    ("one-pass", 0, None, True, False, None),
    ("bf16", 3, "bf16", True, True, None),
    ("int8", 3, "int8", False, True, None),
    ("extra", 2, "f32", False, True, None),
    ("shard-bounds", None, None, True, False, (2, 4)),
)
#: the forest's meshes: (name, shape, axis names, the axes it shards over)
FORESTS = (
    ("line8", (8,), ("data",), ("data",)),
    ("pod2x4", (2, 4), ("pod", "data"), ("pod", "data")),
    ("data2x4", (2, 4), ("data", "model"), ("data",)),
)
FOREST_N, FOREST_DIM, FOREST_N0, FOREST_K = 3003, 16, 64, 10


def mkdata(n, seed=0, dim=DIM):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(
        np.float32)


def queries(b, seed, dim=DIM):
    """Normalised (b, dim + 1) hyperplane queries."""
    q = np.random.default_rng(seed).normal(size=(b, dim + 1))
    scale = np.linalg.norm(q[:, :-1], axis=1, keepdims=True)
    return (q / scale).astype(np.float32)


def segment_inputs(seed=3, sizes=(200, 57, 1, 90, 40, 75), dead=(4,)):
    """Segments' points (ones appended), gids and all-dead flags: six
    ragged segments, one single-point and one all-tombstone."""
    rng = np.random.default_rng(seed)
    out, gid = [], 0
    for u, n in enumerate(sizes):
        pts = rng.normal(size=(n, DIM)).astype(np.float32)
        pts = np.concatenate([pts, np.ones((n, 1), np.float32)], axis=1)
        out.append((u, pts, np.arange(gid, gid + n, dtype=np.int32),
                    u in dead))
        gid += n
    return out


def stacked_kwargs(case, B):
    """One stacked case's keyword arguments, as numpy arrays."""
    _, probe_tiles, probe_dtype, capped, extra, bounds = case
    kw = dict(probe_tiles=probe_tiles, probe_dtype=probe_dtype)
    if bounds is not None:
        kw["shard_bounds"] = bounds
    if capped:
        kw["lambda_cap"] = np.full((B,), 0.8, np.float32)
    if extra:  # a delta's candidates: real points, in no segment
        rng = np.random.default_rng(12)
        kw["extra_d"] = np.sort(rng.uniform(0.05, 1.0, (B, K)).astype(
            np.float32), 1)
        kw["extra_i"] = (10_000 + np.arange(B * K, dtype=np.int32)).reshape(
            B, K)
    return kw


def sharded_ops(cls, policy, *, seed=3, n=1500, more=420, shards=3, **kw):
    """The sharded mutable index both packages build: a routed bulk load,
    inserts that seal a second segment in every shard and leave a live
    delta, and deletes over every shard."""
    m = cls.from_data(mkdata(n, seed=seed, dim=12), shards, n0=32,
                      seed=seed,
                      policy=policy(delta_capacity=100, tombstone_frac=0.95,
                                    max_segments=8), **kw)
    m.insert_batch(mkdata(more, seed=seed + 1, dim=12))
    for g in list(range(0, n, 13)) + [n + 3, n + more - 2]:
        assert m.delete(g)
    return m


def forest_data():
    """Clustered points (norms near 15) and queries for the forest."""
    rng = np.random.default_rng(11)
    cents = rng.normal(size=(12, FOREST_DIM)) * 6
    data = (cents[rng.integers(0, 12, FOREST_N)]
            + rng.normal(size=(FOREST_N, FOREST_DIM))).astype(np.float32)
    q = rng.normal(size=(9, FOREST_DIM + 1)).astype(np.float32)
    return data, q


def _mesh_refs(out):
    import jax.numpy as jnp

    from repro.core import balltree as jbt
    from repro.core.distributed import two_round_exchange
    from repro.kernels import stacked_sweep as jss
    from repro.launch.mesh import make_serving_mesh
    from repro.stream import CompactionPolicy, ShardedMutableP2HIndex

    class Seg:
        def __init__(self, uid, tree, gids):
            self.uid, self.tree, self.gids = uid, tree, gids

    segs = []
    for u, pts, gids, dead in segment_inputs():
        t = jbt.build_tree(pts, n0=16, append_one=False)
        if dead:
            t = dataclasses.replace(t, point_ids=jnp.full(
                t.point_ids.shape, -1, jnp.int32))
        segs.append(Seg(u, t, gids))
    stk = jss.StackedLeaves.from_segments(segs)
    mesh = make_serving_mesh(4)
    q = queries(11, seed=11)
    for case in STACKED_CASES:
        kw = {key: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
              for key, v in stacked_kwargs(case, len(q)).items()}
        fd, fi, cnt, info = jss.stacked_sweep_query(stk, jnp.asarray(q), K,
                                                    mesh=mesh, **kw)
        name = case[0]
        out[f"stacked/{name}/d"] = np.asarray(fd)
        out[f"stacked/{name}/i"] = np.asarray(fi)
        out[f"stacked/{name}/counters"] = np.asarray(cnt)
        out[f"stacked/{name}/mesh_devices"] = np.asarray(
            info["mesh_devices"])
        if info["shard_kth"] is not None:
            out[f"stacked/{name}/shard_kth"] = np.asarray(info["shard_kth"])

    m = sharded_ops(ShardedMutableP2HIndex, CompactionPolicy)
    m.set_mesh(mesh)
    snap = m.snapshot()
    qx = queries(7, seed=21, dim=12)
    for name, kw in (("stacked", dict(method="stacked")),
                     ("default", dict(stacked=True))):
        bd, bi, cnt, info = two_round_exchange(
            snap.shards, qx, K, return_info=True, mesh=mesh, **kw)
        out[f"exchange/{name}/d"] = np.asarray(bd)
        out[f"exchange/{name}/i"] = np.asarray(bi)
        out[f"exchange/{name}/counters"] = np.asarray(cnt)
        out[f"exchange/{name}/lambda0"] = np.asarray(info["lambda0"])
        out[f"exchange/{name}/shard_kth"] = np.asarray(info["shard_kth"])
    bd, bi, cnt = snap.query(qx, K, method="stacked", return_counters=True)
    out["exchange/snapshot/d"], out["exchange/snapshot/i"] = (
        np.asarray(bd), np.asarray(bi))
    out["exchange/snapshot/counters"] = np.asarray(cnt)
    m.close()


def _forest_refs(out):
    from repro.core.api import P2HIndex
    from repro.core.distributed import ShardedP2HIndex
    from repro.launch.mesh import make_mesh
    from repro.serve import P2HEngine

    data, q = forest_data()
    k = FOREST_K
    for name, shape, axis_names, axes in FORESTS:
        idx = ShardedP2HIndex.build(data, make_mesh(shape, axis_names),
                                    axes=axes, n0=FOREST_N0)
        for f in dataclasses.fields(idx.stacked):
            kind = "static" if f.metadata.get("static") else "tree"
            out[f"forest/{name}/{kind}/{f.name}"] = np.asarray(
                getattr(idx.stacked, f.name))
        out[f"forest/{name}/shard_n"] = np.asarray(idx.shard_n)
        bd, bi, st = idx.query(q, k)
        out[f"forest/{name}/d"], out[f"forest/{name}/i"] = bd, bi
        out[f"forest/{name}/stats"] = np.asarray(list(st.values()))
        cap = np.asarray(bd[:, k - 1]) * 1.5
        bd, bi, st = idx.query(q, k, lambda_cap=cap)
        out[f"forest/{name}/cap/d"], out[f"forest/{name}/cap/i"] = bd, bi
        out[f"forest/{name}/cap/stats"] = np.asarray(list(st.values()))
        if name == "line8":
            frozen = P2HIndex.build(data, n0=FOREST_N0)
            eng = P2HEngine(frozen, sharded=idx, slot_size=4)
            for rnd in ("cold", "warm"):
                bd, bi = eng.query(q, k)
                out[f"engine/{rnd}/d"], out[f"engine/{rnd}/i"] = bd, bi
            st = eng.stats()
            out["engine/routes"] = np.asarray(st["routes"]["sharded"])
            out["engine/counters"] = np.asarray(
                list(st["counters"]["sharded"].values()))
            out["engine/cache_hits"] = np.asarray(st["lambda_cache"]["hits"])
            bd, bi, st = idx.query(q, k, engine=eng)
            out["engine/direct/d"], out["engine/direct/i"] = bd, bi
            out["engine/direct/stats"] = np.asarray(list(st.values()))


def main(argv) -> int:
    which, path = argv[1], argv[2]
    import jax

    need = 8
    if jax.device_count() < need:
        raise SystemExit(f"{jax.device_count()} devices; set XLA_FLAGS="
                         f"--xla_force_host_platform_device_count={need}")
    out = {}
    {"mesh": _mesh_refs, "forest": _forest_refs}[which](out)
    np.savez(path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
