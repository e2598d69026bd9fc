"""The port's serving mesh (``repro_torch.launch.mesh``,
``repro_torch.parallel``, the mesh form of the stacked sweep) against the
JAX package's, on the CPU.

The JAX package's mesh programs need forced host devices before ``jax`` is
imported, so one module-scoped fixture runs ``tests/_torch_mesh_ref.py`` in
one child process with eight of them and reads its answers back.  The port
runs in this process, on meshes that name ``cpu`` once per position.  Held:
the stacked launch across 4 positions equals the port's single launch bit
for bit in every probe mode, and JAX's 4-device answers within the tie rule
of ``_torch_parity`` with equal counters; the churn parity of
``stream/meshcheck.py``; round 2 of the exchange under a mesh against
JAX's; and the units of ``tests/test_mesh.py`` (signatures, mesh-keyed
templates, the dispatch crossover, the concat cache).
"""
import gc
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_mesh_ref as R  # noqa: E402
from _torch_parity import assert_topk_parity  # noqa: E402
from repro_torch.core import balltree as tbt  # noqa: E402
from repro_torch.core import distributed as dist  # noqa: E402
from repro_torch.kernels import stacked_sweep as tss  # noqa: E402
from repro_torch.launch.mesh import (DeviceMesh, make_mesh,  # noqa: E402
                                     make_serving_mesh, mesh_context)
from repro_torch.parallel import (all_gather, mesh_devices,  # noqa: E402
                                  mesh_signature, per_position, pmin, psum)
from repro_torch.serve.dispatch import DispatchPolicy  # noqa: E402
from repro_torch.stream import (CompactionPolicy,  # noqa: E402
                                ShardedMutableP2HIndex)
from repro_torch.stream.meshcheck import run_churn_parity  # noqa: E402

TESTS = Path(__file__).resolve().parent


def cpu_mesh(n=4, axis="shard"):
    return make_mesh((n,), (axis,), devices=["cpu"] * n)


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    """The JAX package's answers, from one child process with 8 forced
    host devices."""
    out = tmp_path_factory.mktemp("mesh_ref") / "mesh.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(TESTS.parent / "src"))
    res = subprocess.run([sys.executable, str(TESTS / "_torch_mesh_ref.py"),
                          "mesh", str(out)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


class _Seg:
    def __init__(self, uid, tree, gids):
        self.uid, self.tree, self.gids = uid, tree, gids


@pytest.fixture(scope="module")
def stack():
    segs = []
    for u, pts, gids, dead in R.segment_inputs():
        t = tbt.build_tree(pts, n0=16, append_one=False)
        if dead:
            t = t.with_point_ids(torch.full(t.point_ids.shape, -1,
                                            dtype=torch.int32))
        segs.append(_Seg(u, t, gids))
    return tss.StackedLeaves.from_segments(segs)


# ------------------------------------------------------ the stacked mesh
@pytest.mark.parametrize("case", R.STACKED_CASES, ids=lambda c: c[0])
def test_stacked_mesh_equals_one_launch_and_jax(jref, stack, case):
    """Four positions over six segments (bucketed to 8: two a position):
    bit for bit the single launch; JAX's 4-device answers within the tie
    rule, with equal counters and per-shard k-ths."""
    q = R.queries(11, seed=11)
    kw = {key: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
          for key, v in R.stacked_kwargs(case, len(q)).items()}
    d0, i0, _, info0 = tss.stacked_sweep_query(stack, q, R.K, **kw)
    d1, i1, c1, info1 = tss.stacked_sweep_query(stack, q, R.K,
                                                mesh=cpu_mesh(), **kw)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    assert info0["mesh_devices"] == 1 and info1["mesh_devices"] == 4
    name = case[0]
    assert_topk_parity(d1.numpy(), i1.numpy(), jref[f"stacked/{name}/d"],
                       jref[f"stacked/{name}/i"])
    np.testing.assert_array_equal(c1.numpy(),
                                  jref[f"stacked/{name}/counters"])
    assert int(jref[f"stacked/{name}/mesh_devices"]) == 4
    if info1["shard_kth"] is not None:
        assert torch.equal(info0["shard_kth"], info1["shard_kth"])
        np.testing.assert_allclose(info1["shard_kth"].numpy(),
                                   jref[f"stacked/{name}/shard_kth"],
                                   rtol=1e-5, atol=1e-6)


def test_stacked_mesh_places_views_once(stack):
    """On a repeated device each position's block is a view of the bucketed
    planes, memoised by the mesh's signature; a one-position mesh is the
    single launch and places nothing."""
    q = R.queries(3, seed=5)
    mesh = cpu_mesh()
    tss.stacked_sweep_query(stack, q, R.K, mesh=mesh)
    sig = mesh_signature(mesh)
    keys = [key for key in stack._derived if str(sig) in key]
    assert keys
    placed = stack._derived[next(key for key in keys
                                 if key.startswith("geom:mesh"))]
    bucket = stack._derived["geom:bucket:8:raw"]["pts"]
    assert all(p.data_ptr() == bucket[2 * i].data_ptr()
               for i, p in enumerate(placed["pts"]))
    before = len(stack._derived)
    tss.stacked_sweep_query(stack, q, R.K, mesh=mesh)
    assert len(stack._derived) == before
    _, _, _, info = tss.stacked_sweep_query(stack, q, R.K,
                                            mesh=cpu_mesh(1))
    assert info["mesh_devices"] == 1


def test_stacked_mesh_refuses_another_device_type(stack):
    """A mesh whose positions are not the stack's device type would move
    the work off the card (or onto it): refused, never run."""
    mesh = make_mesh((2,), ("shard",), devices=["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="mesh positions"):
        tss.stacked_sweep_query(stack, R.queries(2, seed=1), 3, mesh=mesh)


# ---------------------------------------------------------- churn parity
@pytest.mark.parametrize("seed", [0, 1])
def test_churn_parity(seed):
    report = run_churn_parity(cpu_mesh(), seed=seed)
    assert report["pinned_isolation"]
    fanouts = [p["segments"] for p in report["phases"]]
    assert max(fanouts) >= 4, fanouts  # the mesh axis really spread
    assert [p["phase"] for p in report["phases"]] == [
        "bulk+compact", "delta", "tombstones", "segment-tombstone",
        "post-compact"]


# ------------------------------------------------ the exchange's round 2
@pytest.fixture(scope="module")
def meshed_index():
    m = R.sharded_ops(ShardedMutableP2HIndex, CompactionPolicy,
                      device="cpu")
    m.set_mesh(cpu_mesh())
    yield m
    m.close()


@pytest.mark.parametrize("name,kw", [("stacked", dict(method="stacked")),
                                     ("default", dict(stacked=True))])
def test_exchange_round2_on_mesh_equals_jax(jref, meshed_index, name, kw):
    """Round 2's stacked launch over the mesh: the answers, counters,
    ``lambda0`` and per-shard k-ths of JAX's 4-device exchange, and the
    one-program exchange's answers bit for bit."""
    snap = meshed_index.snapshot()
    assert snap.mesh == cpu_mesh()
    qx = R.queries(7, seed=21, dim=12)
    bd, bi, cnt, info = dist.two_round_exchange(
        snap.shards, qx, R.K, return_info=True, mesh=snap.mesh, **kw)
    assert_topk_parity(bd, bi, jref[f"exchange/{name}/d"],
                       jref[f"exchange/{name}/i"])
    np.testing.assert_array_equal(cnt, jref[f"exchange/{name}/counters"])
    np.testing.assert_allclose(info["lambda0"],
                               jref[f"exchange/{name}/lambda0"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(info["shard_kth"],
                               jref[f"exchange/{name}/shard_kth"],
                               rtol=1e-5, atol=1e-6)
    d0, i0, _ = dist.two_round_exchange(snap.shards, qx, R.K, **kw)
    assert np.array_equal(bd, d0) and np.array_equal(bi, i0)


def test_sharded_snapshot_carries_the_mesh(jref, meshed_index):
    """``set_mesh`` reaches the snapshot's query and the stats; the
    resilient exchange takes the mesh too; detaching restores one
    program."""
    from repro_torch.serve import ShardSupervisor

    qx = R.queries(7, seed=21, dim=12)
    snap = meshed_index.snapshot()
    bd, bi, cnt = snap.query(qx, R.K, method="stacked",
                             return_counters=True)
    assert_topk_parity(bd, bi, jref["exchange/snapshot/d"],
                       jref["exchange/snapshot/i"])
    np.testing.assert_array_equal(cnt, jref["exchange/snapshot/counters"])
    rd, ri, info = snap.query(qx, R.K, method="stacked", return_info=True,
                              resilience=ShardSupervisor())
    assert np.array_equal(rd, bd) and np.array_equal(ri, bi)
    assert info["missing_shards"] == ()
    st = meshed_index.stats()
    assert st["mesh_devices"] == 4 and st["mesh"] == mesh_signature(
        cpu_mesh())
    meshed_index.set_mesh(None)
    try:
        assert meshed_index.snapshot().mesh is None
        assert meshed_index.stats()["mesh_devices"] == 1
        assert np.array_equal(meshed_index.snapshot().query(
            qx, R.K, method="stacked")[0], bd)
    finally:
        meshed_index.set_mesh(cpu_mesh())
    with pytest.raises(ValueError, match="mesh devices"):
        meshed_index.set_mesh(make_mesh((2,), ("shard",),
                                        devices=["cuda:0"] * 2))


# -------------------------------------------- tests/test_mesh.py's units
def test_mesh_signature_distinguishes_topologies():
    default = mesh_signature()
    assert default[0] == "default"
    sig = mesh_signature(cpu_mesh(1))
    assert sig[0] == "mesh" and sig != default
    assert sig == mesh_signature(cpu_mesh(1))  # stable
    assert mesh_signature(cpu_mesh(1, axis="seg")) != sig
    assert mesh_signature(cpu_mesh(4)) != mesh_signature(cpu_mesh(2))
    two_d = make_mesh((2, 2), ("pod", "data"), devices=["cpu"] * 4)
    assert mesh_signature(two_d) == ("mesh", ("pod", "data"), (2, 2),
                                     ("cpu",) * 4, "cpu")
    assert mesh_devices(None) == 1 and mesh_devices(two_d) == 4


def test_round1_templates_keyed_by_mesh_signature():
    dist._ROUND1_TEMPLATES.clear()
    dist._record_round1(8, 5, 0.25)
    (key,) = dist._ROUND1_TEMPLATES
    assert key == (8, 5, 0.25, mesh_signature())
    # a template recorded under a foreign topology is filtered out
    foreign = (8, 5, 0.25, ("mesh", ("x",), (64,), ("cuda:0",) * 64,
                            "cuda"))
    dist._ROUND1_TEMPLATES[foreign] = None
    tree = tbt.build_tree(R.mkdata(50, seed=8), n0=16)
    assert dist.warm_round1(tree, is_bc=True) == 2
    dist._ROUND1_TEMPLATES.clear()


def test_stacked_templates_record_mesh(stack):
    """A stacked template carries its (mesh, mesh_axis) tail, and its
    signature the mesh's topology, so a warm replay targets exactly the
    recorded topology."""
    q = R.queries(4, seed=10)
    tss.stacked_sweep_query(stack, q, 3)
    with tss._COMPILE_LOCK:
        tpl = next(reversed(tss._RECENT_TEMPLATES))
    assert tpl[-2:] == (None, "shard")
    mesh = cpu_mesh()
    tss.stacked_sweep_query(stack, q, 3, mesh=mesh)
    with tss._COMPILE_LOCK:
        tpl = next(reversed(tss._RECENT_TEMPLATES))
        sigs = list(tss._COMPILE_SIGS)
    assert tpl[-2:] == (mesh, "shard")
    assert any(sig[-2] == mesh_signature(mesh) and sig[0] == 8
               for sig in sigs)
    assert tss.warm_stacked(stack, [tpl]) == 1


def test_dispatch_mesh_devices_lowers_stacked_crossover():
    pol = DispatchPolicy()
    base = pol.route(8, 5, stackable=2, tile_density=0.6)
    assert base.method != "stacked"  # below the one-program crossover
    meshed = pol.route(8, 5, stackable=2, tile_density=0.6,
                       mesh_devices=4)
    assert meshed.method == "stacked"
    assert "mesh=4" in meshed.reason
    # the density bar scales down with the device count, the fan-out
    # floor stays
    assert pol.route(8, 5, stackable=2, tile_density=0.2,
                     mesh_devices=4).method == "stacked"
    assert pol.route(8, 5, stackable=1,
                     mesh_devices=4).method != "stacked"
    # non-stacked decisions unaffected
    assert pol.route(1, 5, mesh_devices=4).method == "dfs"


def _small_stack(seed, gid0=0):
    segs, gid = [], gid0
    for u, n in enumerate((40, 30)):
        pts = tbt.append_ones(R.mkdata(n, seed=seed + u))
        segs.append(_Seg(100 * seed + u, tbt.build_tree(
            pts, n0=16, append_one=False), np.arange(gid, gid + n)))
        gid += n
    return tss.StackedLeaves.from_segments(segs)


def test_concat_cached_releases_retired_stacks():
    a, b = _small_stack(1), _small_stack(2, gid0=1000)
    combined = tss.concat_cached((a, b))
    assert tss.concat_cached((a, b)) is combined  # a hit while both live
    key = (id(a), id(b))
    with tss._CONCAT_LOCK:
        assert key in tss._CONCAT_CACHE
    del a, b
    gc.collect()
    with tss._CONCAT_LOCK:
        assert key not in tss._CONCAT_CACHE


def test_concat_cached_id_reuse_miss():
    """A dead input whose id was recycled must miss: the key is checked
    against the weakrefs, not just the ids."""
    a, b = _small_stack(4), _small_stack(5, gid0=1000)
    combined = tss.concat_cached((a, b))
    c = _small_stack(6, gid0=2000)
    with tss._CONCAT_LOCK:  # stand in for id reuse: alias the live entry
        refs, _ = tss._CONCAT_CACHE[(id(a), id(b))]
        tss._CONCAT_CACHE[(id(a), id(c))] = (refs, combined)
    assert tss.concat_cached((a, c)) is not combined


# ------------------------------------------- the mesh and the collectives
def test_make_mesh_names_devices():
    mesh = make_mesh((2, 3), ("pod", "data"), devices=["cpu"] * 6)
    assert isinstance(mesh, DeviceMesh)
    assert mesh.shape == {"pod": 2, "data": 3} and mesh.size == 6
    assert mesh.devices.shape == (2, 3)
    assert mesh == make_mesh((2, 3), ("pod", "data"), devices=["cpu"] * 6)
    assert hash(mesh) == hash(make_mesh((2, 3), ("pod", "data"),
                                        devices=["cpu"] * 6))
    assert len(mesh.axis_devices(("pod", "data"))) == 6
    assert len(mesh.axis_devices("data")) == 3
    with pytest.raises(ValueError, match="devices for a mesh"):
        make_mesh((2, 2), ("a", "b"), devices=["cpu"] * 3)
    with pytest.raises(ValueError, match="axis"):
        mesh.axis_devices("model")
    with mesh_context(mesh) as ambient:  # nothing to set: a no-op
        assert ambient is None


def test_serving_mesh_needs_the_cuda_devices(monkeypatch):
    """``make_serving_mesh`` takes visible CUDA devices and raises when
    asked for more, as the JAX package's does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    mesh = make_serving_mesh()
    assert mesh.shape == {"shard": 2}
    assert [str(d) for d in mesh.devices.flat] == ["cuda:0", "cuda:1"]
    assert make_serving_mesh(1, axis="seg").shape == {"seg": 1}
    with pytest.raises(ValueError, match="visible CUDA"):
        make_serving_mesh(3)


def test_collectives_over_positions():
    mesh = make_mesh((2, 2), ("pod", "data"), devices=["cpu"] * 4)
    seen = []

    def fn(i, dev, x):
        seen.append((i, dev.type))
        return x * 2, torch.tensor([float(i)])

    parts = [torch.full((2, 3), float(i)) for i in range(4)]
    out = per_position(mesh, ("pod", "data"), fn, parts)
    assert seen == [(i, "cpu") for i in range(4)]
    stacked = all_gather([o[0] for o in out])
    assert stacked.shape == (4, 2, 3) and float(stacked[3, 0, 0]) == 6.0
    tiled = all_gather([o[0] for o in out], tiled=True)
    assert tiled.shape == (8, 3) and torch.equal(tiled[2:4], stacked[1])
    assert torch.equal(pmin([o[1] for o in out]), torch.tensor([0.0]))
    assert torch.equal(psum([o[1] for o in out]), torch.tensor([6.0]))
    with pytest.raises(ValueError, match="per-position"):
        per_position(mesh, "data", fn, parts)
