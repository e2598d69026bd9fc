"""The port's device-sharded forest (``repro_torch.core.distributed.
ShardedP2HIndex``) and the engine's ``"sharded"`` route against the JAX
package's, on the CPU.

The JAX forest needs forced host devices before ``jax`` is imported, so one
module-scoped fixture runs ``tests/_torch_mesh_ref.py`` in one child
process with eight of them and reads its answers back; the port runs in
this process on meshes that name ``cpu`` once per position.  On meshes
(8,), (2, 4) over both axes and (2, 4) over one axis: every shard's padded
tree equals JAX's bit for bit; the answers follow the parity rule of
``_torch_parity`` with all 8 counters equal, with and without
``lambda_cap``; the engine serves the forest as JAX's does.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_mesh_ref as R  # noqa: E402
from _torch_parity import assert_topk_parity, oracle  # noqa: E402
from repro_torch.core.api import P2HIndex  # noqa: E402
from repro_torch.core.balltree import (append_ones, build_tree,  # noqa: E402
                                       normalize_query)
from repro_torch.core.distributed import ShardedP2HIndex, _pad_tree  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.serve import P2HEngine  # noqa: E402

TESTS = Path(__file__).resolve().parent
K = R.FOREST_K
_NAMES = ("nodes_visited", "nodes_pruned", "leaves_scanned", "ip_ops",
          "ball_pruned", "cone_pruned", "verified", "tiles_skipped")


@pytest.fixture(scope="module")
def jref(tmp_path_factory):
    """The JAX package's forests and answers, from one child process with
    8 forced host devices."""
    out = tmp_path_factory.mktemp("forest_ref") / "forest.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count"
               "=8", JAX_PLATFORMS="cpu",
               PYTHONPATH=str(TESTS.parent / "src"))
    res = subprocess.run([sys.executable, str(TESTS / "_torch_mesh_ref.py"),
                          "forest", str(out)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    with np.load(out) as z:
        return dict(z)


@pytest.fixture(scope="module")
def forests():
    data, _ = R.forest_data()
    out = {}
    for name, shape, axis_names, axes in R.FORESTS:
        mesh = make_mesh(shape, axis_names,
                         devices=["cpu"] * int(np.prod(shape)))
        out[name] = ShardedP2HIndex.build(data, mesh, axes=axes,
                                          n0=R.FOREST_N0)
    return out


_IDS = [f[0] for f in R.FORESTS]


@pytest.mark.parametrize("name", _IDS)
def test_forest_trees_equal_jax(jref, forests, name):
    """Every shard's tree, ``_pad_tree`` and the common ``max_depth``
    included, equals the JAX stack's slice bit for bit."""
    idx = forests[name]
    S = jref[f"forest/{name}/tree/points"].shape[0]
    assert idx.num_shards == len(idx.trees) == S
    assert idx.shard_n == int(jref[f"forest/{name}/shard_n"])
    assert idx.true_n == R.FOREST_N
    for s, tree in enumerate(idx.trees):
        for field, a in tree.to_numpy().items():
            want = jref[f"forest/{name}/tree/{field}"][s]
            assert a.dtype == want.dtype, field
            np.testing.assert_array_equal(a, want, err_msg=f"{s} {field}")
        for field, v in tree.statics().items():
            assert v == int(jref[f"forest/{name}/static/{field}"]), field


@pytest.mark.parametrize("capped", [False, True])
@pytest.mark.parametrize("name", _IDS)
def test_forest_answers_and_counters_equal_jax(jref, forests, name, capped):
    """The two rounds' answers within the tie rule and all 8 counters
    equal; with ``lambda_cap`` (1.5 x the k-th) both rounds prune more and
    the answer stays exact."""
    _, q = R.forest_data()
    key = f"forest/{name}/cap" if capped else f"forest/{name}"
    cap = jref[f"forest/{name}/d"][:, K - 1] * 1.5 if capped else None
    bd, bi, st = forests[name].query(q, K, lambda_cap=cap)
    assert_topk_parity(bd, bi, jref[f"{key}/d"], jref[f"{key}/i"])
    assert [st[n] for n in _NAMES] == jref[f"{key}/stats"].tolist()
    data, _ = R.forest_data()
    od, oi, nxt = oracle(append_ones(data), normalize_query(q), K)
    assert_topk_parity(bd, bi, od, oi, nxt)


def test_forest_placement_and_replicas(forests):
    """One tree per position along the sharded axes: the 2 x 4 mesh over
    ``data`` alone holds two shards, on the positions at ``model`` 0."""
    idx = forests["data2x4"]
    assert idx.axes == ("data",) and idx.num_shards == 2
    assert [t.device.type for t in idx.trees] == ["cpu", "cpu"]
    assert forests["pod2x4"].num_shards == 8
    assert idx.device == idx.trees[0].device


def test_pad_tree_pads_as_the_jax_package():
    """Pad nodes are zeros, pad leaves replicate leaf 0's geometry with no
    valid point, and the padded tree answers as the unpadded one."""
    data = R.mkdata(300, seed=7, dim=6)
    t = build_tree(data, n0=32)
    p = _pad_tree(t, t.num_nodes + 3, t.num_leaves + 2, 32)
    assert (p.num_nodes, p.num_leaves) == (t.num_nodes + 3,
                                           t.num_leaves + 2)
    assert not p.left[-3:].any() and not p.centers[-3:].any()
    assert torch.equal(p.leaf_centers[-1], t.leaf_centers[0])
    assert (p.point_ids[-64:] == -1).all() and (p.rx[-64:] == -1).all()
    assert _pad_tree(t, t.num_nodes, t.num_leaves, 32).to_numpy().keys() \
        == t.to_numpy().keys()
    from repro_torch.core.search import sweep_search

    q = torch.from_numpy(R.queries(5, seed=2, dim=6))
    d0, i0, _ = sweep_search(t, q, 4)
    d1, i1, _ = sweep_search(p, q, 4)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)


def test_forest_build_refuses_an_axis_off_the_mesh():
    with pytest.raises(ValueError, match="not all on the mesh"):
        ShardedP2HIndex.build(R.mkdata(40), make_mesh(
            (2,), ("data",), devices=["cpu"] * 2), axes=("model",))


# ------------------------------------------------------------- the engine
@pytest.fixture(scope="module")
def engine(forests):
    data, _ = R.forest_data()
    frozen = P2HIndex.build(data, n0=R.FOREST_N0, device="cpu")
    return P2HEngine(frozen, sharded=forests["line8"], slot_size=4)


def test_engine_sharded_route_equals_jax(jref, forests, engine):
    """Exact batches take the ``"sharded"`` route, cold then warm from the
    lambda cache: the answers, route count, counters and cache hits of
    JAX's engine; warm equals cold bit for bit; ``query(engine=)``
    returns that call's counters."""
    _, q = R.forest_data()
    cold = engine.query(q, K)
    warm = engine.query(q, K)
    for rnd, (bd, bi) in (("cold", cold), ("warm", warm)):
        assert_topk_parity(bd, bi, jref[f"engine/{rnd}/d"],
                           jref[f"engine/{rnd}/i"])
    assert np.array_equal(cold[0], warm[0])
    st = engine.stats()
    assert st["routes"] == {"sharded": int(jref["engine/routes"])}
    assert [st["counters"]["sharded"][n] for n in _NAMES] == \
        jref["engine/counters"].tolist()
    assert st["lambda_cache"]["hits"] == int(jref["engine/cache_hits"]) > 0
    bd, bi, dst = forests["line8"].query(q, K, engine=engine)
    assert_topk_parity(bd, bi, jref["engine/direct/d"],
                       jref["engine/direct/i"])
    assert [dst[n] for n in _NAMES] == jref["engine/direct/stats"].tolist()


def test_engine_sharded_refusals(forests, engine):
    """``engine=`` must serve this forest and derives its own caps; a
    mutable index takes no ``sharded=``; without a forest the route has
    nothing to run."""
    from repro_torch.stream import MutableP2HIndex

    _, q = R.forest_data()
    with pytest.raises(ValueError, match="different index"):
        forests["pod2x4"].query(q, K, engine=engine)
    with pytest.raises(ValueError, match="lambda_cap"):
        forests["line8"].query(q, K, engine=engine,
                               lambda_cap=np.ones(len(q), np.float32))
    m = MutableP2HIndex(R.FOREST_DIM, device="cpu")
    with pytest.raises(ValueError, match="frozen"):
        P2HEngine(m, sharded=forests["line8"])
    plain = P2HEngine(engine.index)
    with pytest.raises(ValueError, match="sharded="):
        plain.query(q, K, method="sharded")
