"""LM placement in the port held to the JAX package's: every parameter's,
cache leaf's and input's logical axes, the specs they resolve to on the
production meshes (16 x 16 and 2 x 16 x 16, full width, nothing
allocated) and the divisibility fallbacks they log; the reference's own
placement tests (``tests/test_substrate.py``, ``test_mesh.py``,
``test_fault_tolerance.py``, ``test_distributed.py``) on the port; and the
placed train step on meshes of the host named at several positions,
against the one-device step (bit for bit on a (1, 4) mesh) and the JAX
package's step.

The JAX sides resolve against ``jax.sharding.AbstractMesh`` (no
devices); the port's against meshes of ``meta`` or ``cpu``.  A JAX spec
is compared as its tuple of entries, the port's through
``models.convert``, which puts back the ``"stack"`` axis of the JAX
package's stacked leaves.
"""
import dataclasses
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import SHAPES as J_SHAPES  # noqa: E402
from repro.configs import get_model as j_get_model  # noqa: E402
from repro.configs import shape_applicable as j_applicable  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.parallel import sharding as JSH  # noqa: E402
from repro.runtime.elastic import specs_for_mesh as j_specs_for_mesh  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import (  # noqa: E402
    ARCH_IDS,
    SHAPES,
    get_config,
    shape_applicable,
)
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    make_mesh,
    make_production_mesh,
    make_test_mesh,
    mesh_context,
)
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.registry import build_model, get_model  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel import sharding as TSH  # noqa: E402
from repro_torch.parallel.placement import (  # noqa: E402
    NamedSharding,
    PlacedTensor,
    device_put,
    gather,
)
from repro_torch.parallel.sharding import P  # noqa: E402
from repro_torch.runtime.elastic import (  # noqa: E402
    elastic_remesh,
    specs_for_mesh,
)

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
DECODE_CELLS = [(a, s) for a in ARCH_IDS for s in SHAPES
                if SHAPES[s]["kind"] == "decode" and shape_applicable(a, s)[0]]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes(kind):
    shape, axes = MESHES[kind]
    return (AbstractMesh(shape, axes),
            make_production_mesh(multi_pod=kind == "multi"))


def _j_spec(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def _fallbacks(log):
    return {(axis, dim, str(mesh)) for _, axis, dim, mesh in log}


# ------------------------------------------------ logical axes and specs
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_logical_axes_match_jax(arch):
    jmodel, _ = j_get_model(arch)
    _, j_logical = jmodel.abstract_params()
    model = build_model(get_config(arch), device="meta")
    shapes, logical = model.abstract_params()
    assert all(t.device.type == "meta" for t in shapes.values())
    assert convert.logical_to_reference(model, logical) == j_logical


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_and_fallbacks_match_jax(arch, mesh_kind):
    jmesh, mesh = _meshes(mesh_kind)
    jmodel, jcfg = j_get_model(arch)
    j_shapes, j_logical = jmodel.abstract_params()
    JSH.fallback_log.clear()
    j_sh = j_specs_for_mesh(j_logical, j_shapes, jmesh, jcfg.rules)
    j_fall = _fallbacks(JSH.fallback_log)
    want = jax.tree.map(lambda sh, s: _j_spec(sh.spec, len(s.shape)), j_sh,
                        j_shapes, is_leaf=lambda x: hasattr(x, "spec"))

    cfg = get_config(arch)
    model = build_model(cfg, device="meta")
    shapes, logical = model.abstract_params()
    TSH.fallback_log.clear()
    sh = specs_for_mesh(logical, shapes, mesh, cfg.rules)
    fall = _fallbacks(TSH.fallback_log)
    got = convert.specs_to_reference(model, {k: v.spec
                                             for k, v in sh.items()})
    assert got == want
    assert fall == j_fall
    # resolve_param_specs resolves the same specs
    specs = TSH.resolve_param_specs(logical, shapes, mesh, rules=cfg.rules)
    assert specs == {k: v.spec for k, v in sh.items()}


def test_llama_fallback_is_the_kv_heads():
    """The table of the motivating check: llama3.2-1b's 8 KV heads on a
    16-way model axis, and nothing else."""
    cfg = get_config("llama3.2-1b")
    model = build_model(cfg, device="meta")
    shapes, logical = model.abstract_params()
    TSH.fallback_log.clear()
    specs_for_mesh(logical, shapes, make_production_mesh(), cfg.rules)
    assert _fallbacks(TSH.fallback_log) == {("kv_heads", 8, "model")}


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch,shape", DECODE_CELLS)
def test_cache_logical_and_specs_match_jax(arch, shape, mesh_kind):
    B, S = SHAPES[shape]["batch"], SHAPES[shape]["seq"]
    jmesh, mesh = _meshes(mesh_kind)
    jmodel, jcfg = j_get_model(arch)
    j_cache = jmodel.abstract_cache(B, S)
    j_logical = jmodel.cache_logical(B, S)
    JSH.fallback_log.clear()
    want = jax.tree.map(
        lambda lg, s: _j_spec(JSH.logical_to_spec(
            lg, s.shape, jmesh, rules=jcfg.rules, name="cache"),
            len(s.shape)), j_logical, j_cache, is_leaf=TSH.is_logical)
    j_fall = _fallbacks(JSH.fallback_log)

    model = build_model(get_config(arch), device="meta")
    assert convert.cache_logical_to_reference(
        model, model.cache_logical(B, S)) == j_logical
    TSH.fallback_log.clear()
    cells = TS.all_shardings(arch, shape, mesh)
    fall = _fallbacks(TSH.fallback_log)
    cache_sh = cells["cache_sharding"]
    got = convert.cache_specs_to_reference(model, {
        i: {k: v.spec for k, v in leaves.items()}
        for i, leaves in cache_sh.items()})
    assert got == want
    # the cell also resolves the parameters and the batch: the cache's own
    # fallbacks are among the cell's
    assert j_fall <= fall


@pytest.mark.parametrize("shape", list(J_SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_batch_logical_match_jax(arch, shape):
    assert shape_applicable(arch, shape) == j_applicable(arch, shape)
    assert SHAPES[shape] == J_SHAPES[shape]
    want, got = JS.input_specs(arch, shape), TS.input_specs(arch, shape)
    assert set(got) == set(want)
    for k, s in want.items():
        assert tuple(got[k].shape) == tuple(s.shape)
        assert str(got[k].dtype) == f"torch.{s.dtype}"
        assert got[k].device.type == "meta"
    j_logical = JS.batch_logical(arch, shape)
    assert TS.batch_logical(arch, shape) == j_logical
    for kind in MESHES:
        jmesh, mesh = _meshes(kind)
        for k, s in want.items():
            assert TSH.logical_to_spec(j_logical[k], tuple(s.shape), mesh) \
                == _j_spec(JSH.logical_to_spec(j_logical[k], s.shape,
                                               jmesh), len(s.shape))


def test_all_shardings_keys_match_jax():
    cells = TS.all_shardings("granite-moe-3b-a800m", "decode_32k",
                             make_production_mesh())
    assert set(cells) == {"cfg", "model", "abstract_params",
                          "param_sharding", "abstract_opt", "opt_sharding",
                          "input_specs", "batch_sharding", "abstract_cache",
                          "cache_sharding"}
    assert cells["opt_sharding"].mu is cells["param_sharding"]
    assert cells["opt_sharding"].count.spec == P()
    assert all(t.dtype == torch.float32
               for t in cells["abstract_opt"].mu.values())


# ------------------------------------------- the reference's own tests
def test_logical_to_spec_divisibility_fallback():
    """``tests/test_substrate.py:142``, and the fallback itself on a
    16-way model axis."""
    mesh = make_mesh((1, 1), ("data", "model"), devices=["cpu"])
    assert TSH.logical_to_spec(("embed", "heads"), (960, 15), mesh) \
        == P(None, "model")
    TSH.fallback_log.clear()
    spec = TSH.logical_to_spec(("embed", "heads"), (960, 15),
                               make_production_mesh(), name="wq")
    assert spec == P(None, None)
    assert list(TSH.fallback_log) == [("wq", "heads", 15, "model")]
    # no mesh: everything replicated, nothing logged
    assert TSH.logical_to_spec(("heads",), (15,)) == P(None)
    # a mesh axis is used once: the first dimension keeps it
    assert TSH.logical_to_spec(("heads", "mlp"), (16, 32),
                               make_production_mesh()) == P("model", None)


@pytest.mark.parametrize("vocab,tp", [(49155, 16), (128256, 16), (50280, 8),
                                      (51865, 1), (1, 0)])
def test_pad_vocab(vocab, tp):
    """``tests/test_substrate.py:151``, and equal to the JAX package's."""
    got = TSH.pad_vocab(vocab, tp)
    assert got % (128 * max(tp, 1)) == 0 and got >= vocab
    assert got == JSH.pad_vocab(vocab, tp)


def test_fallback_log_bounded_and_threadsafe():
    """``tests/test_mesh.py:88`` on the port's log."""
    log = TSH._FallbackLog(maxlen=64)
    errs = []

    def hammer(t):
        try:
            for i in range(300):
                log.append(("w", "ax", t * 1000 + i, "model"))
                if i % 37 == 0:
                    list(log)  # concurrent snapshot iteration
        except Exception as e:  # pragma: no cover
            errs.append(e)

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs
    assert len(log) == 64
    assert log.dropped == 4 * 300 - 64
    assert bool(log)
    log.clear()
    assert len(log) == 0 and log.dropped == 0 and not bool(log)


def test_shard_is_the_identity():
    """Without an ambient mesh ``shard`` returns its tensor and resolves
    nothing; under one it still returns the tensor (the layout is the
    placed step's), and a dimension the mesh axes do not divide lands in
    the fallback log under ``"act"``, as the JAX package's does."""
    x = torch.randn(4, 8, 6)  # 6 heads do not split 4 ways
    TSH.fallback_log.clear()
    assert TSH.shard(x, "batch", "seq", "heads") is x
    assert len(TSH.fallback_log) == 0
    mesh = make_test_mesh((2, 4), devices=["cpu"] * 8)
    with mesh_context(mesh):
        assert TSH.shard(x, "batch", "seq", "heads") is x
    assert [(n, a, d, m) for n, a, d, m in TSH.fallback_log] == [
        ("act", "heads", 6, "model")]
    TSH.fallback_log.clear()


def test_shard_resolves_each_activation_once_a_block():
    """Inside ``activation_context`` an activation is resolved (and its
    fallback logged) once, as the JAX package resolves a constraint once
    a trace: the block's later calls return at once; a new block, global
    sizes or another shape resolve again."""
    x = torch.randn(4, 8, 6)
    mesh = make_test_mesh((2, 4), devices=["cpu"] * 8)
    TSH.fallback_log.clear()
    with mesh_context(mesh):
        with TSH.activation_context():
            for _ in range(3):
                assert TSH.shard(x, "batch", "seq", "heads") is x
            assert len(TSH.fallback_log) == 1
            TSH.shard(torch.randn(4, 8, 10), "batch", "seq", "heads")
            assert len(TSH.fallback_log) == 2
        with TSH.activation_context({"heads": 12}):
            # a position's 6 of 12 heads: 12 divides, nothing logged
            TSH.shard(x, "batch", "seq", "heads")
            assert len(TSH.fallback_log) == 2
        with TSH.activation_context():
            TSH.shard(x, "batch", "seq", "heads")
    assert [d for _, _, d, _ in TSH.fallback_log] == [6, 10, 6]
    TSH.fallback_log.clear()


def test_elastic_remesh_roundtrip():
    """``tests/test_fault_tolerance.py:83``: a one-position mesh."""
    mesh1 = make_mesh((1,), ("data",), devices=["cpu"])
    tree = {"w": torch.arange(32.0).reshape(8, 4)}
    out = elastic_remesh(tree, {"w": ("batch", None)}, mesh1)
    assert isinstance(out["w"], PlacedTensor)
    assert torch.equal(gather(out["w"]), tree["w"])


def _smoke_state(arch="llama3.2-1b", seed=0):
    model, cfg = get_model(arch, smoke=True, seed=seed, device="cpu")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return model, cfg, params


def test_elastic_remesh_chain_bit_for_bit_with_resolved_bytes():
    """(2, 2) -> (1, 4) -> (4, 1) -> (2, 2) on the host named 4 times:
    every leaf bit for bit, every position holding its resolved shard in
    a storage of its own."""
    model, cfg, params = _smoke_state()
    logical = {n: p.logical for n, p in model.named_parameters()}
    tree = {"params": params, "mu": {k: v * 0.5 for k, v in params.items()}}
    tlog = {"params": logical, "mu": logical}
    meshes = [make_test_mesh(s, devices=["cpu"] * 4)
              for s in ((2, 2), (1, 4), (4, 1), (2, 2))]
    placed = tree
    for mesh in meshes:
        placed = elastic_remesh(placed, tlog, mesh, cfg.rules)
        for part in placed:
            for name, pt in placed[part].items():
                want = tree[part][name]
                assert torch.equal(gather(pt), want)
                nbytes = pt.sharding.shard_nbytes(tuple(want.shape),
                                                  want.dtype)
                assert (pt.nbytes_by_position() == nbytes).all()
                ptrs = {s.data_ptr() for s in pt.shards.flat}
                assert len(ptrs) == mesh.size


@pytest.mark.parametrize("spec,splits", [
    (P("data", "model"), True), (P(None, ("data", "model")), True),
    (P(), True), (P("model", None, "data"), False)])
def test_device_put_gather_and_reshard(spec, splits):
    mesh = make_test_mesh((2, 4), devices=["cpu"] * 8)
    x = torch.randn(6, 8, 12)
    sh = NamedSharding(mesh, spec)
    if not splits:  # 6 rows do not split 4 ways
        with pytest.raises(ValueError):
            device_put(x, sh)
        return
    placed = device_put(x, sh)
    assert torch.equal(gather(placed), x)
    assert tuple(placed.shard((1, 3)).shape) == sh.shard_shape(x.shape)
    again = device_put(placed, NamedSharding(mesh, P(None, "model")))
    assert torch.equal(gather(again), x)


def test_named_sharding_refuses_bad_specs():
    mesh = make_test_mesh((2, 4), devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        NamedSharding(mesh, P("pod"))
    with pytest.raises(ValueError):
        NamedSharding(mesh, P("model", "model"))


# ----------------------------------------------------- the placed step
def _batches(cfg, steps=3, seq=32, batch=8, seed=5):
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq=seq, global_batch=batch,
                            seed=seed)
    return [{k: torch.from_numpy(v) for k, v in
             ds.global_batch_arrays(s).items()} for s in range(steps)]


def _one_device(model, cfg, batches, lr=1e-3):
    opt = adamw_init(dict(model.named_parameters()))
    step = TS.make_train_step(model, cfg, lr_fn=lambda s: lr)
    metrics = [step(opt, b) for b in batches]
    return metrics, opt


def _placed(cfg, params, mesh, batches, lr=1e-3):
    step = TS.make_placed_train_step(build_model(cfg, device="meta"), cfg,
                                     mesh=mesh, params=params,
                                     lr_fn=lambda s: lr)
    opt = adamw_init(step.params)
    metrics = [step(opt, b) for b in batches]
    return metrics, opt, step


@pytest.mark.parametrize("shape,axes", [((1, 4), ("data", "model")),
                                        ((1, 1), ("data", "model")),
                                        ((4,), ("model",))])
def test_placed_step_without_data_split_is_the_one_device_step(shape, axes):
    """No data split (one compute position): the losses, grad norms, the
    gathered parameters and both moments equal the one-device step's bit
    for bit over 3 steps."""
    model, cfg, params = _smoke_state()
    batches = _batches(cfg)
    want, opt1 = _one_device(model, cfg, batches)
    mesh = make_test_mesh(shape, axes, devices=["cpu"] * int(np.prod(shape)))
    got, opt2, step = _placed(cfg, params, mesh, batches)
    assert step.data_positions == [(0,) * len(shape)]
    for a, b in zip(want, got):
        for k in ("loss", "nll", "grad_norm", "aux_load", "aux_z"):
            assert torch.equal(a[k], b[k]), k
    for name, p in model.named_parameters():
        assert torch.equal(gather(step.params[name]), p.detach()), name
        assert torch.equal(gather(opt2.mu[name]), opt1.mu[name]), name
        assert torch.equal(gather(opt2.nu[name]), opt1.nu[name]), name
    assert all(int(c) == 3 for c in opt2.count.shards.flat)


def test_placed_step_4x2_meets_the_jax_bars():
    """``tests/test_distributed.py:127``: one step on a (data=4, model=2)
    mesh reproduces the one-device step within the reference's bars
    (loss rtol 5e-3, parameters max-abs 5e-2); here over 3 steps."""
    model, cfg, params = _smoke_state()
    batches = _batches(cfg)
    want, _ = _one_device(model, cfg, batches)
    mesh = make_test_mesh((4, 2), devices=["cpu"] * 8)
    got, _, step = _placed(cfg, params, mesh, batches)
    assert step.data_positions == [(0, 0), (1, 0), (2, 0), (3, 0)]
    for a, b in zip(want, got):
        np.testing.assert_allclose(float(b["loss"]), float(a["loss"]),
                                   rtol=5e-3)
    worst = max(float((gather(step.params[n]) - p.detach()).abs().max())
                for n, p in model.named_parameters())
    assert worst < 5e-2, worst


@pytest.fixture(scope="module")
def jax_f32_step():
    """The JAX package's smoke llama at f32 compute: its parameters and
    its step's metrics on the first batch."""
    jmodel, jcfg = j_get_model("llama3.2-1b", smoke=True)
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
    jmodel = type(jmodel)(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    jstep = jax.jit(JS.make_train_step(jmodel, jcfg, lr_fn=lambda s: 1e-3))
    batch = _batches(get_config("llama3.2-1b", smoke=True), steps=1)[0]
    _, _, metrics = jstep(jparams, j_adamw_init(jparams),
                          {k: jnp.asarray(v.numpy())
                           for k, v in batch.items()})
    return jax.device_get(jparams), jax.device_get(metrics), batch


@pytest.mark.parametrize("shape", [(4, 2), (2, 4)])
def test_placed_step_loss_equals_the_jax_step_f32(jax_f32_step, shape):
    """The JAX package's parameters loaded into the port, f32 compute: the
    placed step's loss and grad norm equal the JAX step's on the same
    parameters and batch (rtol 1e-5 / 1e-4)."""
    jparams, jm, batch = jax_f32_step
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    convert.from_reference_arrays(model, jparams)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    mesh = make_test_mesh(shape, devices=["cpu"] * 8)
    got, _, _ = _placed(cfg, params, mesh, [batch])
    np.testing.assert_allclose(float(got[0]["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got[0]["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)


def test_placed_step_is_storage_sharding_not_tensor_parallel():
    """Without an ambient mesh (``mesh_context``; under one the step runs
    the tensor layout, ``tests/test_torch_lm_tensor.py``) the model axis
    shards the parameters' and moments' storage and the update, not the
    products.  Each data index's compute position gathers
    every split parameter whole (all-gather outputs are whole parameters)
    and runs the unsharded model; the gradients are summed over the data
    positions once (all-reduce) and sent out as shards
    (collective-permute); no activation is ever split or reduced."""
    model, cfg, params = _smoke_state()
    mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
    step = TS.make_placed_train_step(model, cfg, mesh=mesh, params=params,
                                     lr_fn=lambda s: 1e-3)
    opt = adamw_init(step.params)
    assert step.layout == "storage"
    with collectives.record_collectives() as notes:
        step(opt, _batches(cfg, steps=1)[0])
    whole = {p.numel() * p.element_size() for p in params.values()}
    kinds = {k for k, _, _ in notes}
    assert kinds == {"all-gather", "all-reduce", "collective-permute"}
    split = [n for n, p in step.params.items()
             if p.sharding.spec.mesh_axes()]
    gathers = [b for k, b, _ in notes if k == "all-gather"]
    assert len(gathers) == 2 * len(split)  # once a data index
    assert set(gathers) <= whole
    # the dry run's count of the step's collectives is the step's own
    with collectives.record_collectives() as dry:
        step.communicate(_batches(cfg, steps=1)[0])
    assert sorted(dry) == sorted(notes)


def test_placed_step_refuses_mixed_devices_and_unsplit_batches():
    model, cfg, params = _smoke_state()
    mixed = make_test_mesh((2,), ("model",), devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="one device type"):
        TS.make_placed_train_step(model, cfg, mesh=mixed, params=params,
                                  lr_fn=lambda s: 1e-3)
    mesh = make_test_mesh((4, 1), devices=["cpu"] * 4)
    step = TS.make_placed_train_step(model, cfg, mesh=mesh, params=params,
                                     lr_fn=lambda s: 1e-3)
    batch = _batches(cfg, steps=1, batch=6)[0]
    with pytest.raises(ValueError, match="do not split"):
        step(adamw_init(step.params), batch)


def test_placed_adamw_equals_plain_update():
    """Each position steps its own shards: the placed moments and
    parameters equal the plain update's bit for bit."""
    gen = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(8, 12, generator=gen),
              "b": torch.randn(4, generator=gen)}
    grads = {k: torch.randn(v.shape, generator=gen) for k, v in
             params.items()}
    mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
    shs = {"a": NamedSharding(mesh, P("data", "model")),
           "b": NamedSharding(mesh, P("model"))}
    placed = {k: device_put(v, shs[k]) for k, v in params.items()}
    plain = {k: v.clone() for k, v in params.items()}
    opt, popt = adamw_init(plain), adamw_init(placed)
    for _ in range(2):
        adamw_update(grads, opt, plain, lr=1e-2)
        adamw_update({k: device_put(g, shs[k]) for k, g in grads.items()},
                     popt, placed, lr=torch.tensor(1e-2))
    for k in params:
        assert torch.equal(gather(placed[k]), plain[k])
        assert torch.equal(gather(popt.mu[k]), opt.mu[k])
        assert torch.equal(gather(popt.nu[k]), opt.nu[k])
    assert all(int(c) == 2 for c in popt.count.shards.flat)


# ------------------------------------------------------ elastic restore
def test_checkpoint_restore_with_shardings_on_2x4():
    """``tests/test_distributed.py:170``: a checkpoint written with no
    mesh restores placed on a (data=2, model=4) mesh bit for bit."""
    model, cfg, params = _smoke_state()
    logical = {n: p.logical for n, p in model.named_parameters()}
    mesh = make_test_mesh((2, 4), devices=["cpu"] * 8)
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td)
        mgr.save(1, params, blocking=True)
        sh = specs_for_mesh(logical, params, mesh, cfg.rules)
        restored = mgr.restore(1, params, shardings=sh)
    for name, want in params.items():
        got = restored[name]
        assert isinstance(got, PlacedTensor) and got.sharding == sh[name]
        assert torch.equal(gather(got), want), name


def test_checkpoint_from_jax_restores_placed():
    """The JAX package's checkpoint of its parameter tree restores onto a
    (2, 4) host mesh in its own layout, each leaf placed by the port's
    specs put back into that layout (``convert.specs_to_reference``)."""
    from repro.checkpoint import CheckpointManager as JManager

    jmodel, _ = j_get_model("llama3.2-1b", smoke=True)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, jparams)
    model = build_model(get_config("llama3.2-1b", smoke=True), device="meta")
    shapes, logical = model.abstract_params()
    mesh = make_test_mesh((2, 4), devices=["cpu"] * 8)
    specs = specs_for_mesh(logical, shapes, mesh)
    ref_specs = convert.specs_to_reference(model, {
        k: v.spec for k, v in specs.items()})
    shardings = jax.tree.map(lambda s: NamedSharding(mesh, P(*s)),
                             ref_specs, is_leaf=TSH.is_logical)
    like = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), host)
    with tempfile.TemporaryDirectory() as td:
        JManager(td).save(1, jparams, blocking=True)
        restored = CheckpointManager(td).restore(1, like,
                                                 shardings=shardings)
    flat = jax.tree_util.tree_leaves_with_path(host)
    for path, want in flat:
        node = restored
        for p in path:
            node = node[p.key]
        assert torch.equal(gather(node), torch.from_numpy(want))
