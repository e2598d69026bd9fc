"""The dense decoder-only models, the port against the JAX package: each of
the four dense ``SMOKE`` configs at f32 compute in both packages, the JAX
package's initial parameters carried into the port by
``models/convert.py``, the same ``SyntheticLMDataset`` batches.

Tolerances.  Forward logits rtol 1e-4, gradients rtol 1e-4; the first
step's loss rtol 1e-5.  Elementwise, an absolute floor
of 1e-4 x the tensor's largest magnitude (and never below the stated
atol: 1e-5 for logits, 1e-6 for gradients): the smoke configs draw
``wq`` with fan-in = n_heads (``layers.py``'s ``shape[-2]`` rule), so
attention scores reach ~100 and one f32 rounding of a score moves its
probability by ~1e-5.  Each package is measured up to 3.6e-5 x max|.|
away from a float64 evaluation of the same model (glm4's logits: JAX
4.3e-5, the port 4.8e-5, of a largest logit 4.24), so no tighter bar
holds for an elementwise comparison near zero.  For the same reason the
global gradient norm is held at rtol 1e-4: gemma's stands 6.4e-6 (JAX)
and 1.0e-5 (the port) from the float64 value, on opposite sides.

After three ``make_train_step`` steps the losses agree within rtol 1e-4
and the parameters within atol 2 x sum(lr) + rtol 1e-4: AdamW's first
steps move an element by about +-lr whatever its gradient's size, so an
element whose gradient is near 0 may move either way in the two packages.

At the configs' own bf16 compute each package's loss stays within 2e-2 of
its own f32 loss, and the two bf16 losses within 3e-2 of each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.models.transformer import StackedLM as JStackedLM  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim.schedule import cosine_schedule as jcosine  # noqa: E402
from repro_torch.launch.steps import lm_loss, make_train_step  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    from_reference_arrays,
    to_reference_arrays,
)
from repro_torch.models.registry import get_config, get_model  # noqa: E402
from repro_torch.models.transformer import StackedLM  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule  # noqa: E402

DENSE = ["gemma-2b", "glm4-9b", "llama3.2-1b", "smollm-360m"]
B, S, STEPS = 2, 32, 3
SCHED = dict(peak_lr=1e-3, warmup_steps=2, total_steps=STEPS)
FLOOR = 1e-4  # x max|want|, see the module docstring


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps several
    test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, *, rtol, atol, what=""):
    want = np.asarray(want, np.float64)
    floor = max(atol, FLOOR * float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=floor, err_msg=what)


def _jloss(model):
    def loss_fn(params, batch):  # make_train_step's loss, with the logits
        logits, aux = model.apply(params, batch["tokens"])
        lse = jax.nn.logsumexp(logits.astype(jnp.float32), axis=-1)
        gold = jnp.take_along_axis(logits, batch["labels"][..., None],
                                   axis=-1)[..., 0].astype(jnp.float32)
        return jnp.mean(lse - gold), logits
    return loss_fn


@pytest.fixture(scope="module", params=DENSE)
def ref(request):
    """The JAX package's answers for one arch, compiled once a module:
    step 0's loss, logits and gradients, three train steps' metrics and
    parameters, and the loss at the config's own bf16 compute."""
    arch = request.param
    base = jget_config(arch, smoke=True)
    cfg = dataclasses.replace(base, compute_dtype=jnp.float32)
    model = JStackedLM(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    ds = JDataset(vocab=cfg.vocab, seq=S, global_batch=B, seed=0)
    batches = [ds.global_batch_arrays(s) for s in range(STEPS)]
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    (loss, logits), grads = jax.jit(jax.value_and_grad(
        _jloss(model), has_aux=True))(params, jb[0])
    step = jax.jit(jmake_train_step(
        model, cfg, lr_fn=lambda s: jcosine(s, **SCHED)))
    p, opt, metrics = params, jadamw_init(params), []
    for b in jb:
        p, opt, m = step(p, opt, b)
        metrics.append({k: float(v) for k, v in m.items()})
    bf16_model = JStackedLM(base)
    bf16_loss, _ = jax.jit(_jloss(bf16_model))(params, jb[0])
    host = jax.tree.map(np.asarray, params)
    return dict(arch=arch, host=host, batches=batches, loss=float(loss),
                logits=np.asarray(logits), grads=jax.tree.map(np.asarray,
                                                              grads),
                metrics=metrics, params3=jax.tree.map(np.asarray, p),
                bf16_loss=float(bf16_loss))


def _port(ref, compute_dtype=torch.float32):
    cfg = dataclasses.replace(get_config(ref["arch"], smoke=True),
                              compute_dtype=compute_dtype)
    model = StackedLM(cfg, device="cpu")
    from_reference_arrays(model, ref["host"])
    return model, cfg


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_logits_match(ref):
    model, _ = _port(ref)
    with torch.no_grad():
        logits, aux = model.apply(_tb(ref["batches"][0])["tokens"])
    assert logits.dtype == torch.float32 and float(aux.abs().sum()) == 0
    close(logits.numpy(), ref["logits"], rtol=1e-4, atol=1e-5)


def test_loss_and_every_gradient_match(ref):
    model, cfg = _port(ref)
    loss, _ = lm_loss(model, cfg, _tb(ref["batches"][0]))
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = to_reference_arrays(model, dict(zip(names, grads)))
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(ref["grads"])
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (path, g), (_, w) in zip(flat_got, flat_want):
        close(g, w, rtol=1e-4, atol=1e-6, what=jax.tree_util.keystr(path))


def test_three_train_steps_match(ref):
    model, cfg = _port(ref)
    step = make_train_step(model, cfg,
                           lr_fn=lambda s: cosine_schedule(s, **SCHED))
    opt = adamw_init(dict(model.named_parameters()))
    got = [{k: float(v) for k, v in step(opt, _tb(b)).items()}
           for b in ref["batches"]]
    want = ref["metrics"]
    assert [sorted(m) for m in got] == [sorted(m) for m in want]
    np.testing.assert_allclose(got[0]["loss"], want[0]["loss"], rtol=1e-5)
    np.testing.assert_allclose(got[0]["grad_norm"], want[0]["grad_norm"],
                               rtol=FLOOR)
    np.testing.assert_allclose([m["loss"] for m in got],
                               [m["loss"] for m in want], rtol=1e-4)
    np.testing.assert_allclose([m["lr"] for m in got],
                               [m["lr"] for m in want], rtol=1e-6)
    assert int(opt.count) == STEPS
    atol = 2 * sum(m["lr"] for m in want)
    after = to_reference_arrays(model)
    for (path, g), (_, w) in zip(jax.tree_util.tree_leaves_with_path(after),
                                 jax.tree_util.tree_leaves_with_path(
                                     ref["params3"])):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def test_bf16_loss_near_f32_in_each_package(ref):
    model, cfg = _port(ref, torch.bfloat16)
    with torch.no_grad():
        bf16, _ = lm_loss(model, cfg, _tb(ref["batches"][0]))
    assert abs(float(bf16) - ref["loss"]) < 2e-2      # the port's own f32
    assert abs(ref["bf16_loss"] - ref["loss"]) < 2e-2  # JAX's own f32
    assert abs(float(bf16) - ref["bf16_loss"]) < 3e-2


def test_train_step_n_micro_accumulates_the_same_step():
    """``n_micro=2`` gives the one-batch step's loss and parameters."""
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype=torch.float32)
    ds = JDataset(vocab=cfg.vocab, seq=S, global_batch=4, seed=2)
    batch = _tb(ds.global_batch_arrays(0))
    outs = []
    for n_micro in (1, 2):
        model = StackedLM(cfg, seed=1, device="cpu")
        step = make_train_step(model, cfg, n_micro=n_micro,
                               lr_fn=lambda s: cosine_schedule(s, **SCHED))
        m = step(adamw_init(dict(model.named_parameters())), batch)
        outs.append((float(m["loss"]), float(m["grad_norm"]),
                     [p.detach().clone() for p in model.parameters()]))
    np.testing.assert_allclose(outs[1][0], outs[0][0], rtol=1e-5)
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-5)
    for a, b in zip(outs[0][2], outs[1][2]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("arch", DENSE)
def test_param_count_matches_jax(arch):
    want = jget_config(arch).param_count()
    assert get_config(arch).param_count() == want
    assert get_config(arch, smoke=True).param_count() == \
        jget_config(arch, smoke=True).param_count()


def test_llama3_2_1b_full_width_count():
    assert get_config("llama3.2-1b").param_count() == 1_235_814_400


def test_remat_full_equals_no_remat():
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              compute_dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 24)))
    grads = []
    for remat in ("full", None, "dots"):
        model = StackedLM(dataclasses.replace(cfg, remat=remat), seed=3,
                          device="cpu")
        logits, _ = model.apply(tokens)
        grads.append(torch.autograd.grad(logits.square().mean(),
                                         list(model.parameters())))
    for a, b, c in zip(*grads):
        assert torch.equal(a, b)
        assert torch.equal(c, a)


def test_head_padding_exactness():
    """``pad_heads_to``: zero pad slices and the output mask compute the
    unpadded model's logits (``tests/test_archs.py``'s check)."""
    base = dataclasses.replace(get_config("smollm-360m", smoke=True),
                               compute_dtype=torch.float32)
    m0 = StackedLM(base, device="cpu")
    m1 = StackedLM(dataclasses.replace(base, pad_heads_to=4), device="cpu")
    with torch.no_grad():
        for (n, a), b in zip(m0.named_parameters(), m1.parameters()):
            b.zero_()
            b[tuple(slice(0, s) for s in a.shape)] = a
        assert m1.layers[0].attn.wq.shape[1] == 4
        tokens = torch.from_numpy(np.random.default_rng(0).integers(
            0, base.vocab, size=(2, 16)))
        l0, _ = m0.apply(tokens)
        l1, _ = m1.apply(tokens)
    np.testing.assert_allclose(l1.numpy(), l0.numpy(), rtol=1e-5, atol=1e-5)


def test_entry_points_need_the_card_or_an_explicit_host():
    """With no device the model goes to the card, and raises without one,
    for every family; with the host named, every family builds there."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_model("llama3.2-1b", smoke=True)
    model, cfg = get_model("llama3.2-1b", smoke=True, device="cpu")
    assert model.device.type == "cpu" and cfg.name == "llama3.2-1b-smoke"
    for arch in ("mamba2-780m", "granite-moe-3b-a800m", "whisper-tiny"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_model(arch, smoke=True)
        model, cfg = get_model(arch, smoke=True, device="cpu")
        assert model.device.type == "cpu" and cfg.name == f"{arch}-smoke"


def test_same_seed_same_model():
    """Initialisation draws on a host generator, in ``parameters()``
    order: the same seed gives the same parameters, another seed others
    (the card's copy is held to the host's in ``test_torch_gpu.py``)."""
    cfg = get_config("glm4-9b", smoke=True)
    a, b, c = (StackedLM(cfg, seed=s, device="cpu") for s in (5, 5, 6))
    pairs = list(zip(a.parameters(), b.parameters(), c.parameters()))
    assert all(torch.equal(pa, pb) for pa, pb, _ in pairs)
    assert all(torch.equal(pa, pc) == (pa.init_rule[0] != "normal")
               for pa, _, pc in pairs)
