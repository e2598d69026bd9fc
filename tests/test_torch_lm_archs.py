"""The six non-dense architectures, the port against the JAX package: each
``SMOKE`` config (granite-moe, llama4-scout, mamba2, recurrentgemma,
whisper-tiny, phi-3-vision) at f32 compute in both packages, the JAX
package's initial parameters carried into the port by
``models/convert.py``, the same ``SyntheticLMDataset`` token batches and
the same seeded image or frame embeddings.

Tolerances, as ``tests/test_torch_lm_model.py`` states them for the dense
family: logits and gradients rtol 1e-4, the first step's loss rtol 1e-5,
each with an elementwise floor of 1e-4 x the tensor's largest magnitude
(never below atol 1e-5 for logits, 1e-6 for gradients); after three
``make_train_step`` steps the losses within rtol 1e-4 and the parameters
within atol 2 x sum(lr) + rtol 1e-4.  The key bias's gradient is zero in
exact arithmetic (the softmax cancels a shift shared by every key), so
both packages return rounding noise there: each is held to zero within
the floor of the key weights' gradient.

Some of these configs are ill-conditioned at f32 rounding.  llama4-scout's
smoke config (a NoPE global layer over saturated local ones) moves its
logits by 3.2e-4 (7e-5 x max|.|) when the JAX package's own embedding
changes by 2e-7, and its loss after three AdamW steps by 3.8e-4 (relative)
when every parameter does; the whisper encoder's output-bias gradient
sums 24 cancelling terms.  So every floor is also at least twice the JAX
package's own displacement when each parameter is multiplied by 1 +- 2e-7
(random signs, a rounding's size), measured in the fixture tensor by
tensor: on the logits, on every gradient, on the three steps' losses and
on the parameters after them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.launch.steps import make_train_step as jmake_train_step  # noqa: E402
from repro.models.registry import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.models.transformer import StackedLM as JStackedLM  # noqa: E402
from repro.models.whisper import WhisperED as JWhisperED  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim.schedule import cosine_schedule as jcosine  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.launch.steps import lm_loss, make_train_step  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    _reference_path,
    from_reference_arrays,
    to_reference_arrays,
)
from repro_torch.models.registry import (  # noqa: E402
    ARCH_IDS,
    build_model,
    get_config,
    get_model,
)
from repro_torch.models.whisper import WhisperED  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.optim.schedule import cosine_schedule  # noqa: E402

NEW = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e", "mamba2-780m",
       "recurrentgemma-9b", "whisper-tiny", "phi-3-vision-4.2b"]
B, S, STEPS = 2, 32, 3
SCHED = dict(peak_lr=1e-3, warmup_steps=2, total_steps=STEPS)
FLOOR = 1e-4  # x max|want|, see the module docstring
NUDGE = 2e-7  # the relative change of the embedding that measures spread


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps several
    test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, *, rtol, atol, spread=None, what=""):
    want = np.asarray(want, np.float64)
    floor = max(atol, FLOOR * float(np.abs(want).max()))
    if spread is not None:
        floor = max(floor, 2 * float(np.abs(spread).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=floor, err_msg=what)


def _jmodel(cfg):
    return JWhisperED(cfg) if cfg.enc_dec else JStackedLM(cfg)


def _jextras(cfg, batch):
    kw = {}
    if cfg.vlm_patches:
        kw["image_embeds"] = batch["image_embeds"]
    if cfg.enc_dec:
        kw["frames"] = batch["frames"]
    return kw


def _jloss(model, cfg):
    def loss_fn(params, batch):  # make_train_step's loss, with its parts
        logits, aux = model.apply(params, batch["tokens"],
                                  **_jextras(cfg, batch))
        labels = batch["labels"]
        text = logits[:, -labels.shape[1]:]
        lse = jax.nn.logsumexp(text.astype(jnp.float32), axis=-1)
        gold = jnp.take_along_axis(text, labels[..., None], axis=-1
                                   )[..., 0].astype(jnp.float32)
        nll = jnp.mean(lse - gold)
        loss = nll + cfg.moe_aux_weight * aux[0] + 1e-3 * aux[1]
        return loss, (logits, aux)
    return loss_fn


def _batches(cfg):
    """Token batches from the JAX package's dataset, the extras from the
    port's (both numpy, so both packages get the same arrays)."""
    jds = JDataset(vocab=cfg.vocab, seq=S, global_batch=B, seed=0)
    tds = SyntheticLMDataset(vocab=cfg.vocab, seq=S, global_batch=B, seed=0)
    out = []
    for s in range(STEPS):
        b = jds.global_batch_arrays(s)
        b.update(tds.extra_arrays(s, cfg))
        out.append(b)
    return out


@pytest.fixture(scope="module", params=NEW)
def ref(request):
    """The JAX package's answers for one arch, compiled once a module:
    step 0's loss, logits, aux and gradients (and their displacement under
    a 2e-7 change of the embedding), three train steps' metrics and
    parameters."""
    arch = request.param
    cfg = dataclasses.replace(jget_config(arch, smoke=True),
                              compute_dtype=jnp.float32)
    model = _jmodel(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    batches = _batches(cfg)
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    grad_fn = jax.jit(jax.value_and_grad(_jloss(model, cfg), has_aux=True))
    (loss, (logits, aux)), grads = grad_fn(params, jb[0])
    rng = np.random.default_rng(1)
    nudged = jax.tree.map(lambda a: a * (1 + NUDGE * rng.choice(
        [-1.0, 1.0], size=a.shape)).astype(np.float32), params)
    (_, (logits_n, _)), grads_n = grad_fn(nudged, jb[0])
    step = jax.jit(jmake_train_step(
        model, cfg, lr_fn=lambda s: jcosine(s, **SCHED)))

    def train(p):
        opt, metrics = jadamw_init(p), []
        for b in jb:
            p, opt, m = step(p, opt, b)
            metrics.append({k: float(v) for k, v in m.items()})
        return p, metrics

    p, metrics = train(params)
    p_n, metrics_n = train(nudged)
    np_ = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(arch=arch, host=np_(params), batches=batches,
                loss=float(loss), logits=np.asarray(logits),
                logits_spread=np.asarray(logits_n) - np.asarray(logits),
                aux=np.asarray(aux), grads=np_(grads),
                grads_spread=jax.tree.map(lambda a, b: np.asarray(a - b),
                                          grads_n, grads),
                metrics=metrics, params3=np_(p),
                loss_spread=np.array([m["loss"] - n["loss"] for m, n in
                                      zip(metrics, metrics_n)]),
                params3_spread=jax.tree.map(lambda a, b: np.asarray(a - b),
                                            p_n, p))


def _port(ref):
    cfg = dataclasses.replace(get_config(ref["arch"], smoke=True),
                              compute_dtype=torch.float32)
    model = build_model(cfg, device="cpu")
    from_reference_arrays(model, ref["host"])
    return model, cfg


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _extras(batch):
    return {k: v for k, v in batch.items()
            if k in ("image_embeds", "frames")}


def _pairs(got, want):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    return [(jax.tree_util.keystr(p), g, w)
            for (p, g), (_, w) in zip(flat_got, flat_want)]


def test_logits_and_aux_match(ref):
    model, cfg = _port(ref)
    b = _tb(ref["batches"][0])
    with torch.no_grad():
        logits, aux = model.apply(b["tokens"], **_extras(b))
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (B, S + cfg.vlm_patches, cfg.vocab)
    assert tuple(logits.shape) == ref["logits"].shape
    close(logits.numpy(), ref["logits"], rtol=1e-4, atol=1e-5,
          spread=ref["logits_spread"], what="logits")
    if cfg.num_experts:
        assert float(aux.min()) > 0
    else:
        assert float(aux.abs().sum()) == 0
    close(aux.numpy(), ref["aux"], rtol=1e-4, atol=1e-6, what="aux")


def test_loss_and_every_gradient_match(ref):
    model, cfg = _port(ref)
    loss, _ = lm_loss(model, cfg, _tb(ref["batches"][0]))
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = to_reference_arrays(model, dict(zip(names, grads)))
    want, spread = ref["grads"], ref["grads_spread"]
    sibling = {n: w for n, _, w in _pairs(got, want)}
    for (name, g, w), (_, _, sp) in zip(_pairs(got, want),
                                        _pairs(got, spread)):
        if name.endswith("['bk']"):
            wk = sibling[name[:-len("['bk']")] + "['wk']"]
            scale = max(1e-6, FLOOR * float(np.abs(wk).max()))
            assert float(np.abs(g).max()) <= scale, name
            assert float(np.abs(w).max()) <= scale, name
            continue
        close(g, w, rtol=1e-4, atol=1e-6, spread=sp, what=name)


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
    spread = 2 * float(np.abs(ref["loss_spread"]).max())
    np.testing.assert_allclose([m["loss"] for m in got],
                               [m["loss"] for m in want], rtol=1e-4,
                               atol=spread)
    np.testing.assert_allclose([m["aux_load"] for m in got],
                               [m["aux_load"] for m in want], rtol=1e-4,
                               atol=spread)
    np.testing.assert_allclose([m["lr"] for m in got],
                               [m["lr"] for m in want], rtol=1e-6)
    assert int(opt.count) == STEPS
    atol = 2 * sum(m["lr"] for m in want)
    for (name, g, w), (_, _, sp) in zip(
            _pairs(to_reference_arrays(model), ref["params3"]),
            _pairs(ref["params3"], ref["params3_spread"])):
        np.testing.assert_allclose(
            g, w, rtol=1e-4, atol=max(atol, 2 * float(np.abs(sp).max())),
            err_msg=name)


@pytest.mark.parametrize("arch", NEW)
def test_param_count_matches_jax(arch):
    """``ArchConfig.param_count`` equals the JAX package's (which, in both
    packages, counts a ``StackedLM`` of the config, also for whisper); the
    built model's parameters equal the JAX package's init leaf for leaf."""
    assert get_config(arch).param_count() == jget_config(arch).param_count()
    cfg, jcfg = get_config(arch, smoke=True), jget_config(arch, smoke=True)
    assert cfg.param_count() == jcfg.param_count()
    shapes = jax.eval_shape(lambda k: _jmodel(jcfg).init(k)[0],
                            jax.random.PRNGKey(0))
    model = build_model(cfg, device="meta")
    want = {jax.tree_util.keystr(p): tuple(s.shape) for p, s in
            jax.tree_util.tree_leaves_with_path(shapes)}
    got = {}
    for name, p in model.named_parameters():
        path, layer = _reference_path(cfg, name)
        key = "".join(f"['{k}']" for k in path)
        shape = tuple(p.shape)
        if layer is not None:
            got[key] = (got.get(key, (0,))[0] + 1,) + shape
        else:
            got[key] = shape
    assert got == want


def test_full_width_counts():
    want = {"granite-moe-3b-a800m": 3_298_793_472,
            "mamba2-780m": 780_148_992, "whisper-tiny": 27_007_104,
            "recurrentgemma-9b": 9_396_408_320,
            "phi-3-vision-4.2b": 3_821_079_552,
            "llama4-scout-17b-a16e": 107_769_861_120}
    assert {a: get_config(a).param_count() for a in want} == want
    assert sorted(ARCH_IDS) == sorted(JARCH_IDS)
    # the encoder-decoder model itself: both encoders, both decoders and
    # the 32768-position decoder table
    whisper = WhisperED(get_config("whisper-tiny"), device="meta")
    jshapes = jax.eval_shape(
        lambda k: JWhisperED(jget_config("whisper-tiny")).init(k)[0],
        jax.random.PRNGKey(0))
    assert whisper.param_count() == sum(
        int(np.prod(s.shape)) for s in jax.tree.leaves(jshapes)) \
        == 49_625_472


@pytest.mark.parametrize("arch", NEW)
def test_smoke_train_step_decreases_loss(arch):
    """One small SGD step on the gradient lowers the loss
    (``tests/test_archs.py::test_smoke_train_step_decreases_loss``)."""
    model, cfg = get_model(arch, smoke=True, seed=1, device="cpu")
    rng = np.random.default_rng(1)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(B, S)))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.vlm_patches:
        batch["image_embeds"] = torch.from_numpy(rng.normal(
            size=(B, cfg.vlm_patches, cfg.d_model)).astype(np.float32))
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    loss0, _ = lm_loss(model, cfg, batch)
    grads = torch.autograd.grad(loss0, list(model.parameters()))
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
    assert torch.isfinite(loss0) and torch.isfinite(gnorm) and gnorm > 0
    with torch.no_grad():
        for p, g in zip(model.parameters(), grads):
            p -= 0.01 * g.to(p.dtype)
        loss1, _ = lm_loss(model, cfg, batch)
    assert float(loss1) < float(loss0.detach()), arch


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-780m"])
def test_remat_full_equals_no_remat(arch):
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, size=(2, 24)))
    grads = []
    for remat in ("full", None):
        model = build_model(dataclasses.replace(cfg, remat=remat), seed=3,
                            device="cpu")
        logits, aux = model.apply(tokens)
        grads.append(torch.autograd.grad(
            logits.square().mean() + aux.sum(), list(model.parameters())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_extras_are_pure_in_seed_and_step():
    """The seeded image and frame embeddings of a step do not depend on
    the steps drawn before it, so a restarted run replays them."""
    cfg = get_config("phi-3-vision-4.2b", smoke=True)
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq=8, global_batch=2, seed=4)
    later = ds.extra_arrays(5, cfg)["image_embeds"]
    for s in range(5):
        ds.extra_arrays(s, cfg)
    assert np.array_equal(ds.extra_arrays(5, cfg)["image_embeds"], later)
    assert later.shape == (2, cfg.vlm_patches, cfg.d_model)
    assert not np.array_equal(ds.extra_arrays(6, cfg)["image_embeds"],
                              later)
    wcfg = get_config("whisper-tiny", smoke=True)
    assert set(ds.extra_arrays(0, wcfg)) == {"frames"}
    assert ds.extra_arrays(0, get_config("mamba2-780m", smoke=True)) == {}
