"""The tensor layout (``parallel/tensor.py``): the placed train step
under ``mesh_context`` against the JAX package, on meshes of the host
named 4 or 8 times.

The JAX package's ``shard()`` constraints make GSPMD split the
attention's heads, the MLP's hidden layer and the vocabulary over the
``model`` axis (with ``seqshard`` also the residual stream's sequence);
the port writes that layout out, each position computing on its own
shards and explicit collectives joining them.  Held here, at f32 compute
with the JAX package's parameters carried in by ``models/convert.py``:

  * the sublayers -- the vocab-parallel embedding, logits and loss, one
    attention sublayer, one MLP -- equal the JAX package's functions on
    the same inputs at model=2 and 4: llama's split KV heads and (at 4)
    its KV fallback, gemma's MQA, glm4 with 16 padded heads, smollm's
    replicated heads, a vocabulary the model axis does not divide,
    phi-3-vision's image prefix.  The bar is ``allclose(rtol=1e-5)``
    with an absolute floor of ``max(1e-6, 1e-5 x max|want|)``: on unit
    inputs the smoke configs' attention outputs reach 55-63, where f32
    rounding alone moves near-zero elements by more than 1e-6 -- the
    port's unsplit attention already differs from the JAX package's by
    up to 2.9e-6 x max|want|, and splitting the heads adds 2.4e-7 x
    max|want| (partial sums over the positions' heads);
  * the step: loss and grad norm equal the JAX package's jitted step
    (rtol 1e-5 / 1e-4) for the five in-scope smoke configs on (2,2),
    (4,2) and (2,4), with and without ``seqshard``, and every leaf's
    moments and updated parameters the port's one-device step's;
  * bf16 on (4,2) over 3 steps within ``tests/test_distributed.py:127``'s
    bars; a model axis of 1 bit for bit the plain step; every remat
    policy bit for bit ``full``; the collectives; ``mesh_context``; the
    families without a layout raising; a trained state remeshed bit for
    bit and trained on.
"""
import contextlib
import dataclasses
import tempfile
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.launch import steps as JS  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.registry import get_model as j_get_model  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.mesh import (  # noqa: E402
    current_mesh,
    make_test_mesh,
    mesh_context,
)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.registry import build_model, get_model  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.optim.adamw import OptState  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.parallel import tensor as TP  # noqa: E402
from repro_torch.parallel.placement import (  # noqa: E402
    PlacedTensor,
    device_put,
    gather,
)
from repro_torch.runtime.elastic import (  # noqa: E402
    elastic_remesh,
    specs_for_mesh,
)

# name -> (arch, config changes in both packages)
CONFIGS = {
    "llama": ("llama3.2-1b", {}),
    "gemma": ("gemma-2b", {}),
    "glm4-headpad16": ("glm4-9b", {"pad_heads_to": 16}),
    "smollm": ("smollm-360m", {}),
    "phi3v": ("phi-3-vision-4.2b", {}),
    "llama-vocab514": ("llama3.2-1b", {"vocab": 514}),
    "llama-softcap": ("llama3.2-1b", {"logit_softcap": 30.0}),
}
IN_SCOPE = ["llama", "gemma", "glm4-headpad16", "smollm", "phi3v"]
SUBLAYER_CASES = [(n, t) for n in ("llama", "gemma", "glm4-headpad16",
                                   "smollm", "phi3v") for t in (2, 4)]
SUBLAYER_CASES += [("llama-vocab514", 4), ("llama-vocab514", 2),
                   ("llama-softcap", 2)]
B, S = 8, 32
LR = 1e-3
MOMENT_RTOL = 1e-4  # x a leaf's largest moment: the f32 step's per-leaf bar
STEP_ATOL = 1e-3    # x LR: the updated parameters' bar where g is not tiny
ATOL_SCALE = 1e-5  # x max|want|: the elementwise floor, module docstring
OUT_OF_SCOPE = ["granite-moe-3b-a800m", "llama4-scout-17b-a16e",
                "mamba2-780m", "recurrentgemma-9b", "whisper-tiny"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name, dtype=torch.float32):
    arch, kw = CONFIGS[name]
    return dataclasses.replace(get_config(arch, smoke=True),
                               compute_dtype=dtype, **kw)


def _batch(cfg, step=0, batch=B, seq=S):
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq=seq, global_batch=batch,
                            seed=5)
    out = {k: torch.from_numpy(v)
           for k, v in ds.global_batch_arrays(step).items()}
    out.update({k: torch.from_numpy(v)
                for k, v in ds.extra_arrays(step, cfg).items()})
    return out


def _seqshard(cfg):
    return dataclasses.replace(cfg, rules={**(cfg.rules or {}),
                                           "seq_res": "model"})


_REF: dict = {}


def _ref(name):
    """The JAX package's answers for one config at f32 compute, once a
    process: its parameters, its jitted step's metrics on the first
    batch, and its sublayers on fixed inputs (layer 0's attention and
    MLP, the embedding, the logits and the loss)."""
    if name in _REF:
        return _REF[name]
    arch, kw = CONFIGS[name]
    jmodel, jcfg = j_get_model(arch, smoke=True)
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32, **kw)
    jmodel = type(jmodel)(jcfg)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = _cfg(name)
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    metrics = None
    if name in IN_SCOPE:
        jstep = jax.jit(JS.make_train_step(jmodel, jcfg,
                                           lr_fn=lambda s: LR))
        _, _, metrics = jstep(jparams, j_adamw_init(jparams), jbatch)
        metrics = jax.device_get(metrics)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    tokens = batch["tokens"][:2].numpy()
    labels = batch["labels"][:2].numpy()
    image = (batch["image_embeds"][:2].numpy() if cfg.vlm_patches
             else None)
    layer0 = jax.tree.map(lambda a: a[0], jparams["periods"]["slot0"])
    sin, cos = JL.rope(jnp.arange(S), cfg.hd, cfg.rope_theta)
    nvh = cfg.n_heads if cfg.hq_padded != cfg.n_heads else None
    attn, _ = JA.attn_apply(layer0["attn"], jnp.asarray(x), sin, cos,
                            causal=True, q_chunk=cfg.kv_chunk,
                            kv_chunk=cfg.kv_chunk,
                            compute_dtype=jnp.float32, n_valid_heads=nvh)
    mlp = JL.mlp_apply(layer0["ffn"], jnp.asarray(x), act=cfg.act,
                       compute_dtype=jnp.float32)
    emb = jmodel._embed(jparams, jnp.asarray(tokens),
                        None if image is None else jnp.asarray(image))
    logits = jmodel._logits(jparams, jnp.asarray(x))
    lse = jax.nn.logsumexp(logits.astype(jnp.float32), axis=-1)
    gold = jnp.take_along_axis(logits, jnp.asarray(labels)[..., None],
                               axis=-1)[..., 0].astype(jnp.float32)
    _REF[name] = out = {
        "params": jax.device_get(jparams), "metrics": metrics,
        "batch": batch, "x": x, "tokens": tokens, "labels": labels,
        "image": image, "attn": np.asarray(attn), "mlp": np.asarray(mlp),
        "embed": np.asarray(emb), "logits": np.asarray(logits),
        "loss": float(jnp.mean(lse - gold))}
    return out


def _port_model(name, dtype=torch.float32):
    cfg = _cfg(name, dtype)
    model = build_model(cfg, device="cpu")
    convert.from_reference_arrays(model, _ref(name)["params"])
    return model, cfg


def _group(model, cfg, t, *, seq=S, batch=2):
    """One data index's positions along a (1, t) model axis of the host:
    the layout, its views of ``model``'s parameters, the group."""
    mesh = make_test_mesh((1, t), devices=["cpu"] * t)
    logical = {n: p.logical for n, p in model.named_parameters()}
    values = {n: p.detach() for n, p in model.named_parameters()}
    sh = specs_for_mesh(logical, values, mesh, cfg.rules)
    placed = {n: device_put(values[n], sh[n]) for n in values}
    layout = TP.TensorLayout(model, cfg, mesh, sh, [(0, 0)])
    row = layout.groups[0]
    views = [layout.view(layout.leaves(placed, c), c) for c in row]
    return TP.Group(layout, row, views, batch=batch, seq=seq)


def _inputs(group, x):
    """A residual-stream tensor as the positions hold it: copies, or each
    position's block of the sequence under ``seqshard``."""
    if not group.seqshard:
        return [x.clone() for _ in range(group.size)]
    return list(torch.chunk(x, group.size, dim=1))


def _whole(group, outs):
    """The positions' residual-stream parts as one tensor: each copy
    equal (held), or the blocks concatenated."""
    if group.seqshard:
        return torch.cat(outs, dim=1)
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    return outs[0]


def _close(got, want):
    """``allclose(rtol=1e-5, atol=1e-6)`` with the absolute floor scaled
    to the tensor's largest magnitude (see the module docstring)."""
    want = np.asarray(want)
    atol = max(1e-6, ATOL_SCALE * float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=atol)


# ---------------------------------------------------------------- sublayers
@pytest.mark.parametrize("seqshard", [False, True])
@pytest.mark.parametrize("name,t", SUBLAYER_CASES)
def test_attention_sublayer_equals_jax(name, t, seqshard):
    """Layer 0's attention on the position's view (its query heads at
    their global offset, the KV heads they read), joined into the
    residual's layout, with the output bias added once."""
    ref = _ref(name)
    model, cfg = _port_model(name)
    if seqshard:
        cfg = _seqshard(cfg)
    group = _group(model, cfg, t)
    assert group.seqshard == seqshard
    hs = group.to_mixer(_inputs(group, torch.from_numpy(ref["x"])))
    sin, cos = L.rope(torch.arange(S), cfg.hd, cfg.rope_theta)
    nvh = cfg.n_heads if cfg.hq_padded != cfg.n_heads else None
    outs = [A.attn_apply(v.layers[0].attn, h, sin, cos, causal=True,
                         q_chunk=cfg.kv_chunk, kv_chunk=cfg.kv_chunk,
                         compute_dtype=torch.float32,
                         n_valid_heads=nvh)[0]
            for v, h in zip(group.views, hs)]
    outs = group.join(outs, group.split["attn"])
    if group.views[0].layers[0].attn_bo is not None:
        outs = [o + v.layers[0].attn_bo for o, v in zip(outs, group.views)]
    _close(_whole(group, outs), ref["attn"])


@pytest.mark.parametrize("seqshard", [False, True])
@pytest.mark.parametrize("name,t", SUBLAYER_CASES)
def test_mlp_sublayer_equals_jax(name, t, seqshard):
    """Layer 0's MLP on the position's columns of ``wi``/``wg`` and rows
    of ``wo``, the partial sums joined."""
    ref = _ref(name)
    model, cfg = _port_model(name)
    if seqshard:
        cfg = _seqshard(cfg)
    group = _group(model, cfg, t)
    assert group.split["mlp"]
    hs = group.to_mixer(_inputs(group, torch.from_numpy(ref["x"])))
    outs = [L.mlp_apply(v.layers[0].ffn, h, act=cfg.act,
                        compute_dtype=torch.float32)
            for v, h in zip(group.views, hs)]
    _close(_whole(group, group.join(outs, group.split["mlp"])), ref["mlp"])


@pytest.mark.parametrize("seqshard", [False, True])
@pytest.mark.parametrize("name,t", SUBLAYER_CASES)
def test_vocab_parallel_embedding_equals_jax(name, t, seqshard):
    """Each position's rows looked up, the other ids masked to zero, the
    parts joined; a VLM's image prefix before the text."""
    ref = _ref(name)
    model, cfg = _port_model(name)
    if seqshard:
        cfg = _seqshard(cfg)
    seq = S + cfg.vlm_patches
    group = _group(model, cfg, t, seq=seq)
    assert group.split["vocab"] == (cfg.vocab % t == 0)
    tok = torch.from_numpy(ref["tokens"])
    img = (None if ref["image"] is None
           else [torch.from_numpy(ref["image"])] * t)
    _close(_whole(group, group.embed([tok] * t, img)), ref["embed"])


@pytest.mark.parametrize("seqshard", [False, True])
@pytest.mark.parametrize("name,t", SUBLAYER_CASES)
def test_vocab_parallel_logits_and_loss_equal_jax(name, t, seqshard):
    """The final norm and the logits over each position's vocabulary rows
    (softcapped first), and the loss from them: the maximum across
    positions, the exp-sums all-reduced in f32, the gold logit from its
    owner -- ``steps.lm_loss``'s ``lse - gold``.  A vocabulary the model
    axis does not divide is scored whole at the first position."""
    ref = _ref(name)
    model, cfg = _port_model(name)
    if seqshard:
        cfg = _seqshard(cfg)
    group = _group(model, cfg, t)
    xs = _inputs(group, torch.from_numpy(ref["x"]))
    parts = group.logits(model._norm, xs)
    if group.split["vocab"]:
        whole = torch.cat(parts, dim=-1)
    else:
        assert all(p is None for p in parts[1:])
        whole = parts[0]
    _close(whole, ref["logits"])
    labels = torch.from_numpy(ref["labels"])
    loss, nll = group.loss(parts, [labels] * t,
                           torch.zeros(2, dtype=torch.float32))
    np.testing.assert_allclose(float(nll.detach()), ref["loss"], rtol=1e-5)
    assert torch.equal(loss, nll)


# -------------------------------------------------------------- the step
def _placed(cfg, params, shape, batches, *, ambient=True, lr=LR):
    mesh = make_test_mesh(shape, devices=["cpu"] * int(np.prod(shape)))
    with mesh_context(mesh) if ambient else contextlib.nullcontext():
        step = TS.make_placed_train_step(build_model(cfg, device="meta"),
                                         cfg, mesh=mesh, params=params,
                                         lr_fn=lambda s: lr)
    opt = adamw_init(step.params)
    return [step(opt, b) for b in batches], opt, step


_ONE: dict = {}


def _one_device_f32(name):
    """The port's one-device step on the JAX package's parameters and the
    first batch, once a process: the parameters before and after, and
    the moments."""
    if name not in _ONE:
        model, cfg = _port_model(name)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = adamw_init(dict(model.named_parameters()))
        TS.make_train_step(model, cfg, lr_fn=lambda s: LR)(
            opt, _ref(name)["batch"])
        _ONE[name] = {"before": before, "mu": opt.mu, "nu": opt.nu,
                      "after": {n: p.detach().clone()
                                for n, p in model.named_parameters()}}
    return _ONE[name]


@pytest.mark.parametrize("seqshard", [False, True])
@pytest.mark.parametrize("shape", [(2, 2), (4, 2), (2, 4)])
@pytest.mark.parametrize("name", IN_SCOPE)
def test_tensor_step_equals_the_jax_step_f32(name, shape, seqshard):
    """The JAX package's parameters, f32 compute: the tensor layout's
    loss and grad norm equal the JAX package's step on the same
    parameters and batch (rtol 1e-5 / 1e-4), and every leaf's state after
    the step equals the port's one-device step's -- which the loss and the
    global norm alone cannot show: a wrong sum or a misplaced shard on a
    small leaf (a norm scale, a bias, the KV fallback's sliced heads)
    moves the norm by less than 1e-4.

      * the moments, a tenth of the clipped gradient and a twentieth of its
        square, within ``MOMENT_RTOL`` of the leaf's largest element
        (measured: at most 1.3e-5 and 2.1e-5 over the thirty cases);
      * the updated parameters within ``STEP_ATOL`` x the learning rate
        where the gradient is at least 1e-2 of the leaf's largest and
        1e-5 (a first moment of 1e-6): AdamW's first step is
        ``g / (|g| + 1e-8)``, a sign within 1e-3 there and rounding noise
        where the gradient is tiny (measured: at most 1.2e-4 x the
        learning rate, the rounding of parameters near 1)."""
    ref = _ref(name)
    one = _one_device_f32(name)
    cfg = _cfg(name)
    if seqshard:
        cfg = _seqshard(cfg)
    params = {n: p.clone() for n, p in one["before"].items()}
    got, opt, step = _placed(cfg, params, shape, [ref["batch"]])
    assert step.layout == "tensor"
    np.testing.assert_allclose(float(got[0]["loss"]),
                               float(ref["metrics"]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got[0]["grad_norm"]),
                               float(ref["metrics"]["grad_norm"]), rtol=1e-4)
    for n in params:
        for part, tree in (("mu", opt.mu), ("nu", opt.nu)):
            want = one[part][n]
            gap = float((gather(tree[n]) - want).abs().max())
            assert gap <= MOMENT_RTOL * float(want.abs().max()), (n, part, gap)
        mu = one["mu"][n].abs()
        scored = (mu >= 1e-2 * mu.max()) & (mu >= 1e-6)
        gap = (gather(step.params[n]) - one["after"][n]).abs()[scored]
        if gap.numel():
            assert float(gap.max()) <= STEP_ATOL * LR, (n, float(gap.max()))


def _smoke_state(arch="llama3.2-1b", dtype=None, **kw):
    model, cfg = get_model(arch, smoke=True, seed=0, device="cpu")
    if dtype is not None or kw:
        cfg = dataclasses.replace(cfg, **kw, **(
            {} if dtype is None else {"compute_dtype": dtype}))
        model = build_model(cfg, seed=0, device="cpu")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    return model, cfg, params


def _one_device(model, cfg, batches):
    opt = adamw_init(dict(model.named_parameters()))
    step = TS.make_train_step(model, cfg, lr_fn=lambda s: LR)
    return [step(opt, b) for b in batches], opt


@pytest.mark.parametrize("seqshard", [False, True])
def test_tensor_step_4x2_bf16_meets_the_jax_bars(seqshard):
    """``tests/test_distributed.py:127``: (data=4, model=2) against one
    device at bf16 compute, loss rtol 5e-3 and parameters max-abs 5e-2,
    here over 3 steps."""
    model, cfg, params = _smoke_state()
    batches = [_batch(cfg, s) for s in range(3)]
    want, _ = _one_device(model, cfg, batches)
    got, _, step = _placed(_seqshard(cfg) if seqshard else cfg, params,
                           (4, 2), batches)
    assert step.layout == "tensor"
    assert step.data_positions == [(0, 0), (1, 0), (2, 0), (3, 0)]
    for a, b in zip(want, got):
        np.testing.assert_allclose(float(b["loss"]), float(a["loss"]),
                                   rtol=5e-3)
    worst = max(float((gather(step.params[n]) - p.detach()).abs().max())
                for n, p in model.named_parameters())
    assert worst < 5e-2, worst


@pytest.mark.parametrize("shape", [(1, 1), (4, 1)])
def test_model_axis_of_one_is_the_plain_step(shape):
    """Under an ambient mesh whose model axis is 1 the tensor layout
    splits nothing: bit for bit the storage schedule on the same mesh
    over 2 steps (losses, grad norms, parameters, moments), and on one
    position bit for bit the one-device step."""
    model, cfg, params = _smoke_state()
    batches = [_batch(cfg, s) for s in range(2)]
    runs = {}
    for ambient in (False, True):
        got, opt, step = _placed(cfg, params, shape, batches,
                                 ambient=ambient)
        assert step.layout == ("tensor" if ambient else "storage")
        runs[ambient] = (got, opt, step)
    (g0, o0, s0), (g1, o1, s1) = runs[False], runs[True]
    for a, b in zip(g0, g1):
        for k in ("loss", "nll", "grad_norm", "aux_load", "aux_z"):
            assert torch.equal(a[k], b[k]), k
    for n in params:
        assert torch.equal(gather(s0.params[n]), gather(s1.params[n])), n
        assert torch.equal(gather(o0.mu[n]), gather(o1.mu[n])), n
        assert torch.equal(gather(o0.nu[n]), gather(o1.nu[n])), n
    if shape == (1, 1):
        want, opt = _one_device(model, cfg, batches)
        for a, b in zip(want, g1):
            assert torch.equal(a["loss"], b["loss"])
            assert torch.equal(a["grad_norm"], b["grad_norm"])
        for n, p in model.named_parameters():
            assert torch.equal(gather(s1.params[n]), p.detach()), n
            assert torch.equal(gather(o1.mu[n]), opt.mu[n]), n


@pytest.mark.parametrize("seqshard", [False, True])
def test_tensor_step_micro_batches_equal_the_plain_step(seqshard):
    """``n_micro=2`` under the tensor layout on (2,2), f32: each data
    index's gradients accumulated over its two micro-batches in f32 and
    averaged, as the plain step does -- loss and grad norm within rtol
    1e-5 / 1e-4 of ``make_train_step(n_micro=2)``."""
    model, cfg, params = _smoke_state(dtype=torch.float32)
    batch = _batch(cfg)
    opt = adamw_init(dict(model.named_parameters()))
    want = TS.make_train_step(model, cfg, lr_fn=lambda s: LR,
                              n_micro=2)(opt, batch)
    c = _seqshard(cfg) if seqshard else cfg
    mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
    with mesh_context(mesh):
        step = TS.make_placed_train_step(build_model(c, device="meta"), c,
                                         mesh=mesh, params=params,
                                         lr_fn=lambda s: LR, n_micro=2)
    popt = adamw_init(step.params)
    with collectives.record_collectives() as notes:
        got = step(popt, batch)
    with collectives.record_collectives() as dry:
        step.communicate(batch)
    assert sorted(dry) == sorted(notes)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(want["grad_norm"]), rtol=1e-4)


@pytest.mark.parametrize("seqshard", [False, True])
@pytest.mark.parametrize("policy", ["dots", "dots_no_batch"])
def test_remat_policies_bit_for_bit_full_under_the_layout(policy, seqshard):
    """Each remat policy under the tensor layout on (2,2): the loss, grad
    norm, first moments (a tenth of the clipped gradients) and updated
    parameters equal ``full``'s under the same layout bit for bit."""
    runs = {}
    for p in ("full", policy):
        _, cfg, params = _smoke_state(dtype=torch.float32, remat=p)
        if seqshard:
            cfg = _seqshard(cfg)
        runs[p] = _placed(cfg, params, (2, 2), [_batch(cfg)])
    (ga, oa, sa), (gb, ob, sb) = runs["full"], runs[policy]
    assert torch.equal(ga[0]["loss"], gb[0]["loss"])
    assert torch.equal(ga[0]["grad_norm"], gb[0]["grad_norm"])
    for n in sa.params:
        assert torch.equal(gather(oa.mu[n]), gather(ob.mu[n])), n
        assert torch.equal(gather(sa.params[n]), gather(sb.params[n])), n


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_tensor_step_logs_the_global_activation_fallbacks(shape):
    """A tensor step resolves each activation at its global size, in the
    forward and in the backward's recompute alike, so its ``"act"``
    fallbacks are the plain forward's under the same ambient mesh (the
    JAX package's, which resolves the global activations): llama smoke's
    2 KV heads on a 4-way model axis, nothing on a 2-way one -- never a
    position's part (1 KV head, 2 query heads)."""
    from repro_torch.parallel import sharding as TSH

    model, cfg, params = _smoke_state()
    batch = _batch(cfg)
    mesh = make_test_mesh(shape, devices=["cpu"] * 4)

    def act():
        return {e for e in TSH.fallback_log if e[0] == "act"}

    TSH.fallback_log.clear()
    with mesh_context(mesh):
        loss, _ = TS.lm_loss(model, cfg, batch)
        loss.backward()
    want = act()
    assert want == ({("act", "kv_heads", 2, "model")} if shape == (1, 4)
                    else set())
    TSH.fallback_log.clear()
    _placed(cfg, params, shape, [batch])
    assert act() == want
    TSH.fallback_log.clear()


# -------------------------------------------------------- the collectives
@pytest.mark.parametrize("name", ["llama", "phi3v"])
def test_tensor_step_collectives(name):
    """No all-gather carries a whole split parameter (the products run on
    the shards; the only all-gathers are ``seqshard``'s activations);
    ``seqshard`` turns the activations' all-reduce wire bytes into
    reduce-scatter plus all-gather of equal wire bytes and leaves the
    gradients' sums as they were; ``communicate()`` counts exactly what
    the step records."""
    from repro_torch.launch.dryrun import collective_bytes

    model, cfg = _port_model(name)
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = _ref(name)["batch"]
    wire = {}
    for seqshard in (False, True):
        c = _seqshard(cfg) if seqshard else cfg
        mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
        with mesh_context(mesh):
            step = TS.make_placed_train_step(build_model(c, device="meta"),
                                             c, mesh=mesh, params=params,
                                             lr_fn=lambda s: LR)
        opt = adamw_init(step.params)
        with collectives.record_collectives() as notes:
            step(opt, batch)
        with collectives.record_collectives() as dry:
            step.communicate(batch)
        assert sorted(dry) == sorted(notes)
        assert sorted(n.part for n in dry) == sorted(n.part for n in notes)
        # the only all-gathers are the residual stream's sequence: a
        # data index's rows, every position, d_model wide
        rows, seq = B // 2, batch["tokens"].shape[1] + cfg.vlm_patches
        act = rows * seq * cfg.d_model * cfg.compute_dtype.itemsize
        gathers = [n for n in notes if n[0] == "all-gather"]
        assert all(n.part == "activations" and n[1] == act
                   for n in gathers)
        assert bool(gathers) == seqshard
        wire[seqshard] = collective_bytes(notes)["by_part"]
    plain, seq = wire[False], wire[True]
    assert set(plain["activations"]) == {"all-reduce"}
    assert "all-reduce" not in seq["activations"]
    assert seq["activations"]["reduce-scatter"] == \
        seq["activations"]["all-gather"]
    assert (seq["activations"]["reduce-scatter"]
            + seq["activations"]["all-gather"]
            == plain["activations"]["all-reduce"])
    assert seq["gradients"] == plain["gradients"]


def test_position_collectives_and_their_gradients():
    """``all_reduce``, ``all_gather_each``, ``reduce_scatter`` and
    ``all_max`` give every position the same answer, and the first three
    carry the dual collective as their gradient."""
    mesh = make_test_mesh((4,), ("model",), devices=["cpu"] * 4)
    group = collectives.PositionGroup(mesh, [(i,) for i in range(4)])
    gen = torch.Generator().manual_seed(0)
    parts = [torch.randn(3, 8, generator=gen, requires_grad=True)
             for _ in range(4)]
    total = sum(p.detach() for p in parts)
    red = collectives.all_reduce(group, parts)
    assert all(torch.allclose(r, total) for r in red)
    sum(r.sum() * (i + 1) for i, r in enumerate(red)).backward()
    assert all(torch.allclose(p.grad, torch.full_like(p, 10.0))
               for p in parts)
    gat = collectives.all_gather_each(group, [p.detach() for p in parts], 1)
    assert all(torch.equal(g, torch.cat([p.detach() for p in parts], 1))
               for g in gat)
    xs = [p.detach().clone().requires_grad_() for p in parts]
    rs = collectives.reduce_scatter(group, xs, 1)
    for i, r in enumerate(rs):
        assert torch.allclose(r, total[:, 2 * i:2 * i + 2])
    sum(r.sum() for r in rs).backward()
    assert all(torch.equal(x.grad, torch.ones_like(x)) for x in xs)
    mx = collectives.all_max(group, parts)
    want = torch.stack([p.detach() for p in parts]).amax(0)
    assert all(torch.equal(m, want) and not m.requires_grad for m in mx)
    with pytest.raises(ValueError, match="does not split"):
        collectives.reduce_scatter(group, [torch.zeros(3, 6)] * 4, 1)


# ---------------------------------------------------------- mesh_context
def test_mesh_context_sets_clears_nests_and_is_thread_local():
    a = make_test_mesh((2, 2), devices=["cpu"] * 4)
    b = make_test_mesh((1, 4), devices=["cpu"] * 4)
    assert current_mesh() is None
    with mesh_context(a) as got:
        assert got is a and current_mesh() is a
        with mesh_context(b):
            assert current_mesh() is b
            seen = []
            th = threading.Thread(target=lambda: seen.append(current_mesh()))
            th.start()
            th.join()
            assert seen == [None]
        assert current_mesh() is a
    assert current_mesh() is None
    with pytest.raises(RuntimeError):
        with mesh_context(a):
            raise RuntimeError("boom")
    assert current_mesh() is None


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-tiny"])
def test_models_still_move_between_devices(arch):
    """The layout's entry points leave ``nn.Module``'s own machinery
    alone: a ``meta`` model materialises with ``to_empty`` and moves with
    ``to``, as the card's phases build them."""
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg, device="meta").to_empty(device="cpu")
    assert all(p.device.type == "cpu" for p in model.parameters())
    model = model.to(torch.float64)
    assert all(p.dtype == torch.float64 for p in model.parameters())


def test_placed_step_under_another_ambient_mesh_raises():
    _, cfg, params = _smoke_state()
    mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
    other = make_test_mesh((1, 4), devices=["cpu"] * 4)
    with mesh_context(other), pytest.raises(ValueError, match="ambient"):
        TS.make_placed_train_step(build_model(cfg, device="meta"), cfg,
                                  mesh=mesh, params=params,
                                  lr_fn=lambda s: LR)


@pytest.mark.parametrize("arch", OUT_OF_SCOPE)
def test_families_without_a_layout_raise_under_a_mesh(arch):
    """MoE, Mamba-2, the hybrid and Whisper under an ambient mesh with a
    model axis above 1: ``NotImplementedError`` naming the ROADMAP item,
    from the placed step and from the forward; without an ambient mesh
    the storage schedule, as before."""
    model, cfg = get_model(arch, smoke=True, seed=0, device="cpu")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
    with mesh_context(mesh):
        with pytest.raises(NotImplementedError, match="ROADMAP.md item"):
            TS.make_placed_train_step(build_model(cfg, device="meta"), cfg,
                                      mesh=mesh, params=params,
                                      lr_fn=lambda s: LR)
        with pytest.raises(NotImplementedError, match=cfg.family):
            TS.lm_loss(model, cfg, _batch(cfg, batch=2))
    step = TS.make_placed_train_step(build_model(cfg, device="meta"), cfg,
                                     mesh=mesh, params=params,
                                     lr_fn=lambda s: LR)
    assert step.layout == "storage"


def test_serving_under_a_mesh_raises():
    model, cfg = get_model("llama3.2-1b", smoke=True, seed=0, device="cpu")
    tokens = _batch(cfg, batch=2)["tokens"]
    with mesh_context(make_test_mesh((1, 2), devices=["cpu"] * 2)):
        with pytest.raises(NotImplementedError, match="prefill and decode"):
            model.prefill(tokens)
    with mesh_context(make_test_mesh((2, 1), devices=["cpu"] * 2)):
        model.prefill(tokens)  # a model axis of 1: nothing to lay out


# --------------------------------------------------- elastic and restore
def test_tensor_trained_state_remeshes_and_trains_on():
    """A state trained a step under the tensor layout on (2,2) moves
    (2,2) -> (1,4) -> (2,2) through ``elastic_remesh`` bit for bit, and
    restores from a checkpoint placed on (1,4) bit for bit; the moved
    state trains on under the layout on (1,4) as the unmoved one does on
    (2,2) (f32: loss rtol 1e-5)."""
    model, cfg, params = _smoke_state(dtype=torch.float32)
    logical = {n: p.logical for n, p in model.named_parameters()}
    b0, b1 = _batch(cfg, 0), _batch(cfg, 1)
    _, opt, step = _placed(cfg, params, (2, 2), [b0])
    state = {"params": step.params, "mu": opt.mu, "nu": opt.nu,
             "count": {"count": opt.count}}
    want = {part: {n: gather(t) for n, t in tree.items()}
            for part, tree in state.items()}
    tlog = {part: logical for part in ("params", "mu", "nu")}
    tlog["count"] = {"count": ()}
    moved = state
    for shape in ((1, 4), (2, 2), (1, 4)):
        mesh = make_test_mesh(shape, devices=["cpu"] * 4)
        moved = elastic_remesh(moved, tlog, mesh, cfg.rules)
        for part in moved:
            for n, pt in moved[part].items():
                assert isinstance(pt, PlacedTensor)
                assert pt.mesh is mesh
                assert torch.equal(gather(pt), want[part][n]), (shape, n)
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td)
        mgr.save(1, want["params"], blocking=True)
        restored = mgr.restore(1, want["params"], shardings=specs_for_mesh(
            logical, want["params"], mesh, cfg.rules))
    for n, t in restored.items():
        assert torch.equal(gather(t), want["params"][n]), n
    # train on: (2,2) unmoved against (1,4) moved
    cont = step(opt, b1)
    with mesh_context(mesh):
        step14 = TS.make_placed_train_step(
            build_model(cfg, device="meta"), cfg, mesh=mesh,
            params=moved["params"], lr_fn=lambda s: LR)
    opt14 = OptState(mu=moved["mu"], nu=moved["nu"],
                     count=moved["count"]["count"])
    got = step14(opt14, b1)
    assert step14.layout == "tensor"
    np.testing.assert_allclose(float(got["loss"]), float(cont["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]),
                               float(cont["grad_norm"]), rtol=1e-4)
