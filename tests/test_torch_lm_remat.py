"""The dot-saving remat policies, the port against itself and against the
JAX package: ``"full"``, ``"dots"`` and ``"dots_no_batch"`` over each
remat period of ``StackedLM`` and of Whisper's encoder and decoder layers
(``models/transformer.py::_remat_policy``/``_remat_wrap``).

What is held, and to which bar:

  * the numbers do not move: under each policy the loss and every
    gradient equal ``"full"``'s bit for bit, for the ten archs' smoke
    configs at their own dtypes (the recompute runs the same products on
    the same inputs, or reads the kept ones);
  * what a period keeps -- its input and the products the policy saves --
    equals the JAX package's residuals for the same config and policy
    (``jax.ad_checkpoint.print_saved_residuals``' ``output of scan``
    rows, divided over the period axis), by dtype and total bytes;
  * the loss and gradients under ``"dots_no_batch"`` agree with the JAX
    package's under the same policy, at f32 compute, at the bars of
    ``tests/test_torch_lm_archs.py`` (loss rtol 1e-5, gradients rtol 1e-4
    with an elementwise floor of 1e-4 x max|want| and at least twice the
    JAX package's own displacement when each parameter moves by 1 +-
    2e-7);
  * the products recomputed in the backward follow the policy
    (``FlopCounterMode``).

Deliberate differences, each with its own test below:

  * under ``"dots"`` Mamba-2 keeps one f32 (B, Q, H, N) and one f32
    (B, Q, H, P) tensor a chunk fewer: the JAX package's three-operand
    einsums ``btn,bth,bhnp->bthp`` and ``bsn,bsh,bshp->bhnp`` lower to two
    ``dot_general`` each, and the first of each -- C_t times exp(L_t),
    x_s times its decay weight, with batch dimensions only -- is a dot to
    ``checkpoint_dots``; in the port they are elementwise products,
    recomputed;
  * a ``StackedLM`` period also takes the (2,) f32 auxiliary-loss
    accumulator, which the checkpoint holds (8 bytes a period; the JAX
    package's scan carries it unsaved); Whisper's decoder layers take
    the encoder's output, one tensor held once for every layer (the JAX
    package closes over it).
"""
import collections
import contextlib
import dataclasses
import importlib.util
import io
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax.ad_checkpoint import print_saved_residuals  # noqa: E402
from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.models.transformer import StackedLM as JStackedLM  # noqa: E402
from repro.models.whisper import WhisperED as JWhisperED  # noqa: E402
from repro_torch.data.pipeline import SyntheticLMDataset  # noqa: E402
from repro_torch.launch import train as TR  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.launch.steps import (  # noqa: E402
    lm_loss,
    make_placed_train_step,
    make_train_step,
)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    from_reference_arrays,
    to_reference_arrays,
)
from repro_torch.models.registry import (  # noqa: E402
    ARCH_IDS,
    build_model,
    get_config,
)
from repro_torch.models.transformer import StackedLM  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.parallel.placement import gather  # noqa: E402

POLICIES = ["dots", "dots_no_batch"]
RESIDUAL_ARCHS = ["llama3.2-1b", "granite-moe-3b-a800m", "mamba2-780m",
                  "recurrentgemma-9b", "phi-3-vision-4.2b", "whisper-tiny"]
# the batch of the residual comparison: B differs from every smoke
# config's period count, so a stacked row is told from an unstacked one
RB, RS = 3, 48
B, S = 2, 32
FLOOR = 1e-4   # x max|want|, as tests/test_torch_lm_archs.py
NUDGE = 2e-7
_BYTES = {"bf16": 2, "f32": 4}
_NAMES = {torch.bfloat16: "bf16", torch.float32: "f32"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps several
    test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_cpu_dots(monkeypatch):
    """The JAX package's CPU products: importing its ``launch/dryrun.py``
    (as ``tests/test_launch.py`` does in the same process) sets
    ``REPRO_STRICT_BF16_DOTS=1`` for the TPU-faithful lowering, which
    turns its norms' sums into dots and changes the residuals it keeps."""
    monkeypatch.delenv("REPRO_STRICT_BF16_DOTS", raising=False)


def _batch(cfg, *, b=B, s=S, seed=1):
    """Seeded tokens and labels, and the config's extras, from numpy."""
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, size=(b, s)))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, dims=1)}
    if cfg.vlm_patches:
        batch["image_embeds"] = torch.from_numpy(rng.normal(
            size=(b, cfg.vlm_patches, cfg.d_model)).astype(np.float32))
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(b, cfg.enc_frames, cfg.d_model)).astype(np.float32))
    return batch


def _loss_and_grads(cfg, batch, seed=3):
    model = build_model(cfg, seed=seed, device="cpu")
    loss, _ = lm_loss(model, cfg, batch)
    return loss.detach(), torch.autograd.grad(loss, list(model.parameters()))


# ----------------------------------------------------------------------
# (a) the numbers do not move
# ----------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_policy_equals_full_bit_for_bit(arch, policy):
    """Loss and every gradient under the policy equal ``"full"``'s bit for
    bit (bar: ``torch.equal``), at the smoke config's own dtypes."""
    cfg = get_config(arch, smoke=True)
    batch = _batch(cfg)
    want_loss, want = _loss_and_grads(cfg, batch)
    got_loss, got = _loss_and_grads(dataclasses.replace(cfg, remat=policy),
                                    batch)
    assert torch.equal(got_loss, want_loss)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_dots_equals_full_and_none_on_whisper_f32():
    """The encoder-decoder at f32 compute: every policy and None agree."""
    cfg = dataclasses.replace(get_config("whisper-tiny", smoke=True),
                              compute_dtype=torch.float32)
    batch = _batch(cfg)
    want_loss, want = _loss_and_grads(cfg, batch)
    for remat in ("dots", "dots_no_batch", None):
        got_loss, got = _loss_and_grads(dataclasses.replace(cfg, remat=remat),
                                        batch)
        assert torch.equal(got_loss, want_loss), remat
        for a, b in zip(got, want):
            assert torch.equal(a, b), remat


# ----------------------------------------------------------------------
# (b) what a period keeps, against the JAX package's residuals
# ----------------------------------------------------------------------


def _jax_kept(cfg):
    """Per scanned body (``transformer`` for a ``StackedLM``, ``enc`` and
    ``dec`` for Whisper): dtype -> bytes a period, from the ``output of
    scan`` rows whose leading axis is the period axis, for the JAX
    config ``cfg`` at the residual batch."""
    model = JWhisperED(cfg) if cfg.enc_dec else JStackedLM(cfg)
    params, _ = model.init(jax.random.PRNGKey(0))
    tokens = jnp.zeros((RB, RS), jnp.int32)
    kw = {}
    if cfg.vlm_patches:
        kw["image_embeds"] = jnp.zeros((RB, cfg.vlm_patches, cfg.d_model))
    if cfg.enc_dec:
        kw["frames"] = jnp.zeros((RB, cfg.enc_frames, cfg.d_model))

    def f(p):
        logits, aux = model.apply(p, tokens, **kw)
        return logits.astype(jnp.float32).sum() + aux.sum()

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        print_saved_residuals(f, params)
    periods = cfg.n_layers if cfg.enc_dec else cfg.n_periods
    kept = collections.defaultdict(collections.Counter)
    for line in out.getvalue().splitlines():
        m = re.match(r"(\w+)\[([\d,]*)\] output of scan", line)
        if not m:
            continue
        shape = [int(d) for d in m.group(2).split(",") if d]
        if not shape or shape[0] != periods:
            continue  # the last period's output carry
        body = ("enc" if "encode" in line else
                "dec" if "_dec_body" in line else "transformer")
        kept[body][m.group(1)] += (int(np.prod(shape[1:]))
                                   * _BYTES[m.group(1)])
    return {k: dict(v) for k, v in kept.items()}


def _nbytes(t):
    return t.numel() * t.element_size()


@contextlib.contextmanager
def _record_periods(monkeypatch):
    """Records each checkpointed period of a forward: its arguments, and
    the selective-checkpoint cache it fills (None under ``"full"``)."""
    calls = []
    real_checkpoint = T.checkpoint
    real_contexts = T.create_selective_checkpoint_contexts

    def contexts(policy):
        made = real_contexts(policy)
        calls[-1]["cache"] = made[0].storage
        return made

    def checkpoint(fn, *args, **kw):
        calls.append({"args": args, "cache": None})
        return real_checkpoint(fn, *args, **kw)

    monkeypatch.setattr(T, "checkpoint", checkpoint)
    monkeypatch.setattr(T, "create_selective_checkpoint_contexts", contexts)
    yield calls


def _cached(cache):
    """The tensors a selective-checkpoint cache holds (an operator's
    entries by call index, or in call order)."""
    out = []
    for entries in (cache or {}).values():
        if isinstance(entries, dict):
            entries = entries.values()
        for entry in entries:
            for w in (entry if isinstance(entry, (tuple, list))
                      else [entry]):
                if isinstance(getattr(w, "val", None), torch.Tensor):
                    out.append(w.val)
    return out


def _port_periods(arch, policy, monkeypatch, **over):
    """(config, the recorded periods of one forward at the residual
    batch) for the arch's smoke config under ``policy``."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), remat=policy,
                              **over)
    model = build_model(cfg, device="cpu")
    batch = _batch(cfg, b=RB, s=RS)
    with _record_periods(monkeypatch) as calls:
        lm_loss(model, cfg, batch)
    return cfg, calls


def _port_kept(arch, policy, monkeypatch, **over):
    """Per body, dtype -> bytes a period: the period's input carry and the
    products its cache holds (equal in every period, checked)."""
    cfg, calls = _port_periods(arch, policy, monkeypatch, **over)
    kept = []
    for call in calls:
        c = collections.Counter()
        for t in [call["args"][0]] + _cached(call["cache"]):
            c[_NAMES[t.dtype]] += _nbytes(t)
        kept.append(dict(c))
    if cfg.enc_dec:
        n = cfg.n_layers
        bodies = {"enc": kept[:n], "dec": kept[n:]}
    else:
        bodies = {"transformer": kept}
    for name, per in bodies.items():
        assert per and all(p == per[0] for p in per), (name, per)
    return {name: per[0] for name, per in bodies.items()}


CASES = [(a, p) for a in RESIDUAL_ARCHS for p in ("full",) + tuple(POLICIES)
         if (a, p) != ("mamba2-780m", "dots")]


@pytest.mark.parametrize("arch,policy", CASES)
def test_kept_per_period_equals_jax_residuals(arch, policy, monkeypatch):
    """Bar: equal dtype by dtype, to the byte.  (Mamba-2 under ``dots``
    is the named difference below.)"""
    jcfg = dataclasses.replace(jget_config(arch, smoke=True), remat=policy)
    assert _port_kept(arch, policy, monkeypatch) == _jax_kept(jcfg)


def test_ssd_keeps_two_einsum_intermediates_fewer_under_dots(monkeypatch):
    """The named difference: under ``dots`` the JAX package keeps, per
    chunk, the first ``dot_general`` of each three-operand SSD einsum, an
    f32 (B, Q, H, N) and an f32 (B, Q, H, P); the port keeps everything
    else.  Checked at N = 16 = P and at N = 8, so the two terms are told
    apart (bar: equal to the byte)."""
    for state in (16, 8):
        cfg = dataclasses.replace(get_config("mamba2-780m", smoke=True),
                                  ssm_state=state)
        H = 2 * cfg.d_model // cfg.ssm_headdim
        Q = min(cfg.ssd_chunk, RS)
        nc = -(-RS // Q)
        extra = 4 * RB * nc * Q * H * (state + cfg.ssm_headdim)
        got = _port_kept("mamba2-780m", "dots", monkeypatch,
                         ssm_state=state)["transformer"]
        want = _jax_kept(dataclasses.replace(
            jget_config("mamba2-780m", smoke=True), ssm_state=state,
            remat="dots"))["transformer"]
        assert got["bf16"] == want["bf16"]
        assert got["f32"] + extra == want["f32"]


@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "whisper-tiny"])
def test_period_arguments_besides_the_carry(arch, monkeypatch):
    """The named difference: a ``StackedLM`` period's checkpoint also holds
    the (2,) f32 aux accumulator (a new one each period); each Whisper
    decoder layer's holds the encoder's output, the same tensor for every
    layer; nothing else but parameters."""
    cfg, calls = _port_periods(arch, "dots_no_batch", monkeypatch)
    extra = [[a for a in call["args"][1:] if isinstance(a, torch.Tensor)
              and not isinstance(a, torch.nn.Parameter)] for call in calls]
    if cfg.enc_dec:
        n = cfg.n_layers
        assert all(e == [] for e in extra[:n])
        enc = extra[n][0]
        assert all(len(e) == 1 and e[0] is enc for e in extra[n:])
        assert tuple(enc.shape) == (RB, cfg.enc_frames, cfg.d_model)
    else:
        assert len(calls) == cfg.n_periods
        for e in extra:
            assert len(e) == 1
            assert e[0].dtype == torch.float32 and tuple(e[0].shape) == (2,)
        assert len({id(e[0]) for e in extra}) == len(extra)


# ----------------------------------------------------------------------
# (c) against the JAX package under "dots_no_batch"
# ----------------------------------------------------------------------


def _jloss(model, cfg):
    def loss_fn(params, batch):  # make_train_step's loss
        kw = {}
        if cfg.vlm_patches:
            kw["image_embeds"] = batch["image_embeds"]
        if cfg.enc_dec:
            kw["frames"] = batch["frames"]
        logits, aux = model.apply(params, batch["tokens"], **kw)
        labels = batch["labels"]
        text = logits[:, -labels.shape[1]:]
        lse = jax.nn.logsumexp(text.astype(jnp.float32), axis=-1)
        gold = jnp.take_along_axis(text, labels[..., None], axis=-1
                                   )[..., 0].astype(jnp.float32)
        nll = jnp.mean(lse - gold)
        return nll + cfg.moe_aux_weight * aux[0] + 1e-3 * aux[1]
    return loss_fn


def _pairs(got, want):
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    return [(jax.tree_util.keystr(p), g, w)
            for (p, g), (_, w) in zip(flat_got, flat_want)]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m",
                                  "whisper-tiny"])
def test_dots_no_batch_matches_jax(arch):
    """Loss rtol 1e-5; each gradient rtol 1e-4 with its floor (module
    docstring).  The key bias's gradient is zero in exact arithmetic, so
    both packages are held to zero within the key weights' floor, as
    ``tests/test_torch_lm_archs.py`` holds them."""
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               compute_dtype=jnp.float32,
                               remat="dots_no_batch")
    jmodel = JWhisperED(jcfg) if jcfg.enc_dec else JStackedLM(jcfg)
    params, _ = jmodel.init(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=torch.float32,
                              remat="dots_no_batch")
    batch = JDataset(vocab=cfg.vocab, seq=S, global_batch=B,
                     seed=0).global_batch_arrays(0)
    batch.update(SyntheticLMDataset(vocab=cfg.vocab, seq=S, global_batch=B,
                                    seed=0).extra_arrays(0, cfg))
    grad_fn = jax.jit(jax.value_and_grad(_jloss(jmodel, jcfg)))
    jb = jax.tree.map(jnp.asarray, batch)
    want_loss, want = grad_fn(params, jb)
    rng = np.random.default_rng(1)
    nudged = jax.tree.map(lambda a: a * (1 + NUDGE * rng.choice(
        [-1.0, 1.0], size=a.shape)).astype(np.float32), params)
    _, want_n = grad_fn(nudged, jb)
    host = jax.tree.map(np.asarray, params)
    want = jax.tree.map(np.asarray, want)
    spread = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                          want_n, want)

    model = build_model(cfg, device="cpu")
    from_reference_arrays(model, host)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss, _ = lm_loss(model, cfg, tb)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    got = to_reference_arrays(model, dict(zip(names, grads)))
    sibling = {n: w for n, _, w in _pairs(got, want)}
    for (name, g, w), (_, _, sp) in zip(_pairs(got, want),
                                        _pairs(got, spread)):
        if name.endswith("['bk']"):
            wk = sibling[name[:-len("['bk']")] + "['wk']"]
            scale = max(1e-6, FLOOR * float(np.abs(wk).max()))
            assert float(np.abs(g).max()) <= scale, name
            assert float(np.abs(w).max()) <= scale, name
            continue
        w64 = np.asarray(w, np.float64)
        floor = max(1e-6, FLOOR * float(np.abs(w64).max()),
                    2 * float(np.abs(sp).max()))
        np.testing.assert_allclose(np.asarray(g, np.float64), w64,
                                   rtol=1e-4, atol=floor, err_msg=name)


# ----------------------------------------------------------------------
# (d) what the backward recomputes
# ----------------------------------------------------------------------


class _ProductFlops(torch.utils._python_dispatch.TorchDispatchMode):
    """Sums the forward FLOPs of the products run inside a remat period,
    by their tag: batched or not, and ``residual`` at the period's end
    (read by no backward operation)."""

    def __init__(self):
        super().__init__()
        self.inside = False
        self.flops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.utils.flop_counter import flop_registry
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.inside and func.overloadpacket in T._PRODUCT_OPS:
            batched, residual, end = L.product_tag()
            key = ("dead" if residual and end else
                   "batched" if batched else "no_batch")
            self.flops[key] += flop_registry[func.overloadpacket](
                *args, out_val=out, **kwargs)
        return out


def _step_flops(cfg, batch):
    from torch.utils.flop_counter import FlopCounterMode
    model = build_model(cfg, seed=3, device="cpu")
    with FlopCounterMode(display=False) as fc:
        loss, _ = lm_loss(model, cfg, batch)
        torch.autograd.grad(loss, list(model.parameters()))
    return fc.get_total_flops()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m",
                                  "recurrentgemma-9b", "whisper-tiny"])
def test_recomputed_flops_follow_the_policy(arch, monkeypatch):
    """``FlopCounterMode`` over loss and gradients: ``full`` minus
    ``dots_no_batch`` is the forward FLOPs of the periods' products
    without batch dimensions, ``dots_no_batch`` minus ``dots`` those of
    their batched products, and ``dots`` recomputes no product (it
    equals no remat).  The period's last ``residual`` product is
    recomputed under no policy: the recompute stops before it.  Bar:
    exact integers."""
    cfg = get_config(arch, smoke=True)
    batch = _batch(cfg)
    got = {p: _step_flops(dataclasses.replace(cfg, remat=p), batch)
           for p in ("full", "dots_no_batch", "dots", None)}
    rec = _ProductFlops()
    real = T.checkpoint

    def checkpoint(fn, *args, **kw):
        rec.inside = True
        try:
            return real(fn, *args, **kw)
        finally:
            rec.inside = False

    monkeypatch.setattr(T, "checkpoint", checkpoint)
    model = build_model(dataclasses.replace(cfg, remat="full"), seed=3,
                        device="cpu")
    with torch.no_grad(), rec:
        lm_loss(model, cfg, batch)
    assert rec.flops["no_batch"] > 0 and rec.flops["batched"] > 0
    # granite's period ends in the MoE's combine, whose expert products
    # the backward reads: no residual product there
    assert (rec.flops["dead"] > 0) == (arch != "granite-moe-3b-a800m")
    assert got["full"] - got["dots_no_batch"] == rec.flops["no_batch"]
    assert got["dots_no_batch"] - got["dots"] == rec.flops["batched"]
    assert got["dots"] == got[None]


# ----------------------------------------------------------------------
# (e) names, refusals and the entry points
# ----------------------------------------------------------------------


def test_unknown_policy_raises_key_error():
    cfg = get_config("llama3.2-1b", smoke=True)
    with pytest.raises(KeyError):
        T._remat_policy("bogus")
    tokens = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(KeyError):
        StackedLM(dataclasses.replace(cfg, remat="bogus"),
                  device="cpu").apply(tokens)
    assert T._remat_policy("full") is None


def test_untagged_product_is_refused():
    """A product whose structure the code does not state cannot be held
    to a dot-saving policy: the period raises, never keeps a guess."""
    w = torch.randn(8, 8, requires_grad=True)

    def fn(x):
        return torch.tanh(x @ w)

    x = torch.randn(4, 8, requires_grad=True)
    for policy in POLICIES:
        with pytest.raises(RuntimeError, match="layers.product"):
            T._remat_wrap(fn, policy)(x)
    T._remat_wrap(fn, "full")(x).sum().backward()

    def tagged(x):
        with L.product(False):
            y = x @ w
        return torch.tanh(y)

    want = torch.autograd.grad(torch.tanh(x @ w).sum(), (x, w))
    for policy in POLICIES:
        got = torch.autograd.grad(
            T._remat_wrap(tagged, policy)(x).sum(), (x, w))
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_product_tags_nest_and_reset():
    assert L.product_tag() is None
    with L.product(True):
        assert L.product_tag() == (True, False, False)
        with L.period_end():
            with L.product(False, residual=True):
                assert L.product_tag() == (False, True, True)
            assert L.product_tag() == (True, False, True)
        with L.period_end(False):
            assert L.product_tag() == (True, False, False)
    assert L.product_tag() is None


@pytest.mark.parametrize("arch", ["llama3.2-1b", "whisper-tiny"])
def test_make_train_step_under_dots_no_batch(arch):
    """Three optimiser steps at two micro-batches: the metrics and every
    parameter equal ``"full"``'s bit for bit."""
    base = get_config(arch, smoke=True)
    batches = [_batch(base, seed=s) for s in range(3)]
    out = {}
    for remat in ("full", "dots_no_batch"):
        cfg = dataclasses.replace(base, remat=remat)
        model = build_model(cfg, seed=3, device="cpu")
        step = make_train_step(model, cfg, lr_fn=lambda s: 1e-3, n_micro=2)
        opt = adamw_init(dict(model.named_parameters()))
        metrics = [{k: torch.as_tensor(v).clone()
                    for k, v in step(opt, b).items()} for b in batches]
        out[remat] = (metrics, [p.detach().clone()
                                for p in model.parameters()])
    for a, b in zip(out["full"][0], out["dots_no_batch"][0]):
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    for a, b in zip(out["full"][1], out["dots_no_batch"][1]):
        assert torch.equal(a, b)


def test_placed_train_step_under_dots_no_batch():
    """The placed step on a (data=2, model=2) mesh of host positions:
    losses, gradient norms and every gathered parameter after two steps
    equal ``"full"``'s bit for bit."""
    base = get_config("llama3.2-1b", smoke=True)
    batches = [{k: torch.from_numpy(v) for k, v in SyntheticLMDataset(
        vocab=base.vocab, seq=S, global_batch=4, seed=5
    ).global_batch_arrays(s).items()} for s in range(2)]
    params = dict(build_model(base, seed=3, device="cpu").named_parameters())
    out = {}
    for remat in ("full", "dots_no_batch"):
        cfg = dataclasses.replace(base, remat=remat)
        mesh = make_test_mesh((2, 2), devices=["cpu"] * 4)
        step = make_placed_train_step(
            build_model(cfg, device="meta"), cfg, mesh=mesh,
            params={n: p.detach().clone() for n, p in params.items()},
            lr_fn=lambda s: 1e-3)
        opt = adamw_init(step.params)
        metrics = [step(opt, b) for b in batches]
        out[remat] = ([(m["loss"], m["grad_norm"]) for m in metrics],
                      {n: gather(t) for n, t in step.params.items()})
    for (a, b), (c, d) in zip(out["full"][0], out["dots_no_batch"][0]):
        assert torch.equal(a, c) and torch.equal(b, d)
    for n, t in out["full"][1].items():
        assert torch.equal(t, out["dots_no_batch"][1][n]), n


@pytest.mark.parametrize("entry", ["launch", "example"])
def test_train_entry_points_under_dots_no_batch(entry, tmp_path,
                                                monkeypatch):
    """``launch/train.py::train`` and ``examples/train_lm_torch.py`` take
    the arch's config: with ``remat="dots_no_batch"`` in it, the logged
    history equals ``"full"``'s bit for bit."""
    real = TR.get_config
    hists = {}
    for remat in ("full", "dots_no_batch"):
        monkeypatch.setattr(
            TR, "get_config",
            lambda a, smoke=False, r=remat: dataclasses.replace(
                real(a, smoke), remat=r))
        ckpt = str(tmp_path / f"{entry}-{remat}")
        if entry == "launch":
            _, hist, _ = TR.train(TR.TrainConfig(
                arch="llama3.2-1b", smoke=True, steps=4, global_batch=4,
                seq=S, ckpt_dir=ckpt, ckpt_every=2, log_every=1,
                device="cpu"))
        else:
            path = os.path.join(os.path.dirname(__file__), "..", "examples",
                                "train_lm_torch.py")
            spec = importlib.util.spec_from_file_location("ex_train", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            hist = mod.main(["--arch", "whisper-tiny", "--steps", "8",
                             "--batch", "4", "--seq", str(S), "--ckpt", ckpt,
                             "--device", "cpu"])["history"]
        hists[remat] = [{k: v for k, v in h.items()
                         if k not in ("sec", "straggler")} for h in hist]
    assert hists["full"] == hists["dots_no_batch"]
