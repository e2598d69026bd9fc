"""The LM substrate's layers, the port against the JAX package on the same
inputs (numpy, fixed seeds): the norms, rotary embeddings, dense products
and MLP, and ``gqa_attention``'s forward and gradients -- the port's
``torch.autograd.Function`` against the JAX package's ``custom_vjp`` --
over the cases of ``tests/test_model_layers.py``.

Tolerances, in f32: forwards rtol 1e-5, atol 1e-6; gradients rtol 1e-4,
atol 1e-5 (a gradient sums over more products).  In bf16 the two
packages round the same f32 values to bf16, so a value may land one bf16
step apart: rtol 2**-7.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as JA  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


@pytest.mark.parametrize("shape,scale_mag", [((4, 32), 1.0), ((2, 5, 64), 8.0)])
def test_rmsnorm_f32(shape, scale_mag):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=shape) * scale_mag).astype(np.float32)
    s = rng.normal(size=shape[-1:]).astype(np.float32)
    want = np.asarray(JL.rmsnorm(jnp.asarray(x), jnp.asarray(s)))
    got = _np(TL.rmsnorm(_t(x), _t(s)))
    np.testing.assert_allclose(got, want, **FWD)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rmsnorm_bf16_branch(seed):
    """The JAX package's branch for a backend without bf16 batched dots:
    the sum of squares in f32, the normalisation in bf16."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(4, 32)) * rng.uniform(0.1, 8)).astype(np.float32)
    s = rng.normal(size=(32,)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(JL.rmsnorm(xj, jnp.asarray(s))).astype(np.float32)
    xt = _t(np.asarray(xj.astype(jnp.float32))).to(torch.bfloat16)
    got = TL.rmsnorm(xt, _t(s))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), want, rtol=2.0 ** -7, atol=0)


def test_layernorm_f32():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 7, 48)).astype(np.float32) * 3 + 1
    s, b = (rng.normal(size=(48,)).astype(np.float32) for _ in range(2))
    want = np.asarray(JL.layernorm(jnp.asarray(x), jnp.asarray(s),
                                   jnp.asarray(b)))
    np.testing.assert_allclose(_np(TL.layernorm(_t(x), _t(s), _t(b))), want,
                               **FWD)


@pytest.mark.parametrize("head_dim,theta", [(8, 10000.0), (64, 500000.0)])
def test_rope_and_apply_rope(head_dim, theta):
    pos = np.arange(48)
    js, jc = JL.rope(jnp.asarray(pos), head_dim, theta)
    ts, tc = TL.rope(_t(pos), head_dim, theta)
    np.testing.assert_allclose(_np(ts), np.asarray(js), **FWD)
    np.testing.assert_allclose(_np(tc), np.asarray(jc), **FWD)
    x = np.random.default_rng(4).normal(
        size=(2, 48, 3, head_dim)).astype(np.float32)
    want = np.asarray(JL.apply_rope(jnp.asarray(x), js, jc))
    got = TL.apply_rope(_t(x), ts, tc)
    np.testing.assert_allclose(_np(got), want, **FWD)


def test_dense_f32():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 9, 40)).astype(np.float32)
    w = rng.normal(size=(40, 24)).astype(np.float32)
    want = np.asarray(JL.dense(jnp.asarray(x), jnp.asarray(w), jnp.float32))
    np.testing.assert_allclose(_np(TL.dense(_t(x), _t(w), torch.float32)),
                               want, **FWD)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("relu", False)])
def test_mlp_apply_f32(act, gated):
    rng = np.random.default_rng(6)
    d, f = 32, 64
    p = {"wi": rng.normal(size=(d, f)) / math.sqrt(d),
         "wo": rng.normal(size=(f, d)) / math.sqrt(f)}
    if gated:
        p["wg"] = rng.normal(size=(d, f)) / math.sqrt(d)
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(2, 6, d)).astype(np.float32)
    want = np.asarray(JL.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), act=act,
                                   compute_dtype=jnp.float32))
    mod = TL.mlp_init(TL.ParamInit(), d, f, gated=gated)
    with torch.no_grad():
        for k, v in p.items():
            getattr(mod, k).copy_(_t(v))
    got = TL.mlp_apply(mod, _t(x), act=act, compute_dtype=torch.float32)
    np.testing.assert_allclose(_np(got), want, **FWD)


def test_param_init_scales_and_determinism():
    """``1/sqrt(fan_in)`` with fan_in = shape[-2] (the JAX package's
    rule), 0.02 for the embedding, and the same draw from the same seed."""
    def build():
        pi = TL.ParamInit()
        mod = torch.nn.Module()
        mod.w = pi.normal((512, 8, 64))
        mod.e = TL.embed_init(pi, 4096, 64)
        mod.b = pi.zeros((64,))
        mod.s = pi.ones((64,))
        TL.ParamInit.fill(mod, 7)
        return mod

    a, b = build(), build()
    for name, p in a.named_parameters():
        assert torch.equal(p, getattr(b, name))
    with torch.no_grad():
        assert abs(float(a.w.std()) - 1 / math.sqrt(8)) < 0.01
        assert abs(float(a.e.std()) - 0.02) < 0.001
        assert float(a.b.abs().max()) == 0
        assert float((a.s - 1).abs().max()) == 0


# ------------------------------------------------------------- attention
CASES = [  # tests/test_model_layers.py's cases
    (32, 4, 2, 16, True, None, 8, 8),
    (48, 4, 1, 8, True, 12, 16, 8),
    (40, 6, 3, 16, False, None, 64, 64),   # no padding path
    (33, 2, 2, 8, True, None, 8, 16),      # ragged seq
]


@pytest.mark.parametrize("Sq,H,Hkv,D,causal,window,cq,ck", CASES)
def test_gqa_attention_forward_and_grads(Sq, H, Hkv, D, causal, window, cq,
                                         ck):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(2, Sq, H, D)).astype(np.float32)
    k = rng.normal(size=(2, Sq, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(2, Sq, Hkv, D)).astype(np.float32)
    ct = rng.normal(size=(2, Sq, H, D)).astype(np.float32)  # cotangent
    kw = dict(causal=causal, window=window, q_chunk=cq, kv_chunk=ck)

    def jfn(q, k, v):
        out = JA.gqa_attention(q, k, v, jnp.arange(Sq), jnp.arange(Sq),
                               compute_dtype=jnp.float32, **kw)
        return jnp.sum(out * ct), out

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    tout = TA.gqa_attention(tq, tk, tv, torch.arange(Sq), torch.arange(Sq),
                            compute_dtype=torch.float32, **kw)
    np.testing.assert_allclose(_np(tout), np.asarray(jout), **FWD)
    tgrads = torch.autograd.grad(torch.sum(tout * _t(ct)), (tq, tk, tv))
    for name, got, want in zip("qkv", tgrads, jgrads):
        np.testing.assert_allclose(_np(got), np.asarray(want), **GRAD,
                                   err_msg=f"d{name}")


def test_gqa_attention_bf16_close_to_f32():
    """In bf16 each package stays near its own f32 answer, and the two
    stay near each other."""
    rng = np.random.default_rng(1)
    Sq, H, Hkv, D = 40, 4, 2, 16
    q, k, v = (rng.normal(size=(2, Sq, h, D)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    kw = dict(causal=True, q_chunk=16, kv_chunk=16)
    outs = {}
    for dt_name, jdt, tdt in (("f32", jnp.float32, torch.float32),
                              ("bf16", jnp.bfloat16, torch.bfloat16)):
        outs["j" + dt_name] = np.asarray(JA.gqa_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.arange(Sq),
            jnp.arange(Sq), compute_dtype=jdt, **kw)).astype(np.float32)
        outs["t" + dt_name] = _np(TA.gqa_attention(
            _t(q), _t(k), _t(v), torch.arange(Sq), torch.arange(Sq),
            compute_dtype=tdt, **kw))
    for pkg in "jt":
        np.testing.assert_allclose(outs[pkg + "bf16"], outs[pkg + "f32"],
                                   atol=5e-2)
    np.testing.assert_allclose(outs["tbf16"], outs["jbf16"], atol=5e-2)


def test_attention_backward_recomputes_blocks_from_lse(monkeypatch):
    """The backward runs the blockwise recompute (``_flash_bwd``) on the
    saved ``lse``; nothing of the forward's blocks is kept."""
    calls = []
    real = TA._flash_bwd

    def spy(do, q, k, v, pos_q, pos_k, out, lse, **kw):
        calls.append((tuple(lse.shape), lse.dtype, kw["nq"], kw["nk"]))
        return real(do, q, k, v, pos_q, pos_k, out, lse, **kw)

    monkeypatch.setattr(TA, "_flash_bwd", spy)
    q = torch.randn(1, 24, 4, 8, requires_grad=True)
    k = torch.randn(1, 24, 2, 8, requires_grad=True)
    out = TA.gqa_attention(q, k, k, torch.arange(24), torch.arange(24),
                           q_chunk=8, kv_chunk=8,
                           compute_dtype=torch.float32)
    out.sum().backward()
    assert calls == [((1, 4, 24), torch.float32, 3, 3)]
