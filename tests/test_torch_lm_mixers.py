"""The LM substrate's other mixers, the port against the JAX package on the
same inputs (numpy, fixed seeds), in f32 on the CPU: the MoE FFN
(capacity, routing, dispatch, the capacity carry), the chunked SSD and the
Mamba-2 block, the RG-LRU block and its scan, the two-block local
attention and cross-attention -- with the port's own copies of the
reference's properties (``tests/test_model_layers.py``).

Tolerance, for every comparison with the JAX package: rtol 1e-5 with an
absolute floor of 1e-4 x max|want| (the floor measured on the dense f32
logits: each package stands up to 3.6e-5 x max|.| off float64 where the
smoke configs' init saturates).  Against the plain sequential references
of a scan (the recurrence written as a loop) the same rule holds.

The key bias's gradient is zero in exact arithmetic (a bias on every key
shifts each query's scores by one constant, which the softmax cancels), so
both packages return rounding noise there; each is held to zero within
the floor of the key weights' gradient instead.

Routing is compared as ids: the port's top-k expert ids equal the JAX
package's except at tokens whose k-th and (k+1)-th router probabilities
lie within that tolerance of each other.  Those tokens are counted and
printed; a token's treatment depends only on earlier tokens (first come),
so the outputs are compared up to a row's first such token.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.models import attention as JA  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.layers import ParamInit as JParamInit  # noqa: E402
from repro.models.layers import split_tree  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.layers import ParamInit  # noqa: E402

RTOL, FLOOR = 1e-5, 1e-4
F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps several
    test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, what=""):
    got = got.detach().double().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float64)
    atol = max(1e-30, FLOOR * float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=RTOL,
                               atol=atol, err_msg=what)


def _t(a, grad=False):
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.requires_grad_(grad)


def _jparams(init, seed, *args, **kw):
    return split_tree(init(JParamInit(jax.random.PRNGKey(seed)), *args,
                           **kw))[0]


def _port(module, tree):
    """Load the JAX package's parameter dict into the port's module."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            node = tree
            for key in name.split("."):
                node = node[key]
            p.copy_(torch.from_numpy(np.array(node)))
    return module


_PI = ParamInit(torch.float32, "cpu")


# ------------------------------------------------------------------ moe


@pytest.mark.parametrize("S,k,E,cf,want", [
    (14, 2, 4, 1.25, 8),      # cf*S*k/E = 8.75 -> 8: the 8-alignment's floor
    (15, 2, 4, 1.25, 16),     # 9.375 -> 9, aligned up to 16
    (2048, 8, 40, 1.25, 512),  # granite at S 2048
    (4, 2, 8, 1.25, 8),       # below 8: 8 (= A)
    (3, 1, 4, 1.25, 3),       # never above A = S k
    (32, 1, 4, 4.0, 32),      # llama4's smoke capacity factor
    (64, 2, 4, 0.5, 16),
    (1, 8, 40, 1.25, 8),      # one decode token
])
def test_moe_capacity_table(S, k, E, cf, want):
    assert TM.moe_capacity(S, k, E, cf) == JM.moe_capacity(S, k, E, cf) \
        == want


def _router_ids(p, x, k):
    """JAX's top-k ids and probabilities and the port's ids, on the same
    router inputs; and the mask of near-tied tokens."""
    logits = jnp.einsum("bsd,de->bse", jnp.asarray(x),
                        jnp.asarray(p["router"]))
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    jv, je = jax.lax.top_k(probs, k + 1)
    jv, je = np.asarray(jv), np.asarray(je)
    tl = torch.from_numpy(np.array(x)) @ torch.from_numpy(
        np.array(p["router"]))
    _, te = torch.topk(torch.softmax(tl, -1), k, dim=-1)
    gap = jv[..., k - 1] - jv[..., k]
    tie = gap <= RTOL * jv[..., k - 1] + FLOOR * jv.max()
    return je[..., :k], te.numpy(), tie


MOE_CASES = [  # gated, shared_ff, top_k, capacity_factor, seed
    (True, 0, 2, 1.25, 0),
    (True, 16, 1, 4.0, 1),   # llama4-style: top-1 and a shared expert
    (False, 0, 2, 0.5, 2),   # drops
    (True, 0, 3, 1.0, 3),
]


@pytest.mark.parametrize("gated,shared,k,cf,seed", MOE_CASES)
def test_moe_apply_matches_jax(gated, shared, k, cf, seed):
    E, D, Fd = 6, 16, 24
    p = _jparams(JM.moe_init, seed, D, Fd, E, gated=gated, shared_ff=shared)
    x = np.random.default_rng(seed).normal(size=(3, 20, D)).astype(
        np.float32)
    jout, jaux, jcnt = jax.jit(lambda p, x: JM.moe_apply(
        p, x, top_k=k, capacity_factor=cf, compute_dtype=jnp.float32,
        return_counts=True))(p, jnp.asarray(x))
    tp = _port(TM.moe_init(_PI, D, Fd, E, gated=gated, shared_ff=shared), p)
    tout, taux, tcnt = TM.moe_apply(tp, _t(x), top_k=k, capacity_factor=cf,
                                    compute_dtype=F32, return_counts=True)
    je, te, tie = _router_ids(p, x, k)
    print(f"near-tied tokens: {int(tie.sum())} of {tie.size}")
    assert np.array_equal(np.sort(je, -1)[~tie], np.sort(te, -1)[~tie])
    for b in range(x.shape[0]):
        upto = int(np.argmax(tie[b])) if tie[b].any() else x.shape[1]
        close(tout[b, :upto], np.asarray(jout)[b, :upto], f"row {b}")
    if not tie.any():
        assert np.array_equal(tcnt.numpy(), np.asarray(jcnt))
        assert tcnt.dtype == torch.int32
    close(taux["load_loss"], jaux["load_loss"], "load_loss")
    close(taux["z_loss"], jaux["z_loss"], "z_loss")


def test_moe_gradients_match_jax():
    E, D, Fd, k = 4, 8, 16, 2
    p = _jparams(JM.moe_init, 5, D, Fd, E, shared_ff=8)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 12, D)).astype(np.float32)
    ct = rng.normal(size=(2, 12, D)).astype(np.float32)

    def jloss(p, x):
        out, aux = JM.moe_apply(p, x, top_k=k, capacity_factor=1.0,
                                compute_dtype=jnp.float32)
        return (jnp.sum(out * ct) + aux["load_loss"] + aux["z_loss"])

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(p, jnp.asarray(x))
    tp = _port(TM.moe_init(_PI, D, Fd, E, shared_ff=8), p)
    tx = _t(x, grad=True)
    out, aux = TM.moe_apply(tp, tx, top_k=k, capacity_factor=1.0,
                            compute_dtype=F32)
    loss = (out * _t(ct)).sum() + aux["load_loss"] + aux["z_loss"]
    loss.backward()
    close(tx.grad, jgx, "dx")
    for name, t in tp.named_parameters():
        node = jg
        for key in name.split("."):
            node = node[key]
        close(t.grad, node, name)


def _mixture(tp, x, k):
    """The MoE written plainly: every token through every expert, weighted
    by its renormalised top-k gates (no capacity, no dispatch)."""
    probs = torch.softmax(x @ tp.router, -1)
    gv, ge = torch.topk(probs, k, -1)
    gv = gv / gv.sum(-1, keepdim=True)
    ref = torch.zeros_like(x)
    for e in range(tp.router.shape[1]):
        h = torch.nn.functional.silu(x @ tp.wg[e]) * (x @ tp.wi[e])
        w = torch.where(ge == e, gv, 0.0).sum(-1)
        ref = ref + (h @ tp.wo[e]) * w[..., None]
    return ref


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_moe_dispatch_conservation(seed):
    """Capacity at least the assignments: the output is the per-token
    mixture of expert outputs -- no token lost or counted twice
    (``tests/test_model_layers.py::test_moe_dispatch_conservation``)."""
    E, D, Fd, k = 4, 8, 16, 2
    tp = TM.moe_init(ParamInit(F32, "cpu"), D, Fd, E)
    ParamInit.fill(tp, seed)
    x = torch.from_numpy(np.random.default_rng(seed).normal(
        size=(2, 8, D)).astype(np.float32))
    with torch.no_grad():
        out, aux = TM.moe_apply(tp, x, top_k=k, capacity_factor=float(E),
                                compute_dtype=F32)
        ref = _mixture(tp, x, k)
    close(out, ref.numpy())
    assert math.isfinite(float(aux["load_loss"]))


def test_moe_capacity_drops_are_deterministic_and_first_come():
    """Capacity 0.5: the same input drops the same assignments
    (``tests/test_model_layers.py::test_moe_capacity_drops_are_
    deterministic``); and a token's output depends only on earlier
    tokens, so a prefix of the row gives the same outputs."""
    tp = TM.moe_init(ParamInit(F32, "cpu"), 8, 16, 4)
    ParamInit.fill(tp, 7)
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(1, 64, 8)).astype(np.float32))
    with torch.no_grad():
        a, _, cnt = TM.moe_apply(tp, x, top_k=2, capacity_factor=0.5,
                                 compute_dtype=F32, return_counts=True)
        b, _ = TM.moe_apply(tp, x, top_k=2, capacity_factor=0.5,
                            compute_dtype=F32)
        C = TM.moe_capacity(64, 2, 4, 0.5)
        assert int(cnt.max()) > C  # something was dropped
        pre, _ = TM.moe_apply(tp, x[:, :40], top_k=2, capacity=C,
                              compute_dtype=F32)
    assert torch.equal(a, b)
    close(pre, a[:, :40].numpy())


@pytest.mark.parametrize("split", [5, 16, 31])
def test_moe_capacity_carry_two_chunks_equal_one_call(split):
    """Chunk 1 at the full call's capacity returns its pre-drop counts;
    chunk 2 continues first-come positions from them: the two chunks
    give the full call's outputs and counts, drops included; and
    one token at a time with ``capacity_ref`` does too."""
    E, D, Fd, k, S = 4, 8, 16, 2, 32
    tp = TM.moe_init(ParamInit(F32, "cpu"), D, Fd, E)
    ParamInit.fill(tp, 11)
    x = torch.from_numpy(np.random.default_rng(11).normal(
        size=(2, S, D)).astype(np.float32))
    kw = dict(top_k=k, capacity_factor=0.75, compute_dtype=F32)
    C = TM.moe_capacity(S, k, E, 0.75)
    with torch.no_grad():
        full, _, fcnt = TM.moe_apply(tp, x, return_counts=True, **kw)
        o1, _, c1 = TM.moe_apply(tp, x[:, :split], capacity=C,
                                 return_counts=True, **kw)
        o2, _, c2 = TM.moe_apply(tp, x[:, split:], expert_counts=c1,
                                 capacity=C, return_counts=True, **kw)
        assert int(fcnt.max()) > C  # the carry has drops to get right
        close(torch.cat([o1, o2], 1), full.numpy())
        assert torch.equal(c2, fcnt)
        cnt, outs = torch.zeros((2, E), dtype=torch.int32), []
        for t in range(S):
            o, _, cnt = TM.moe_apply(tp, x[:, t:t + 1], expert_counts=cnt,
                                     capacity_ref=torch.tensor(C),
                                     return_counts=True, **kw)
            outs.append(o)
        close(torch.cat(outs, 1), full.numpy())


def test_moe_carry_matches_jax():
    E, D, Fd, k, S = 4, 8, 16, 2, 24
    p = _jparams(JM.moe_init, 12, D, Fd, E)
    x = np.random.default_rng(12).normal(size=(2, S, D)).astype(np.float32)
    cnt0 = np.random.default_rng(13).integers(0, 6, size=(2, E)).astype(
        np.int32)
    jout, _, jcnt = jax.jit(lambda p, x, c: JM.moe_apply(
        p, x, top_k=k, capacity_factor=1.0, compute_dtype=jnp.float32,
        expert_counts=c, capacity=16, return_counts=True))(
            p, jnp.asarray(x), jnp.asarray(cnt0))
    tp = _port(TM.moe_init(_PI, D, Fd, E), p)
    with torch.no_grad():
        tout, _, tcnt = TM.moe_apply(tp, _t(x), top_k=k, capacity_factor=1.0,
                                     compute_dtype=F32,
                                     expert_counts=torch.from_numpy(cnt0),
                                     capacity=16, return_counts=True)
    close(tout, jout)
    assert np.array_equal(tcnt.numpy(), np.asarray(jcnt))


# ------------------------------------------------------------------ ssd


def _ssd_naive(x, dt, Ac, Bm, Cm, s=None):
    """The SSM recurrence as a sequential loop, float64."""
    B, Sq, H, P = x.shape
    N = Bm.shape[-1]
    s = np.zeros((B, H, N, P)) if s is None else np.asarray(s, np.float64)
    ys = np.zeros(x.shape)
    for t in range(Sq):
        dA = np.exp(dt[:, t] * Ac)                            # (B, H)
        s = s * dA[:, :, None, None] + np.einsum(
            "bn,bh,bhp->bhnp", Bm[:, t], dt[:, t], x[:, t])
        ys[:, t] = np.einsum("bn,bhnp->bhp", Cm[:, t], s)
    return ys, s


def _ssd_inputs(Sq, seed=2, B=2, H=3, P=4, N=8, dt_hi=0.5):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, P)).astype(np.float32),
            rng.uniform(0.01, dt_hi, size=(B, Sq, H)).astype(np.float32),
            -rng.uniform(0.5, 2.0, size=(H,)).astype(np.float32),
            rng.normal(size=(B, Sq, N)).astype(np.float32),
            rng.normal(size=(B, Sq, N)).astype(np.float32))


@pytest.mark.parametrize("Sq,chunk", [(16, 4), (20, 8), (32, 32)])
def test_ssd_chunked_matches_naive_recurrence_and_jax(Sq, chunk):
    x, dt, Ac, Bm, Cm = _ssd_inputs(Sq)
    s0 = np.random.default_rng(9).normal(size=(2, 3, 8, 4)).astype(
        np.float32)
    y, s = TS.ssd_chunked(*map(_t, (x, dt, Ac, Bm, Cm)), chunk=chunk,
                          init_state=_t(s0), return_state=True)
    y_ref, s_ref = _ssd_naive(*(a.astype(np.float64)
                                for a in (x, dt, Ac, Bm, Cm)), s=s0)
    close(y, y_ref, "y vs the recurrence")
    close(s, s_ref, "state vs the recurrence")
    jy, js = JS.ssd_chunked(*map(jnp.asarray, (x, dt, Ac, Bm, Cm)),
                            chunk=chunk, init_state=jnp.asarray(s0),
                            return_state=True)
    close(y, jy, "y vs JAX")
    close(s, js, "state vs JAX")


def test_ssd_masked_decay_keeps_gradients_finite():
    """The port's one deliberate difference in the SSD: where an upper-
    triangle exponent L_t - L_s overflows (large dt), the JAX package's
    ``where(mask, exp(seg), 0)`` gives a 0 x inf = NaN gradient; the port
    masks before the ``exp``, so its forward equals JAX's and its
    gradient stays finite."""
    x, dt, Ac, Bm, Cm = _ssd_inputs(16, dt_hi=8.0)
    Ac = np.full_like(Ac, -16.0)

    def jf(dt):
        return jnp.sum(JS.ssd_chunked(jnp.asarray(x), dt, jnp.asarray(Ac),
                                      jnp.asarray(Bm), jnp.asarray(Cm),
                                      chunk=16))

    jg = np.asarray(jax.grad(jf)(jnp.asarray(dt)))
    assert not np.isfinite(jg).all()  # the reference's NaN
    tdt = _t(dt, grad=True)
    y = TS.ssd_chunked(_t(x), tdt, _t(Ac), _t(Bm), _t(Cm), chunk=16)
    y.sum().backward()
    assert torch.isfinite(tdt.grad).all()
    close(y, JS.ssd_chunked(*map(jnp.asarray, (x, dt, Ac, Bm, Cm)),
                            chunk=16))


@pytest.fixture(scope="module")
def mamba():
    p = _jparams(JS.mamba2_init, 3, 32, d_state=8, headdim=8)
    u = np.random.default_rng(3).normal(size=(2, 12, 32)).astype(np.float32)
    return p, u, _port(TS.mamba2_init(_PI, 32, d_state=8, headdim=8), p)


def test_mamba2_apply_and_gradients_match_jax(mamba):
    p, u, tp = mamba
    ct = np.random.default_rng(4).normal(size=u.shape).astype(np.float32)

    def jf(p, u):
        out, s = JS.mamba2_apply(p, u, chunk=4, compute_dtype=jnp.float32,
                                 return_state=True)
        return jnp.sum(out * ct) + jnp.sum(s), (out, s)

    (_, (jout, js)), (jg, jgu) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(p, jnp.asarray(u))
    tu = _t(u, grad=True)
    out, s = TS.mamba2_apply(tp, tu, chunk=4, compute_dtype=F32,
                             return_state=True)
    close(out, jout, "out")
    close(s, js, "state")
    ((out * _t(ct)).sum() + s.sum()).backward()
    close(tu.grad, jgu, "du")
    for name, t in tp.named_parameters():
        close(t.grad, jg[name], name)
    tp.zero_grad()


def test_mamba2_decode_matches_jax_and_continues_prefill(mamba):
    """The prefix's state and conv ring, then decode steps: JAX's decode
    on the same state, and the full sequence's outputs
    (``tests/test_model_layers.py::test_mamba2_prefill_state_continues_
    decode``, whose 5e-2 bar is the bf16 ring's; here the ring is loaded
    from f32 values that bf16 holds exactly only up to rounding, so the
    bar is the ring's bf16 step)."""
    p, u, tp = mamba
    with torch.no_grad():
        full = TS.mamba2_apply(tp, _t(u), chunk=4, compute_dtype=F32)
        pre, s = TS.mamba2_apply(tp, _t(u[:, :9]), chunk=4,
                                 compute_dtype=F32, return_state=True)
        d_inner, conv_dim = tp.norm.shape[0], tp.conv_w.shape[1]
        zx = _t(u[:, 6:9]) @ tp.in_proj
        st = {"ssm": s,
              "conv": zx[..., d_inner:d_inner + conv_dim].to(torch.bfloat16)}
        jst = {"ssm": jnp.asarray(s.numpy()),
               "conv": jnp.asarray(st["conv"].float().numpy(), jnp.bfloat16)}
        outs = [pre]
        for t in range(9, 12):
            o, st = TS.mamba2_decode(tp, _t(u[:, t:t + 1]), st,
                                     compute_dtype=F32)
            jo, jst = JS.mamba2_decode(p, jnp.asarray(u[:, t:t + 1]), jst,
                                       compute_dtype=jnp.float32)
            close(o, jo, f"decode step {t}")
            close(st["ssm"], jst["ssm"], f"state after step {t}")
            outs.append(o)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=5e-2, atol=5e-3)
    zero = TS.mamba2_state(tp, 2)
    assert zero["ssm"].shape == (2, 8, 8, 8) and zero["conv"].shape == \
        (2, 3, 64 + 16) and zero["conv"].dtype == torch.bfloat16


# ---------------------------------------------------------------- rglru


@pytest.mark.parametrize("S", [1, 2, 7, 16, 33])
def test_linear_scan_matches_sequential_loop(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.2, 1.0, size=(2, S, 5)).astype(np.float32)
    b = rng.normal(size=(2, S, 5)).astype(np.float32)
    h, want = np.zeros((2, 5)), np.zeros((2, S, 5))
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want[:, t] = h
    close(TR.linear_scan(_t(a), _t(b)), want)


@pytest.fixture(scope="module")
def rglru():
    p = _jparams(JR.rglru_init, 4, 16, 24)
    u = np.random.default_rng(4).normal(size=(2, 10, 16)).astype(np.float32)
    return p, u, _port(TR.rglru_init(_PI, 16, 24), p)


def test_rglru_apply_and_gradients_match_jax(rglru):
    p, u, tp = rglru
    h0 = np.random.default_rng(5).normal(size=(2, 24)).astype(np.float32)
    ct = np.random.default_rng(6).normal(size=u.shape).astype(np.float32)

    def jf(p, u):
        out, h = JR.rglru_apply(p, u, compute_dtype=jnp.float32,
                                init_state=jnp.asarray(h0),
                                return_state=True)
        return jnp.sum(out * ct) + jnp.sum(h), (out, h)

    (_, (jout, jh)), (jg, jgu) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1), has_aux=True))(p, jnp.asarray(u))
    tu = _t(u, grad=True)
    out, h = TR.rglru_apply(tp, tu, compute_dtype=F32, init_state=_t(h0),
                            return_state=True)
    close(out, jout, "out")
    close(h, jh, "last state")
    ((out * _t(ct)).sum() + h.sum()).backward()
    close(tu.grad, jgu, "du")
    for name, t in tp.named_parameters():
        close(t.grad, jg[name], name)
    tp.zero_grad()


def test_rglru_decode_matches_jax_and_the_scan(rglru):
    """Decode from the zero state, token by token: JAX's decode at every
    step, and the scan's hidden state and outputs (the reference's
    sequential check, ``tests/test_model_layers.py:130``)."""
    p, u, tp = rglru
    with torch.no_grad():
        full, h_fin = TR.rglru_apply(tp, _t(u), compute_dtype=F32,
                                     return_state=True)
        st, jst, outs = TR.rglru_state(tp, 2), JR.rglru_state(p, 2), []
        for t in range(u.shape[1]):
            o, st = TR.rglru_decode(tp, _t(u[:, t:t + 1]), st,
                                    compute_dtype=F32)
            jo, jst = JR.rglru_decode(p, jnp.asarray(u[:, t:t + 1]), jst,
                                      compute_dtype=jnp.float32)
            close(o, jo, f"decode step {t}")
            close(st["h"], jst["h"], f"h after step {t}")
            outs.append(o)
    # the conv ring holds bf16 copies, so the decode's conv inputs round
    np.testing.assert_allclose(st["h"].numpy(), h_fin.numpy(), rtol=0,
                               atol=5e-3)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=5e-2, atol=5e-3)


# ------------------------------------------------------------ attention


def _qkv(S, H, Hkv, D, seed, B=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(B, S, h, D)).astype(np.float32)
            for h in (H, Hkv, Hkv, H)]


@pytest.mark.parametrize("S,H,Hkv,D,W", [
    (64, 4, 2, 16, 16),   # the reference's case
    (50, 4, 1, 8, 16),    # padded to the window, MQA
    (24, 2, 2, 8, 32),    # window beyond S: one block
])
def test_local_attention_matches_windowed_gqa_and_jax(S, H, Hkv, D, W):
    q, k, v, ct = _qkv(S, H, Hkv, D, S)
    pos = np.arange(S)
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    out = TA.local_attention(tq, tk, tv, torch.from_numpy(pos), window=W,
                             compute_dtype=F32)
    (out * _t(ct)).sum().backward()
    grads = [t.grad.clone() for t in (tq, tk, tv)]
    for t in (tq, tk, tv):
        t.grad = None
    ref = TA.gqa_attention(tq, tk, tv, torch.from_numpy(pos),
                           torch.from_numpy(pos), causal=True, window=W,
                           q_chunk=16, kv_chunk=16, compute_dtype=F32)
    (ref * _t(ct)).sum().backward()
    close(out, ref.detach().numpy(), "vs windowed gqa")
    for g, t, n in zip(grads, (tq, tk, tv), "qkv"):
        close(g, t.grad.numpy(), f"d{n} vs windowed gqa")

    def jf(q, k, v):
        o = JA.local_attention(q, k, v, jnp.arange(S), window=W,
                               compute_dtype=jnp.float32)
        return jnp.sum(o * ct), o

    (_, jo), jg = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(*map(jnp.asarray, (q, k, v)))
    close(out, jo, "vs JAX")
    for g, w, n in zip(grads, jg, "qkv"):
        close(g, w, f"d{n} vs JAX")


def test_local_attention_bf16_close_to_f32():
    q, k, v, _ = _qkv(64, 4, 1, 16, 3)
    args = [_t(a) for a in (q, k, v)]
    pos = torch.arange(64)
    f32 = TA.local_attention(*args, pos, window=16, compute_dtype=F32)
    bf = TA.local_attention(*args, pos, window=16,
                            compute_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    jbf = JA.local_attention(*map(jnp.asarray, (q, k, v)), jnp.arange(64),
                             window=16, compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(bf.float().numpy(), f32.numpy(), atol=3e-2)
    np.testing.assert_allclose(bf.float().numpy(),
                               np.asarray(jbf, np.float32), atol=2e-2)


@pytest.mark.parametrize("bias", [False, True])
def test_cross_attention_matches_jax(bias):
    """``attn_apply(kv=)``: bidirectional over the encoder's positions, no
    rotary embedding on either side -- forward and every gradient."""
    D, H, hd, S, F_ = 32, 4, 8, 10, 14
    p = split_tree({"a": JA.attn_init(JParamInit(jax.random.PRNGKey(8)), D,
                                      H, H, hd, qkv_bias=bias,
                                      out_bias=bias)})[0]["a"]
    if bias:  # nonzero biases, so their paths are exercised
        rng = np.random.default_rng(1)
        p = {k: (jnp.asarray(rng.normal(size=v.shape), jnp.float32)
                 if k.startswith("b") else v) for k, v in p.items()}
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, S, D)).astype(np.float32)
    enc = rng.normal(size=(2, F_, D)).astype(np.float32)
    ct = rng.normal(size=(2, S, D)).astype(np.float32)

    def jf(p, x, enc):
        o, _ = JA.attn_apply(p, x, None, None, kv=enc, rope_on=False,
                             kv_chunk=8, q_chunk=4,
                             compute_dtype=jnp.float32)
        return jnp.sum(o * ct), o

    (_, jo), (jg, jgx, jge) = jax.jit(jax.value_and_grad(
        jf, argnums=(0, 1, 2), has_aux=True))(p, jnp.asarray(x),
                                              jnp.asarray(enc))
    tp = _port(TA.attn_init(_PI, D, H, H, hd, qkv_bias=bias,
                            out_bias=bias), p)
    tx, te = _t(x, grad=True), _t(enc, grad=True)
    o, (k, v) = TA.attn_apply(tp, tx, None, None, kv=te, rope_on=False,
                              kv_chunk=8, q_chunk=4, compute_dtype=F32)
    assert k.shape == (2, F_, H, hd)
    close(o, jo, "out")
    (o * _t(ct)).sum().backward()
    close(tx.grad, jgx, "dx")
    close(te.grad, jge, "d enc")
    for name, t in tp.named_parameters():
        if name == "bk":  # zero in exact arithmetic: rounding noise in both
            scale = FLOOR * float(np.abs(np.asarray(jg["wk"])).max())
            assert float(t.grad.abs().max()) <= scale
            assert float(np.abs(np.asarray(jg["bk"])).max()) <= scale
            continue
        close(t.grad, jg[name], name)
