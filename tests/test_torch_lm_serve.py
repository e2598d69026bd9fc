"""The LM substrate's serving path, the port against the JAX package: every
``SMOKE`` config at f32 compute and cache in both packages, the JAX
package's parameters carried into the port by ``models/convert.py``, the
prompts and extras drawn as both ``serve_batch``es draw them.

Tolerances, as ``tests/test_torch_lm_archs.py`` states them: logits and
cache leaves rtol 1e-4, with an elementwise floor of 1e-4 x the tensor's
largest magnitude and at least twice the JAX package's own displacement
when each parameter is multiplied by 1 +- 2e-7 (random signs, a rounding's
size), measured in the fixture leaf by leaf.  Integer leaves (a ring's
positions, the MoE's counts and capacity) are equal.

A greedy token is an argmax: two computations that agree to 1e-6 still
pick different tokens where the top two logits nearly tie, and the
sequences part from there.  So decoding is compared under teacher forcing
(the port fed the JAX package's tokens, logits held step by step), and the
tokens themselves only while the reference's top-1/top-2 margin exceeds
twice the step's tolerance: past a row's first narrower step, nothing.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch.steps import make_decode_step as jmake_decode_step  # noqa: E402
from repro.launch.steps import make_prefill_step as jmake_prefill_step  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models.registry import get_config as jget_config  # noqa: E402
from repro.models.transformer import StackedLM as JStackedLM  # noqa: E402
from repro.models.whisper import WhisperED as JWhisperED  # noqa: E402
from repro_torch.launch.serve import (  # noqa: E402
    ServeConfig,
    decode_steps,
    serve_batch,
    serve_inputs,
    serve_len,
)
from repro_torch.launch.steps import (  # noqa: E402
    make_decode_step,
    make_prefill_step,
)
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import moe as TM  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    cache_from_reference,
    cache_to_reference,
    from_reference_arrays,
)
from repro_torch.models.registry import (  # noqa: E402
    ARCH_IDS,
    build_model,
    get_config,
)

B, P, GEN, SEED = 2, 20, 4, 0
RTOL, FLOOR = 1e-4, 1e-4  # FLOOR x max|want|, see the module docstring
NUDGE = 2e-7


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensors: one intra-op thread is fastest, and it keeps several
    test workers from oversubscribing the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tol(want, spread=None):
    """The absolute floor of one comparison."""
    floor = FLOOR * float(np.abs(np.asarray(want, np.float64)).max())
    if spread is not None:
        floor = max(floor, 2 * float(np.abs(spread).max()))
    return max(floor, 1e-6)


def close(got, want, spread=None, what=""):
    want = np.asarray(want)
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(np.asarray(got), want, err_msg=what)
        return
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               want.astype(np.float64), rtol=RTOL,
                               atol=tol(want, spread), err_msg=what)


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _cfgs(arch):
    jcfg = dataclasses.replace(jget_config(arch, smoke=True),
                               compute_dtype=jnp.float32,
                               cache_dtype=jnp.float32)
    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              compute_dtype=torch.float32,
                              cache_dtype=torch.float32)
    return jcfg, cfg


def _jmodel(cfg):
    return JWhisperED(cfg) if cfg.enc_dec else JStackedLM(cfg)


def _inputs(cfg, prompt_len=P, seed=SEED):
    """Prompts and extras in ``serve_batch``'s order of draws (numpy)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, size=(B, prompt_len)
                                  ).astype(np.int32)}
    if cfg.vlm_patches:
        out["image_embeds"] = rng.normal(
            size=(B, cfg.vlm_patches, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        out["frames"] = rng.normal(
            size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return out


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _nudge(params, seed=1):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a * (1 + NUDGE * rng.choice(
        [-1.0, 1.0], size=a.shape)).astype(np.float32), params)


_JIT = {}


def _jserve(jcfg, params, inputs, gen, tokens=None):
    """A loop over the JAX package's ``make_prefill_step`` and
    ``make_decode_step``: (prefill logits, prefill cache, each step's
    logits, the final cache, the tokens fed).  With ``tokens`` (B, gen)
    the steps are fed those (teacher forcing), else the greedy ones.  The
    caches are sized as the port's ``serve_batch`` sizes them, a slot for
    every step after a VLM's image prefix (the JAX package's own
    ``serve_batch`` leaves the prefix out and clamps the last steps'
    writes onto the cache's last slot)."""
    prompt_len = inputs["tokens"].shape[1]
    max_len = prompt_len + jcfg.vlm_patches + gen + 1
    key = (jcfg, max_len)
    if key not in _JIT:  # compiled once for the nudged run too
        model = _jmodel(jcfg)
        _JIT.clear()
        _JIT[key] = (jax.jit(jmake_prefill_step(model, jcfg,
                                                max_len=max_len)),
                     jax.jit(jmake_decode_step(model, jcfg)))
    prefill, step = _JIT[key]
    batch = {k: jnp.asarray(v) for k, v in inputs.items()}
    logits, cache = prefill(params, batch)
    cache0 = jax.tree.map(np.asarray, cache)
    nxt = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
    pos0 = prompt_len + jcfg.vlm_patches
    fed, steps = [], []
    for i in range(gen):
        tok = nxt if tokens is None else jnp.asarray(tokens[:, i])
        fed.append(np.asarray(tok))
        nxt, lg, cache = step(params, cache, {
            "tokens": tok[:, None],
            "pos": jnp.full((B,), pos0 + i, jnp.int32)})
        steps.append(np.asarray(lg[:, 0]))
    return (np.asarray(logits[:, 0]), cache0, steps,
            jax.tree.map(np.asarray, cache), np.stack(fed, axis=1))


@pytest.fixture(scope="module", params=ARCH_IDS)
def ref(request):
    """The JAX package's serving of one arch, compiled once a module: the
    prefill's logits and cache, the greedy tokens of ``GEN`` steps and
    each step's logits, the final cache -- and, for the spreads, the same
    teacher-forced run from every parameter times 1 +- 2e-7."""
    arch = request.param
    jcfg, _ = _cfgs(arch)
    params, _ = _jmodel(jcfg).init(jax.random.PRNGKey(SEED))
    inputs = _inputs(jcfg)
    logits, cache0, steps, cache, toks = _jserve(jcfg, params, inputs, GEN)
    n_logits, n_cache0, n_steps, n_cache, _ = _jserve(
        jcfg, _nudge(params), inputs, GEN, tokens=toks)

    def spread(a, b):
        return {k: v.astype(np.float64) - b[k] for k, v in a.items()}

    return dict(arch=arch, host=jax.tree.map(np.asarray, params),
                inputs=inputs, logits=logits, cache0=cache0, steps=steps,
                cache=cache, tokens=toks,
                logits_spread=n_logits - logits,
                steps_spread=[a - b for a, b in zip(n_steps, steps)],
                cache0_spread=spread(_leaves(n_cache0), _leaves(cache0)),
                cache_spread=spread(_leaves(n_cache), _leaves(cache)))


def _port(arch, host=None, **over):
    _, cfg = _cfgs(arch)
    cfg = dataclasses.replace(cfg, **over)
    model = build_model(cfg, seed=SEED, device="cpu")
    if host is not None:
        from_reference_arrays(model, host)
    return model, cfg


def _extras(batch):
    return {k: v for k, v in batch.items() if k != "tokens"}


def _margins(logits):
    """Each row's top-1 minus top-2 logit."""
    top = np.sort(np.asarray(logits, np.float64), axis=-1)
    return top[:, -1] - top[:, -2]


def test_prefill_logits_and_every_cache_leaf_match(ref):
    model, cfg = _port(ref["arch"], ref["host"])
    _, max_len = serve_len(cfg, P, GEN)
    logits, cache = make_prefill_step(model, cfg, max_len=max_len)(
        _tb(ref["inputs"]))
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == (B, 1, cfg.vocab)
    close(logits[:, 0].numpy(), ref["logits"], ref["logits_spread"],
          "prefill logits")
    got, want = _leaves(cache_to_reference(model, cache)), \
        _leaves(ref["cache0"])
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        close(got[name], want[name], ref["cache0_spread"].get(name), name)


def test_teacher_forced_decode_logits_match(ref):
    """``GEN`` decode steps fed the JAX package's greedy tokens: each
    step's logits, then every leaf of the final cache."""
    model, cfg = _port(ref["arch"], ref["host"])
    pos0, max_len = serve_len(cfg, P, GEN)
    logits, cache = make_prefill_step(model, cfg, max_len=max_len)(
        _tb(ref["inputs"]))
    step = make_decode_step(model, cfg)
    for i in range(GEN):
        tok = torch.from_numpy(ref["tokens"][:, i:i + 1].copy())
        nxt, lg, cache = step(cache, {"tokens": tok, "pos": torch.full(
            (B,), pos0 + i, dtype=torch.int32)})
        assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (B,)
        assert torch.equal(nxt, torch.argmax(lg[:, -1], -1).int())
        close(lg[:, 0].numpy(), ref["steps"][i], ref["steps_spread"][i],
              f"decode step {i}")
    got, want = _leaves(cache_to_reference(model, cache)), \
        _leaves(ref["cache"])
    for name in want:
        close(got[name], want[name], ref["cache_spread"].get(name), name)


def test_serve_batch_matches_the_jax_step_loop(ref):
    """The port's ``serve_batch`` on the JAX package's parameters against
    a loop over the JAX package's prefill and decode steps on the same
    prompts: tokens equal while the reference's margin is wide."""
    model, cfg = _port(ref["arch"], ref["host"])
    gen, stats = serve_batch(ServeConfig(arch=ref["arch"], batch=B,
                                         prompt_len=P, gen_len=GEN,
                                         seed=SEED, device="cpu"),
                             model=model)
    assert gen.dtype == np.int32 and gen.shape == (B, GEN)
    assert set(stats) == {"prefill_s", "decode_s", "tok_per_s"}
    want = ref["tokens"]
    reasons = [ref["logits"]] + ref["steps"][:GEN - 1]
    spreads = [ref["logits_spread"]] + ref["steps_spread"][:GEN - 1]
    compared = 0
    for r in range(B):
        for i in range(GEN):
            if _margins(reasons[i])[r] <= 2 * tol(reasons[i], spreads[i]):
                break
            assert gen[r, i] == want[r, i], (r, i)
            compared += 1
    assert compared >= B  # every row's first token at least


def test_cache_round_trips_through_convert(ref):
    model, _ = _port(ref["arch"])
    for tree in (ref["cache0"], ref["cache"]):
        cache = cache_from_reference(model, tree)
        back = _leaves(cache_to_reference(model, cache))
        want = _leaves(tree)
        assert sorted(back) == sorted(want)
        for name in want:
            np.testing.assert_array_equal(back[name], want[name], name)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_init_cache_matches_jax_layout(arch):
    """``init_cache`` against the JAX package's, leaf for leaf through
    ``cache_to_reference`` (shapes and values, the config's bf16 cache
    dtype); ``abstract_cache`` is its shapes on the meta device."""
    jcfg, cfg = jget_config(arch, smoke=True), get_config(arch, smoke=True)
    model = build_model(cfg, device="cpu")
    want = _leaves(_jmodel(jcfg).init_cache(B, 24))
    cache = model.init_cache(B, 24)
    got = _leaves(cache_to_reference(model, cache))
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].shape == want[name].shape, name
        np.testing.assert_array_equal(got[name],
                                      want[name].astype(got[name].dtype),
                                      name)
    abstract = model.abstract_cache(B, 24)
    for i, leaves in cache.items():
        for name, t in leaves.items():
            a = abstract[i][name]
            assert a.device.type == "meta" and a.shape == t.shape \
                and a.dtype == t.dtype
            if name in ("k", "v", "conv", "cross_k", "cross_v"):
                assert t.dtype == cfg.cache_dtype


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_prefill_decode_matches_forward(arch):
    """decode_step(prefill(t[:-1]), t[-1]) logits == apply(t)'s last, on
    the port alone (``tests/test_archs.py``'s check and bar)."""
    model, cfg = _port(arch)
    S = 32
    inputs = _tb(_inputs(cfg, prompt_len=S, seed=2))
    tokens = inputs["tokens"]
    with torch.no_grad():
        full, _ = model.apply(tokens, **_extras(inputs))
    _, cache = model.prefill(tokens[:, :-1], **_extras(inputs))
    pos = torch.full((B,), S - 1 + cfg.vlm_patches, dtype=torch.int32)
    logits, _ = model.decode_step(cache, tokens[:, -1:], pos)
    ref = full[:, -1].float().numpy()
    got = logits[:, 0].float().numpy()
    np.testing.assert_allclose(got, ref, atol=5e-3 * np.abs(ref).max()
                               + 1e-4, rtol=0)
    assert (got.argmax(-1) == ref.argmax(-1)).all(), arch


def test_moe_capacity_carry_across_alignment_boundary():
    """A 14-token prefill and one decode step against the 15-token
    forward where capacity(14) != capacity(15) (E=4, top_k=2, cf=1.25):
    the carry applies the full length's capacity in both phases."""
    assert TM.moe_capacity(14, 2, 4, 1.25) != TM.moe_capacity(15, 2, 4, 1.25)
    model, cfg = _port("granite-moe-3b-a800m", num_experts=4, top_k=2)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 15)))
    with torch.no_grad():
        full, _ = model.apply(toks)
    _, cache = model.prefill(toks[:, :-1])
    assert int(cache[0]["moe_cap"]) == TM.moe_capacity(15, 2, 4, 1.25)
    logits, cache = model.decode_step(cache, toks[:, -1:],
                                      torch.full((2,), 14, dtype=torch.int32))
    err = float(torch.max(torch.abs(logits[:, 0] - full[:, -1])))
    assert err < 1e-4, err
    assert (cache[0]["moe_cnt"].sum(-1) == 15 * cfg.top_k).all()


@pytest.mark.parametrize("arch,prompt_len", [("recurrentgemma-9b", 10),
                                             ("recurrentgemma-9b", 16),
                                             ("llama4-scout-17b-a16e", 7)])
def test_ring_cache_short_and_exact_prompts_match_jax(arch, prompt_len):
    """Ring caches of windowed layers (window 16) from prompts shorter
    than the window (the ``S < W`` pad, then a wrap during decoding) and
    as long as it, against the JAX package: the prefill's cache (``pos``
    included) and 12 teacher-forced steps' logits."""
    gen = 12
    jcfg, _ = _cfgs(arch)
    params, _ = _jmodel(jcfg).init(jax.random.PRNGKey(3))
    inputs = _inputs(jcfg, prompt_len=prompt_len, seed=3)
    logits, cache0, steps, cache, toks = _jserve(jcfg, params, inputs, gen)
    host = jax.tree.map(np.asarray, params)
    model, cfg = _port(arch, host)
    lg, tc = make_prefill_step(model, cfg, max_len=prompt_len + gen + 1)(
        _tb(inputs))
    close(lg[:, 0].numpy(), logits, what="prefill logits")
    got = _leaves(cache_to_reference(model, tc))
    rings = [n for n in got if n.endswith("['pos']")]
    assert rings
    for name, want in _leaves(cache0).items():
        close(got[name], want, what=name)
    for name in rings:  # the empty slots of a short prompt
        assert (got[name] == -1).sum() == B * max(0, 16 - prompt_len) * (
            got[name].size // (B * 16)), name
    step = make_decode_step(model, cfg)
    for i in range(gen):
        _, lg, tc = step(tc, {"tokens": torch.from_numpy(
            toks[:, i:i + 1].copy()), "pos": torch.full(
            (B,), prompt_len + i, dtype=torch.int32)})
        close(lg[:, 0].numpy(), steps[i], what=f"step {i}")
    for name, want in _leaves(cache).items():
        close(_leaves(cache_to_reference(model, tc))[name], want, what=name)


@pytest.mark.parametrize("hkv", [1, 2])
@pytest.mark.parametrize("mode", ["cache_len", "cache_len_window",
                                  "key_pos_window"])
def test_decode_attention_matches_jax(hkv, mode):
    """Both masks (a valid prefix, with or without a window; a ring's
    slot positions under a window) and the MQA branch (one KV head)."""
    rng = np.random.default_rng(4)
    Bq, Smax, Hq, D, W = 3, 12, 4, 8, 5
    q = rng.normal(size=(Bq, 1, Hq, D)).astype(np.float32)
    k = rng.normal(size=(Bq, Smax, hkv, D)).astype(np.float32)
    v = rng.normal(size=(Bq, Smax, hkv, D)).astype(np.float32)
    kw, tkw = {}, {}
    if mode.startswith("cache_len"):
        cl = np.array([1, 7, 12], np.int32)
        args, targs = (jnp.asarray(cl),), (torch.from_numpy(cl),)
    else:
        kp = rng.permutation(np.arange(Smax))[None].repeat(Bq, 0)
        kp[0, :4] = -1  # empty slots
        kp = kp.astype(np.int32)
        pq = np.array([9, 11, 6], np.int32)
        args = targs = ()
        kw = dict(key_pos=jnp.asarray(kp), pos_q=jnp.asarray(pq))
        tkw = dict(key_pos=torch.from_numpy(kp), pos_q=torch.from_numpy(pq))
    if mode.endswith("window"):
        kw["window"] = tkw["window"] = W
    want = JA.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               *args, compute_dtype=jnp.float32, **kw)
    got = TA.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), *targs,
                              compute_dtype=torch.float32, **tkw)
    assert tuple(got.shape) == (Bq, 1, Hq, D)
    close(got.numpy(), np.asarray(want), what=mode)


@pytest.mark.parametrize("chunk", [4, 16])
def test_gqa_attention_kv_len_matches_jax(chunk):
    """``gqa_attention(kv_len=)``: keys past the longest valid prefix are
    masked, through the forward-only flash path (padded chunks too)."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, 9, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, 9, 2, 8)).astype(np.float32)
    pos_q, pos_k, kv_len = np.arange(4, 9), np.arange(9), np.array([6, 4])
    want = JA.gqa_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(pos_q), jnp.asarray(pos_k),
                            kv_len=jnp.asarray(kv_len), q_chunk=chunk,
                            kv_chunk=chunk, compute_dtype=jnp.float32)
    got = TA.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), torch.from_numpy(pos_q),
                           torch.from_numpy(pos_k),
                           kv_len=torch.from_numpy(kv_len), q_chunk=chunk,
                           kv_chunk=chunk, compute_dtype=torch.float32)
    close(got.numpy(), np.asarray(want))
    unmasked = TA.gqa_attention(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(v), torch.from_numpy(pos_q),
                                torch.from_numpy(pos_k), q_chunk=chunk,
                                kv_chunk=chunk, compute_dtype=torch.float32)
    assert not torch.allclose(got, unmasked)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-780m",
                                  "recurrentgemma-9b"])
def test_serve_batch_generates(arch):
    gen, stats = serve_batch(ServeConfig(arch=arch, smoke=True, batch=2,
                                         prompt_len=8, gen_len=6,
                                         device="cpu"))
    assert gen.shape == (2, 6) and gen.dtype == np.int32
    assert stats["tok_per_s"] > 0
    vocab = get_config(arch, smoke=True).vocab
    assert (gen >= 0).all() and (gen < vocab).all()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "phi-3-vision-4.2b",
                                  "whisper-tiny"])
def test_serve_inputs_draw_as_the_jax_serve_batch(arch):
    """The port's ``serve_inputs`` draws the prompts and extras that the
    JAX package's ``serve_batch`` draws from the same seed."""
    _, cfg = _cfgs(arch)
    got = serve_inputs(ServeConfig(arch=arch, batch=B, prompt_len=P,
                                   seed=SEED, device="cpu"), cfg)
    want = _inputs(cfg)
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        np.testing.assert_array_equal(got[name].numpy(), w, name)


def test_vlm_serve_batch_decodes_as_the_full_forward():
    """A VLM's serving cache holds the image prefix, the prompt and every
    decode step: ``serve_batch``'s steps fed its own tokens give the full
    forward's logits over the image, the prompt and the tokens before each
    step, and each token is that forward's argmax, or one of its tied top
    ones (the row is not compared past that step)."""
    arch, prompt_len = "phi-3-vision-4.2b", 8
    model, cfg = _port(arch)
    scfg = ServeConfig(arch=arch, batch=B, prompt_len=prompt_len,
                       gen_len=GEN, seed=SEED, device="cpu")
    gen, _ = serve_batch(scfg, model=model)
    batch = serve_inputs(scfg, cfg)
    pos0, max_len = serve_len(cfg, prompt_len, GEN)
    assert pos0 == prompt_len + cfg.vlm_patches
    logits, cache = make_prefill_step(model, cfg, max_len=max_len)(batch)
    steps = [logits[:, 0]] + [lg[:, 0] for _, lg, _ in decode_steps(
        model, cfg, cache, None, pos0=pos0, steps=GEN - 1, forced=gen)]
    steps = torch.stack(steps, dim=1).numpy()
    seq = torch.cat([batch["tokens"], torch.from_numpy(gen[:, :-1])], 1)
    with torch.no_grad():
        full = model.apply(seq, image_embeds=batch["image_embeds"])[0]
    full = full[:, pos0 - 1:].numpy()
    assert steps.shape == full.shape == (B, GEN, cfg.vocab)
    close(steps, full, what="teacher-forced steps against the forward")
    for r in range(B):
        for i in range(GEN):
            f = full[r, i]
            tied = np.flatnonzero(f >= f.max() - tol(f))
            assert gen[r, i] in tied, (r, i, gen[r, i], tied)
            if len(tied) > 1:
                break


def test_greedy_decode_matches_full_forward():
    """Each greedy token is the argmax of the full forward over the prompt
    and the tokens generated so far; where that forward's top two lie
    within the tolerance, the token is one of the tied ones and the
    sequence is not compared further."""
    model, cfg = _port("llama3.2-1b")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, 8)))
    logits, cache = model.prefill(toks, max_len=16)
    seq = [int(torch.argmax(logits[0, -1]))]
    for i in range(3):
        lg, cache = model.decode_step(
            cache, torch.tensor([[seq[-1]]]), torch.tensor([8 + i],
                                                           dtype=torch.int32))
        seq.append(int(torch.argmax(lg[0, -1])))
    ref_tokens = toks
    for i in range(4):
        with torch.no_grad():
            full = model.apply(ref_tokens)[0][0, -1].numpy()
        t = tol(full)
        tied = np.flatnonzero(full >= full.max() - t)
        assert seq[i] in tied, (i, seq[i], tied)
        if len(tied) > 1:
            break
        ref_tokens = torch.cat([ref_tokens, torch.tensor([[seq[i]]])], 1)


def test_serving_entry_points_need_the_card_or_an_explicit_host(monkeypatch):
    """With no CUDA device the default ``ServeConfig`` raises (no fallback
    to the host); ``device="cpu"`` serves on the host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_batch(ServeConfig(batch=1, prompt_len=4, gen_len=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TA.init_kv_cache(1, 1, 4, 1, 8)
    model, _ = _port("llama3.2-1b")
    with pytest.raises(ValueError, match="serves on"):
        serve_batch(ServeConfig(batch=1, prompt_len=4, gen_len=1,
                                device="meta"), model=model)
    kv = TA.init_kv_cache(2, 1, 4, 1, 8, device="cpu")
    assert kv["k"].shape == (2, 1, 4, 1, 8) and kv["k"].dtype == \
        torch.bfloat16
