"""The LM substrate's optimiser, schedule, gradient utilities, token
stream and checkpoints in the port: the counterparts of
``tests/test_substrate.py``'s optimiser and data tests, and each function
held to the JAX package's on the same arrays (fixed seeds).

Tolerances: ``adamw_update`` and ``cosine_schedule`` rtol 1e-6 (the same
f32 formula; ``pow``, ``sqrt`` and ``cos`` may round one ulp apart);
clipping rtol 1e-6; int8 compression equal codes, since both round the
same f32 quotient half to even; tokens equal.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data import SyntheticLMDataset as JDataset  # noqa: E402
from repro.data import global_batch_for_step as jglobal_batch  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro.optim import clip_by_global_norm as jclip  # noqa: E402
from repro.optim.grad import compress_int8 as jcompress  # noqa: E402
from repro.optim.grad import ef_compress_grads as jef  # noqa: E402
from repro.optim.schedule import cosine_schedule as jcosine  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    SyntheticLMDataset,
    global_batch_for_step,
)
from repro_torch.optim import (  # noqa: E402
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    compress_int8,
    cosine_schedule,
    decompress_int8,
    ef_compress_grads,
)


def _t(a):
    return torch.from_numpy(np.array(a))


# ----------------------------------------------------------------- optim
def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0]), "b": torch.tensor(2.0)}
    opt = adamw_init(params)

    def loss(p):
        return torch.sum(p["w"] ** 2) + p["b"] ** 2

    for _ in range(200):
        leaves = {k: v.detach().requires_grad_(True) for k, v in
                  params.items()}
        g = dict(zip(leaves, torch.autograd.grad(loss(leaves),
                                                 list(leaves.values()))))
        params, opt = adamw_update(g, opt, params, lr=0.05,
                                   weight_decay=0.0)
    assert float(loss(params)) < 1e-3
    assert int(opt.count) == 200 and opt.count.dtype == torch.int32


@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_update_matches_jax(weight_decay):
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (3,), "c": (2, 3, 4)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    jp, jo = {k: jnp.asarray(v) for k, v in params.items()}, None
    tp = {k: _t(v) for k, v in params.items()}
    jo, to = jadamw_init(jp), adamw_init(tp)
    for step in range(4):
        grads = {k: (rng.normal(size=s) * 10.0 ** (step - 2)).astype(
            np.float32) for k, s in shapes.items()}
        lr = jcosine(jnp.asarray(step), peak_lr=3e-3, warmup_steps=2,
                     total_steps=4)
        jp, jo = jadamw_update({k: jnp.asarray(v) for k, v in grads.items()},
                               jo, jp, lr=lr, weight_decay=weight_decay)
        tp, to = adamw_update({k: _t(v) for k, v in grads.items()}, to, tp,
                              lr=torch.tensor(float(lr)),
                              weight_decay=weight_decay)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(to.mu[k].numpy(), np.asarray(jo.mu[k]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(to.nu[k].numpy(), np.asarray(jo.nu[k]),
                                       rtol=1e-6, atol=1e-12)
    assert int(to.count) == int(jo.count) == 4


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 3.0), "b": torch.full((4,), 4.0)}  # norm 10
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert np.isclose(float(gn), 10.0, rtol=1e-5)
    total = float(torch.sqrt(sum(torch.sum(x * x)
                                 for x in clipped.values())))
    assert np.isclose(total, 1.0, rtol=1e-5)
    small, gn2 = clip_by_global_norm(clipped, 5.0)  # under the limit
    assert all(torch.equal(small[k], clipped[k]) for k in g)


def test_clip_matches_jax():
    rng = np.random.default_rng(1)
    g = {k: rng.normal(size=s).astype(np.float32) * 3
         for k, s in (("x", (9, 4)), ("y", (13,)))}
    jc, jn = jclip({k: jnp.asarray(v) for k, v in g.items()}, 2.0)
    tc, tn = clip_by_global_norm({k: _t(v) for k, v in g.items()}, 2.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in g:
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6)


def test_cosine_schedule_shape_and_jax():
    lrs = [float(cosine_schedule(torch.tensor(s), peak_lr=1.0,
                                 warmup_steps=10, total_steps=100))
           for s in range(100)]
    assert lrs[0] < lrs[9]              # warmup rises
    assert max(lrs) <= 1.0 + 1e-6
    assert lrs[-1] < 0.2                # decays toward final_frac
    want = [float(jcosine(jnp.asarray(s), peak_lr=1.0, warmup_steps=10,
                          total_steps=100)) for s in range(100)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6)
    assert float(cosine_schedule(7, peak_lr=2.0, warmup_steps=10,
                                 total_steps=100)) == pytest.approx(1.6)


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_int8_compression_bounded_error_and_matches_jax(seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(64,)) * rng.uniform(0.1, 100)).astype(np.float32)
    q, s = compress_int8(_t(x))
    err = np.abs((decompress_int8(q, s) - _t(x)).numpy())
    assert err.max() <= float(s) * 0.5 + 1e-6  # half-ulp of the quant grid
    jq, js = jcompress(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-6)


def test_error_feedback_unbiased_over_time():
    """The sum of dequantised gradients tracks the sum of true gradients
    (the residual stays bounded), and each step equals the JAX package's."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(128,)).astype(np.float32)
    errors, jerrors = None, None
    acc = np.zeros(128)
    for _ in range(50):
        quant, errors = ef_compress_grads({"w": _t(g)}, errors)
        jquant, jerrors = jef({"w": jnp.asarray(g)}, jerrors)
        q, s = quant["w"]
        np.testing.assert_array_equal(q.numpy(), np.asarray(jquant["w"][0]))
        acc += decompress_int8(q, s).numpy()
    np.testing.assert_allclose(errors["w"].numpy(), np.asarray(jerrors["w"]),
                               rtol=1e-5, atol=1e-6)
    true = 50 * g
    assert np.abs(acc - true).max() <= float(np.abs(true).max()) * 0.05 + 1.0


# ----------------------------------------------------------------- data
def test_data_deterministic_and_restart_stable():
    ds = SyntheticLMDataset(vocab=128, seq=16, global_batch=8, seed=3)
    a = ds.shard_batch(step=7, shard=1, num_shards=4)
    b = ds.shard_batch(step=7, shard=1, num_shards=4)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = ds.shard_batch(step=8, shard=1, num_shards=4)
    assert not np.array_equal(a["tokens"], c["tokens"])
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    with pytest.raises(ValueError):
        ds.shard_batch(step=0, shard=0, num_shards=3)


def test_data_elastic_resharding_preserves_global_batch():
    ds = SyntheticLMDataset(vocab=128, seq=16, global_batch=8, seed=3)
    g4 = global_batch_for_step(ds, 5, 4)
    g2 = global_batch_for_step(ds, 5, 2)
    np.testing.assert_array_equal(g4["tokens"], g2["tokens"])


@pytest.mark.parametrize("vocab,seq,batch,seed,shards", [
    (512, 32, 2, 0, 1), (128256, 64, 4, 7, 2), (49152, 17, 6, 3, 3)])
def test_tokens_equal_jax(vocab, seq, batch, seed, shards):
    ds = SyntheticLMDataset(vocab=vocab, seq=seq, global_batch=batch,
                            seed=seed)
    jds = JDataset(vocab=vocab, seq=seq, global_batch=batch, seed=seed)
    for step in (0, 1, 9):
        got = global_batch_for_step(ds, step, shards)
        want = jglobal_batch(jds, step, shards)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(ds.global_batch_arrays(step)["tokens"],
                                      jds.global_batch_arrays(step)["tokens"])


# ------------------------------------------------------------ checkpoint
def test_checkpoint_restores_bf16_and_structure(tmp_path):
    """A bf16 leaf is stored as its uint16 bits under ``"bfloat16"`` (the
    JAX package's format) and comes back as bf16 in ``like``'s structure
    and on its device."""
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = [{"w": torch.randn(3, 4).to(torch.bfloat16),
             "b": torch.arange(5, dtype=torch.float32)},
            {"count": torch.tensor(7, dtype=torch.int32)}]
    mgr.save(3, tree, blocking=True)
    meta = mgr.read_manifest(3)["leaves"]
    assert [m["dtype"] for m in meta] == ["float32", "bfloat16", "int32"]
    back = mgr.restore(3, tree)
    assert back[0]["w"].dtype == torch.bfloat16
    assert torch.equal(back[0]["w"], tree[0]["w"])
    assert torch.equal(back[0]["b"], tree[0]["b"])
    assert int(back[1]["count"]) == 7
    with pytest.raises(ValueError):
        mgr.restore(3, [{"w": torch.zeros(3, 4), "b": tree[0]["b"]},
                        tree[1]])
    leaf = os.path.join(str(tmp_path), "step_3", "leaf_1.npy")
    arr = np.load(leaf)
    arr[0, 0] ^= 1
    np.save(leaf, arr)
    with pytest.raises(IOError):
        mgr.restore(3, tree)
