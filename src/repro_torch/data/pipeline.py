"""Synthetic data (host numpy): P2HNNS point sets and hyperplane queries,
and the LM token streams.

The same generators as the JAX package's ``data/pipeline.py``: with the
same arguments they return bit-identical arrays, so both packages can be
fed the same data from a seed.

Determinism contract of the LM stream (the training restart depends on
it): the batch for step ``s`` is a pure function of (seed, step, row), so a
restarted or re-sharded job resumes with bit-identical data and no loader
state needs checkpointing.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["make_p2h_dataset", "SyntheticLMDataset", "global_batch_for_step"]


def _rng_for(seed: int, step: int, shard: int = 0) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence(entropy=seed, spawn_key=(step, shard)))


@dataclasses.dataclass
class SyntheticLMDataset:
    """Token streams with a power-law unigram start and a noisy
    deterministic bigram walk, so the loss is non-trivial and learnable."""

    vocab: int
    seq: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2

    def shard_batch(self, step: int, shard: int, num_shards: int):
        """The rows ``shard`` of ``num_shards`` owns at ``step``: dict(tokens
        (b, seq) i32, labels (b, seq) i32), b = global_batch / num_shards.
        Rows are keyed by their global index, so the global batch is the
        same for any number of shards."""
        if self.global_batch % num_shards:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split into {num_shards} shards")
        b = self.global_batch // num_shards
        rows = range(shard * b, (shard + 1) * b)
        gens = [_rng_for(self.seed, step, r) for r in rows]
        toks = np.empty((b, self.seq + 1), dtype=np.int32)
        toks[:, 0] = [g.zipf(self.zipf_a) % self.vocab for g in gens]
        steps = np.stack([g.zipf(self.zipf_a, size=self.seq) for g in gens]
                         ).astype(np.int64)
        mix = np.stack([g.random(self.seq) for g in gens]) < 0.25
        for t in range(self.seq):
            follow = (toks[:, t].astype(np.int64) * 6364136223846793005 + 7
                      ) % self.vocab
            toks[:, t + 1] = np.where(mix[:, t], steps[:, t] % self.vocab,
                                      follow).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def global_batch_arrays(self, step: int):
        """The whole global batch of ``step``."""
        return global_batch_for_step(self, step, 1)

    def extra_arrays(self, step: int, model_cfg) -> dict:
        """The model's extra inputs at ``step``, N(0, 1) f32 stand-ins for
        the stubbed frontends: ``image_embeds`` (global_batch,
        vlm_patches, d_model) for a VLM, ``frames`` (global_batch,
        enc_frames, d_model) for an encoder-decoder, nothing for the
        others.  A pure function of (seed, step), like the tokens (the JAX
        package's ``launch/train.py`` draws them from one generator a run,
        so a restarted run draws others)."""
        rng = _rng_for(self.seed + 1, step)
        out = {}
        for key, n, on in (("image_embeds", model_cfg.vlm_patches,
                            model_cfg.vlm_patches),
                           ("frames", model_cfg.enc_frames,
                            model_cfg.enc_dec)):
            if on:
                out[key] = rng.normal(size=(
                    self.global_batch, n, model_cfg.d_model)
                ).astype(np.float32)
        return out


def global_batch_for_step(ds: SyntheticLMDataset, step: int,
                          num_shards: int):
    parts = [ds.shard_batch(step, s, num_shards) for s in range(num_shards)]
    return {k: np.concatenate([p[k] for p in parts], axis=0)
            for k in parts[0]}


def make_p2h_dataset(n: int, d: int, *, kind: str = "clustered",
                     n_queries: int = 100, seed: int = 0):
    """Point set (n, d) + hyperplane queries (n_queries, d+1).

    Kinds: "normal" (isotropic), "clustered" (GMM, the common real-data
    shape), "unit" (normalized), "heavy" (Cauchy-ish heavy tails),
    "planted" (clustered points near a low-dimensional subspace -- the
    low-intrinsic-dimension regime where metric-tree bounds prune).
    """
    rng = np.random.default_rng(seed)
    if kind == "normal":
        x = rng.normal(size=(n, d))
    elif kind == "clustered":
        k = max(4, d // 8)
        centers = rng.normal(size=(k, d)) * 4.0
        x = centers[rng.integers(0, k, n)] + rng.normal(size=(n, d)) * 0.5
    elif kind == "planted":
        # planted clusters in a k_lat-dim latent subspace, projected to the
        # ambient dim with small isotropic noise: intrinsic dim ~ k_lat << d
        k_lat = max(2, d // 16)
        n_c = 8
        basis = np.linalg.qr(rng.normal(size=(d, k_lat)))[0]
        centers = rng.normal(size=(n_c, k_lat)) * 6.0
        z = centers[rng.integers(0, n_c, n)] \
            + rng.normal(size=(n, k_lat))
        x = z @ basis.T + rng.normal(size=(n, d)) * 0.05
    elif kind == "unit":
        x = rng.normal(size=(n, d))
        x /= np.linalg.norm(x, axis=1, keepdims=True)
    elif kind == "heavy":
        x = rng.standard_cauchy(size=(n, d)).clip(-50, 50)
    else:
        raise ValueError(kind)
    # queries: random hyperplanes through the data region; coefficients
    # ~ N(0,1), bias placed near the data
    q = rng.normal(size=(n_queries, d + 1))
    anchor = x[rng.integers(0, n, n_queries)]
    q[:, -1] = -np.einsum("qd,qd->q", q[:, :-1], anchor)
    q[:, -1] += rng.normal(scale=0.1, size=n_queries)
    return x.astype(np.float32), q.astype(np.float32)
