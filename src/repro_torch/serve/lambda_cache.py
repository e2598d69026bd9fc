"""LSH-bucketed lambda cache: warm-start top-k thresholds across queries.

Host numpy, the same as the JAX package's module: the same ``seed`` draws
the same projection planes, so both packages bucket a query alike.

The sweep backends accept ``lambda_cap`` -- an externally-known upper
bound on a query's true global k-th distance -- and prune every tile and
point whose lower bound meets it *from the first leaf*.  The distributed
index derives such caps **across shards** (round-1 exchange); this cache
derives them **across time**: hot traffic keeps asking nearly-identical
hyperplanes (same normal direction up to sign), so the k-th distance of a
previously-answered neighbor query bounds the new one.

Exactness argument (documented contract, asserted by the parity suite):
for any point ``x`` and queries ``q``, ``q'``,

    |<x,q>|  <=  |<x,q'>| + |<x, q - q'>|  <=  |<x,q'>| + ||x|| * ||q-q'||

so with ``R >= max_x ||x||`` (root ball: ``R = ||c_root|| + r_root``) the
k-th smallest |<x,q>| is at most ``lambda'(q') + R * ||q - q'||`` -- a
*valid* cap for ``q`` whenever ``lambda'`` upper-bounds q''s k-th
distance.  Because ``|<x,-q'>| = |<x,q'>|`` the sign-canonical distance
``min(||q-q'||, ||q+q'||)`` is used.  Any exact backend's k-th returned
distance is by definition an upper bound on its own k-th distance, and a
*budgeted* (beam) backend's k-th returned distance is the distance of k
real points, hence also an upper bound -- so every served batch can
update the cache.  Caps are additionally inflated by a relative factor
plus an additive slack covering the f32 rounding noise of the backends'
bound arithmetic (see ``lookup``), so ``cap`` strictly exceeds every
true top-k member's *computed* lower bound: pruning discards only
candidates whose bound >= cap > true k-th, which can never evict a true
top-k member -- results are bit-identical to the uncapped run.

Buckets are sign-random-projection (SRP) signatures of the query
direction: ``m`` fixed Gaussian directions, one bit each, sign-canonical
(the signature of -q equals the signature of q).  Nearby normals collide;
each bucket stores the last (query, lambda, epoch) triple per ``k``.

**Epoch tagging (mutable indexes).**  Against a
:class:`repro_torch.stream.MutableP2HIndex` the live point set changes between
batches, and the validity argument above is epoch-sensitive:

  * an *insert* only ever shrinks the true k-th distance, so a cap
    recorded before it stays a valid upper bound;
  * a *delete* can grow the true k-th distance (removing a current
    top-k member promotes the (k+1)-th), so a cap recorded before it
    may silently exclude the new true answer -- stale caps are unsound,
    not just suboptimal.

Entries therefore carry the epoch of the snapshot that produced them,
and ``lookup(min_epoch=...)`` treats entries older than the caller's
``last_delete_epoch`` as misses (and evicts them).  The engine pins one
snapshot per micro-batch and threads ``snapshot.last_delete_epoch`` /
``snapshot.epoch`` through lookup/update, so warm serving over a
mutating index stays exact (regression-tested in tests/test_torch_serve.py).

**Epoch vectors (sharded mutable indexes).**  Against a
sharded mutable index (:class:`repro_torch.stream.ShardedMutableP2HIndex`)
every shard publishes its own epoch, and a served batch pins an epoch *vector* (one component per
shard).  A *merged* global k-th would be invalidated by a delete in any
shard, so sharded entries instead store **per-shard** local k-th bounds
``lam_s``, each tagged with its shard's epoch.  Any one shard's local
k-th upper-bounds the global k-th (that shard alone holds k points
within it), so a valid cap needs only the *surviving* components:

    cap  =  min over valid s of  (lam_s + R * min(||q-q'||, ||q+q'||))

Invalidation is therefore keyed per shard: a delete in shard 2 bumps
only component 2's floor, dropping only that component -- the entry
keeps serving (a little looser) from the other shards' bounds instead
of the whole cache entry being evicted.  An entry dies only when every
component is stale, or the shard layout changed (vector length
mismatch).  Scalar epochs are the 1-vector special case of the same
scheme.
"""
from __future__ import annotations

import numpy as np

__all__ = ["LambdaCache", "epoch_is_stale"]


def _as_epoch(e):
    """Normalize an epoch tag: scalars stay ints, vectors become tuples."""
    if isinstance(e, (tuple, list, np.ndarray)):
        return tuple(int(x) for x in e)
    return int(e)


def epoch_is_stale(entry_epoch, min_epoch) -> bool:
    """Is a cap recorded at ``entry_epoch`` unsound for a serving view
    whose delete-epoch floor is ``min_epoch``?  Both may be scalars
    (single-host index) or per-shard vectors (sharded index); staleness
    is componentwise -- stale iff any component predates its floor, or
    the shard layout changed (length mismatch)."""
    e, m = _as_epoch(entry_epoch), _as_epoch(min_epoch)
    if isinstance(e, int) and isinstance(m, int):
        return e < m
    e = (e,) if isinstance(e, int) else e
    m = (m,) if isinstance(m, int) else m
    if len(e) != len(m):
        return True
    return any(a < b for a, b in zip(e, m))

# strict inflation: keeps caps > true kth under f32 rounding so warm runs
# stay bit-identical (see module docstring)
_INFLATE = 1.0 + 1e-6


class LambdaCache:
    """Host-side cache: SRP bucket -> (query, k-th distance) per k."""

    def __init__(self, d: int, max_norm: float, *, n_bits: int = 14,
                 seed: int = 0, max_entries: int = 65536):
        assert n_bits <= 62
        self.d = int(d)
        self.max_norm = float(max_norm)
        rng = np.random.default_rng(seed)
        # fixed projection directions; queries are (d,) incl. the appended
        # coefficient, so bucket on the full normalized coefficient vector
        self.proj = rng.standard_normal((self.d, n_bits)).astype(np.float32)
        self._pow2 = (1 << np.arange(n_bits, dtype=np.int64))
        self.max_entries = int(max_entries)
        self._store: dict = {}  # (sig, k) -> (q (d,) f32, lam float, epoch)
        self.hits = 0
        self.misses = 0
        self.stale_evictions = 0

    # ------------------------------------------------------------------
    def signatures(self, queries: np.ndarray) -> np.ndarray:
        """Sign-canonical SRP signatures for (B, d) queries -> (B,) i64."""
        q = np.asarray(queries, np.float32)
        bits = (q @ self.proj) >= 0  # (B, n_bits)
        # canonicalize +/- q to the same bucket: flip all bits so bit 0 is 0
        flip = bits[:, :1]
        bits = np.logical_xor(bits, flip)
        return (bits.astype(np.int64) @ self._pow2).astype(np.int64)

    # ------------------------------------------------------------------
    def lookup(self, queries: np.ndarray, k: int, *,
               min_epoch=0) -> np.ndarray:
        """Valid per-query caps (B,) f32; +inf where the cache has nothing.

        ``min_epoch``: the serving snapshot's ``last_delete_epoch`` --
        a scalar, or a per-shard vector when serving a sharded mutable
        index.  Entries stale under :func:`epoch_is_stale` predate a
        delete in some covered shard, may under-bound the current true
        k-th distance, and are treated as misses (evicted).
        """
        q = np.asarray(queries, np.float32)
        caps = np.full((q.shape[0],), np.inf, np.float32)
        sigs = self.signatures(q)
        for i, sig in enumerate(sigs):
            key = (int(sig), int(k))
            ent = self._store.get(key)
            lam = None
            if ent is not None:
                q0, lam_e, tag = ent
                if isinstance(lam_e, tuple):
                    # sharded entry: min over still-valid per-shard
                    # bounds; a delete in shard s only drops component s
                    lam = self._valid_component_min(lam_e, tag, min_epoch)
                elif not epoch_is_stale(tag, min_epoch):
                    lam = float(lam_e)
                if lam is None:
                    del self._store[key]  # fully stale: deletes
                    self.stale_evictions += 1  # invalidated every bound
            if lam is None:
                self.misses += 1
                continue
            q0 = ent[0]
            delta = min(float(np.linalg.norm(q[i] - q0)),
                        float(np.linalg.norm(q[i] + q0)))
            # additive slack: the backends compute their lower bounds in
            # f32, so a true top-k member's *computed* bound can exceed its
            # true distance by ~eps * ||q|| * R of rounding noise.  The
            # multiplicative inflation alone cannot cover that when lambda
            # is at or near 0 (points lying exactly on the hyperplane):
            # cap would round to ~0 and prune everything.  1e-5*(1+||q||R)
            # dominates the f32 noise scale with ~50x margin while staying
            # negligible for any lambda the cap usefully prunes with.
            slack = 1e-5 * (1.0 + float(np.linalg.norm(q[i]))
                            * self.max_norm)
            caps[i] = (lam + self.max_norm * delta) * _INFLATE + slack
            self.hits += 1
        return caps

    @staticmethod
    def _valid_component_min(lams: tuple, epochs: tuple,
                             min_epoch) -> float | None:
        """Min over per-shard bounds whose epoch is not stale; None when
        nothing survives (or the shard layout changed)."""
        floors = _as_epoch(min_epoch)
        floors = (floors,) if isinstance(floors, int) else floors
        if len(epochs) != len(floors):
            return None
        valid = [lam for lam, e, f in zip(lams, epochs, floors)
                 if e >= f and np.isfinite(lam)]
        return min(valid) if valid else None

    # ------------------------------------------------------------------
    def update(self, queries: np.ndarray, k: int, kth_dists: np.ndarray,
               *, epoch=0, min_epoch=0):
        """Record served results; ``kth_dists`` are per-query k-th returned
        distances (upper bounds on the true k-th by construction).
        ``epoch`` tags the snapshot (scalar) or epoch vector (sharded)
        that produced them; an existing entry stale under ``min_epoch``
        is replaced unconditionally (its lambda is no longer
        trustworthy, however small)."""
        q = np.asarray(queries, np.float32)
        lam = np.asarray(kth_dists, np.float32).reshape(-1)
        sigs = self.signatures(q)
        tag = _as_epoch(epoch)
        for i, sig in enumerate(sigs):
            if not np.isfinite(lam[i]):
                continue  # fewer than k valid results: not a valid bound
            key = (int(sig), int(k))
            # keep the tighter center: prefer the smaller lambda
            prev_lam = self._surviving_lambda(key, min_epoch)
            if prev_lam is None or lam[i] <= prev_lam:
                self._store[key] = (q[i].copy(), float(lam[i]), tag)
        self._evict_overflow()

    def update_sharded(self, queries: np.ndarray, k: int,
                       shard_kths: np.ndarray, *, epoch, min_epoch=None):
        """Record a sharded serve: ``shard_kths`` (B, S) are per-shard
        local k-th upper bounds (+inf where a shard produced fewer than k
        finite results this batch -- e.g. its round-2 scan was fully
        pruned), ``epoch`` the pinned per-shard epoch vector.  Stored
        componentwise so later deletes invalidate per shard.  An entry is
        replaced when the previous one is missing, fully stale under
        ``min_epoch``, from a different shard layout, or looser (its
        surviving min exceeds the new one) -- components and center move
        together because the cap formula is anchored on one center."""
        q = np.asarray(queries, np.float32)
        lam = np.asarray(shard_kths, np.float32)
        tag = tuple(int(e) for e in epoch)
        assert lam.ndim == 2 and lam.shape[1] == len(tag), (lam.shape, tag)
        if min_epoch is None:
            min_epoch = (0,) * len(tag)
        sigs = self.signatures(q)
        for i, sig in enumerate(sigs):
            finite = np.isfinite(lam[i])
            if not finite.any():
                continue  # nothing bounded this batch: no valid entry
            new_min = float(lam[i][finite].min())
            key = (int(sig), int(k))
            prev_min = self._surviving_lambda(key, min_epoch)
            if prev_min is None or new_min <= prev_min:
                self._store[key] = (q[i].copy(),
                                    tuple(float(x) for x in lam[i]), tag)
        self._evict_overflow()

    def _surviving_lambda(self, key, min_epoch) -> float | None:
        """The bound an existing entry still provides under ``min_epoch``
        (scalar- or sharded-mode); None when missing or fully stale --
        the shared replace-or-keep test of both update paths."""
        prev = self._store.get(key)
        if prev is None:
            return None
        if isinstance(prev[1], tuple):
            return self._valid_component_min(prev[1], prev[2], min_epoch)
        return None if epoch_is_stale(prev[2], min_epoch) else float(prev[1])

    def _evict_overflow(self):
        while len(self._store) > self.max_entries:  # FIFO-ish eviction
            self._store.pop(next(iter(self._store)))

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        return {"entries": len(self._store), "hits": self.hits,
                "misses": self.misses,
                "stale_evictions": self.stale_evictions}

    def clear(self):
        self._store.clear()
        self.hits = 0
        self.misses = 0
        self.stale_evictions = 0
