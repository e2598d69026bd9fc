"""The two-round lambda exchange over shard backends, on one device.

The paper motivates Ball-Tree partly because "we can leverage it to split
massive data sets into fine granularities for scalable and distributed
P2HNNS" (Section III-A, point 4).  This module is that scale-out story
for the sharded mutable index (:mod:`repro_torch.stream.sharded`), whose
shards are host-level partitions that each hold a full mutable index:

  round 1:  every shard sweeps a small prefix (``frac1``) of its most
            promising leaves (plus its delta, exactly) -> local top-k; the
            min over shards of the local k-ths is lambda0, a *valid upper
            bound on the global k-th distance* (the union of shards holds
            >= k candidates below any shard's local k-th);
  round 2:  every shard runs the full exact sweep under
            ``lambda_cap=lambda0`` -- distant shards prune almost all of
            their tiles at once.  At stackable fan-out the shards' segment
            stacks are concatenated and swept by **one** launch of the
            stacked kernel K2 (``probe_route="round2"``, ``shard_bounds`` =
            segments per shard), which also reduces each shard's k-th.

A merge of both rounds' candidates, de-duplicated by id, finishes.  Exact:
round-2 pruning only discards candidates whose lower bound exceeds an
upper bound on the global k-th distance.

Round 1 is the JAX package's: each shard's plain ``sweep_search`` beam
(``Snapshot.query(method="beam")``), not a kernel call.

Still to port (ROADMAP.md, queue 1, item 12): the frozen device-sharded
forest ``ShardedP2HIndex``, its ``shard_map`` query and ``_pad_tree``;
a ``mesh`` of more than one device raises ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import threading

import numpy as np
import torch

from repro_torch.core import search
from repro_torch.parallel.sharding import mesh_signature, require_one_device

__all__ = ["two_round_exchange", "warm_round1"]

# ---------------------------------------------------------------------------
# Round-1 template registry.
#
# The JAX package compiles round 1's per-segment sweep per tree shape and
# replays the recorded (B, k, frac1) templates against a freshly built
# tree before a compaction publishes it.  The port compiles nothing, so
# the registry only records: ``warm_round1`` counts what the JAX package
# would replay.  Templates are keyed by the topology signature, as the
# stacked registry keys its signatures.
_ROUND1_LOCK = threading.Lock()
_ROUND1_TEMPLATES: "collections.OrderedDict[tuple, None]" = (
    collections.OrderedDict())
_ROUND1_MAX_TEMPLATES = 8


def _record_round1(B: int, k: int, frac1: float) -> None:
    key = (int(B), int(k), float(frac1), mesh_signature())
    with _ROUND1_LOCK:
        _ROUND1_TEMPLATES[key] = None
        _ROUND1_TEMPLATES.move_to_end(key)
        while len(_ROUND1_TEMPLATES) > _ROUND1_MAX_TEMPLATES:
            _ROUND1_TEMPLATES.popitem(last=False)


def warm_round1(tree, *, is_bc: bool = True, templates=None) -> int:
    """The pre-publish warmup of the exchange's per-segment sweeps for
    ``tree``: the recorded ``(B, k, frac1)`` templates of this topology
    (or the ``templates`` given), each in its two forms (the round-1 beam
    and the capped round-2 sweep).  Nothing needs compiling here, so
    nothing runs; returns the number of (template, form) pairs, the count
    the JAX package's warmup replays."""
    del tree, is_bc  # no per-shape program to prepare
    if templates is not None:
        tpls = [tuple(t)[:3] for t in templates]
    else:
        sig = mesh_signature()
        with _ROUND1_LOCK:
            tpls = [key[:3] for key in _ROUND1_TEMPLATES if key[3] == sig]
    return 2 * len(tpls)


def _device_of(shards, default="cpu") -> torch.device:
    for s in shards:
        dev = getattr(s, "device", None)
        if dev is not None:
            return torch.device(dev)
    return torch.device(default)


def _merge(parts_d, parts_i, k: int, B: int, device):
    """Merge candidate lists (host arrays or device tensors, each (B, k_i))
    into the global top-k on ``device`` (``merge_topk``: de-duplicated by
    id, an id's smallest distance kept); host arrays out."""
    if not parts_d:
        return (np.full((B, k), np.inf, np.float32),
                np.full((B, k), -1, np.int32))
    dd = torch.cat([torch.as_tensor(p, dtype=torch.float32).to(device)
                    for p in parts_d], dim=1)
    ii = torch.cat([torch.as_tensor(p, dtype=torch.int32).to(device)
                    for p in parts_i], dim=1)
    bd, bi = search.merge_topk(dd, ii, k)
    return bd.cpu().numpy(), bi.cpu().numpy()


def _schedule_kw(bq, split) -> dict:
    """The kernels' schedule knobs, forwarded only when set (a backend
    with the JAX package's ``query`` signature takes neither)."""
    out = {}
    if bq is not None:
        out["bq"] = bq
    if split is not None:
        out["split"] = split
    return out


def two_round_exchange(shards, queries, k: int = 1, *, frac1: float = 0.25,
                       method: str = "sweep", frac: float = 1.0,
                       lambda_cap=None, return_info: bool = False,
                       stacked: bool | None = None,
                       probe_tiles: int | None = None,
                       probe_dtype: str | None = None,
                       mesh=None, mesh_axis: str = "shard",
                       deadline=None, resilience=None,
                       bq: int | None = None, split: int | None = None):
    """Host-orchestrated two-round lambda exchange over shard backends.

    ``shards`` is any sequence of backends with the ``Snapshot.query``
    signature::

        backend.query(q, k, method=..., frac=..., lambda_cap=...,
                      return_counters=True, include_deltas=...)
            -> (bd, bi, counters)

    answering with *global* ids over already-normalised ``(B, d)``
    queries -- in particular the per-shard :class:`repro_torch.stream.
    Snapshot` pins of a sharded mutable index (delta-only, multi-segment
    and mid-compaction shard states alike).

      round 1:  each shard runs its budgeted prefix scan (``method="beam"``
                at ``frac1``; deltas are always scanned exactly).  A
                shard's k-th is the distance of k real points, hence an
                upper bound on the global k-th; the min over shards,
                tightened by an externally valid ``lambda_cap``, is
                ``lambda0``.
      round 2:  each shard runs the full ``method`` over its *segments
                only* (round 1 already scanned every delta exactly, and
                its candidates reach the final merge) under
                ``lambda_cap=lambda0``; ``merge_topk`` de-duplicates and
                merges both rounds' candidates.

    ``method="beam"`` is budgeted and never consumes caps: one capless
    round at ``frac``.  ``return_info=True`` appends a dict with
    ``lambda0`` (B,), per-shard ``round1_kth`` (S, B) and ``shard_kth``
    (S, B), each shard's tightest valid local k-th bound (the lambda
    cache's per-shard invalidation unit).

    ``stacked`` controls round 2's segment-parallel form: the stackable
    shards' segment stacks are concatenated and swept by **one** stacked
    launch under ``lambda0`` (:func:`repro_torch.kernels.stacked_sweep.
    stacked_sweep_query` with ``probe_route="round2"`` -- one pass by
    default; ``probe_tiles``/``probe_dtype`` as there), which also merges
    across shards and reduces each shard's k-th.  ``None`` auto-promotes
    the exact ``sweep``/``pallas`` methods when the stackable shards' live
    segment fan-out reaches ``STACKED_FANOUT_DEFAULT`` on a dense enough
    grid; ``True`` (or ``method="stacked"``) forces it; ``False`` forbids
    it, here and in every shard (the sequential reference: with
    ``method="pallas"`` one sweep-kernel launch per segment).

    ``bq``/``split`` set the kernels' query block and CTAs per block on
    round 2 (``None``: the device's defaults).  ``mesh`` is ``None`` or
    one device; more raise (ROADMAP.md, queue 1, item 12).

    ``deadline`` (a :class:`repro_torch.serve.resilience.Deadline`) and/or
    ``resilience`` (a :class:`repro_torch.serve.resilience.
    ShardSupervisor`) switch to the degraded-capable twin
    :func:`_resilient_exchange`.  Both ``None`` keeps this path.
    """
    require_one_device(mesh)
    shards = tuple(shards)  # iterated once per round: reject generators
    sched = _schedule_kw(bq, split)
    if resilience is not None or deadline is not None:
        return _resilient_exchange(
            shards, queries, k, frac1=frac1, method=method, frac=frac,
            return_info=return_info, stacked=stacked,
            probe_tiles=probe_tiles, probe_dtype=probe_dtype,
            deadline=deadline, sup=resilience, sched=sched)
    q = np.ascontiguousarray(np.atleast_2d(np.asarray(queries, np.float32)))
    B = q.shape[0]
    device = _device_of(shards)
    counters = np.zeros((8,), np.int64)
    ext = (None if lambda_cap is None
           else np.asarray(lambda_cap, np.float32).reshape(-1))
    lam0 = None
    round1_kth = []
    parts_d, parts_i = [], []
    if method != "beam":
        _record_round1(B, k, frac1)  # template for pre-publish warmup
        lam = np.full((B,), np.inf, np.float32) if ext is None else ext
        for s in shards:
            bd1, bi1, c1 = s.query(q, k, method="beam", frac=frac1,
                                   return_counters=True)
            counters += np.asarray(c1, np.int64)
            kth1 = np.asarray(bd1, np.float32)[:, k - 1]
            round1_kth.append(kth1)
            lam = np.minimum(lam, kth1)
            # round-1 candidates (incl. the exact delta scan) feed the
            # final merge, so round 2 need not rescan the deltas
            parts_d.append(bd1)
            parts_i.append(bi1)
        lam0 = lam
    base = "sweep" if method == "stacked" else method
    stk_merged, stk_kth, cnt_stk = _stacked_round2(
        shards, q, k, method=method, stacked=stacked, lam0=lam0,
        probe_tiles=probe_tiles, probe_dtype=probe_dtype, sched=sched)
    if cnt_stk is not None:
        counters += cnt_stk
    if stk_merged is not None:
        # one launch already merged every stackable shard's segments and
        # reduced the per-shard k-ths: one merged candidate list
        parts_d.append(stk_merged[0])
        parts_i.append(stk_merged[1])
    round2_kth = []
    for si, s in enumerate(shards):
        if si in stk_kth:
            round2_kth.append(stk_kth[si])
            continue
        kw = ({"stacked": stacked, "probe_dtype": probe_dtype, **sched}
              if hasattr(s, "stacked_leaves") else {})
        bd, bi, cnt = s.query(q, k, method=base, frac=frac,
                              lambda_cap=lam0, return_counters=True,
                              include_deltas=method == "beam", **kw)
        counters += np.asarray(cnt, np.int64)
        round2_kth.append(np.asarray(bd, np.float32)[:, k - 1])
        parts_d.append(bd)
        parts_i.append(bi)
    bd, bi = _merge(parts_d, parts_i, k, B, device)
    if return_info:
        r2 = (np.stack(round2_kth) if round2_kth
              else np.zeros((0, B), np.float32))
        r1 = (np.stack(round1_kth) if round1_kth
              else np.full_like(r2, np.inf))
        # per-shard local k-th upper bounds: round-1 beam k-ths are
        # real-point distances; round-2 k-ths are too when finite (a
        # heavily-pruned far shard leaves +inf slots).  Their min is each
        # shard's tightest valid local bound.
        info = {
            "lambda0": None if lam0 is None else np.asarray(lam0),
            "round1_kth": r1,
            "shard_kth": np.minimum(r1, r2) if len(r2) else r2,
        }
        return bd, bi, counters, info
    return bd, bi, counters


def _stackable(pairs, method, stacked, lam0):
    """Resolve round 2's segment-parallel dispatch over ``pairs`` (``[(shard
    index, shard), ...]``): the pairs whose segment stacks one stacked
    launch sweeps, or ``[]`` when the sequential loop runs instead."""
    if (lam0 is None or stacked is False
            or method not in ("sweep", "pallas", "stacked")):
        return []
    stackable = [(si, s) for si, s in pairs
                 if callable(getattr(s, "stacked_leaves", None))
                 and len(getattr(s, "segments", ())) > 0]
    if stackable and stacked is None and method != "stacked":
        from repro_torch.kernels.stacked_sweep import (
            STACKED_DENSITY_DEFAULT, STACKED_FANOUT_DEFAULT, tile_density)

        fanout = sum(1 for _, s in stackable
                     for seg in s.segments if seg.live)
        all_segs = [seg for _, s in stackable for seg in s.segments]
        # the concatenated grid re-pads every shard to the global max tile
        # count, so density is judged on the flattened segment set
        if (fanout < STACKED_FANOUT_DEFAULT
                or tile_density(all_segs) < STACKED_DENSITY_DEFAULT):
            return []
    return stackable


def _launch_round2(stackable, q, k, *, lam0, probe_tiles, probe_dtype=None,
                   sched=None):
    """ONE stacked launch over the concatenated segment stacks of
    ``stackable`` (:func:`_stackable`) under ``lambda0``, with the
    in-launch merge and per-shard k-th reductions.  Returns ``((merged
    dists (B, k), merged global ids (B, k)), {shard index: per-shard k-th
    (B,)}, counters)``.  An error of the launch itself is no one shard's:
    it is raised as :class:`~repro_torch.serve.resilience.DeviceFault`."""
    from repro_torch.kernels.stacked_sweep import (concat_cached,
                                                   stacked_sweep_query)
    from repro_torch.serve.resilience import DeviceFault

    stks = [s.stacked_leaves() for _, s in stackable]
    combined = concat_cached(stks)
    is_bc = getattr(stackable[0][1], "variant", "bc") == "bc"
    try:
        # probe_route="round2": the sweep enters with lambda0, the
        # exchanged round-1 k-th, so the route's default is one pass
        fd, fi, cnt, info = stacked_sweep_query(
            combined, q, k, lambda_cap=lam0, probe_tiles=probe_tiles,
            probe_dtype=probe_dtype, probe_route="round2",
            shard_bounds=tuple(stk.num_segments for stk in stks),
            use_ball=is_bc, use_cone=is_bc, **(sched or {}))
    except Exception as e:
        members = [si for si, _ in stackable]
        raise DeviceFault(f"round 2's stacked launch over shards {members} "
                          f"failed: {e!r}") from e
    shard_kth = info["shard_kth"].cpu().numpy()  # (S_stackable, B)
    kths = {si: shard_kth[row] for row, (si, _) in enumerate(stackable)}
    return ((fd, fi), kths,
            cnt.cpu().numpy().astype(np.int64))


def _stacked_round2(shards, q, k, *, method, stacked, lam0, probe_tiles,
                    probe_dtype=None, sched=None):
    """Resolve and run the segment-parallel round 2 over ``shards``
    (:func:`_stackable`, then :func:`_launch_round2`) -- ``(None, {},
    None)`` when the sequential loop runs instead."""
    stackable = _stackable(enumerate(shards), method, stacked, lam0)
    if not stackable:
        return None, {}, None
    return _launch_round2(stackable, q, k, lam0=lam0, probe_tiles=probe_tiles,
                          probe_dtype=probe_dtype, sched=sched)


def _resilient_exchange(shards, queries, k, *, frac1, method, frac,
                        return_info, stacked, probe_tiles, probe_dtype,
                        deadline, sup, sched=None):
    """Degraded-capable twin of the two-round exchange: every shard call
    runs through a :class:`~repro_torch.serve.resilience.ShardSupervisor`
    (per-call budget clamped by ``deadline``, circuit breakers, one hedged
    duplicate for stragglers) and a failing shard produces **bounded
    degradation**, never an exception.

    Exactness contract: the returned neighbours are exactly the oracle's
    answers restricted to the live shards.  Three rules make that hold:

    * A shard missing from round 1 merely loosens ``lambda0`` -- the min
      over the *responding* shards' round-1 k-ths is still a valid upper
      bound for the surviving set.  An external ``lambda_cap`` is never
      consumed here: it bounds the *full*-set k-th, which can undercut the
      live-shard-restricted k-th and would prune live answers.
    * A shard contributes fully exact or not at all: when its round 2
      fails, its round-1 candidates are dropped too, and the shard is
      reported in ``missing_shards``.
    * Dropping a shard can loosen ``lambda0`` after other shards already
      swept under the tighter cap, so any surviving shard whose capped
      result still has pruned (+inf) slots under the stale cap runs again.
      Each pass either finishes cleanly or strictly grows the missing set,
      so it ends in <= S passes; an exhausted deadline fast-fails the
      re-runs into the missing set.

    The stacked round 2 runs as ONE supervised multi-shard call.  A shard
    fault or timeout there isolates the culprit: each member gets its own
    supervised call on the stacked route (one launch per shard; the JAX
    package runs them sequentially), so a failing kernel never gives way to
    a plain sweep.  An error of the launch itself is no shard's: it is
    raised (:class:`~repro_torch.serve.resilience.DeviceFault`).

    ``info`` gains ``missing_shards`` (sorted tuple), ``degraded`` and
    ``complete`` -- False iff some missing shard could hold a closer point
    (it has, or is not known not to have, live points).
    """
    if sup is None:
        from repro_torch.serve.resilience import ShardSupervisor

        sup = ShardSupervisor()
    sched = sched or {}
    q = np.ascontiguousarray(np.atleast_2d(np.asarray(queries, np.float32)))
    B = q.shape[0]
    S = len(shards)
    device = _device_of(shards)
    counters = np.zeros((8,), np.int64)
    missing: set[int] = set()
    r1_d, r1_i, r1_kth = {}, {}, {}
    if method != "beam":
        _record_round1(B, k, frac1)  # template for pre-publish warmup

        def mk_r1(s):
            return lambda: s.query(q, k, method="beam", frac=frac1,
                                   return_counters=True)

        # parallel round 1: a straggler costs min(budget, straggler), not
        # the sum over shards; the min-fold is order-insensitive
        res1 = sup.call_parallel(
            [((si,), mk_r1(s)) for si, s in enumerate(shards)],
            deadline=deadline)
        for si, (ok, val, _why) in enumerate(res1):
            if not ok:
                # not missing yet: the shard gets a round-2 attempt with
                # include_deltas=True (only a round-2 failure loses it)
                continue
            bd1, bi1, c1 = val
            counters += np.asarray(c1, np.int64)
            r1_d[si] = np.asarray(bd1, np.float32)
            r1_i[si] = np.asarray(bi1, np.int32)
            r1_kth[si] = r1_d[si][:, k - 1]
    base = "sweep" if method == "stacked" else method
    done2: dict[int, tuple] = {}   # si -> (bd, bi, kth (B,), gen)
    stk_units: list[tuple] = []    # (members, fd, fi, {si: kth}, gen)
    lam0 = None
    while True:
        gen = len(missing)
        lamk = [r1_kth[si] for si in sorted(r1_kth)]
        lam0 = (np.minimum.reduce(lamk).astype(np.float32)
                if (method != "beam" and lamk) else None)
        # retire results computed under a now-stale (tighter) cap whose
        # pruned +inf slots a looser lambda0 could fill in
        for si in [si for si, (_, _, kth, g) in done2.items()
                   if g != gen and bool(np.isinf(kth).any())]:
            del done2[si]
        stk_units = [u for u in stk_units
                     if not (u[4] != gen
                             and any(bool(np.isinf(np.asarray(v)).any())
                                     for v in u[3].values()))]
        covered = set(done2) | {si for u in stk_units for si in u[0]}
        todo = [si for si in range(S)
                if si not in missing and si not in covered]
        if not todo:
            break
        failed = False
        # combined stacked unit: stackable todo shards with round-1
        # results (an r1-failed shard needs include_deltas=True, which the
        # stacked launch does not do -- it goes sequential below)
        cand = [si for si in todo if si in r1_kth]
        isolated = set()
        if cand and lam0 is not None and stacked is not False:
            plan = _stackable([(si, shards[si]) for si in cand], method,
                              stacked, lam0)

            def stk_fn(plan=plan, lam_stk=lam0):
                if not plan:
                    return None, {}, None
                return _launch_round2(plan, q, k, lam0=lam_stk,
                                      probe_tiles=probe_tiles,
                                      probe_dtype=probe_dtype, sched=sched)

            ok, val, _why = sup.call(tuple(cand), stk_fn,
                                     deadline=deadline)
            if ok:
                merged, kths, cnt = val
                if merged is not None:
                    stk_units.append((tuple(sorted(kths)), merged[0],
                                      merged[1], kths, gen))
                    counters += cnt
                    todo = [si for si in todo if si not in kths]
            else:
                # every member stays in todo for an individual supervised
                # attempt (and verdict) below, on the launch's own kernel
                isolated = {si for si, _ in plan}
        for si in todo:
            s = shards[si]
            kw = {}
            if hasattr(s, "stacked_leaves"):
                kw = {"stacked": stacked, "probe_dtype": probe_dtype, **sched}
                if si in isolated:  # the failed launch's kernel, per shard
                    kw.update(stacked=True, probe_tiles=probe_tiles)
            inc = (method == "beam") or si not in r1_kth

            def fn(s=s, cap=lam0, inc=inc, kw=kw):
                return s.query(q, k, method=base, frac=frac,
                               lambda_cap=cap, return_counters=True,
                               include_deltas=inc, **kw)

            ok, val, _why = sup.call((si,), fn, deadline=deadline)
            if ok:
                bd, bi, cnt = val
                counters += np.asarray(cnt, np.int64)
                bd = np.asarray(bd, np.float32)
                done2[si] = (bd, np.asarray(bi, np.int32), bd[:, k - 1],
                             gen)
            else:
                # fully exact or not at all: drop the beam prefix too
                missing.add(si)
                r1_d.pop(si, None)
                r1_i.pop(si, None)
                r1_kth.pop(si, None)
                failed = True
        if not failed:
            break
    parts_d = [r1_d[si] for si in range(S) if si in r1_d]
    parts_i = [r1_i[si] for si in range(S) if si in r1_i]
    for _mem, fd, fi, _kths, _g in stk_units:
        parts_d.append(fd)
        parts_i.append(fi)
    for si in sorted(done2):
        parts_d.append(done2[si][0])
        parts_i.append(done2[si][1])
    bd, bi = _merge(parts_d, parts_i, k, B, device)
    if missing:
        sup.count("degraded_batches")
    if not return_info:
        return bd, bi, counters
    complete = True
    for si in sorted(missing):
        live = getattr(shards[si], "live_count", None)
        if live is None or live > 0:  # unknown -> assume it could
            complete = False
            break
    r1 = np.full((S, B), np.inf, np.float32)
    for si, v in r1_kth.items():
        r1[si] = v
    r2 = np.full((S, B), np.inf, np.float32)
    for si in done2:
        r2[si] = done2[si][2]
    for _mem, _fd, _fi, kths, _g in stk_units:
        for si, v in kths.items():
            r2[si] = np.asarray(v)
    info = {
        "lambda0": None if lam0 is None else np.asarray(lam0),
        "round1_kth": r1,
        "shard_kth": np.minimum(r1, r2),
        "missing_shards": tuple(sorted(missing)),
        "complete": complete,
        "degraded": bool(missing),
    }
    return bd, bi, counters, info
