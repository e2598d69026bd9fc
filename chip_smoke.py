#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py            # full size: 1,000,000 x 128 planted

Three paths, each through the entry points a user calls:

  * slice 1, the paper's: build a BC-Tree over the data, then answer exact
    top-k point-to-hyperplane queries (``P2HIndex.query(method="kernel")``)
    through the sweep kernel K1 (``csrc/p2h_sweep.cu``);
  * slice 2, the mutable index's read path: a ``MutableP2HIndex`` of 8
    sealed segments (7 rounds of ``insert_batch`` + ``compact`` after the
    bulk load), a live delta and deletes over every segment, queried with
    ``method="stacked"`` through the stacked kernel K2
    (``csrc/stacked_sweep.cu``) in each probe mode;
  * slice 5, serving: both indexes served through ``P2HEngine``
    (micro-batches, dispatch, the lambda cache) -- the frozen one by K1,
    the mutable one by K2 -- and acknowledged writes recovered from a
    write-ahead log;
  * slice 6, the sharded index: a ``ShardedMutableP2HIndex`` of 8 hashed
    shards queried through the two-round lambda exchange, whose round 2 is
    one K2 launch over every shard's segments (K1 once per segment on the
    sequential route), served by ``P2HEngine``, degraded around failing
    shards, and, on a smaller index with per-shard logs, split, merged,
    saved and recovered.

Phases, one line each:

  1. platform   the card (nvidia-smi name and power limit), precision
  2. build      one nvcc per kernel source, all started together, for
                sm_90a; ptxas' registers and spills per instance, failing
                if an instance the main paths launch (bq = 64) spills
  3. data       host build of the data and the tree; index size
  4. kernel     K1 against its plain PyTorch version on the same operands
                at the card's schedule (bq = 64 query blocks, `split` CTAs
                per block, the plain version at the same split): distances,
                ids (apart from ties), skip counts
  5. query      ``P2HIndex.query(method="kernel")`` on every query against
                the brute-force oracle, with the launch count of that run;
                ``sweep`` and ``dfs`` on a few queries; every exact route's
                ids held to the oracle's with ties judged on float64
                distances (``assert_exact_topk``), and the f32 oracle's own
                distance from a float64 oracle measured;
                ``beam`` with its recall
  6. timing     CUDA-event times of K1 (and its device time alone, from a
                profiler trace), of K1 at the old schedule (bq = 8,
                split = 1), of a warm batch, of phase 1, of the plain
                version and of a brute-force scan, beside the kernel's
                bound (valid rows)
  7. stacked    the mutable index: build time, segments, tiles, the
                stacked planes' bytes; per probe mode (f32 two-pass,
                one pass, bf16 probe, int8 probe) the whole ``query`` at
                the card's defaults held to the oracle over the live set,
                its launches counted (K2 twice for a two-pass query, once
                for one pass, K1 never); the bf16/int8/one-pass answers and
                the f32 answer at bq = 8, split = 1 equal the f32 one bit
                for bit; the sequential walk (K1 with caps) on a few
                queries equals the stacked answer; every K2 launch of those
                runs replayed against its plain version at its (bq, split):
                distances bit for bit, skip counts equal; CUDA-event and
                device times, bounds, the plain version's time, the f32
                batch at bq = 8, split = 1, a warm batch and a brute-force
                scan of the live set
  9. serve      phase 3's and phase 7's indexes behind ``P2HEngine`` at
                slot_size 1024: the drop-in ``query`` (launches counted from
                0, K1 for the frozen index, K2 for the mutable one) and the
                streaming submit/flush/result, each equal to the oracle and
                bit for bit to the direct route (``method="kernel"`` /
                ``"stacked"``); a hot trace (256 normals, each 4 times,
                perturbed) served cold then warm from the lambda cache:
                warm equal to cold bit for bit, warm skips >= cold; the
                k-th neighbours of cached queries deleted and the next warm
                answer held to the oracle over the live set; q/s, p50 and
                p99 per batch at slot_size 8, 64 and 1024 with launches per
                batch; the latency of one batch at occupancy 1 and 2 on the
                ``dfs`` route beside the kernel route; a fresh
                125,000-point ``MutableP2HIndex`` with a ``ShardWal`` under
                ``build/``: acknowledged inserts and deletes, ``save``, more
                writes, ``load(wal=)`` into a new object holding exactly
                the acknowledged live set and answering as the oracle does
                (acknowledgement latency and recovery seconds: host I/O)
 10. sharded    ``ShardedMutableP2HIndex.from_data`` over phase 3's data:
                8 hashed shards of ~125,000 points, each one sealed
                segment; 4,096 routed inserts left in the deltas and
                10,000 deletes.  The default ``query`` (round 2
                auto-promoted to one K2 launch), ``method="stacked"`` in
                f32 and with a bf16 probe, and the sequential round 2
                (``stacked=False, method="pallas"``: K1 once per segment)
                on 64 queries, each held to the oracle over the live set,
                no deleted id, ``lambda0`` >= the oracle's k-th; every K2
                launch of those runs replayed against ``stacked_sweep_ref``
                at its ``bq``/``split`` (distances bit for bit, skips
                equal) and one K1 launch against ``p2h_sweep_ref``; a warm
                exchange batch split into round 1 (eight plain beams),
                round 2 (its K2 launch by CUDA events) and the merges;
                ``P2HEngine`` at slot_size 64 and 1024, cold and warm, equal
                to the direct query, a delete that drops one shard's cache
                component, q/s and p50/p99; the resilient exchange with
                shards {3} and {0, 5} failing, equal to the oracle over the
                live shards; and a 4-shard 125,000-point index with
                per-shard logs under ``build/chip_smoke_sharded/``:
                acknowledged writes, ``split_shard`` under exact queries,
                ``merge_shards``, ``save``, more writes, a drop and
                ``open``, holding exactly the acknowledged writes
  8. kernels    one JSON line, after every phase: per kernel its launches
                (by phase), error and times

then the card's nvidia-smi line and, last, the result line
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without the result line; it also exits non-zero when there
is no CUDA device or when the package is not beside it.  It takes no
arguments; ``run`` takes smaller sizes for a rehearsal on the host.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

K, SEED, BEAM_FRAC = 10, 0, 0.05
RTOL, ATOL = 1e-5, 1e-6
# phase 10's tie tolerance in units of u S (``hold64``): u the f32 unit
# roundoff, S a row's largest sum_j |q_j x_j| over the oracle's candidates.
# Two routes may swap two points only where their float64 distances differ
# by less than two f32 errors, each measured at up to 2.96 u S on an H100
# (the oracle's and the answers' alike; the largest swap gap seen, 1.31)
U32, TIE_UNITS = 2.0 ** -24, 6.0
# NVIDIA H100 SXM data sheet: HBM3 bandwidth; dense peaks by input type
# (f32 outside the tensor cores), at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_OPS = {"f32": PEAK_F32_FLOPS, "bf16": 989e12, "int8": 1979e12}
# the stacked index: rounds of bulk inserts (one sealed segment each),
# fresh points left in the delta, deleted gids, sequential-walk queries
ROUNDS, FRESH, DELETES, SEQ_QUERIES = 8, 4096, 10_000, 64
# serving: the hot trace's distinct normals, the slot sizes timed, the
# occupancies timed on the dfs route; the durable-writes index and its ops
HOT, SLOTS, OCCUPANCIES = 256, (8, 64, 1024), (1, 2)
WAL_N, WAL_INSERTS, WAL_DELETES, WAL_MORE = 125_000, 4096, 1000, 1024
# the sharded index: hashed shards (one sealed segment each), the slot
# sizes it is served at, the failing shard sets of the degraded checks;
# the durable sharded index: points, shards, acknowledged writes before
# the split and after the save
SHARDS, SHARD_SLOTS, FAILING = 8, (64, 1024), ((3,), (0, 5))
DUR_N, DUR_SHARDS, DUR_WRITES, DUR_MORE = 125_000, 4, (2048, 512), (512, 128)
SRC = Path(__file__).resolve().parent / "src"
BUILD = Path(__file__).resolve().parent / "build"
# the kernel instances the main paths launch (bq = 64; K2 in its three
# probe modes; bq = 8 for a serving batch of 8 slots); none may spill
MAIN_INSTANCES = tuple(
    f"{name}<{bq}{mode}>" for bq in (64, 8)
    for name, modes in (("p2h_sweep_kernel", ("",)),
                        ("stacked_sweep_kernel", (",0", ",1", ",2")))
    for mode in modes)


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_instances(report: str) -> dict:
    """``{"kernel<bq,mode>": (registers, spill store bytes, spill load
    bytes)}`` from ``ptxas -v``'s report of one library."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:entry function '|Function properties for )"
                      r"\S*?(p2h_sweep_kernel|stacked_sweep_kernel)I(\w*?)EEv",
                      line)
        if m:
            args = ",".join(re.findall(r"Li(\d+)E", m.group(2) + "E"))
            name = f"{m.group(1)}<{args}>"
            out.setdefault(name, [0, 0, 0])
            continue
        if name is None:
            continue
        if "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill", line)
            out[name][1:] = [int(st), int(ld)]
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def timed_ms(fn, reps: int, device) -> float:
    """Mean ms of ``fn()`` over ``reps`` back-to-back calls (CUDA events on
    the card, the host clock on the CPU); ``fn`` was warmed up before."""
    import torch

    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def brute_topk(points, queries, k: int, chunk: int = 65536):
    """The library yardstick: chunked ``torch.topk`` of ``|Q @ X^T|``."""
    import torch

    best_d = best_i = None
    for off in range(0, points.shape[0], chunk):
        d, i = torch.topk(torch.abs(queries @ points[off:off + chunk].T), k,
                          dim=1, largest=False)
        i = i + off
        if best_d is not None:
            d, j = torch.topk(torch.cat([best_d, d], 1), k, dim=1,
                              largest=False)
            i = torch.gather(torch.cat([best_i, i], 1), 1, j)
        best_d, best_i = d, i
    return best_d, best_i


def check(what, *answers, exact=False, rtol=RTOL, atol=ATOL):
    """Hold an answer to a reference (``assert_topk_close``) or, with
    ``exact``, to the oracle at float64 (``assert_exact_topk``); raises
    ``AssertionError`` naming ``what``."""
    from repro_torch.core.exact import assert_exact_topk, assert_topk_close

    try:
        if exact:
            return assert_exact_topk(*answers, rtol=rtol, atol=atol)
        return assert_topk_close(*answers, rtol=rtol, atol=atol)
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None


def run(device, *, n=1_000_000, d=128, queries=1024, n0=256,
        sweep_queries=64, dfs_queries=16, reps=10, sweep_n=None,
        fresh=FRESH, deletes=DELETES, hot=HOT, slots=SLOTS, wal_n=WAL_N,
        wal_inserts=WAL_INSERTS, wal_deletes=WAL_DELETES,
        wal_more=WAL_MORE, shards=SHARDS, shard_slots=SHARD_SLOTS,
        failing=FAILING, dur_n=DUR_N, dur_shards=DUR_SHARDS,
        dur_writes=DUR_WRITES, dur_more=DUR_MORE) -> dict:
    """All phases on ``device`` at these sizes (the defaults are the full
    size; ``sweep_n`` cuts slice 1's depth alone); returns the kernels
    record."""
    import torch

    from repro_torch.kernels import _build
    from repro_torch.launch import platform

    # 1. platform
    device = platform.resolve_device(device)
    report = platform.device_report()
    card = nvidia_smi() if device.type == "cuda" else "no card"
    log("platform", card=repr(card), device=report["name"],
        count=report["count"], allow_tf32=report["allow_tf32"],
        matmul_precision=report["matmul_precision"],
        torch=torch.__version__, cuda=torch.version.cuda)

    # 2. build every kernel, one nvcc per source, all at once
    if device.type == "cuda":
        t0 = time.perf_counter()
        reports = _build.build(force=True)
        log("build", seconds=f"{time.perf_counter() - t0:.1f}",
            target="sm_90a", libraries=",".join(
                _build.library_path(name).name for name in _build.SOURCES))
        instances = {}
        for ptxas in reports.values():
            instances.update(ptxas_instances(ptxas))
        for inst, (regs, st, ld) in sorted(instances.items()):
            log("build", instance=inst, registers=regs, spill_stores=st,
                spill_loads=ld)
        for inst in MAIN_INSTANCES:  # the main path's instances
            if inst not in instances or any(instances[inst][1:]):
                raise AssertionError(f"{inst}: missing from ptxas' report or "
                                     f"spills ({instances.get(inst)})")
    k1, frozen = run_sweep(device, card, n=sweep_n or n, d=d,
                           queries=queries, n0=n0,
                           sweep_queries=sweep_queries,
                           dfs_queries=dfs_queries, reps=reps)
    k2, mutable = run_stacked(device, card, n=n, d=d, queries=queries,
                              n0=n0, reps=reps, fresh=fresh, deletes=deletes)
    served = run_serve(device, card, frozen, mutable, hot=hot, slots=slots,
                       wal_n=wal_n, wal_inserts=wal_inserts,
                       wal_deletes=wal_deletes, wal_more=wal_more)
    del mutable  # phase 10 holds its own copy of the data on the card
    gc.collect()
    sharded = run_sharded(device, card, frozen["x"], frozen["q"], n0=n0,
                          reps=reps, shards=shards, fresh=fresh,
                          deletes=deletes, slots=shard_slots,
                          failing=failing, dur_n=dur_n,
                          dur_shards=dur_shards, dur_writes=dur_writes,
                          dur_more=dur_more)
    for rec, phase in ((k1, "5 query"), (k2, "7 stacked f32")):
        rec["launches_by_phase"] = {
            phase: rec["launches"], "9 serve": served[rec["name"]],
            **{ph: n[rec["name"]] for ph, n in sharded.items()}}
        rec["launches"] = sum(rec["launches_by_phase"].values())
    return {"kernels": [k1, k2]}


def run_sweep(device, card, *, n, d, queries, n0, sweep_queries,
              dfs_queries, reps) -> dict:
    """Slice 1, phases 3-6; returns K1's record and what phase 9 reuses:
    the index, the raw queries and the oracle's answer to them."""
    import torch

    from repro_torch.core.api import P2HIndex
    from repro_torch.core.balltree import append_ones, normalize_query
    from repro_torch.core.exact import dists64, exact_search
    from repro_torch.data.pipeline import make_p2h_dataset
    from repro_torch.kernels import ops, p2h_scan
    from repro_torch.kernels.ref import p2h_sweep_ref

    k = K
    p2h_sweep = p2h_scan.p2h_sweep

    # 3. data and tree (host numpy), then onto the device
    t0 = time.perf_counter()
    x, q = make_p2h_dataset(n, d, kind="planted", n_queries=queries,
                            seed=SEED)
    t_data = time.perf_counter() - t0
    index = P2HIndex.build(x, n0=n0, variant="bc", seed=SEED, device=device)
    tree = index.tree
    log("data", n=n, d=d, queries=queries,
        data_seconds=f"{t_data:.1f}",
        tree_build_seconds=f"{index.report.build_seconds:.1f}",
        leaves=tree.num_leaves, nodes=tree.num_nodes, depth=tree.max_depth,
        index_bytes=index.report.index_bytes,
        tile_bytes=tree.points.nbytes)
    qn = torch.from_numpy(normalize_query(q)).to(device)
    pts = torch.from_numpy(append_ones(x)).to(device)
    # the oracle's top-(k+1): the answer, and the (k+1)-th the tie rule
    # needs -- the same for every exact route
    od, oi1 = exact_search(pts, qn, k + 1)
    od, oi, nxt = od[:, :k].cpu(), oi1[:, :k].cpu(), od[:, k].cpu().numpy()
    # measured, not checked: how far f32 arithmetic itself stands from the
    # float64 top-k -- the f32 oracle's ids against a float64 oracle's, at
    # float64 distances; the rows off by more than the tolerance are rows
    # whose order no f32 route can be held to
    oi64 = exact_search(pts.double(), qn.double(), k + 1)[1]
    ref64 = dists64(pts, qn, oi64[:, :k])[0]
    gap = (torch.sort(dists64(pts, qn, oi1[:, :k])[0], 1).values
           - ref64).abs()
    log("oracle", f32_rows_off_float64=int(
        (gap > ATOL + RTOL * ref64).any(1).sum()), max_gap=float(gap.max()))

    # 4. the kernel against its plain version, same operands, at the card's
    #    schedule: bq = the smallest block of the batch up to 64, split =
    #    the CTAs per block that fill the SMs in one wave
    bq = p2h_scan.resolve_bq(None, queries, device)
    opnds, _ = ops.prepare_operands(tree, qn, bq=bq)
    nqb, n_visit = opnds["visit"].shape
    split = p2h_scan.default_split(opnds, k=k, bq=bq)
    kd, ki, ks = p2h_sweep(**opnds, k=k, bq=bq, split=split)
    rd, ri, rs, live = p2h_sweep_ref(**opnds, k=k, bq=bq, split=split,
                                     return_live=True)
    sync(device)
    max_err = check("kernel vs plain", kd.cpu(), ki.cpu(), rd.cpu(),
                    ri.cpu(), nxt)
    if not torch.equal(ks, rs):
        raise AssertionError(f"skip counts differ: {int(ks.sum())} vs "
                             f"{int(rs.sum())}")
    # clusters the card holds at once, by split, at these shapes: the
    # default split is the largest whose nqb clusters all fit
    clusters = "n/a"
    if device.type == "cuda":
        shapes = dict(bq=bq, n0=tree.n0, dp=opnds["queries"].shape[1], k=k)
        clusters = ",".join(
            f"{sp}:{p2h_scan.max_active_clusters(split=sp, **shapes)}"
            for sp in p2h_scan.SUPPORTED_SPLIT)
    log("kernel", match=True, max_abs_err=max_err,
        distances_bit_equal=bool(torch.equal(kd, rd)), bq=bq, split=split,
        ctas=nqb * split, clusters_by_split=clusters, blocks=nqb,
        visits=nqb * n_visit, skips=int(ks.sum()),
        plain_skips=int(rs.sum()), skips_equal=True,
        live_pairs=int(live.sum()))

    # 5. the main path through the user's entry point, launches counted
    p2h_sweep.launches = 0
    t0 = time.perf_counter()
    bd, bi, stats = index.query(q, k, method="kernel", return_stats=True)
    query_s = time.perf_counter() - t0
    launches = p2h_sweep.launches
    if launches < 1:
        raise AssertionError("the main path launched no kernel")
    if not (np.isfinite(bd).all() and bd.shape == (queries, k)):
        raise AssertionError("kernel route gave non-finite or misshapen "
                             "distances")
    err = check("query(kernel) vs oracle", bd, bi, od, oi, nxt)
    err64 = check("query(kernel) vs oracle, float64", bd, bi, oi1, pts, qn,
                  exact=True)
    log("query", method="kernel", queries=queries, k=k,
        equals_oracle=True, max_abs_err=err, f32_vs_f64_err=err64,
        launches=launches,
        host_seconds=f"{query_s:.3f}",
        leaves_scanned=stats["leaves_scanned"],
        tiles_skipped=stats["tiles_skipped"])
    for method, nq in (("sweep", sweep_queries), ("dfs", dfs_queries)):
        t0 = time.perf_counter()
        md, mi, st = index.query(q[:nq], k, method=method, return_stats=True)
        sec = time.perf_counter() - t0
        err = check(f"query({method}) vs oracle, float64", md, mi,
                    oi1[:nq], pts, qn[:nq], exact=True)
        log("query", method=method, queries=nq, equals_oracle=True,
            f32_vs_f64_err=err, host_seconds=f"{sec:.2f}", **st)
    t0 = time.perf_counter()
    _, beam_i = index.query(q, k, method="beam", frac=BEAM_FRAC)
    sec = time.perf_counter() - t0
    oi_np = oi64[:, :k].cpu().numpy()
    recall = np.mean([len(set(beam_i[b]) & set(oi_np[b])) / k
                      for b in range(queries)])
    log("query", method="beam", frac=BEAM_FRAC, recall=f"{recall:.4f}",
        host_seconds=f"{sec:.3f}")

    # 6. timing at the main path's shapes, and the same kernel at the old
    #    schedule (bq = 8, one CTA per block) on the same queries
    kernel_ms = timed_ms(lambda: p2h_sweep(**opnds, k=k, bq=bq, split=split),
                         reps, device)
    dev_ms = device_ms(lambda: p2h_sweep(**opnds, k=k, bq=bq, split=split),
                       reps, device, "p2h_sweep_kernel")
    batch_ms = timed_ms(lambda: index.query(q, k, method="kernel"), 3,
                        device)
    old, _ = ops.prepare_operands(tree, qn, bq=8)
    p2h_sweep(**old, k=k, bq=8, split=1)  # warm-up
    bq8_ms = timed_ms(lambda: p2h_sweep(**old, k=k, bq=8, split=1), reps,
                      device)
    phase1_ms = timed_ms(lambda: ops.prepare_operands(tree, qn, bq=bq),
                         reps, device)
    plain_ms = timed_ms(lambda: p2h_sweep_ref(**opnds, k=k, bq=bq,
                                              split=split), 1, device)
    brute_topk(pts, qn, k)  # warm-up
    library_ms = timed_ms(lambda: brute_topk(pts, qn, k), reps, device)
    bytes_ms, ops_ms, pairs, nbytes, flops = sweep_bound(
        opnds, live, tree.d, ks, kd.nbytes + ki.nbytes + ks.nbytes)
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log("timing", card=repr(card), kernel_ms=f"{kernel_ms:.4f}",
        device_ms=dev_ms, batch_ms=f"{batch_ms:.3f}",
        bq=bq, split=split, bq8_split1_ms=f"{bq8_ms:.4f}",
        phase1_ms=f"{phase1_ms:.4f}", plain_ms=f"{plain_ms:.3f}",
        library_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, bytes=int(nbytes), flops=int(flops),
        scanned_pairs=pairs, reps=reps)
    record = {
        "name": "p2h_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/p2h_sweep.cu",
        "replaces": "src/repro/kernels/p2h_scan.py:55",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }
    return record, dict(index=index, x=x, q=q, pts=pts, qn=qn,
                        oracle=(od, oi, nxt), oracle_ids=oi1)


def sweep_bound(opnds: dict, live, d: int, skips, out_bytes: int):
    """The least time for one K1 launch on these inputs: the larger of
    (each input read once, each output written once) over the memory rate
    and 2*bq*d operations per valid (non-pad) row of each (block, tile)
    pair the launch scanned, at the true width ``d``, over the f32 peak.
    Bytes read: the valid rows of the tiles some block scanned, at width d
    plus their 4 tables; every other operand whole.  Pad rows are neither
    loaded nor scored by the kernel, so they are not counted.  Returns
    (bytes ms, operations ms, scanned pairs, bytes, operations)."""
    import torch

    nqb, n_visit = opnds["visit"].shape
    bq = opnds["queries"].shape[0] // nqb
    pairs = int(live.sum())
    if pairs != nqb * n_visit - int(skips.sum()):
        raise AssertionError("the kernel's and the plain version's scanned "
                             "pairs differ")
    valid = (opnds["ids_tiles"] >= 0).sum(dim=1)  # (L,)
    scanned = opnds["visit"].long()[live]
    tiles = torch.unique(scanned)
    nbytes = int(valid[tiles].sum()) * (d + 4) * 4
    nbytes += opnds["queries"].shape[0] * d * 4
    nbytes += sum(t.nbytes for name, t in opnds.items() if name not in (
        "pts_tiles", "ids_tiles", "rx_tiles", "xc_tiles", "xs_tiles",
        "queries"))
    nbytes += out_bytes
    flops = 2.0 * bq * d * int(valid[scanned].sum())
    return (nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3,
            pairs, nbytes, flops)


def device_ms(fn, reps: int, device, kernel: str):
    """Mean device time per call of the kernels whose name holds
    ``kernel``, over ``reps`` calls of ``fn``, from a ``torch.profiler``
    trace of the card: the kernel alone, without the wrapper's host work
    and the small launches around it.  None on the host, or where the
    trace holds no such kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if kernel in e.key)
    return us / 1e3 / reps if us else None


def timed_call(fn, device):
    """``(fn(), ms)`` of one call (CUDA events on the card)."""
    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def stacked_bound(rec: dict, live, d: int) -> tuple[float, float, int]:
    """The least time for one stacked launch on these inputs: the larger
    of (each input read once and each output written once) over the memory
    rate, and 2*bq*d operations per valid (non-pad, live) row of each
    (segment, block, tile) the launch scanned, at the true width ``d``,
    over the card's peak for the points' type.  Bytes read: the valid rows
    of the tiles some block scanned, at their own width plus their 4
    tables; the node bounds only where the launch needs them -- ``leaf_lb``
    at every visited (segment, query, tile), to decide the skip, and
    ``leaf_ip`` at the queries of scanned pairs; every other operand whole.
    Pad and tombstoned rows are never scored, so they are not counted.
    Returns (bytes ms, operations ms, scanned pairs); the bound is the
    larger time."""
    import torch

    pts = rec["pts_tiles"]
    N = pts.shape[0]
    nqb, n_visit = rec["visit"].shape[1:]
    B = rec["queries"].shape[0]
    bq, k = B // nqb, rec["k"]
    pairs = int(live.sum())
    valid = (rec["ids_tiles"] >= 0).sum(dim=-1)  # (N, L)
    rows = scanned = 0
    for s in range(N):
        tiles = rec["visit"][s].long()[live[s]]
        rows += int(valid[s][torch.unique(tiles)].sum())
        scanned += int(valid[s][tiles].sum())
    nbytes = rows * (d * pts.element_size() + 16)
    nbytes += (N * B * n_visit + pairs * bq) * 4  # leaf_lb, leaf_ip
    nbytes += sum(t.nbytes for name, t in rec.items()
                  if isinstance(t, torch.Tensor) and name not in (
                      "pts_tiles", "ids_tiles", "rx_tiles", "xc_tiles",
                      "xs_tiles", "leaf_ip", "leaf_lb"))
    nbytes += N * B * k * 8 + N * nqb * 4  # outputs
    ops = 2.0 * bq * d * scanned
    dtype = rec.get("probe_dtype", "f32")
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    return bytes_ms, ops / PEAK_OPS[dtype] * 1e3, pairs


def run_stacked(device, card, *, n, d, queries, n0, reps,
                rounds=ROUNDS, fresh=FRESH, deletes=DELETES,
                seq_queries=SEQ_QUERIES) -> dict:
    """Slice 2, phase 7: the mutable index's stacked read path; returns
    K2's record and what phase 9 reuses: the index, its deleted gids and
    the oracle's view of its live set."""
    import torch

    from repro_torch.core import search
    from repro_torch.core.balltree import normalize_query
    from repro_torch.core.exact import exact_search
    from repro_torch.data.pipeline import make_p2h_dataset
    from repro_torch.kernels import p2h_scan, ref
    from repro_torch.kernels import stacked_sweep as tss
    from repro_torch.stream import CompactionPolicy, MutableP2HIndex

    k = K
    x, q = make_p2h_dataset(n, d, kind="planted", n_queries=queries,
                            seed=SEED)
    chunk = n // rounds
    rng = np.random.default_rng(SEED + 1)
    t0 = time.perf_counter()
    m = MutableP2HIndex.from_data(
        x[:chunk], n0=n0, device=device,
        policy=CompactionPolicy(delta_capacity=chunk, tombstone_frac=0.95,
                                max_segments=32))
    for r in range(1, rounds):  # each full delta seals into a segment
        m.insert_batch(x[r * chunk:(r + 1) * chunk])
        m.compact()
    sync(device)
    build_s = time.perf_counter() - t0
    near = x[rng.choice(n, fresh)] + rng.normal(
        scale=0.05, size=(fresh, d)).astype(np.float32)
    m.insert_batch(near)  # stays in the delta
    dead = rng.choice(rounds * chunk, deletes, replace=False)
    t0 = time.perf_counter()
    for g in dead:
        if not m.delete(int(g)):
            raise AssertionError(f"gid {g} was not live")
    sync(device)
    delete_s = time.perf_counter() - t0
    snap = m.snapshot()
    if len(snap.segments) != rounds or snap.delta_live != fresh:
        raise AssertionError(f"{len(snap.segments)} segments and "
                             f"{snap.delta_live} delta rows, expected "
                             f"{rounds} and {fresh}")
    t0 = time.perf_counter()
    stk = snap.stacked_leaves()
    sync(device)
    stack_s = time.perf_counter() - t0
    planes = sum(getattr(stk, f.name).nbytes
                 for f in dataclasses.fields(stk)
                 if isinstance(getattr(stk, f.name), torch.Tensor))
    log("stacked-data", n=n, segments=len(snap.segments),
        delta_rows=snap.delta_live, deleted=deletes,
        live=snap.live_count, tiles=stk.num_tiles,
        build_seconds=f"{build_s:.1f}",
        segment_build_seconds=",".join(
            f"{c['wall_s']:.1f}" for c in m.compaction_log),
        delete_seconds=f"{delete_s:.2f}", stack_seconds=f"{stack_s:.2f}",
        stacked_plane_bytes=planes)

    # the oracle over the live set; answers carry global ids, so the
    # points are laid out by gid for the float64 check
    X, G = snap.live_points()
    pts = torch.from_numpy(X).to(device)
    qn = torch.from_numpy(normalize_query(q)).to(device)
    od, oi1 = exact_search(pts, qn, k + 1)
    gid_t = torch.from_numpy(G.astype(np.int64)).to(device)
    ref_i = gid_t[oi1.long()]
    by_gid = torch.zeros((int(G.max()) + 1, X.shape[1]),
                         dtype=torch.float32, device=device)
    by_gid[gid_t] = pts
    od_k, oi_k = od[:, :k].cpu(), ref_i[:, :k].cpu()
    nxt = od[:, k].cpu().numpy()
    dead_set = set(dead.tolist())

    modes = [("f32", {}), ("single", dict(probe_tiles=0)),
             ("bf16", dict(probe_dtype="bf16")),
             ("int8", dict(probe_dtype="int8"))]
    real = tss.stacked_sweep

    def recorded_query(**kw):
        """``m.query(method="stacked")`` with each K2 launch's operands
        kept for the replay; returns (answer, records, launches, host
        seconds)."""
        recs = []

        def recording(*args, **kws):
            recs.append(kws)
            return real(*args, **kws)

        tss.stacked_sweep = recording
        tss.LAUNCHES = p2h_scan.p2h_sweep.launches = 0
        try:
            sync(device)
            t0 = time.perf_counter()
            out = m.query(q, k, method="stacked", return_stats=True, **kw)
            host_s = time.perf_counter() - t0
        finally:
            tss.stacked_sweep = real
        if p2h_scan.p2h_sweep.launches:
            raise AssertionError("the stacked route launched K1")
        for rec in recs:  # the schedule each launch took
            if rec["split"] is None:
                rec["split"] = tss.default_split(
                    rec, k=rec["k"], bq=rec["bq"],
                    probe_dtype=rec.get("probe_dtype", "f32"))
        return out, recs, tss.LAUNCHES, host_s

    answers, records, launches = {}, {}, {}
    for name, kw in modes:  # at the card's defaults: bq and split None
        (bd, bi, st), records[name], launches[name], host_s = \
            recorded_query(**kw)
        want = 1 if name == "single" else 2
        if launches[name] != want:
            raise AssertionError(
                f"{name}: {launches[name]} stacked launches (want {want})")
        if not (np.isfinite(bd).all() and bd.shape == (queries, k)):
            raise AssertionError(f"{name}: non-finite or misshapen answer")
        if dead_set & set(bi.ravel().tolist()):
            raise AssertionError(f"{name}: a deleted gid was returned")
        err = check(f"stacked {name} vs oracle", bd, bi, od_k, oi_k, nxt)
        err64 = check(f"stacked {name} vs oracle, float64", bd, bi, ref_i,
                      by_gid, qn, exact=True)
        answers[name] = (bd, bi)
        rec = records[name][-1]
        log("stacked-query", mode=name, queries=queries, k=k,
            equals_oracle=True, max_abs_err=err, f32_vs_f64_err=err64,
            launches=launches[name], bq=rec["bq"], split=rec["split"],
            host_seconds=f"{host_s:.3f}",
            leaves_scanned=st["leaves_scanned"],
            tiles_skipped=st["tiles_skipped"], verified=st["verified"])
    fd, fi = answers["f32"]
    for name in ("single", "bf16", "int8"):
        bd, bi = answers[name]
        if not np.array_equal(bd, fd):
            raise AssertionError(f"{name} distances differ from f32's")
        check(f"{name} ids vs f32", bd, bi, fd, fi, rtol=0.0, atol=0.0)
    # the f32 two-pass batch at the old schedule: bq = 8, one CTA a block
    (od8, oi8, _), old_recs, _, _ = recorded_query(bq=8, split=1)
    if not np.array_equal(od8, fd):
        raise AssertionError("bq=8, split=1 distances differ from the card "
                             "schedule's")
    check("bq=8, split=1 ids vs the card schedule", od8, oi8, fd, fi,
          rtol=0.0, atol=0.0)

    # the sequential walk: one K1 launch per segment, capped by the
    # running k-th
    p2h_scan.p2h_sweep.launches = 0
    t0 = time.perf_counter()
    sd, si, sst = m.query(q[:seq_queries], k, method="pallas",
                          stacked=False, return_stats=True)
    seq_s = time.perf_counter() - t0
    err = check("sequential walk vs stacked", sd, si, fd[:seq_queries],
                fi[:seq_queries], nxt[:seq_queries])
    log("stacked-sequential", queries=seq_queries, equals_stacked=True,
        max_abs_err=err, sweep_launches=p2h_scan.p2h_sweep.launches,
        host_seconds=f"{seq_s:.3f}", leaves_scanned=sst["leaves_scanned"],
        tiles_skipped=sst["tiles_skipped"])

    # every K2 launch of those runs against its plain version at the same
    # schedule, timed
    max_err, totals = 0.0, {}
    for name, recs in records.items():
        for i, rec in enumerate(recs):
            pass_name = (("A", "B")[i] if len(recs) == 2 else "AB")
            (kd, ki, ks), _ = timed_call(lambda: real(**rec), device)
            (rd, ri, rs, live), plain_ms = timed_call(
                lambda: ref.stacked_sweep_ref(**rec, return_live=True),
                device)
            if not torch.equal(ks, rs):
                raise AssertionError(f"{name} pass {pass_name}: skip counts "
                                     f"differ")
            if not torch.equal(kd, rd):
                raise AssertionError(
                    f"{name} pass {pass_name}: distances differ from the "
                    f"plain version's by up to "
                    f"{float((kd - rd).abs().nan_to_num().max())}")
            # ids: equal apart from exact ties, the k-th place included
            # (of two points at the k-th distance, the kernel's unsorted
            # top-k and the plain version's sorted one may keep either)
            rd2 = rd.reshape(-1, k).cpu().numpy()
            max_err = max(max_err, check(
                f"{name} pass {pass_name} ids vs plain",
                  kd.reshape(-1, k).cpu().numpy(),
                  ki.reshape(-1, k).cpu().numpy(), rd2,
                  ri.reshape(-1, k).cpu().numpy(), rd2[:, -1],
                  rtol=0.0, atol=0.0))
            kernel_ms = timed_ms(lambda: real(**rec), reps, device)
            dev_ms = device_ms(lambda: real(**rec), reps, device,
                               "stacked_sweep_kernel")
            bytes_ms, ops_ms, pairs = stacked_bound(rec, live, d + 1)
            bound_ms = max(bytes_ms, ops_ms)
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            if pairs != int(live.numel() - ks.sum()):
                raise AssertionError("the kernel's and the plain version's "
                                     "scanned tiles differ")
            nqb = rec["visit"].shape[1]
            log("stacked-kernel", mode=name, pass_=pass_name,
                matches_plain=True, bq=rec["bq"], split=rec["split"],
                ctas=nqb * rec["split"], skips=int(ks.sum()),
                plain_skips=int(rs.sum()), skips_equal=True, scanned=pairs,
                kernel_ms=f"{kernel_ms:.4f}", device_ms=dev_ms,
                plain_ms=f"{plain_ms:.1f}",
                bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
                dtype=rec.get("probe_dtype", "f32"))
            if name == "f32":  # the kernels line: both launches of a batch
                for key, v in (("ms", kernel_ms), ("plain_ms", plain_ms),
                               ("bound_ms", bound_ms), ("bytes_ms", bytes_ms),
                               ("ops_ms", ops_ms)):
                    totals[key] = totals.get(key, 0.0) + v
    bq8_ms = sum(timed_ms(lambda rec=rec: real(**rec), reps, device)
                 for rec in old_recs)
    # the whole batch once warm, host clock: delta scan, phase 1, both
    # launches, the merges and the copies to the host
    batch_ms = timed_ms(lambda: m.query(q, k, method="stacked"), 3, device)
    brute_topk(pts, qn, k)  # warm-up
    library_ms = timed_ms(lambda: brute_topk(pts, qn, k), reps, device)
    # the rest of a batch, beside the kernel: the delta scan, phase 1
    # (bounds and visit orders of every segment) and the final merge
    dd, di, _ = snap.delta_candidates(qn, k)
    delta_ms = timed_ms(lambda: snap.delta_candidates(qn, k), reps, device)
    phase1_ms = timed_ms(lambda: tss.prepare_stacked_operands(
        stk, qn, bq=records["f32"][0]["bq"], lambda_cap=dd[:, k - 1],
        lane_pad=True), reps,
        device)
    planes = real(**records["f32"][-1])[:2]
    merge_ms = timed_ms(lambda: search.merge_topk_planes(
        *planes, k, extra_d=dd, extra_i=di), reps, device)
    log("stacked-timing", card=repr(card), kernel_ms=f"{totals['ms']:.4f}",
        bq8_split1_ms=f"{bq8_ms:.4f}", batch_ms=f"{batch_ms:.3f}",
        plain_ms=f"{totals['plain_ms']:.1f}",
        bound_ms=f"{totals['bound_ms']:.4f}",
        library_ms=f"{library_ms:.4f}", delta_ms=f"{delta_ms:.4f}",
        phase1_ms=f"{phase1_ms:.4f}", merge_ms=f"{merge_ms:.4f}",
        live_points=len(X), reps=reps)
    record = {
        "name": "stacked_sweep",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/stacked_sweep.cu",
        "replaces": "src/repro/kernels/stacked_sweep.py:622",
        "launches": launches["f32"],
        "max_abs_err": max_err,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": ("bytes" if totals["bytes_ms"] >= totals["ops_ms"]
                     else "operations"),
        "library_ms": library_ms,
    }
    return record, dict(index=m, dead=dead_set, oracle=(od_k, oi_k, nxt),
                        oracle_ids=ref_i, by_gid=by_gid)


def run_serve(device, card, frozen: dict, mutable: dict, *, hot, slots,
              wal_n, wal_inserts, wal_deletes, wal_more) -> dict:
    """Phase 9: phase 3's frozen index and phase 7's mutable index served
    through ``P2HEngine``, then the durable writes; returns each kernel's
    launches on the serving path."""
    import torch

    from repro_torch.core.balltree import normalize_query
    from repro_torch.core.exact import exact_search
    from repro_torch.kernels import p2h_scan
    from repro_torch.kernels import stacked_sweep as tss
    from repro_torch.serve import P2HEngine

    k = K
    index, m, q = frozen["index"], mutable["index"], frozen["q"]
    queries = len(q)
    dead = set(mutable["dead"])

    def reset_launches():
        sync(device)
        p2h_scan.p2h_sweep.launches = tss.LAUNCHES = 0

    def launches():
        sync(device)
        return {"p2h_sweep": p2h_scan.p2h_sweep.launches,
                "stacked_sweep": tss.LAUNCHES}

    def no_dead(what, ids):
        if dead & set(np.asarray(ids).ravel().tolist()):
            raise AssertionError(f"{what}: a deleted gid was returned")

    def live_oracle(qs):
        """The f32 oracle over the mutable index's current live set:
        ``(dists, gids, (k+1)-th)``."""
        X, G = m.snapshot().live_points()
        od, oi = exact_search(torch.from_numpy(X).to(device),
                              torch.from_numpy(qs).to(device), k + 1)
        ref = torch.from_numpy(G.astype(np.int64)).to(device)[oi.long()]
        return od[:, :k].cpu(), ref[:, :k].cpu(), od[:, k].cpu().numpy()

    def frozen_oracle(qs):
        od, oi = exact_search(frozen["pts"], torch.from_numpy(qs).to(device),
                              k + 1)
        return od[:, :k].cpu(), oi[:, :k].cpu(), od[:, k].cpu().numpy()

    def exact(what, bd, bi, orc):
        """Hold an answer to the f32 oracle ``orc[:3]`` (ties at the
        tolerance) and, where ``orc`` also carries the top-(k+1) ids, the
        points they index and the queries, its ids to the oracle's at
        float64 distances.  The second is for the main path's queries: on
        others an f32 route and the f32 oracle may break a tie closer than
        f32 rounding apart (1.4e-6 at these norms; the f32 oracle's own
        order stands up to 2.1e-6 off float64, phase 5's ``oracle`` line)."""
        err = check(f"{what} vs oracle", bd, bi, *orc[:3])
        if len(orc) > 3:
            check(f"{what} vs oracle, float64", bd, bi, *orc[3:],
                  exact=True)
        return err

    qn = normalize_query(q)
    qt = torch.from_numpy(qn).to(device)
    m_orc = (*mutable["oracle"], mutable["oracle_ids"], mutable["by_gid"],
             qt)
    f_orc = (*frozen["oracle"], frozen["oracle_ids"], frozen["pts"], qt)

    # the main path: both indexes behind an engine, launches from 0
    fe = P2HEngine(index, slot_size=queries)
    me = P2HEngine(m, slot_size=queries)
    if not (fe.policy.prefer_pallas and fe.policy.small_batch == 0):
        raise AssertionError(f"card dispatch not resolved: {fe.policy}")
    reset_launches()
    t0 = time.perf_counter()
    fd, fi = fe.query(q, k)
    md, mi = me.query(q, k)
    serve_s = time.perf_counter() - t0
    served = launches()
    if min(served.values()) < 1:
        raise AssertionError(f"the serving path skipped a kernel: {served}")
    routes = (fe.stats()["routes"], me.stats()["routes"])
    if routes != ({"pallas": 1}, {"stacked": 1}):
        raise AssertionError(f"serving routes {routes}")
    errs = [exact("engine(frozen)", fd, fi, f_orc),
            exact("engine(mutable)", md, mi, m_orc)]
    no_dead("engine(mutable)", mi)
    # bit for bit against the direct routes, and the streaming API (now
    # warm: the drop-in pass filled the cache) against the drop-in answer
    direct = {"frozen": index.query(q, k, method="kernel"),
              "mutable": m.query(q, k, method="stacked", probe_dtype="bf16")}
    for name, eng, (bd, bi) in (("frozen", fe, (fd, fi)),
                                ("mutable", me, (md, mi))):
        dd, di = direct[name]
        if not (np.array_equal(bd, dd) and np.array_equal(bi, di)):
            raise AssertionError(f"engine({name}) differs from the direct "
                                 f"route")
        tickets = [eng.submit(row, k) for row in q]
        if eng.flush() != 1:
            raise AssertionError("the stream took more than one batch")
        got = [eng.result(t) for t in tickets]
        sd, si = np.stack([g[0] for g in got]), np.stack([g[1] for g in got])
        if not (np.array_equal(sd, bd) and np.array_equal(si, bi)):
            raise AssertionError(f"streaming({name}) differs from the "
                                 f"drop-in answer")
        log("serve", index=name, slot_size=queries, equals_oracle=True,
            equals_direct=True, streaming_equal=True,
            routes=eng.stats()["routes"],
            cache_hits=eng.cache.stats()["hits"])
    log("serve", main_path_launches=served, host_seconds=f"{serve_s:.3f}",
        max_abs_err=max(errs))

    # warm against cold on a hot trace: 256 normals, each 4 times, perturbed
    rng = np.random.default_rng(SEED + 2)
    trace = (q[:hot][np.arange(queries) % hot]
             + rng.normal(scale=1e-3, size=q.shape)).astype(np.float32)
    tn = normalize_query(trace)
    engines = {}
    for name, idx, route, orc in (("frozen", index, "pallas", frozen_oracle),
                                  ("mutable", m, "stacked", live_oracle)):
        eng = engines[name] = P2HEngine(idx, slot_size=queries)
        cold = eng.query(trace, k)
        st_cold = eng.stats()
        eng.reset_stats()
        warm = eng.query(trace, k)
        st_warm = eng.stats()
        if not (np.array_equal(warm[0], cold[0])
                and np.array_equal(warm[1], cold[1])):
            raise AssertionError(f"{name}: warm answers differ from cold")
        skips = [s["counters"][route]["tiles_skipped"]
                 for s in (st_cold, st_warm)]
        hits = st_warm["lambda_cache"]["hits"]
        if skips[1] < skips[0] or hits == 0:
            raise AssertionError(f"{name}: warm skips {skips[1]} < cold "
                                 f"{skips[0]}, or no cache hit ({hits})")
        err = exact(f"trace({name})", *cold, orc(tn))
        if name == "mutable":
            no_dead("trace(mutable)", cold[1])
        log("serve-warm", index=name, trace=queries, distinct=hot,
            warm_equals_cold=True, equals_oracle=True, max_abs_err=err,
            cold_skips=skips[0], warm_skips=skips[1], cache_hits=hits,
            cold_ms=f"{st_cold['latency_p50_ms']:.3f}",
            warm_ms=f"{st_warm['latency_p50_ms']:.3f}")

    # epoch tagging: delete the k-th neighbours of cached queries; the next
    # warm answer must not trust their stale caps
    eng = engines["mutable"]
    victims = {int(g) for g in warm[1][:8, k - 1]}
    for g in victims:
        if not m.delete(g):
            raise AssertionError(f"gid {g} was not live")
    dead |= victims
    hits0, evict0 = eng.cache.hits, eng.cache.stale_evictions
    after = eng.query(trace, k)
    evicted = eng.cache.stale_evictions - evict0
    if evicted == 0:
        raise AssertionError("no cache entry went stale after the deletes")
    err = exact("trace after deletes", *after, live_oracle(tn))
    no_dead("trace after deletes", after[1])
    log("serve-epoch", deleted=len(victims), stale_evictions=evicted,
        cache_hits=eng.cache.hits - hits0, equals_oracle=True,
        max_abs_err=err)

    # speed: q/s and per-batch latency by slot size (cold cache each)
    for slot in slots:
        for name, idx in (("frozen", index), ("mutable", m)):
            P2HEngine(idx, slot_size=slot).query(q[:slot], k)  # warm-up
            eng = P2HEngine(idx, slot_size=slot)
            reset_launches()
            t0 = time.perf_counter()
            tickets = [eng.submit(row, k) for row in q]
            eng.flush()
            got = [eng.result(t) for t in tickets]
            sync(device)
            wall = time.perf_counter() - t0
            n_launch = launches()
            st = eng.stats()
            bd = np.stack([g[0] for g in got])
            if not np.isfinite(bd).all():
                raise AssertionError(f"slot {slot}: non-finite answers")
            log("serve-speed", card=repr(card), index=name, slot_size=slot,
                batches=st["batches"], routes=st["routes"],
                qps=f"{queries / wall:.1f}",
                p50_ms=f"{st['latency_p50_ms']:.3f}",
                p99_ms=f"{st['latency_p99_ms']:.3f}",
                launches_per_batch=",".join(
                    f"{kn}:{v / st['batches']:g}"
                    for kn, v in n_launch.items()),
                cache_hits=st["lambda_cache"]["hits"])

    # one batch at occupancy 1 and 2: the dfs route beside the kernel route
    for name, idx, route in (("frozen", index, "pallas"),
                             ("mutable", m, "stacked")):
        for occ in OCCUPANCIES:
            row = {}
            for method in ("dfs", route):
                eng = P2HEngine(idx, slot_size=8, use_cache=False)
                if method != "dfs":  # warm-up: the kernel route's buffers
                    eng.query(q[:occ], k, method=method)
                    eng.reset_stats()
                bd, bi = eng.query(q[:occ], k, method=method)
                if name == "frozen":  # dfs scores with einsum: float64
                    check(f"{method} at occupancy {occ}", bd, bi,
                          frozen["oracle_ids"][:occ], frozen["pts"],
                          qt[:occ], exact=True)
                row[method] = eng.stats()["latency_p50_ms"]
            log("serve-occupancy", card=repr(card), index=name,
                occupancy=occ, dfs_ms=f"{row['dfs']:.3f}",
                **{f"{route}_ms": f"{row[route]:.3f}"},
                faster=min(row, key=row.get))

    run_wal(device, card, frozen["x"], q, wal_n=wal_n,
            wal_inserts=wal_inserts, wal_deletes=wal_deletes,
            wal_more=wal_more)
    return served


def run_wal(device, card, x, q, *, wal_n, wal_inserts, wal_deletes,
            wal_more) -> None:
    """Phase 9, durable writes: acknowledged inserts and deletes on a
    fresh index with a ``ShardWal``, a ``save``, more writes, and a
    recovery by ``load(wal=)`` into a new object.  Host I/O: the times are
    the host clock's, fsync included."""
    import torch

    from repro_torch.core.balltree import normalize_query
    from repro_torch.core.exact import exact_search
    from repro_torch.serve import P2HEngine
    from repro_torch.stream import (CompactionPolicy, MutableP2HIndex,
                                    ShardWal, WalConfig)

    k = K
    root = BUILD / "chip_smoke_wal"
    shutil.rmtree(root, ignore_errors=True)
    path = str(root / "shard0.wal")
    acked, t_ack, t_call = [], {}, {}

    def on_ack(tokens):
        now = time.perf_counter()
        for tok in tokens:
            t_ack[tok] = now
        acked.extend(tokens)

    rng = np.random.default_rng(SEED + 3)
    t0 = time.perf_counter()
    w = MutableP2HIndex.from_data(
        x[:wal_n], n0=256, device=device,
        policy=CompactionPolicy(delta_capacity=2 * (wal_inserts + wal_more),
                                tombstone_frac=0.95, max_segments=32))
    build_s = time.perf_counter() - t0
    wal = ShardWal(path, config=WalConfig(), on_ack=on_ack)
    w.attach_wal(wal)

    def write(op, arg):
        t = time.perf_counter()
        if op == "ins":
            tok = ("ins", w.insert(arg))
        else:
            if not w.delete(arg):
                raise AssertionError(f"gid {arg} was not live")
            tok = ("del", arg)
        t_call[tok] = t
        return tok[1]

    d = x.shape[1]
    fresh = (x[rng.choice(len(x), wal_inserts + wal_more)]
             + rng.normal(scale=0.05, size=(wal_inserts + wal_more, d))
             ).astype(np.float32)
    for row in fresh[:wal_inserts]:
        write("ins", row)
    for g in rng.choice(wal_n, wal_deletes, replace=False):
        write("del", int(g))
    wal.commit(force=True)
    if len(acked) != wal_inserts + wal_deletes:
        raise AssertionError(f"{len(acked)} writes acknowledged of "
                             f"{wal_inserts + wal_deletes}")
    t0 = time.perf_counter()
    w.save(str(root / "ckpt"))
    save_s = time.perf_counter() - t0
    more_dels = wal_more // 4
    new = [write("ins", row)
           for row in fresh[wal_inserts:wal_inserts + wal_more - more_dels]]
    for g in new[-more_dels:]:
        write("del", g)
    wal.commit(force=True)
    live = set(range(wal_n))
    for op, g in acked:
        (live.add if op == "ins" else live.discard)(g)
    lat = np.array([t_ack[t] - t_call[t] for t in t_call]) * 1e3
    del w, wal, write  # dropped without a close: the log holds every ack
    gc.collect()
    t0 = time.perf_counter()
    r = MutableP2HIndex.load(str(root / "ckpt"), device=device,
                             wal=ShardWal(path))
    sync(device)
    recover_s = time.perf_counter() - t0
    got = set(r.live_gids().tolist())
    if got != live:
        raise AssertionError(f"recovered {len(got)} live gids, "
                             f"{len(got ^ live)} differ from the "
                             f"acknowledged {len(live)}")
    eng = P2HEngine(r, slot_size=len(q))
    bd, bi = eng.query(q, k)
    X, G = r.snapshot().live_points()
    pts = torch.from_numpy(X).to(device)
    qn = torch.from_numpy(normalize_query(q)).to(device)
    od, oi1 = exact_search(pts, qn, k + 1)
    gid_t = torch.from_numpy(G.astype(np.int64)).to(device)
    ref = gid_t[oi1.long()]
    err = check("recovered engine vs oracle", bd, bi, od[:, :k].cpu(),
                ref[:, :k].cpu(), od[:, k].cpu().numpy())
    log("serve-wal", card=repr(card), clock="host I/O", points=wal_n,
        writes=len(t_call), acknowledged=len(acked),
        ack_p50_ms=f"{np.percentile(lat, 50):.3f}",
        ack_p99_ms=f"{np.percentile(lat, 99):.3f}",
        build_seconds=f"{build_s:.2f}", save_seconds=f"{save_s:.2f}",
        recovery_seconds=f"{recover_s:.3f}", live=len(live),
        recovered_equals_acked=True, equals_oracle=True, max_abs_err=err,
        routes=eng.stats()["routes"])
    r.close()
    shutil.rmtree(root, ignore_errors=True)


def oracle64(X, G, qn, k: int, device):
    """The f32 oracle over a live set ``(X, G)`` (points, gids) for the
    queries ``qn`` on ``device``: ``(dists (B, k+1), gids (B, k+1), a table
    of the points by gid)`` -- what ``assert_exact_topk`` takes."""
    import torch

    from repro_torch.core.exact import exact_search

    pts = torch.from_numpy(X).to(device)
    od, oi = exact_search(pts, qn, k + 1)
    gid_t = torch.from_numpy(G.astype(np.int64)).to(device)
    by_gid = torch.zeros((int(G.max()) + 1, X.shape[1]),
                         dtype=torch.float32, device=device)
    by_gid[gid_t] = pts
    return od, gid_t[oi.long()], by_gid


def hold64(what, bd, bi, orc, qn, rows=slice(None)):
    """Hold an answer to the oracle ``orc`` (:func:`oracle64`) through
    ``assert_exact_topk``: ids at float64 distances against the oracle's
    k + 1 candidates ranked at float64, each f32 distance within the f32
    error bound of its float64 value.

    The exchange scores a point by round 1's plain beam or by K2, the
    oracle by one matmul: three f32 sums in three orders.  At these norms
    (``S = sum_j |q_j x_j|`` ~ 20 against k-th distances ~1e-5) each is
    off its float64 value by a few ``u S`` (``u = 2**-24``), so two routes
    may order points that far apart differently.  Each row's tie tolerance
    is therefore ``TIE_UNITS u S`` with ``S`` the largest over that row's
    k + 1 oracle candidates -- the reference's alone, whatever the answer
    -- and at least the parity atol.  Returns ``(the check's error, the
    per-row tolerance (B,), readings)``; the readings, in units of ``u S``
    (the largest answer-to-reference gap, the oracle's and the answer's own
    f32 errors), and the share of the tolerance used are also in the
    error's message when the check fails."""
    import torch

    from repro_torch.core.exact import dists64

    od, ref, by_gid = orc
    od, ref, q = od[rows], ref[rows], qn[rows]
    k = ref.shape[1] - 1
    ids = torch.as_tensor(np.asarray(bi)).to(q.device).long()
    d64 = dists64(by_gid, q, ids)[0]
    r64, mag = dists64(by_gid, q, ref)
    order = torch.argsort(r64, dim=1, stable=True)
    ranked, r64s = torch.gather(ref, 1, order), torch.gather(r64, 1, order)
    unit = U32 * mag.amax(1)  # u S per row
    tol = torch.clamp(TIE_UNITS * unit, min=ATOL)
    gap = (torch.sort(d64, 1).values - r64s[:, :k]).abs().amax(1)
    answer = torch.as_tensor(np.asarray(bd)).to(q.device, torch.float64)
    readings = dict(
        tie_gap_units=float((gap / unit).max()),
        tol_used=float((gap / tol).max()),
        oracle_err_units=float(((od.double() - r64).abs().amax(1)
                                / unit).max()),
        answer_err_units=float(((answer - d64).abs().amax(1) / unit).max()),
        max_tol=float(tol.max()), min_tol=float(tol.min()),
        kth_median=float(r64s[:, k - 1].median()),
        f32_oracle_gap=float(np.abs(np.asarray(bd)
                                    - od[:, :-1].cpu().numpy()).max()))
    try:
        err = check(f"{what} vs oracle, float64", bd, bi, ranked, by_gid, q,
                    exact=True, atol=tol.cpu().numpy())
    except AssertionError as e:
        raise AssertionError(f"{e} ({readings})") from None
    return err, tol.cpu().numpy(), dict(f32_vs_f64_err=err, **readings)


def replay_stacked(what, recs, real, k, device):
    """Each recorded K2 launch against its plain version at the launch's
    schedule: distances bit for bit, skip counts equal, ids equal apart
    from exact ties.  Returns (max id-check error, the last launch's
    live-pair mask, its plain version's ms)."""
    import torch

    from repro_torch.kernels import ref

    max_err, live, plain_ms = 0.0, None, None
    for i, rec in enumerate(recs):
        kd, ki, ks = real(**rec)
        (rd, ri, rs, live), plain_ms = timed_call(
            lambda: ref.stacked_sweep_ref(**rec, return_live=True), device)
        if not torch.equal(ks, rs):
            raise AssertionError(f"{what} launch {i}: skip counts differ")
        if not torch.equal(kd, rd):
            raise AssertionError(
                f"{what} launch {i}: distances differ from the plain "
                f"version's by up to "
                f"{float((kd - rd).abs().nan_to_num().max())}")
        rd2 = rd.reshape(-1, k).cpu().numpy()
        max_err = max(max_err, check(
            f"{what} launch {i} ids vs plain",
            kd.reshape(-1, k).cpu().numpy(), ki.reshape(-1, k).cpu().numpy(),
            rd2, ri.reshape(-1, k).cpu().numpy(), rd2[:, -1],
            rtol=0.0, atol=0.0))
    return max_err, live, plain_ms


def run_sharded(device, card, x, q, *, n0, reps, shards, fresh, deletes,
                slots, failing, dur_n, dur_shards, dur_writes,
                dur_more) -> dict:
    """Phase 10: the sharded index through the two-round exchange, its
    kernels checked, timed, served, degraded; then the durable sharded
    index.  Returns each kernel's launches on the default exchange (the
    phase's main path) and on the sequential round 2, by run."""
    import torch

    from repro_torch.core import distributed
    from repro_torch.core.balltree import normalize_query
    from repro_torch.core.exact import dists64
    from repro_torch.kernels import p2h_scan, ref
    from repro_torch.kernels import stacked_sweep as tss
    from repro_torch.runtime import RetryPolicy
    from repro_torch.serve import (DeviceFault, FaultInjector, FaultSpec,
                                   P2HEngine, ResilienceConfig,
                                   ShardSupervisor)
    from repro_torch.serve.lambda_cache import epoch_is_stale
    from repro_torch.stream import CompactionPolicy, ShardedMutableP2HIndex

    k, n, d = K, len(x), x.shape[1]
    queries = len(q)
    seq_queries = min(SEQ_QUERIES, queries)
    rng = np.random.default_rng(SEED + 4)
    real_k2, real_k1 = tss.stacked_sweep, p2h_scan.p2h_sweep

    # the index: hashed shards, one sealed segment each, then routed
    # inserts into the deltas and deletes over every shard
    t0 = time.perf_counter()
    m = ShardedMutableP2HIndex.from_data(
        x, shards, n0=n0, device=device, seed=SEED,
        policy=CompactionPolicy(delta_capacity=-(-n // shards),
                                tombstone_frac=0.95, max_segments=32))
    sync(device)
    build_s = time.perf_counter() - t0
    near = x[rng.choice(n, fresh)] + rng.normal(
        scale=0.05, size=(fresh, d)).astype(np.float32)
    m.insert_batch(near)
    dead = set(rng.choice(n, deletes, replace=False).tolist())
    t0 = time.perf_counter()
    for g in sorted(dead):
        if not m.delete(int(g)):
            raise AssertionError(f"gid {g} was not live")
    sync(device)
    delete_s = time.perf_counter() - t0
    snap = m.snapshot()
    per = m.stats()["per_shard"]
    if (len(snap.segments) != shards or snap.delta_live != fresh
            or any(p["segments"] != 1 for p in per)):
        raise AssertionError(f"shard layout {per}")
    log("sharded-data", n=n, shards=shards, live=snap.live_count,
        delta_rows=snap.delta_live, deleted=deletes,
        shard_points=",".join(str(p["live"]) for p in per),
        build_seconds=f"{build_s:.1f}", delete_seconds=f"{delete_s:.2f}",
        segment_build_seconds=f"{build_s / shards:.1f}")

    qn_np = normalize_query(q)
    qn = torch.from_numpy(qn_np).to(device)
    orc = oracle64(*snap.live_points(), qn, k, device)
    # the float64 k-th of the oracle's k + 1 candidates
    kth64 = torch.sort(dists64(orc[2], qn, orc[1])[0], 1).values[
        :, k - 1].cpu().numpy()

    def exact(what, bd, bi, rows=slice(None), oracle=None):
        """The oracle over the live set (``hold64``), no deleted gid, no
        empty slot; returns what ``hold64`` returns."""
        if dead & set(np.asarray(bi).ravel().tolist()):
            raise AssertionError(f"{what}: a deleted gid was returned")
        if not np.isfinite(bd).all():
            raise AssertionError(f"{what}: non-finite distances")
        return hold64(what, bd, bi, oracle or orc, qn, rows)

    def recorded(fn):
        """``fn()`` with every K1 and K2 launch counted from 0 and its
        operands kept; returns (result, K2 records, K1 records, host s)."""
        k2_recs, k1_recs = [], []

        def k2(*a, **kw):
            k2_recs.append(kw)
            return real_k2(*a, **kw)

        def k1(*a, **kw):
            k1_recs.append(kw)
            return real_k1(*a, **kw)

        k1.launches = 0
        sync(device)
        tss.LAUNCHES = 0
        tss.stacked_sweep, p2h_scan.p2h_sweep = k2, k1
        try:
            t0 = time.perf_counter()
            out = fn()
            sync(device)
            host_s = time.perf_counter() - t0
        finally:
            tss.stacked_sweep, p2h_scan.p2h_sweep = real_k2, real_k1
        if tss.LAUNCHES != len(k2_recs) or k1.launches != len(k1_recs):
            raise AssertionError("a launch went uncounted")
        for rec in k2_recs:
            if rec["split"] is None:
                rec["split"] = tss.default_split(
                    rec, k=rec["k"], bq=rec["bq"],
                    probe_dtype=rec.get("probe_dtype", "f32"))
        for rec in k1_recs:
            if rec["split"] is None:
                rec["split"] = p2h_scan.default_split(rec, k=rec["k"],
                                                      bq=rec["bq"])
        return out, k2_recs, k1_recs, host_s

    # the main path: the default query, round 2 auto-promoted to the
    # stack -- one K2 launch, no K1
    (bd, bi, st, info), main_k2, main_k1, host_s = recorded(
        lambda: m.query(q, k, return_stats=True, return_info=True))
    if len(main_k2) != 1 or main_k1:
        raise AssertionError(f"default query: {len(main_k2)} K2 and "
                             f"{len(main_k1)} K1 launches (want 1 and 0)")
    _, tol, rdg = exact("query", bd, bi)
    # lambda0 and each shard's k-th are f32 distances of real points: each
    # row held to the float64 k-th at that row's tolerance
    margin = np.minimum(info["lambda0"] - kth64,
                        (info["shard_kth"] - kth64[None]).min(0))
    if (margin < -tol).any():
        b = int(np.argmin(margin + tol))
        raise AssertionError(f"row {b}: lambda0 or a shard's k-th under the "
                             f"float64 k-th by {-margin[b]} (tolerance "
                             f"{tol[b]})")
    log("sharded-query", route="default", queries=queries, k=k,
        equals_oracle=True, **rdg,
        k2_launches=len(main_k2),
        k1_launches=0, bq=main_k2[0]["bq"], split=main_k2[0]["split"],
        lambda0_ge_kth=True,
        lambda0_min_margin=float((info["lambda0"] - kth64).min()),
        shard_kth_min_margin=float((info["shard_kth"] - kth64[None]).min()),
        host_seconds=f"{host_s:.3f}",
        leaves_scanned=st["leaves_scanned"],
        tiles_skipped=st["tiles_skipped"], verified=st["verified"])
    k2_by_route = {"default": main_k2}
    for name, kw, want in (("stacked-f32", dict(method="stacked"), 1),
                           ("stacked-bf16", dict(
                               method="stacked", probe_dtype="bf16",
                               probe_tiles=tss.STACKED_PROBE_TILES_DEFAULT),
                            2)):
        (rd, ri, rst), recs, k1s, host_s = recorded(
            lambda kw=kw: m.query(q, k, return_stats=True, **kw))
        if len(recs) != want or k1s:
            raise AssertionError(f"{name}: {len(recs)} K2 launches (want "
                                 f"{want}) and {len(k1s)} K1")
        rdg = exact(name, rd, ri)[2]
        if not np.array_equal(rd, bd):
            raise AssertionError(f"{name}: distances differ from the "
                                 f"default route's")
        k2_by_route[name] = recs
        log("sharded-query", route=name, equals_oracle=True,
            equals_default=True, **rdg, k2_launches=len(recs),
            host_seconds=f"{host_s:.3f}",
            tiles_skipped=rst["tiles_skipped"])
    # the sequential round 2: K1 once per segment, under lambda0
    (sd, si), _, seq_k1, host_s = recorded(
        lambda: m.query(q[:seq_queries], k, method="pallas", stacked=False))
    live_segs = sum(1 for s in snap.segments if s.live)
    if len(seq_k1) != live_segs:
        raise AssertionError(f"sequential round 2: {len(seq_k1)} K1 "
                             f"launches for {live_segs} segments")
    rdg = exact("sequential", sd, si, rows=slice(0, seq_queries))[2]
    # each run's launches, counted from 0 just before it
    launches = {"10 sharded": {"stacked_sweep": len(main_k2),
                               "p2h_sweep": len(main_k1)},
                "10 sharded sequential": {"stacked_sweep": 0,
                                          "p2h_sweep": len(seq_k1)}}
    rec = seq_k1[0]
    kd, ki, ks = real_k1(**rec)
    rd, ri, rs = ref.p2h_sweep_ref(**rec)
    if not torch.equal(ks, rs):
        raise AssertionError("sequential K1 launch: skip counts differ")
    k1_err = check("sequential K1 launch vs plain", kd.cpu(), ki.cpu(),
                   rd.cpu(), ri.cpu())
    log("sharded-sequential", queries=seq_queries, equals_oracle=True, **rdg,
        k1_launches=len(seq_k1), bq=rec["bq"],
        split=rec["split"], k1_matches_plain=True, k1_max_abs_err=k1_err,
        k1_bit_equal=bool(torch.equal(kd, rd)),
        host_seconds=f"{host_s:.3f}")

    # every K2 launch of those runs against its plain version
    k2_err = 0.0
    for name, recs in k2_by_route.items():
        e, live, plain_ms = replay_stacked(f"sharded {name}", recs, real_k2,
                                           k, device)
        k2_err = max(k2_err, e)
        if name == "default":
            rec2 = recs[0]
            bytes_ms, ops_ms, pairs = stacked_bound(rec2, live, d + 1)
            r2_plain_ms = plain_ms
    log("sharded-kernel", matches_plain=True, launches_replayed=sum(
        len(r) for r in k2_by_route.values()), max_abs_err=k2_err,
        shards_in_launch=shards, segments_in_launch=rec2["pts_tiles"].shape[0])

    # timing: a warm exchange batch and its parts
    timed_ms(lambda: m.query(q, k), 1, device)  # warm
    batch_ms = timed_ms(lambda: m.query(q, k), 3, device)
    r1_ms = timed_ms(lambda: [s.query(qn_np, k, method="beam", frac=0.25,
                                      return_counters=True)
                              for s in snap.shards], 3, device)
    parts = [s.query(qn_np, k, method="beam", frac=0.25,
                     return_counters=True) for s in snap.shards]
    lam0 = np.minimum.reduce([p[0][:, k - 1] for p in parts])
    r2_ms = timed_ms(lambda: distributed._stacked_round2(
        snap.shards, qn_np, k, method="sweep", stacked=None, lam0=lam0,
        probe_tiles=None), 3, device)
    (fd, fi), _, _ = distributed._stacked_round2(
        snap.shards, qn_np, k, method="sweep", stacked=None, lam0=lam0,
        probe_tiles=None)
    pd, pi = [p[0] for p in parts] + [fd], [p[1] for p in parts] + [fi]
    merge_ms = timed_ms(lambda: distributed._merge(pd, pi, k, queries,
                                                   device), reps, device)
    k2_ms = timed_ms(lambda: real_k2(**rec2), reps, device)
    k2_dev_ms = device_ms(lambda: real_k2(**rec2), reps, device,
                          "stacked_sweep_kernel")
    log("sharded-timing", card=repr(card), batch_ms=f"{batch_ms:.3f}",
        round1_ms=f"{r1_ms:.3f}", round2_ms=f"{r2_ms:.3f}",
        k2_ms=f"{k2_ms:.4f}", k2_device_ms=k2_dev_ms,
        merge_ms=f"{merge_ms:.4f}",
        k2_bound_ms=f"{max(bytes_ms, ops_ms):.4f}",
        k2_bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        k2_plain_ms=f"{r2_plain_ms:.1f}", scanned_pairs=pairs,
        stacked_route_cell2_ms="26.0 (PERF.md 5)", reps=reps)

    # serving: the engine at each slot size, cold then warm, against the
    # direct query; launches per batch; q/s and p50/p99.  Four batches a
    # slot size at most: a batch costs its eight beams, ~1.2 s at any size
    for slot in slots:
        nq = min(queries, 4 * slot)
        qs = q[:nq]
        eng = P2HEngine(m, slot_size=slot)
        sync(device)
        tss.LAUNCHES = 0
        p2h_scan.p2h_sweep.launches = 0
        t0 = time.perf_counter()
        tickets = [eng.submit(row, k) for row in qs]
        eng.flush()
        got = [eng.result(t) for t in tickets]
        sync(device)
        wall = time.perf_counter() - t0
        n_k2, n_k1 = tss.LAUNCHES, p2h_scan.p2h_sweep.launches
        cold = (np.stack([g[0] for g in got]), np.stack([g[1] for g in got]))
        st_cold = eng.stats()
        route = next(iter(st_cold["routes"]))
        # the direct query in the engine's batches: the same shapes, so
        # the same kernels and sums
        parts = [m.query(qs[i:i + slot], k, method=route,
                         stacked=route == "stacked")
                 for i in range(0, nq, slot)]
        direct = (np.concatenate([p[0] for p in parts]),
                  np.concatenate([p[1] for p in parts]))
        warm = eng.query(qs, k)
        for tag, (ed, ei) in (("cold", cold), ("warm", warm)):
            if not np.array_equal(ed, direct[0]):
                raise AssertionError(f"engine slot {slot} {tag}: distances "
                                     f"differ from the direct query's")
            check(f"engine slot {slot} {tag} ids vs direct", ed, ei,
                  *direct, rtol=0.0, atol=0.0)
        exact(f"engine slot {slot}", *cold, rows=slice(0, nq))
        log("sharded-serve", card=repr(card), slot_size=slot, queries=nq,
            batches=st_cold["batches"], routes=st_cold["routes"],
            qps=f"{nq / wall:.1f}",
            p50_ms=f"{st_cold['latency_p50_ms']:.3f}",
            p99_ms=f"{st_cold['latency_p99_ms']:.3f}",
            k2_per_batch=f"{n_k2 / st_cold['batches']:g}", k1=n_k1,
            equals_direct=True, warm_equals_cold=True,
            cache_hits=eng.cache.stats()["hits"])
    # a delete of a cached query's k-th neighbour in one shard drops only
    # that shard's component of the entry
    victim = int(warm[1][0, k - 1])
    owner = m.router.shard_of(victim)
    key = (int(eng.cache.signatures(qn_np[:1])[0]), k)
    if not m.delete(victim):
        raise AssertionError(f"gid {victim} was not live")
    dead.add(victim)
    floors = m.snapshot().last_delete_epoch
    tag = eng.cache._store[key][2]
    stale = [s for s, (e, f) in enumerate(zip(tag, floors))
             if epoch_is_stale(e, f)]
    if stale != [owner]:
        raise AssertionError(f"stale components {stale}, want [{owner}]")
    evict0 = eng.cache.stale_evictions
    after = eng.query(q, k)
    rdg = exact("engine after the delete", *after,
               oracle=oracle64(*m.snapshot().live_points(), qn, k, device))[2]
    log("sharded-serve-epoch", deleted=victim, owner_shard=owner,
        stale_components=stale, surviving_components=shards - 1,
        stale_evictions=eng.cache.stale_evictions - evict0,
        equals_oracle=True, **rdg)

    # degraded answers: failing shards, no wall-clock budget
    snap = m.snapshot()
    for fail in failing:
        sup = ShardSupervisor(ResilienceConfig(
            shard_timeout_s=None, breaker_failures=99,
            fault_injector=FaultInjector(
                {s: [FaultSpec("error")] for s in fail}),
            retry=RetryPolicy(max_restarts=0)))
        sync(device)
        tss.LAUNCHES = p2h_scan.p2h_sweep.launches = 0
        t0 = time.perf_counter()
        # a shard failing in round 1 is left out of round 2's one K2
        # launch over the others, then fails again on its own
        gd, gi, ginfo = m.query(q, k, return_info=True, resilience=sup)
        sync(device)
        sec = time.perf_counter() - t0
        n_k2, n_k1 = tss.LAUNCHES, p2h_scan.p2h_sweep.launches
        if (ginfo["missing_shards"] != tuple(fail) or not ginfo["degraded"]
                or ginfo["complete"]):
            raise AssertionError(f"degraded {fail}: {ginfo}")
        if (n_k2, n_k1) != (1, 0):
            raise AssertionError(f"degraded {fail}: {n_k2} K2 and {n_k1} K1 "
                                 f"launches (want 1 and 0)")
        Xs, Gs = zip(*(s.live_points() for si, s in enumerate(snap.shards)
                       if si not in fail))
        rdg = exact(f"degraded {fail} vs the live shards", gd, gi,
                   oracle=oracle64(np.concatenate(Xs), np.concatenate(Gs),
                                   qn, k, device))[2]
        log("sharded-degraded", failing=list(fail),
            missing_shards=list(ginfo["missing_shards"]), degraded=True,
            complete=False, equals_live_oracle=True, **rdg, k2_launches=n_k2,
            k1_launches=n_k1, host_seconds=f"{sec:.3f}")
    # a K2 launch that fails is no shard's fault: the armed exchange raises
    # it, and answers no shard by the plain sweep instead
    def broken(*a, **kw):
        raise RuntimeError("K2 launch refused")

    tss.stacked_sweep = broken
    try:
        m.query(q[:64], k, resilience=ShardSupervisor(ResilienceConfig(
            shard_timeout_s=None, retry=RetryPolicy(max_restarts=0))))
        raise AssertionError("a failing K2 launch gave an answer")
    except DeviceFault as e:
        if "K2 launch refused" not in str(e):
            raise
    finally:
        tss.stacked_sweep = real_k2
    log("sharded-degraded", failing_kernel="stacked_sweep",
        raised="DeviceFault")
    m.close()
    del m, snap, orc
    gc.collect()
    run_sharded_wal(device, card, x, q, n0=n0, dur_n=dur_n,
                    dur_shards=dur_shards, dur_writes=dur_writes,
                    dur_more=dur_more)
    return launches


def run_sharded_wal(device, card, x, q, *, n0, dur_n, dur_shards,
                    dur_writes, dur_more) -> None:
    """Phase 10, durable: a sharded index with per-shard logs; the
    acknowledged writes survive a split, a merge, a save, more writes and
    a drop, and ``open`` recovers exactly them.  Host I/O times."""
    import threading

    import torch

    from repro_torch.core.balltree import normalize_query
    from repro_torch.stream import (CompactionPolicy, ShardedMutableP2HIndex,
                                    WalConfig)

    k = K
    root = BUILD / "chip_smoke_sharded"
    shutil.rmtree(root, ignore_errors=True)
    acked = set()

    def on_ack(tokens):
        acked.update(tokens)

    t0 = time.perf_counter()
    w = ShardedMutableP2HIndex.from_data(
        x[:dur_n], dur_shards, n0=n0, device=device, seed=SEED,
        wal_dir=str(root / "wal"), ckpt_root=str(root),
        wal_config=WalConfig(), on_ack=on_ack,
        policy=CompactionPolicy(delta_capacity=4 * sum(dur_writes + dur_more),
                                tombstone_frac=0.95, max_segments=32))
    build_s = time.perf_counter() - t0
    d = x.shape[1]
    live, issued = set(range(dur_n)), []

    def writes(n_ins, n_del, seed):
        r = np.random.default_rng(seed)
        pts = (x[r.choice(dur_n, n_ins)] + r.normal(
            scale=0.05, size=(n_ins, d))).astype(np.float32)
        new = [w.insert(p) for p in pts]
        issued.extend(("ins", g) for g in new)
        live.update(new)
        for g in r.choice(sorted(live), n_del, replace=False):
            if not w.delete(int(g)):
                raise AssertionError(f"gid {g} was not live")
            issued.append(("del", int(g)))
            live.discard(int(g))
        for sh in w.shards:
            sh._wal.commit(force=True)

    writes(*dur_writes, SEED + 6)
    qs = q[:64]
    qn = torch.from_numpy(normalize_query(qs)).to(device)

    def oracle_of(index):
        return oracle64(*index.snapshot().live_points(), qn, k, device)

    before = oracle_of(w)
    errors, done, seen = [], threading.Event(), [0]

    def storm():  # queries while the split migrates rows
        try:
            while not done.is_set():
                hold64("query during the split", *w.query(qs, k), before,
                       qn)
                seen[0] += 1
        except BaseException as e:  # surfaced after join
            errors.append(e)

    th = threading.Thread(target=storm)
    t0 = time.perf_counter()
    th.start()
    try:
        new = w.split_shard(0)
    finally:
        done.set()
        th.join()
    split_s = time.perf_counter() - t0
    if errors:
        raise errors[0]
    owned = [len(sh.live_gids()) for sh in w.shards]
    hold64("after the split", *w.query(qs, k), before, qn)
    t0 = time.perf_counter()
    w.merge_shards(new, 0)
    merge_s = time.perf_counter() - t0
    hold64("after the merge", *w.query(qs, k), before, qn)
    t0 = time.perf_counter()
    w.save(str(root))
    save_s = time.perf_counter() - t0
    writes(*dur_more, SEED + 7)
    missing = [t for t in issued if t not in acked]
    if missing:
        raise AssertionError(f"{len(missing)} writes never acknowledged")
    if set(int(g) for sh in w.shards for g in sh.live_gids()) != live:
        raise AssertionError("the live set before the drop is not the "
                             "acknowledged one")
    del w  # dropped without a close: the logs hold every acknowledgement
    gc.collect()
    t0 = time.perf_counter()
    r = ShardedMutableP2HIndex.open(str(root), device=device)
    sync(device)
    recover_s = time.perf_counter() - t0
    per = [set(int(g) for g in sh.live_gids()) for sh in r.shards]
    got = set().union(*per)
    if got != live or sum(len(s) for s in per) != len(live):
        raise AssertionError(f"recovered {len(got)} live gids, "
                             f"{len(got ^ live)} differ from the "
                             f"acknowledged {len(live)}")
    rdg = hold64("recovered", *r.query(qs, k), oracle_of(r), qn)[2]
    log("sharded-wal", card=repr(card), clock="host I/O", points=dur_n,
        shards=dur_shards, writes=len(issued), acknowledged=len(issued),
        build_seconds=f"{build_s:.2f}", split_seconds=f"{split_s:.2f}",
        queries_during_split=seen[0], owned_after_split=owned,
        merge_seconds=f"{merge_s:.2f}", save_seconds=f"{save_s:.2f}",
        recovery_seconds=f"{recover_s:.3f}", recovered_shards=r.num_shards,
        live=len(live), recovered_equals_acked=True, equals_oracle=True,
        **rdg, misroutes=r.stats()["misroutes"])
    r.close()
    shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: the package is missing ({SRC / 'repro_torch'})",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    record = run(torch.device("cuda", 0))
    for kern in record["kernels"]:  # reached only if every check passed
        log("kernels", name=kern["name"], launches=kern["launches"],
            matches_plain=True, max_abs_err=kern["max_abs_err"])
    print(json.dumps(record))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
