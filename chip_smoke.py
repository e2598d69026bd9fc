#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one CUDA card and check them.

    python3 chip_smoke.py            # full size: 1,000,000 x 128 planted

The main paths, each through the entry points a user calls:

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
    saved and recovered;
  * slice 7, the paper's comparison: the BC-Tree and the Ball-Tree (the
    same tree, K1 with the variant's flags) beside the NH and FH hashing
    baselines (``NHIndex``, ``FHIndex``: host tables and candidates, one
    batched verification on the card);
  * slice 8, the serving mesh: the card named at four mesh positions, each
    with its own stream -- the stacked route and round 2 of the exchange
    with one K2 launch a position and pass, and the device-sharded forest
    ``ShardedP2HIndex`` with one tree a position, K1 at each position in
    each of its two rounds;
  * slice 9, the LM substrate's training path: llama3.2-1b at full width
    (f32 parameters, bf16 compute) trained through ``make_train_step`` on
    ``SyntheticLMDataset`` batches.  It owes no hand-written kernel (the
    JAX package's LM code reaches no ``pallas_call``), so the ``kernels``
    line stays K1 and K2;
  * slice 10, the LM substrate's other families in training:
    granite-moe-3b-a800m (MoE) and mamba2-780m (Mamba-2) at full width and
    whisper-tiny (encoder-decoder) through ``make_train_step``, every new
    family's smoke config through ``train()`` on the card against the
    host, and the two-block local attention of recurrentgemma.  No
    ``pallas_call`` either: no kernel joins the line;
  * slice 11, the LM substrate's serving path: llama3.2-1b at full width
    served through ``serve_batch`` (prefill once, the KV cache, greedy
    decode), its decode held to its forward, and every arch's smoke config
    served on the card against the host.  No ``pallas_call``: no kernel
    joins the line;
  * slice 12, LM placement: llama3.2-1b at full width trained through
    ``make_placed_train_step`` with its parameters and AdamW state split
    over the card named at 4 mesh positions, moved between meshes by
    ``elastic_remesh``, a checkpoint restored placed, and the dry run of
    two production cells.  No ``pallas_call`` (placement is
    ``NamedSharding`` and XLA's partitioner in the JAX package): no kernel
    joins the line.

Phases, one line each:

  1. platform   the card (nvidia-smi name and power limit), precision
  2. build      one nvcc per kernel source, all started together, for
                sm_90a, in the background of the phases that launch no
                kernel (13-15, then phase 7's index and phase 3's tree);
                ptxas' registers and spills per instance, failing if an
                instance the main paths launch (bq = 64) spills
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
                batch; the latency of one batch at occupancy 1 on the
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
 11. baselines  Table III on phase 3's data: build seconds and
                ``index_bytes`` of the BC-Tree and the Ball-Tree (phase 3's
                tree), of ``NHIndex.build`` and ``FHIndex.build`` (m = 16,
                lam = 4 d, FH l = 4: host build and upload apart), and of NH
                with the exact lift on the first 20,000 points (the cut on
                its line); then the query rows on 1024 queries: the
                BC-Tree's phase-6 batch and recall, the Ball-Tree through
                K1 (``use_ball = use_cone = False``) with its launches
                counted from 0, that launch replayed against
                ``p2h_sweep_ref`` (distances bit for bit, skips equal), its
                answer held to the oracle at float64 and its batch timed;
                NH and FH at budgets 256 and 2048: host candidate seconds,
                the card's verification ms, ``verified``, recall@10 beside
                its chance level budget / n, the candidates of 64 queries
                held to the reference's loop written out plainly, every
                answer held to a float64 top-k over its own candidate set,
                and recall at 2048 at least recall at 256 less 0.05
 12. mesh       the card's device named at 4 positions, a stream each:
                phase 7's index through ``query(method="stacked",
                mesh=...)`` in every probe mode, bit for bit its one launch,
                4 K2 launches a pass, each replayed against
                ``stacked_sweep_ref``, with the one launch's and the mesh's
                batch in turns, each position's pass-A and pass-B device
                time, all positions' pass B at once on their streams and
                the gathers; ``run_churn_parity`` at its defaults; round 2
                of phase 10's exchange on the mesh, bit for bit its one
                launch, each launch replayed; ``ShardedP2HIndex.build`` over
                phase 3's data (4 shards of 250,000), its 1024 queries held
                to the oracle at float64 (``hold64``), 8 K1 launches a
                batch each replayed against ``p2h_sweep_ref``, the rounds
                and the merge timed apart, and served by
                ``P2HEngine(..., sharded=)`` at slot 1024, cold and warm
                equal to the direct query
13. lm         (run right after phase 2 starts: it launches no kernel of
                the port, so it trains while nvcc builds)
                (a) ``get_model``-style llama3.2-1b at full width on the
                card, AdamW under the cosine schedule, 20 steps of 4 x 2048
                tokens: the step-0 loss within 0.5 of ln V and within 0.05
                of the f32-compute loss on the same parameters and batch,
                every loss and grad norm finite, the last loss below the
                first; step time (median of the warm steps, CUDA events),
                tokens/s, ``max_memory_allocated``, 6 N T and its share of
                the bf16 dense peak; (b) ``gqa_attention`` forward and
                backward at the model's attention shapes against a dense
                softmax attention written plainly, in f32 and bf16, timed
                beside ``scaled_dot_product_attention``; (c) ``train()`` at
                smoke width, f32 compute, on the card against the host
                (the first 4 losses rtol 1e-4) and resumed after an
                injected crash (final loss rtol 1e-5)
14. lm-families (right after 13, also beside nvcc) (a) granite-moe at
                full width, 10 steps of 4 x 2048 tokens: the step-0
                cross-entropy within 0.5 of ln V, finite losses, aux and
                grad norms; step time, tokens/s, ``max_memory_allocated``,
                6 N_active T over the bf16 peak, the load and z losses,
                the share of assignments dropped by capacity, and a
                ``torch.profiler`` split of a step by the model code that
                launched each kernel (attention, grouped expert products,
                dispatch/combine, SSD intra-/inter-chunk, the rest); (b)
                mamba2 the same; (c) whisper-tiny, 1,500 frames and 448
                decoder tokens a row; (d) the six new archs' smoke configs
                through ``train()`` at f32, card against host over 4 steps
                (rtol 1e-4, or twice the host's own spread under a 2e-7
                change of every parameter where that is larger); (e)
                ``local_attention`` against ``gqa_attention(window=)`` at
                recurrentgemma's attention shape (S 8192, 16/1 heads,
                head_dim 256, window 2048), f32 and bf16, timed beside SDPA
                with a band mask
15. lm-serve    (right after 14, also beside nvcc) (a) llama3.2-1b at full
                width through ``serve_batch``: 16 prompts of 1,024 tokens,
                128 greedy steps, bf16 compute and cache; tokens in the
                vocabulary, every logit finite; prefill ms, decode ms a
                step (median of the warm steps, CUDA events), tokens/s,
                cache bytes, ``max_memory_allocated``, the step's ratio to
                its bound (the parameters as stored and the live cache over
                the HBM rate), a ``torch.profiler`` split of one step and
                its idle share, ``decode_attention`` beside SDPA; (b)
                ``decode_step(prefill(t[:-1]), t[-1])`` against
                ``apply(t)[:, -1]`` within 5e-3 max|ref| + 1e-4 on 2 rows
                of 1,024 tokens and (c) 16 greedy tokens each the
                forward's argmax (ties within that tolerance end a row's
                comparison) -- both at full depth in f64 and on the first
                2 layers in f32 (the f32 forward at full depth moves its
                own logits by O(1) under a change of batch shape; logged);
                (d) the ten archs' smoke configs through ``serve_batch`` at
                f32 on the card and on the host, the host's tokens fed to
                both: each step's logits rtol 1e-4, or twice the host's
                own spread under a 2e-7 change of every parameter where
                that is larger
16. lm-placement (right after 15, also beside nvcc) llama3.2-1b at full
                width (f32 parameters, bf16 compute, full remat), 3 steps of
                4 x 2048 tokens at a constant lr 1e-3 from phase 13's seed:
                (a) on one device; (b) placed on (data=1, model=4) -- the
                losses, grad norms, gathered parameters and both moments
                equal to (a) bit for bit; (c) placed on (data=2, model=2)
                -- losses rtol 5e-3 and parameters max-abs 5e-2 of (a)
                (the JAX package's bars), the gaps and the elements more
                than 1e-6 apart logged, and on the first 2 layers at f32
                compute the losses rtol 1e-5 and grad norms rtol 1e-4;
                (d) ``elastic_remesh`` of (c)'s parameters and moments
                (2,2) -> (1,4) -> (4,1) -> (2,2), bit for bit, each
                position holding its resolved bytes, and
                ``CheckpointManager.restore(shardings=)`` of the smoke
                model onto (2,2) bit for bit; (e) each position's measured
                bytes (parameters, moments, count, batch) equal to the dry
                run's count for the same config, batch and mesh, the step
                times of (a)-(c) (CUDA events) and
                ``max_memory_allocated``; (f) ``launch/dryrun.run_cell`` of
                llama3.2-1b ``train_4k`` and ``decode_32k`` on the 16 x 16
                single-pod mesh of ``meta``: memory, FLOPs, collective
                bytes and fallbacks (the 8 KV heads among them)
  8. kernels    one JSON line, after every phase: per kernel its launches
                (by phase), error and times

then the card's nvidia-smi line and, last, the result line
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without the result line; it also exits non-zero when there
is no CUDA device or when the package is not beside it.  It takes no
arguments; ``run`` takes smaller sizes for a rehearsal on the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
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
HOT, SLOTS, OCCUPANCIES = 256, (8, 64, 1024), (1,)
WAL_N, WAL_INSERTS, WAL_DELETES, WAL_MORE = 125_000, 4096, 1000, 1024
# the sharded index: hashed shards (one sealed segment each), the slot
# sizes it is served at, the failing shard sets of the degraded checks;
# the durable sharded index: points, shards, acknowledged writes before
# the split and after the save
SHARDS, SHARD_SLOTS, FAILING = 8, (64, 1024), ((3,), (0, 5))
DUR_N, DUR_SHARDS, DUR_WRITES, DUR_MORE = 125_000, 4, (2048, 512), (512, 128)
# the baselines (``bench_indexing.py:24-25``, ``bench_query.py:32``): hash
# tables, FH's partitions, NH's exact-lift build cut to its first points,
# the candidate budgets
BASE_M, BASE_L, LIFT_N, BUDGETS = 16, 4, 20_000, (256, 2048)
REF_ROWS = 64  # queries whose candidates are held to the reference loop
# the serving mesh: positions on the one card (its device named this often)
MESH_POSITIONS = 4
# the LM substrate (phase 13): the model, the batch of one train step
# (B x S tokens), its steps and the first warm one; the smoke-width runs'
# steps and the step the crash is injected at
LM_ARCH, LM_BATCH, LM_SEQ, LM_STEPS, LM_WARM = "llama3.2-1b", 4, 2048, 20, 3
LM_SMOKE_STEPS, LM_CRASH_AT = 30, 17
# steps of the smoke runs whose losses the card must hold to the host's:
# past them AdamW amplifies f32 rounding differences (a 2e-7 relative
# change of the host's own embedding moves its loss by 2.4e-5 at step 5
# and 1.2e-3 at step 10), so the runs part at any tolerance
LM_PARITY_STEPS = 4
# the LM substrate's other families (phase 14): the MoE, SSM and
# encoder-decoder archs trained at full width (4 x LM_SEQ tokens a step,
# Whisper's decoder at its 448-token target length), their steps and the
# first warm one; the archs held card against host at smoke width; the
# sequence of the local attention's check (recurrentgemma's other shapes)
FAM_MOE, FAM_SSM, FAM_ED = "granite-moe-3b-a800m", "mamba2-780m", \
    "whisper-tiny"
FAM_STEPS, FAM_WARM, FAM_DEC_SEQ, FAM_LOCAL_SEQ = 10, 3, 448, 8192
FAM_SMOKE = ("granite-moe-3b-a800m", "llama4-scout-17b-a16e", "mamba2-780m",
             "recurrentgemma-9b", "whisper-tiny", "phi-3-vision-4.2b")
# the LM serving path (phase 15): ``LM_ARCH`` served at full width (batch
# x prompt tokens, then gen greedy steps), the decode steps left out of the
# median; the checks' rows and tokens a row, the greedy check's steps, and
# the depth of the f32 checks (at full depth the f32 forward moves its own
# logits by O(1) under a change of batch shape: ``run_serve_checks``)
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN, SERVE_WARM = 16, 1024, 128, 3
SERVE_ROWS, SERVE_LEN, SERVE_GREEDY, SERVE_F32_LAYERS = 2, 1024, 16, 2
# bf16 bars, as fractions of the reference's largest magnitude: the
# served decode attention against SDPA on the same bf16 cache, and the
# first layers' bf16 decode step against their bf16 forward
SERVE_ATTN_BAR, SERVE_BF16_BAR = 2e-2, 1e-1
# LM placement (phase 16): the steps each placement runs from phase 13's
# parameters and batches at the JAX package's constant learning rate
# (``tests/test_distributed.py``), the depth of the f32 check, the meshes
# of the card named at 4 positions (placed steps, then the elastic chain),
# and the dry run's cells on the single-pod mesh
PLACE_STEPS, PLACE_LR, PLACE_F32_LAYERS = 3, 1e-3, 2
PLACE_BITWISE, PLACE_DP = (1, 4), (2, 2)
PLACE_CHAIN = ((1, 4), (4, 1), (2, 2))
PLACE_DRY = ("train_4k", "decode_32k")
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
        sweep_queries=64, dfs_queries=8, reps=10, sweep_n=None,
        fresh=FRESH, deletes=DELETES, hot=HOT, slots=SLOTS, wal_n=WAL_N,
        wal_inserts=WAL_INSERTS, wal_deletes=WAL_DELETES,
        wal_more=WAL_MORE, shards=SHARDS, shard_slots=SHARD_SLOTS,
        failing=FAILING, dur_n=DUR_N, dur_shards=DUR_SHARDS,
        dur_writes=DUR_WRITES, dur_more=DUR_MORE, lift_n=LIFT_N,
        budgets=BUDGETS, lm_kw=None, lm_fam_kw=None,
        lm_place_kw=None) -> dict:
    """All phases on ``device`` at these sizes (the defaults are the full
    size; the plain ``dfs`` route, 2.6 s a query on the host, is checked
    on 8 queries to keep the script within its limit; ``sweep_n`` cuts
    slice 1's depth alone, ``lm_kw`` is passed to
    :func:`run_lm`, ``lm_fam_kw`` to :func:`run_lm_families` and
    ``lm_place_kw`` to :func:`run_lm_placement`); returns the kernels
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

    # 2. build every kernel, one nvcc per source, all at once, while the
    # phases that launch no kernel run: 13-14 train the LM, 15 serves it,
    # 16 places it, then 7's index and 3's tree are built on the host;
    # checked before phase 4
    ready = None
    if device.type == "cuda":
        pool = ThreadPoolExecutor(max_workers=1)
        future = pool.submit(lambda t=time.perf_counter(): (
            _build.build(force=True), time.perf_counter() - t))
        pool.shutdown(wait=False)

        def ready():
            reports, seconds = future.result()
            log("build", seconds=f"{seconds:.1f}", target="sm_90a",
                libraries=",".join(_build.library_path(name).name
                                   for name in _build.SOURCES))
            instances = {}
            for ptxas in reports.values():
                instances.update(ptxas_instances(ptxas))
            for inst, (regs, st, ld) in sorted(instances.items()):
                log("build", instance=inst, registers=regs, spill_stores=st,
                    spill_loads=ld)
            for inst in MAIN_INSTANCES:  # the main path's instances
                if inst not in instances or any(instances[inst][1:]):
                    raise AssertionError(f"{inst}: missing from ptxas' "
                                         f"report or spills "
                                         f"({instances.get(inst)})")
    t0 = time.perf_counter()
    run_lm(device, card, reps=reps, **(lm_kw or {}))
    log("lm", phase_seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    run_lm_families(device, card, reps=reps, **(lm_fam_kw or {}))
    log("lm-families", phase_seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    run_lm_serve(device, card, reps=reps)
    log("lm-serve", phase_seconds=f"{time.perf_counter() - t0:.1f}")
    t0 = time.perf_counter()
    run_lm_placement(device, card, **(lm_place_kw or {}))
    log("lm-placement", phase_seconds=f"{time.perf_counter() - t0:.1f}")
    stacked = build_stacked(device, n=n, d=d, queries=queries, n0=n0,
                            fresh=fresh, deletes=deletes)
    k1, frozen = run_sweep(device, card, n=sweep_n or n, d=d,
                           queries=queries, n0=n0,
                           sweep_queries=sweep_queries,
                           dfs_queries=dfs_queries, reps=reps, ready=ready)
    k2, mutable = run_stacked(device, card, n=n, d=d, queries=queries,
                              n0=n0, reps=reps, fresh=fresh, deletes=deletes,
                              built=stacked)
    del stacked
    served = run_serve(device, card, frozen, mutable, hot=hot, slots=slots,
                       wal_n=wal_n, wal_inserts=wal_inserts,
                       wal_deletes=wal_deletes, wal_more=wal_more)
    sharded, exchange = run_sharded(
        device, card, frozen["x"], frozen["q"], n0=n0, reps=reps,
        shards=shards, fresh=fresh, deletes=deletes, slots=shard_slots,
        failing=failing, dur_n=dur_n, dur_shards=dur_shards,
        dur_writes=dur_writes, dur_more=dur_more)
    base = run_baselines(device, card, frozen, reps=reps, lift_n=lift_n,
                         budgets=budgets)
    t0 = time.perf_counter()
    meshed = run_mesh(device, card, mutable, exchange, frozen, n0=n0,
                      reps=reps)
    log("mesh", phase_seconds=f"{time.perf_counter() - t0:.1f}")
    del mutable, exchange
    gc.collect()
    for rec, phase in ((k1, "5 query"), (k2, "7 stacked f32")):
        rec["launches_by_phase"] = {
            phase: rec["launches"], "9 serve": served[rec["name"]],
            **{ph: n[rec["name"]] for ph, n in sharded.items()},
            "11 baselines": base["p2h_sweep"] if rec is k1 else 0,
            **{ph: n[rec["name"]] for ph, n in meshed.items()}}
    for rec in (k1, k2):
        rec["launches"] = sum(rec["launches_by_phase"].values())
    return {"kernels": [k1, k2]}


def run_sweep(device, card, *, n, d, queries, n0, sweep_queries,
              dfs_queries, reps, ready=None) -> dict:
    """Slice 1, phases 3-6; returns K1's record and what phase 9 reuses:
    the index, the raw queries and the oracle's answer to them.
    ``ready()``, when given, is called once the host data and tree are
    built, before the first kernel launch (the build of phase 2)."""
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
    if ready is not None:
        ready()
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
                        oracle=(od, oi, nxt), oracle_ids=oi1,
                        batch_ms=batch_ms, answer_ids=bi)


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


def build_stacked(device, *, n, d, queries, n0, rounds=ROUNDS,
                  fresh=FRESH, deletes=DELETES) -> dict:
    """Phase 7's index: a ``MutableP2HIndex`` of ``rounds`` sealed
    segments, a live delta and deletes, built on the host and uploaded.
    It launches no kernel, so ``run()`` builds it while nvcc runs."""
    import torch

    from repro_torch.data.pipeline import make_p2h_dataset
    from repro_torch.stream import CompactionPolicy, MutableP2HIndex

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
    return dict(q=q, index=m, dead=dead, snap=snap, stk=stk)


def run_stacked(device, card, *, n, d, queries, n0, reps,
                rounds=ROUNDS, fresh=FRESH, deletes=DELETES,
                seq_queries=SEQ_QUERIES, built=None) -> dict:
    """Slice 2, phase 7: the mutable index's stacked read path; returns
    K2's record and what phase 9 reuses: the index, its deleted gids and
    the oracle's view of its live set.  ``built`` is
    :func:`build_stacked`'s result at the same sizes (built here when
    None)."""
    import torch

    from repro_torch.core import search
    from repro_torch.core.balltree import normalize_query
    from repro_torch.core.exact import exact_search
    from repro_torch.kernels import p2h_scan, ref
    from repro_torch.kernels import stacked_sweep as tss

    k = K
    if built is None:
        built = build_stacked(device, n=n, d=d, queries=queries, n0=n0,
                              rounds=rounds, fresh=fresh, deletes=deletes)
    q, m, dead = built["q"], built["index"], built["dead"]
    snap, stk = built["snap"], built["stk"]

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

    # one batch at each occupancy: the dfs route beside the kernel route
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


def recorded(fn, device):
    """``fn()`` with every K1 and K2 launch counted from 0 and its
    operands kept; returns (result, K2 records, K1 records, host s)."""
    from repro_torch.kernels import p2h_scan
    from repro_torch.kernels import stacked_sweep as tss

    real_k2, real_k1 = tss.stacked_sweep, p2h_scan.p2h_sweep
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


def run_sharded(device, card, x, q, *, n0, reps, shards, fresh, deletes,
                slots, failing, dur_n, dur_shards, dur_writes,
                dur_more) -> dict:
    """Phase 10: the sharded index through the two-round exchange, its
    kernels checked, timed, served, degraded; then the durable sharded
    index.  Returns each kernel's launches on the default exchange (the
    phase's main path) and on the sequential round 2, by run, and the
    exchange's round-2 inputs and answer, which phase 12 runs again."""
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


    # the main path: the default query, round 2 auto-promoted to the
    # stack -- one K2 launch, no K1
    (bd, bi, st, info), main_k2, main_k1, host_s = recorded(
        lambda: m.query(q, k, return_stats=True, return_info=True), device)
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
            lambda kw=kw: m.query(q, k, return_stats=True, **kw), device)
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
        lambda: m.query(q[:seq_queries], k, method="pallas", stacked=False),
        device)
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
    # what phase 12 runs round 2 of again, under a mesh
    exchange = dict(shards=snap.shards, qn=qn_np, lam0=lam0, one=(fd, fi),
                    round2_ms=r2_ms)
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
    return launches, exchange


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


def hold_candidates(what, bd, bi, pts, qn, cand, k: int,
                    chunk: int = 256) -> dict:
    """Hold a hashing baseline's answer ``(bd, bi)`` (B, k) to a float64
    brute force over each query's own candidate set ``cand``: a row with
    at most k candidates returns all of them, then -1; a longer row is
    held through ``assert_exact_topk`` to its set's float64 top-(k+1), at
    the tie tolerance of ``hold64`` (``TIE_UNITS u S``, ``S`` the row's
    largest ``sum_j |q_j x_j|`` over those k + 1).  Raises naming
    ``what``; returns readings."""
    import torch

    from repro_torch.core.exact import dists64

    bi = np.asarray(bi)
    lens = np.array([len(c) for c in cand])
    for b in np.nonzero(lens <= k)[0]:
        got = bi[b][bi[b] >= 0]
        if (bi[b, len(got):] >= 0).any() or set(got) != set(cand[b]):
            raise AssertionError(f"{what}: row {b} does not return its "
                                 f"{lens[b]} candidates")
    rows = np.nonzero(lens > k)[0]
    err, tols = 0.0, []
    for off in range(0, len(rows), chunk):
        r = rows[off:off + chunk]
        width = int(lens[r].max())
        ids = np.full((len(r), width), -1, np.int64)
        for j, b in enumerate(r):
            ids[j, :lens[b]] = cand[b]
        ids = torch.from_numpy(ids).to(pts.device)
        q = qn[torch.from_numpy(r).to(pts.device)]
        d64, mag = dists64(pts, q, ids.clamp(min=0))
        d64 = torch.where(ids >= 0, d64, torch.full_like(d64, np.inf))
        top = torch.argsort(d64, dim=1, stable=True)[:, :k + 1]
        ref = torch.gather(ids, 1, top)
        tol = torch.clamp(TIE_UNITS * U32 * torch.gather(mag, 1, top).amax(1),
                          min=ATOL).cpu().numpy()
        err = max(err, check(what, bd[r], bi[r], ref, pts, q, exact=True,
                             atol=tol))
        tols.append(tol)
    tols = np.concatenate(tols) if tols else np.zeros(1)
    return dict(f32_vs_f64_err=err, rows_short=int((lens <= k).sum()),
                min_tol=float(tols.min()), max_tol=float(tols.max()))


def reference_candidates(name, idx, qh, budget: int, rows,
                         probes: int = 2) -> list:
    """The JAX package's candidate loops (``core/nh.py:109-144``,
    ``core/fh.py:113-132``) written out plainly, for the rows ``rows`` of
    the normalised batch ``qh``: NH's windows per table up to the early
    stop at ``4 * budget`` ids, then ``np.unique``; FH's two ends of every
    partition of every table, which the reference takes for every query
    (only their order depends on it, and ``np.unique`` drops the order);
    then the seeded cut to ``budget``."""
    from repro_torch.core import transform as T

    fq = (T.lift(qh) if idx.lifted_pairs is None
          else T.sampled_lift(qh, idx.lifted_pairs))
    if name == "NH":
        hq = np.floor((T.nh_query_transform(fq) @ idx.proj.T + idx.bias)
                      / idx.width).astype(np.int32)
        sets = []
        for b in rows:
            cand, count = [], 0
            for t, keys in enumerate(idx.bucket_keys):
                lo = np.searchsorted(keys, hq[b, t] - probes, "left")
                hi = np.searchsorted(keys, hq[b, t] + probes, "right")
                cand.append(idx.bucket_ids[t, lo:hi])
                count += hi - lo
                if count >= budget * 4:
                    break
            sets.append(np.unique(np.concatenate(cand)))
    else:
        m = idx.proj.shape[0]
        per = max(1, budget // (m * len(idx.part_slices) * 2))
        ends = []
        for t in range(m):
            for s, e in idx.part_slices:
                take = min(per, e - s)
                ends += [idx.sorted_ids[t, s:s + take],
                         idx.sorted_ids[t, e - take:e]]
        sets = [np.unique(np.concatenate(ends))] * len(rows)
    return [c[np.random.default_rng(0).permutation(len(c))[:budget]]
            if len(c) > budget else c for c in sets]


def recall_at(ids, oracle_ids, k: int) -> float:
    oracle_ids = np.asarray(oracle_ids)
    return float(np.mean([len(set(a[:k]) & set(b[:k])) / k
                          for a, b in zip(np.asarray(ids), oracle_ids)]))


def run_baselines(device, card, frozen: dict, *, reps, lift_n,
                  budgets) -> dict:
    """Phase 11, the paper's comparison (Table III and the query rows): the
    BC-Tree and the Ball-Tree (the same tree, the variant's flags on K1)
    beside the NH and FH hashing baselines, on phase 3's data and queries.
    Returns K1's launches on the Ball-Tree's query."""
    import torch

    from repro_torch.core.exact import verify_candidates
    from repro_torch.core.fh import FHIndex
    from repro_torch.core.nh import NHIndex
    from repro_torch.kernels import p2h_scan
    from repro_torch.kernels import stacked_sweep as tss
    from repro_torch.kernels.ref import p2h_sweep_ref

    k = K
    bc, x, q = frozen["index"], frozen["x"], frozen["q"]
    pts, qn = frozen["pts"], frozen["qn"]
    oi = frozen["oracle"][1].numpy()
    n, d = x.shape
    lam = 4 * d

    # Table III: build seconds and index bytes
    log("baselines-index", card=repr(card), index="BC-Tree", points=n,
        build_seconds=f"{bc.report.build_seconds:.2f}",
        index_bytes=bc.report.index_bytes, source="phase 3")
    log("baselines-index", card=repr(card), index="Ball-Tree", points=n,
        build_seconds=f"{bc.report.build_seconds:.2f}",
        index_bytes=bc.tree.index_bytes(bc=False),
        source="phase 3's tree (the build does not depend on the variant)")
    hashes = {}
    for name, cls, kw in (("NH", NHIndex, dict(lam=lam)),
                          ("FH", FHIndex, dict(lam=lam, l=BASE_L))):
        idx = cls.build(x, m=BASE_M, device=device, **kw)
        hashes[name] = idx
        log("baselines-index", card=repr(card), index=name, points=n,
            m=BASE_M, lam=lam, **({"l": BASE_L} if name == "FH" else {}),
            build_seconds=f"{idx.build_seconds:.2f}", clock="host",
            upload_seconds=f"{idx.upload_seconds:.3f}",
            index_bytes=idx.index_bytes())
    exact = NHIndex.build(x[:lift_n], m=BASE_M, device=device)
    log("baselines-index", card=repr(card), index="NH exact lift",
        points=lift_n, m=BASE_M, lifted_dim=exact.proj.shape[1],
        build_seconds=f"{exact.build_seconds:.2f}", clock="host",
        upload_seconds=f"{exact.upload_seconds:.3f}",
        index_bytes=exact.index_bytes(),
        cut=f"first {lift_n} of {n} points: the lift of all would take "
            f"{n * (exact.proj.shape[1] - 1) * 4 / 1e9:.1f} GB in f32 and "
            f"twice that squared in float64")
    del exact
    gc.collect()

    # query rows: the BC-Tree through K1 (phases 5-6)
    log("baselines-query", card=repr(card), index="BC-Tree",
        route="K1 (method=kernel)", queries=len(q), k=k,
        batch_ms=f"{frozen['batch_ms']:.3f}",
        recall=recall_at(frozen["answer_ids"], oi, k), source="phases 5-6")

    # the Ball-Tree through K1 with the variant's flags, launches from 0
    ball = dataclasses.replace(bc, variant="ball")
    real_k1, recs = p2h_scan.p2h_sweep, []

    def k1(*a, **kw):
        recs.append(kw)
        return real_k1(*a, **kw)

    k1.launches = 0
    k2_before = tss.LAUNCHES
    sync(device)
    p2h_scan.p2h_sweep = k1
    try:
        t0 = time.perf_counter()
        bd, bi = ball.query(q, k, method="kernel")
        sync(device)
        host_s = time.perf_counter() - t0
    finally:
        p2h_scan.p2h_sweep = real_k1
    launches = k1.launches
    if launches < 1 or launches != len(recs) or tss.LAUNCHES != k2_before:
        raise AssertionError(f"the Ball-Tree query made {launches} counted "
                             f"K1 launches of {len(recs)}, and "
                             f"{tss.LAUNCHES - k2_before} K2")
    rec = recs[0]
    if rec["use_ball"] or rec["use_cone"]:
        raise AssertionError("the Ball-Tree query used the BC-Tree's "
                             "point bounds")
    if rec["split"] is None:
        rec["split"] = p2h_scan.default_split(rec, k=rec["k"], bq=rec["bq"])
    kd, ki, ks = real_k1(**rec)
    rd, ri, rs = p2h_sweep_ref(**rec)
    sync(device)
    if not torch.equal(ks, rs):
        raise AssertionError("Ball-Tree K1 launch: skip counts differ")
    if not torch.equal(kd, rd):
        raise AssertionError("Ball-Tree K1 launch: distances differ from "
                             "the plain version's")
    rd2 = rd.cpu().numpy()
    check("Ball-Tree K1 launch ids vs plain", kd.cpu().numpy(),
          ki.cpu().numpy(), rd2, ri.cpu().numpy(), rd2[:, -1], rtol=0.0,
          atol=0.0)
    err64 = check("Ball-Tree query(kernel) vs oracle, float64", bd, bi,
                  frozen["oracle_ids"], pts, qn, exact=True)
    kernel_ms = timed_ms(lambda: real_k1(**rec), reps, device)
    batch_ms = timed_ms(lambda: ball.query(q, k, method="kernel"), 3,
                        device)
    log("baselines-query", card=repr(card), index="Ball-Tree",
        route="K1 (method=kernel, use_ball=use_cone=False)",
        queries=len(q), k=k, batch_ms=f"{batch_ms:.3f}",
        kernel_ms=f"{kernel_ms:.4f}", recall=recall_at(bi, oi, k),
        equals_oracle=True, f32_vs_f64_err=err64, launches=launches,
        bq=rec["bq"], split=rec["split"], bit_equal_plain=True,
        skips=int(ks.sum()), plain_skips=int(rs.sum()),
        host_seconds=f"{host_s:.3f}")

    # the hashes: host candidates, the device's verification, recall
    for name, idx in hashes.items():
        recalls = {}
        for budget in budgets:
            t0 = time.perf_counter()
            hd, hi, st = idx.query(q, k, budget=budget)
            sync(device)
            query_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            qh, cand = idx.candidates(q, budget=budget)
            cand_s = time.perf_counter() - t0
            verified = sum(len(c) for c in cand)
            if verified != st["verified"]:
                raise AssertionError(f"{name}: verified {st['verified']} "
                                     f"by query, {verified} by candidates")
            rows = np.arange(0, len(q), max(1, len(q) // REF_ROWS))
            ref = reference_candidates(name, idx, qh, budget, rows)
            for b, c in zip(rows, ref):
                if not np.array_equal(cand[b], c):
                    raise AssertionError(f"{name} budget {budget}: query "
                                         f"{b}'s candidates are not the "
                                         f"reference loop's")
            qt = torch.from_numpy(qh).to(device)
            verify_ms = timed_ms(
                lambda: verify_candidates(idx.data, qt, cand, k), reps,
                device)
            readings = hold_candidates(
                f"{name} budget {budget}", hd, hi, idx.data, qt, cand, k)
            recalls[budget] = recall_at(hi, oi, k)
            log("baselines-query", card=repr(card), index=name,
                budget=budget, queries=len(q), k=k,
                candidate_seconds=f"{cand_s:.3f}", clock="host",
                verify_ms=f"{verify_ms:.3f}", verified=verified,
                query_seconds=f"{query_s:.3f}",
                recall=recalls[budget], chance_recall=budget / n,
                equals_candidates_top_k=True,
                candidates_equal_reference_loop=len(rows),
                distinct_candidate_sets=len({c.tobytes() for c in cand}),
                **readings)
        lo, hi_ = recalls[budgets[0]], recalls[budgets[-1]]
        log("baselines-recall", index=name,
            check=f"recall({budgets[-1]}) >= recall({budgets[0]}) - 0.05",
            recall_hi=hi_, limit=lo - 0.05,
            chance_recall_hi=budgets[-1] / n,
            chance_recall_lo=budgets[0] / n)
        if hi_ < lo - 0.05:
            raise AssertionError(f"{name}: recall {hi_} at budget "
                                 f"{budgets[-1]} under {lo} at "
                                 f"{budgets[0]} less 0.05")
    del hashes
    gc.collect()
    return {"p2h_sweep": launches}


def run_mesh(device, card, mutable: dict, exchange: dict, frozen: dict, *,
             n0, reps) -> dict:
    """Phase 12: the serving mesh on the one card, ``device`` named at
    ``MESH_POSITIONS`` positions, each with its own stream.  (a) phase 7's
    index on the stacked route in every probe mode, bit for bit its one
    launch, every position's K2 launch replayed against its plain version;
    (b) the churn parity of ``stream/meshcheck.py``; (c) the device-sharded
    forest over phase 3's data, one shard a position, held to the oracle
    at float64, every K1 launch replayed, then served by ``P2HEngine``;
    (d) round 2 of phase 10's exchange, bit for bit its one launch.
    Returns each kernel's launches by run."""
    import torch

    from repro_torch.core import distributed
    from repro_torch.core.balltree import append_ones
    from repro_torch.core.distributed import ShardedP2HIndex
    from repro_torch.kernels import p2h_scan, ref
    from repro_torch.kernels import stacked_sweep as tss
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import per_position
    from repro_torch.serve import P2HEngine
    from repro_torch.stream.meshcheck import run_churn_parity

    k, P = K, MESH_POSITIONS
    real_k2, real_k1 = tss.stacked_sweep, p2h_scan.p2h_sweep
    mesh = make_mesh((P,), ("shard",), devices=[device] * P)
    m, q, qn = mutable["index"], frozen["q"], frozen["qn"]
    launches = {}
    # the oracle over the index's live set now: phase 9 deleted points
    # since phase 7's oracle
    X, G = m.snapshot().live_points()
    live_orc = oracle64(X, G, qn, k, device)

    # (a) the mutable index's stacked route on the mesh, every probe mode
    f32 = None
    for name, kw in (("f32", {}), ("single", dict(probe_tiles=0)),
                     ("bf16", dict(probe_dtype="bf16")),
                     ("int8", dict(probe_dtype="int8"))):
        (od, oi, ost), one_recs, _, one_s = recorded(
            lambda kw=kw: m.query(q, k, method="stacked", return_stats=True,
                                  **kw), device)
        (md, mi, mst), recs, k1s, host_s = recorded(
            lambda kw=kw: m.query(q, k, method="stacked", return_stats=True,
                                  mesh=mesh, **kw), device)
        if k1s or len(recs) != P * len(one_recs):
            raise AssertionError(f"mesh {name}: {len(recs)} K2 and "
                                 f"{len(k1s)} K1 launches (want "
                                 f"{P * len(one_recs)} and 0)")
        if not (np.array_equal(md, od) and np.array_equal(mi, oi)):
            raise AssertionError(f"mesh {name}: the answer differs from "
                                 f"the one launch's")
        if not np.isin(mi, G).all():
            raise AssertionError(f"mesh {name}: a deleted gid was returned")
        _, _, rdg = hold64(f"mesh {name}", md, mi, live_orc, qn)
        k2_err, _, _ = replay_stacked(f"mesh {name}", recs, real_k2, k,
                                      device)
        if name == "f32":
            f32 = (recs, one_recs)
            launches["12 mesh stacked f32"] = {"stacked_sweep": len(recs),
                                               "p2h_sweep": 0}
        log("mesh-stacked", mode=name, positions=P, queries=len(q), k=k,
            equals_one_launch=True, equals_oracle=True, **rdg,
            k2_launches=len(recs), one_launch_k2=len(one_recs),
            replayed=len(recs), matches_plain=True, k2_max_abs_err=k2_err,
            tiles_skipped=mst["tiles_skipped"],
            one_launch_tiles_skipped=ost["tiles_skipped"],
            leaves_scanned=mst["leaves_scanned"],
            one_launch_leaves_scanned=ost["leaves_scanned"],
            host_seconds=f"{host_s:.3f}", one_host_seconds=f"{one_s:.3f}")
    # the f32 batch: one launch and the mesh in turns; each position's
    # passes alone, all positions' pass B at once on their streams, and
    # the gathers between them
    recs, one_recs = f32

    def one():
        return m.query(q, k, method="stacked")

    def meshed():
        return m.query(q, k, method="stacked", mesh=mesh)

    one_ms = [timed_ms(one, 3, device)]
    mesh_ms = [timed_ms(meshed, 3, device), timed_ms(meshed, 3, device)]
    one_ms.append(timed_ms(one, 3, device))
    dev = {}
    for i, rec in enumerate(recs + one_recs):
        tag = (f"pos{i % P}_{'AB'[i // P]}" if i < len(recs)
               else f"one_{'AB'[i - len(recs)]}")
        dev[tag] = device_ms(lambda rec=rec: real_k2(**rec), reps, device,
                             "stacked_sweep_kernel")
    pass_b = recs[P:]
    together_ms = timed_ms(lambda: per_position(
        mesh, "shard", lambda _i, _d, rec: real_k2(**rec), pass_b), reps,
        device)
    alone_ms = sum(timed_ms(lambda rec=rec: real_k2(**rec), reps, device)
                   for rec in pass_b)
    # the library's gathers on outputs of its own form: the probe planes,
    # then pass B's planes, summed skips and probe skips
    outs_a = [real_k2(**rec) for rec in recs[:P]]
    outs_b = [(bd, bi, sa + sb, sa) for (_, _, sa), (bd, bi, sb)
              in zip(outs_a, (real_k2(**rec) for rec in pass_b))]

    def gathers():
        return (tss._gather_planes([o[:2] for o in outs_a], device),
                tss._gather_planes(outs_b, device))

    gather_ms = timed_ms(gathers, reps, device)
    log("mesh-timing", card=repr(card), positions=P,
        one_launch_batch_ms=",".join(f"{t:.3f}" for t in one_ms),
        mesh_batch_ms=",".join(f"{t:.3f}" for t in mesh_ms),
        pass_b_all_positions_ms=f"{together_ms:.4f}",
        pass_b_positions_alone_sum_ms=f"{alone_ms:.4f}",
        gathers_ms=f"{gather_ms:.4f}", reps=reps,
        **{f"{t}_device_ms": v for t, v in dev.items()})

    # (b) churn parity at its defaults, on the card
    t0 = time.perf_counter()
    rep = run_churn_parity(make_mesh((P,), ("shard",), devices=[device] * P))
    log("mesh-churn", positions=P, phases=",".join(
        f"{p['phase']}:{p['segments']}" for p in rep["phases"]),
        pinned_isolation=rep["pinned_isolation"],
        final_live=rep["final_live"], equals_one_launch=True,
        seconds=f"{time.perf_counter() - t0:.1f}")

    # (d) round 2 of phase 10's exchange on the mesh: one pass, one K2
    # launch a position
    ex = exchange
    (r2, _, _), recs, k1s, host_s = recorded(
        lambda: distributed._stacked_round2(
            ex["shards"], ex["qn"], k, method="sweep", stacked=None,
            lam0=ex["lam0"], probe_tiles=None,
            placed=dict(mesh=mesh, mesh_axis="shard")), device)
    if k1s or len(recs) != P:
        raise AssertionError(f"mesh exchange: {len(recs)} K2 and "
                             f"{len(k1s)} K1 launches (want {P} and 0)")
    if not (torch.equal(r2[0], ex["one"][0])
            and torch.equal(r2[1], ex["one"][1])):
        raise AssertionError("mesh exchange: round 2 differs from its one "
                             "launch")
    k2_err, _, _ = replay_stacked("mesh exchange", recs, real_k2, k, device)
    r2_ms = timed_ms(lambda: distributed._stacked_round2(
        ex["shards"], ex["qn"], k, method="sweep", stacked=None,
        lam0=ex["lam0"], probe_tiles=None,
        placed=dict(mesh=mesh, mesh_axis="shard")), 3, device)
    launches["12 mesh exchange round 2"] = {"stacked_sweep": len(recs),
                                            "p2h_sweep": 0}
    log("mesh-exchange", card=repr(card), positions=P,
        shards=len(ex["shards"]), equals_one_launch=True,
        k2_launches=len(recs), replayed=len(recs), matches_plain=True,
        k2_max_abs_err=k2_err, round2_ms=f"{r2_ms:.3f}",
        one_launch_round2_ms=f"{ex['round2_ms']:.3f}",
        host_seconds=f"{host_s:.3f}")

    # (c) the device-sharded forest: one tree a position
    x = frozen["x"]
    n = len(x)
    fmesh = make_mesh((P,), ("data",), devices=[device] * P)
    t0 = time.perf_counter()
    forest = ShardedP2HIndex.build(x, fmesh, n0=n0, seed=SEED)
    sync(device)
    build_s = time.perf_counter() - t0
    (bd, bi, st), k2s, recs, host_s = recorded(lambda: forest.query(q, k),
                                               device)
    if k2s or len(recs) != 2 * P:
        raise AssertionError(f"forest: {len(recs)} K1 and {len(k2s)} K2 "
                             f"launches (want {2 * P} and 0)")
    if not (np.isfinite(bd).all() and bd.shape == (len(q), k)):
        raise AssertionError("forest: non-finite or misshapen answer")
    orc = oracle64(append_ones(x), np.arange(n), qn, k, device)
    _, _, rdg = hold64("forest", bd, bi, orc, qn)
    k1_err, plain = 0.0, []
    for i, rec in enumerate(recs):
        kd, ki, ks = real_k1(**rec)
        (rd, ri, rs), ms = timed_call(lambda rec=rec: ref.p2h_sweep_ref(
            **rec), device)
        plain.append(ms)
        if not torch.equal(ks, rs):
            raise AssertionError(f"forest K1 launch {i}: skip counts differ")
        if not torch.equal(kd, rd):
            raise AssertionError(f"forest K1 launch {i}: distances differ "
                                 f"from the plain version's")
        k1_err = max(k1_err, check(f"forest K1 launch {i} ids vs plain",
                                   kd.cpu(), ki.cpu(), rd.cpu(), ri.cpu()))
    launches["12 mesh forest"] = {"p2h_sweep": len(recs),
                                  "stacked_sweep": 0}
    log("mesh-forest", positions=P, n=n, shard_n=forest.shard_n,
        leaves_per_shard=forest.trees[0].num_leaves, queries=len(q), k=k,
        build_seconds=f"{build_s:.1f}", equals_oracle=True, **rdg,
        k1_launches=len(recs), replayed=len(recs), matches_plain=True,
        bit_equal_plain=True, k1_max_abs_err=k1_err,
        tiles_skipped=st["tiles_skipped"],
        leaves_scanned=st["leaves_scanned"], host_seconds=f"{host_s:.3f}")
    # the forest's phases as its query runs them, timed apart: round 1 at
    # every position with the pmin, round 2 at every position, the gather
    # with the merge and the psum
    B = len(q)
    inf = torch.full((B,), float("inf"), device=device)
    fkw = dict(mesh=fmesh, axes=forest.axes, k=k)
    firsts, lam0 = distributed._forest_round1(forest.trees, qn, inf,
                                              frac1=0.02, **fkw)
    outs = distributed._forest_round2(forest.trees, firsts, lam0,
                                      shard_n=forest.shard_n, n=n, **fkw)
    r1_ms = timed_ms(lambda: distributed._forest_round1(
        forest.trees, qn, inf, frac1=0.02, **fkw), reps, device)
    r2_ms = timed_ms(lambda: distributed._forest_round2(
        forest.trees, firsts, lam0, shard_n=forest.shard_n, n=n, **fkw),
        reps, device)
    merge_ms = timed_ms(lambda: distributed._forest_merge(outs, k, device),
                        reps, device)
    batch_ms = timed_ms(lambda: forest.query(q, k), 3, device)
    k1_dev = [device_ms(lambda rec=rec: real_k1(**rec), reps, device,
                        "p2h_sweep_kernel") for rec in recs]
    log("mesh-forest-timing", card=repr(card), batch_ms=f"{batch_ms:.3f}",
        round1_ms=f"{r1_ms:.3f}", round2_ms=f"{r2_ms:.3f}",
        merge_ms=f"{merge_ms:.4f}",
        round1_k1_device_ms=",".join(str(t) for t in k1_dev[:P]),
        round2_k1_device_ms=",".join(str(t) for t in k1_dev[P:]),
        k1_plain_ms=",".join(f"{t:.1f}" for t in plain),
        one_tree_batch_ms=f"{frozen['batch_ms']:.3f}", reps=reps)
    # served: the engine's "sharded" route at one slot of the whole batch
    eng = P2HEngine(frozen["index"], sharded=forest, slot_size=B)
    (ed, ei), k2s, recs, host_s = recorded(lambda: eng.query(q, k), device)
    if k2s or len(recs) != 2 * P or eng.stats()["routes"] != {"sharded": 1}:
        raise AssertionError(f"forest engine: {len(recs)} K1 launches, "
                             f"routes {eng.stats()['routes']}")
    warm = eng.query(q, k)
    for tag, (ad, ai) in (("cold", (ed, ei)), ("warm", warm)):
        if not np.array_equal(ad, bd):
            raise AssertionError(f"forest engine {tag}: distances differ "
                                 f"from the direct query's")
        check(f"forest engine {tag} ids vs direct", ad, ai, bd, bi,
              rtol=0.0, atol=0.0)
    launches["12 mesh forest engine"] = {"p2h_sweep": len(recs),
                                         "stacked_sweep": 0}
    log("mesh-forest-serve", card=repr(card), slot_size=B,
        qps=f"{B / host_s:.1f}", k1_per_batch=len(recs),
        equals_direct=True, warm_equals_cold=True,
        cache_hits=eng.cache.stats()["hits"])
    return launches


def plain_attention(q, k, v, scale):
    """Causal softmax attention written out densely: the KV heads repeated
    to the query heads, scores, softmax and the product with V in f32 on
    the operands as given.  (B, S, H, D) -> (B, S, H, D) f32."""
    import torch

    S, G = q.shape[1], q.shape[2] // k.shape[2]
    kr = k.float().repeat_interleave(G, dim=2)
    vr = v.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, kr)
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    s = s.masked_fill(~keep, float("-inf"))
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), vr)


def sdpa_attention(q, k, v, scale):
    """The library's fused attention on the same operands (the yardstick
    for a fused kernel; used nowhere in the port)."""
    import torch.nn.functional as F

    G = q.shape[2] // k.shape[2]
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.repeat_interleave(G, dim=2).transpose(1, 2),
        v.repeat_interleave(G, dim=2).transpose(1, 2), is_causal=True,
        scale=scale)
    return out.transpose(1, 2)


def run_lm(device, card, *, reps, cfg=None, batch=LM_BATCH, seq=LM_SEQ,
           steps=LM_STEPS, warm=LM_WARM, smoke_steps=LM_SMOKE_STEPS,
           crash_at=LM_CRASH_AT) -> None:
    """Phase 13, the LM substrate: (a) ``LM_ARCH`` at full width (or
    ``cfg``, a cut of it for a rehearsal) trained through
    ``make_train_step``; (b) the attention against the plain version; (c)
    ``train()`` at smoke width on the card against the host, and resumed
    after an injected crash."""
    import torch

    from repro_torch.models.registry import get_config

    cfg = cfg or get_config(LM_ARCH)
    run_lm_train(device, card, cfg, batch=batch, seq=seq, steps=steps,
                 warm=warm)
    run_lm_attention(device, card, cfg, seq=seq, reps=reps)
    run_lm_smoke(device, card, steps=smoke_steps, crash_at=crash_at)
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the LM phase turned TF32 on")


def run_lm_train(device, card, cfg, *, batch, seq, steps, warm) -> None:
    """(a) The model on the card (f32 parameters, the config's bf16
    compute), AdamW under the cosine schedule, ``steps`` steps of
    ``SyntheticLMDataset`` batches of batch x seq tokens."""
    import math
    import statistics

    import torch

    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.steps import lm_loss, make_train_step
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.models.transformer import StackedLM
    from repro_torch.optim import adamw_init, cosine_schedule

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if cfg == get_config(LM_ARCH):  # the entry point a user calls
        model, _ = get_model(LM_ARCH, seed=SEED, device=device)
    else:  # a cut of it, for a rehearsal on the host
        model = StackedLM(cfg, seed=SEED, device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    n_params = model.param_count()
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq=seq, global_batch=batch,
                            seed=SEED)
    batches = [{k: torch.from_numpy(v).to(device)
                for k, v in ds.global_batch_arrays(s).items()}
               for s in range(steps)]
    # the step-0 loss at the config's compute dtype and at f32, same
    # parameters, same batch
    with torch.no_grad():
        loss0 = float(lm_loss(model, cfg, batches[0])[0])
        model.cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
        try:
            loss0_f32 = float(lm_loss(model, model.cfg, batches[0])[0])
        finally:
            model.cfg = cfg
    ln_v = math.log(cfg.vocab)
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(model, cfg, lr_fn=lambda s: cosine_schedule(
        s, peak_lr=1e-3, warmup_steps=5, total_steps=steps))
    runs = [timed_call(lambda b=b: step(opt, b), device) for b in batches]
    with torch.no_grad():
        loss0_after = float(lm_loss(model, cfg, batches[0])[0])
    ms = [t for _, t in runs]
    loss = [float(m["loss"]) for m, _ in runs]
    gnorm = [float(m["grad_norm"]) for m, _ in runs]
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device.type == "cuda" else None)
    med = statistics.median(ms[warm:])
    flops = 6 * n_params * batch * seq
    log("lm-train", card=repr(card), arch=cfg.name, params=n_params,
        dtypes=f"{cfg.param_dtype}/{cfg.compute_dtype}", remat=cfg.remat,
        batch=batch, seq=seq, steps=steps, init_s=f"{init_s:.1f}",
        loss0=f"{loss0:.4f}", loss0_f32=f"{loss0_f32:.4f}",
        ln_vocab=f"{ln_v:.4f}", loss_first=f"{loss[0]:.4f}",
        loss_last=f"{loss[-1]:.4f}", loss0_after=f"{loss0_after:.4f}",
        grad_norm_first=f"{gnorm[0]:.4g}",
        grad_norm_last=f"{gnorm[-1]:.4g}", step_ms_first=f"{ms[0]:.1f}",
        step_ms_median=f"{med:.1f}", warm_steps=len(ms[warm:]),
        step_ms_min=f"{min(ms[warm:]):.1f}",
        step_ms_max=f"{max(ms[warm:]):.1f}",
        tokens_per_s=f"{batch * seq / (med / 1e3):.0f}",
        max_memory_allocated_gib=("not measured" if peak is None
                                  else f"{peak:.2f}"),
        flops_6NT=f"{flops:.4e}",
        bf16_peak_share=(f"{flops / (med / 1e3) / PEAK_OPS['bf16']:.4f}"
                         if device.type == "cuda" else "not measured"),
        peak_used="989e12 bf16 dense (H100 SXM data sheet, 700 W)")
    log("lm-train", losses=",".join(f"{x:.4f}" for x in loss),
        step_ms=",".join(f"{x:.1f}" for x in ms))
    lm_profile(lambda: step(opt, batches[-1]), device, card)
    if not abs(loss0 - ln_v) < 0.5:
        raise AssertionError(f"step-0 loss {loss0} is not within 0.5 of "
                             f"ln V = {ln_v}")
    if not abs(loss0_f32 - loss0) < 0.05:
        raise AssertionError(f"step-0 loss at f32 {loss0_f32} against "
                             f"{loss0} at {cfg.compute_dtype}")
    if not all(math.isfinite(x) for x in loss + gnorm):
        raise AssertionError(f"non-finite loss or grad_norm: {loss} {gnorm}")
    if not loss[-1] < loss[0]:
        raise AssertionError(f"the loss did not fall: {loss}")
    del model, opt, step, batches, runs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def lm_profile(fn, device, card, top: int = 8) -> None:
    """One more step under ``torch.profiler``: the device's busy time
    beside the step's CUDA-event time, and the kernels that take the most
    of it (the card only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if device.type != "cuda":
        return
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, ms = timed_call(fn, device)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    if not kernels:
        log("lm-profile", card=repr(card), step_ms=f"{ms:.1f}",
            device_busy_ms="not measured (no device events in the trace)")
        return
    gemm = sum(e.device_time_total for e in kernels
               if re.search(r"gemm|xmma|cutlass|sm90", e.key)) / 1e3
    log("lm-profile", card=repr(card), step_ms=f"{ms:.1f}",
        device_busy_ms=f"{busy:.1f}", idle_share=f"{1 - busy / ms:.3f}",
        kernels=sum(e.count for e in kernels), matmul_ms=f"{gemm:.1f}",
        other_ms=f"{busy - gemm:.1f}")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:top]:
        log("lm-profile", kernel=repr(e.key[:90]), count=e.count,
            ms=f"{e.device_time_total / 1e3:.1f}")


def run_lm_attention(device, card, cfg, *, seq, reps) -> None:
    """(b) ``gqa_attention`` (forward, and the ``autograd.Function``'s
    backward) at the config's attention shapes -- batch 1, causal, its
    heads and chunk -- against the plain dense version on the same
    operands, in f32 and bf16; timed beside the library's fused
    attention."""
    import torch

    from repro_torch.models.attention import gqa_attention

    B, H, Hkv, D, C = 1, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.kv_chunk
    gen = torch.Generator().manual_seed(SEED)
    base = [torch.randn(shape, generator=gen).to(device)
            for shape in ((B, seq, H, D), (B, seq, Hkv, D), (B, seq, Hkv, D),
                          (B, seq, H, D))]
    pos = torch.arange(seq, device=device)
    scale = 1.0 / D ** 0.5
    # normwise bounds, max|err| / max|plain|: f32 sums in another order;
    # in bf16 the probabilities are rounded to bf16 before p @ V, and the
    # output and gradients are rounded to bf16
    bound = {"f32": 2e-5, "bf16": 3e-2}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = (t.to(dt).requires_grad_(True) for t in base[:3])
        ct = base[3].to(dt)

        def port():
            return gqa_attention(q, k, v, pos, pos, causal=True, q_chunk=C,
                                 kv_chunk=C, compute_dtype=dt)

        def fwd_bwd(fn):
            out = fn()
            return out, torch.autograd.grad((out.float() * ct.float()).sum(),
                                            (q, k, v))

        got = fwd_bwd(port)
        want = fwd_bwd(lambda: plain_attention(q, k, v, scale))
        errs = {}
        for what, g, w in zip(("out", "dq", "dk", "dv"), (got[0], *got[1]),
                              (want[0], *want[1])):
            g, w = g.detach().float(), w.detach().float()
            errs[what] = float((g - w).abs().max() / w.abs().max())
        with torch.no_grad():
            port_fwd_ms = timed_ms(port, reps, device)
        times = {}
        for key, fn in (("port", port),
                        ("plain", lambda: plain_attention(q, k, v, scale)),
                        ("sdpa", lambda: sdpa_attention(q, k, v, scale))):
            fwd_bwd(fn)  # warm
            times[key] = timed_ms(lambda fn=fn: fwd_bwd(fn), reps, device)
        log("lm-attention", card=repr(card), dtype=name, batch=B, seq=seq,
            heads=f"{H}/{Hkv}", head_dim=D, chunk=C, causal=True,
            port_fwd_ms=f"{port_fwd_ms:.3f}",
            port_fwd_bwd_ms=f"{times['port']:.3f}",
            plain_fwd_bwd_ms=f"{times['plain']:.3f}",
            sdpa_fwd_bwd_ms=f"{times['sdpa']:.3f}",
            **{f"err_{k}": f"{e:.2e}" for k, e in errs.items()},
            bound=bound[name])
        if not max(errs.values()) <= bound[name]:
            raise AssertionError(f"attention {name} against the plain "
                                 f"version: {errs} > {bound[name]}")


def run_lm_smoke(device, card, *, steps, crash_at) -> None:
    """(c) ``train()`` at ``LM_ARCH``'s smoke width with f32 compute: on
    the card against the same run on the host (the same seed draws the
    same parameters on both; the first ``LM_PARITY_STEPS`` losses rtol
    1e-4, the rest logged), and on the card with a
    crash injected at ``crash_at``, resumed from its checkpoint to the
    uninterrupted run's final loss (rtol 1e-5)."""
    import contextlib
    import io

    import torch

    from repro_torch.launch.train import TrainConfig, train

    root = BUILD / "chip_smoke_lm"
    shutil.rmtree(root, ignore_errors=True)

    def run(tag, dev, **kw):
        cfg = TrainConfig(arch=LM_ARCH, smoke=True, steps=steps,
                          global_batch=8, seq=64, ckpt_dir=str(root / tag),
                          ckpt_every=10, log_every=1, peak_lr=3e-3,
                          warmup=5, device=dev, compute_dtype=torch.float32)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            _, hist, restarts = train(cfg, **kw)
        return [h["loss"] for h in hist], restarts, time.perf_counter() - t0

    card_loss, _, card_s = run("card", device)
    host_loss, _, host_s = run("host", "cpu")
    crash_loss, restarts, crash_s = run("crash", device,
                                        fail_at_step=crash_at)
    rel = np.abs(np.asarray(card_loss) - host_loss) / np.abs(host_loss)
    parity = float(rel[:LM_PARITY_STEPS].max())
    resumed = abs(crash_loss[-1] - card_loss[-1]) / abs(card_loss[-1])
    log("lm-smoke", card=repr(card), arch=f"{LM_ARCH} smoke", steps=steps,
        compute="f32", card_s=f"{card_s:.1f}", host_s=f"{host_s:.1f}",
        loss_first=f"{card_loss[0]:.5f}", loss_last=f"{card_loss[-1]:.5f}",
        parity_steps=LM_PARITY_STEPS,
        card_vs_host_max_rel=f"{parity:.2e}",
        card_vs_host_max_rel_all_steps=f"{float(rel.max()):.2e}",
        crash_at=crash_at,
        restarts=restarts, resumed_loss=f"{crash_loss[-1]:.6f}",
        resumed_rel=f"{resumed:.2e}", crash_s=f"{crash_s:.1f}")
    np.testing.assert_allclose(card_loss[:LM_PARITY_STEPS],
                               host_loss[:LM_PARITY_STEPS], rtol=1e-4,
                               err_msg="train() on the card against the host")
    if restarts != 1 or not resumed <= 1e-5:
        raise AssertionError(f"crash-restart: {restarts} restarts, final "
                             f"loss {crash_loss[-1]} against "
                             f"{card_loss[-1]}")
    shutil.rmtree(root, ignore_errors=True)


def free_device(device) -> None:
    """Drop what the last phase left: collect, empty the allocator's cache
    and start a new peak."""
    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def run_lm_families(device, card, *, reps, moe_cfg=None, ssm_cfg=None,
                    ed_cfg=None, batch=LM_BATCH, seq=LM_SEQ,
                    dec_seq=FAM_DEC_SEQ, steps=FAM_STEPS, warm=FAM_WARM,
                    smoke_archs=FAM_SMOKE, local_seq=FAM_LOCAL_SEQ,
                    local_window=None) -> None:
    """Phase 14, the LM substrate's other families: (a) ``FAM_MOE`` and (b)
    ``FAM_SSM`` at full width (or ``moe_cfg``/``ssm_cfg``, cuts of them
    for a rehearsal) trained through ``make_train_step``, (c) ``FAM_ED``
    (the encoder-decoder), (d) every new arch's smoke config through
    ``train()`` on the card against the host, (e) the two-block local
    attention at recurrentgemma's attention shape (``local_window``
    replaces its window for a rehearsal)."""
    import torch

    from repro_torch.models.registry import get_config

    for arch, cfg, n in ((FAM_MOE, moe_cfg, seq), (FAM_SSM, ssm_cfg, seq),
                         (FAM_ED, ed_cfg, dec_seq)):
        run_family_train(device, card, arch, cfg or get_config(arch),
                         batch=batch, seq=n, steps=steps, warm=warm)
    free_device(device)
    run_family_smoke(device, card, smoke_archs)
    run_local_attention(device, card, seq=local_seq, reps=reps,
                        window=local_window)
    free_device(device)
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the LM families' phase turned TF32 on")


def count_drops(fn):
    """``fn()`` with every ``moe_apply`` also returning its pre-drop
    expert counts: (fn's result, assignments dropped by capacity, all
    assignments).  Without a carried count an expert keeps min(count, C)
    of a row's assignments."""
    from repro_torch.models import moe

    plain, seen = moe.moe_apply, [0, 0]

    def recording(p, x, **kw):
        out, aux, cnt = plain(p, x, return_counts=True, **kw)
        cap = moe.moe_capacity(x.shape[1], kw["top_k"], p.router.shape[1],
                               kw["capacity_factor"])
        seen[0] += int((cnt - cap).clamp_min(0).sum())
        seen[1] += int(cnt.sum())
        return out, aux

    moe.moe_apply = recording
    try:
        out = fn()
    finally:
        moe.moe_apply = plain
    return out, seen[0], seen[1]


def active_params(cfg, n_params: int) -> int:
    """Parameters a token passes through: all but the experts it is not
    routed to (top_k of num_experts in each MoE layer)."""
    if not cfg.num_experts:
        return n_params
    per_expert = cfg.d_model * cfg.d_ff * (3 if cfg.gated_mlp else 2)
    moe_layers = sum(spec.moe and spec.mlp for spec in
                     list(cfg.pattern) * cfg.n_periods
                     + list(cfg.tail_specs))
    return n_params - moe_layers * (cfg.num_experts - cfg.top_k) * per_expert


def run_family_train(device, card, arch, cfg, *, batch, seq, steps,
                     warm) -> None:
    """(a)-(c) One family on the card: ``arch``'s model (or a cut of it),
    f32 parameters and the config's compute dtype, AdamW under the cosine
    schedule, ``steps`` steps of ``SyntheticLMDataset`` batches of batch x
    seq tokens with the model's seeded extras."""
    import math
    import statistics

    import torch

    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.steps import lm_loss, make_train_step
    from repro_torch.models.registry import build_model, get_config, get_model
    from repro_torch.optim import adamw_init, cosine_schedule

    free_device(device)
    t0 = time.perf_counter()
    if cfg == get_config(arch):  # the entry point a user calls
        model, _ = get_model(arch, seed=SEED, device=device)
    else:  # a cut of it, for a rehearsal on the host
        model = build_model(cfg, seed=SEED, device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    if any(p.device != device for p in model.parameters()):
        raise AssertionError(f"{arch}: a parameter is off {device}")
    n_params = model.param_count()
    ds = SyntheticLMDataset(vocab=cfg.vocab, seq=seq, global_batch=batch,
                            seed=SEED)
    batches = []
    for s in range(steps):
        arrays = ds.global_batch_arrays(s)
        arrays.update(ds.extra_arrays(s, cfg))
        batches.append({k: torch.from_numpy(v).to(device)
                        for k, v in arrays.items()})
    with torch.no_grad():
        (loss0, (nll0, aux0)), dropped, assigned = count_drops(
            lambda: lm_loss(model, cfg, batches[0]))
    loss0, nll0, ln_v = float(loss0), float(nll0), math.log(cfg.vocab)
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(model, cfg, lr_fn=lambda s: cosine_schedule(
        s, peak_lr=1e-3, warmup_steps=5, total_steps=steps))
    runs = [timed_call(lambda b=b: step(opt, b), device) for b in batches]
    ms = [t for _, t in runs]
    loss = [float(m["loss"]) for m, _ in runs]
    gnorm = [float(m["grad_norm"]) for m, _ in runs]
    load = [float(m["aux_load"]) for m, _ in runs]
    zl = [float(m["aux_z"]) for m, _ in runs]
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device.type == "cuda" else None)
    med = statistics.median(ms[warm:])
    tokens = batch * seq
    n_active = active_params(cfg, n_params)
    flops = 6 * n_active * tokens
    log("lm-family", card=repr(card), arch=cfg.name, params=n_params,
        config_param_count=cfg.param_count(), active_params=n_active,
        dtypes=f"{cfg.param_dtype}/{cfg.compute_dtype}", remat=cfg.remat,
        batch=batch, seq=seq, steps=steps, init_s=f"{init_s:.1f}",
        loss0=f"{loss0:.4f}", nll0=f"{nll0:.4f}", ln_vocab=f"{ln_v:.4f}",
        loss_first=f"{loss[0]:.4f}", loss_last=f"{loss[-1]:.4f}",
        aux_load0=f"{float(aux0[0]):.4f}", aux_z0=f"{float(aux0[1]):.4f}",
        drop_share=(f"{dropped / assigned:.4f}" if assigned else "no MoE"),
        dropped=dropped, assignments=assigned,
        grad_norm_first=f"{gnorm[0]:.4g}",
        grad_norm_last=f"{gnorm[-1]:.4g}", step_ms_first=f"{ms[0]:.1f}",
        step_ms_median=f"{med:.1f}", warm_steps=len(ms[warm:]),
        step_ms_min=f"{min(ms[warm:]):.1f}",
        step_ms_max=f"{max(ms[warm:]):.1f}",
        tokens_per_s=f"{tokens / (med / 1e3):.0f}",
        max_memory_allocated_gib=("not measured" if peak is None
                                  else f"{peak:.2f}"),
        flops_6NT_active=f"{flops:.4e}",
        bf16_peak_share=(f"{flops / (med / 1e3) / PEAK_OPS['bf16']:.4f}"
                         if device.type == "cuda" else "not measured"),
        peak_used="989e12 bf16 dense (H100 SXM data sheet, 700 W)")
    log("lm-family", arch=cfg.name,
        losses=",".join(f"{x:.4f}" for x in loss),
        aux_load=",".join(f"{x:.4f}" for x in load),
        aux_z=",".join(f"{x:.4f}" for x in zl),
        step_ms=",".join(f"{x:.1f}" for x in ms))
    family_profile(lambda: step(opt, batches[-1]), device, card, cfg.name)
    if not abs(nll0 - ln_v) < 0.5:  # the cross-entropy, without the aux
        raise AssertionError(f"{cfg.name}: step-0 cross-entropy {nll0} is "
                             f"not within 0.5 of ln V = {ln_v}")
    if not all(math.isfinite(x) for x in loss + gnorm + load + zl):
        raise AssertionError(f"{cfg.name}: non-finite loss, aux or "
                             f"grad_norm: {loss} {gnorm} {load} {zl}")
    del model, opt, step, batches, runs
    free_device(device)


FAMILY_REST = "rest (projections, MLPs, norms, embedding, loss)"
FAMILY_SPANS = {  # the model code's profiler ranges (``layers.span``)
    "attention": "attention",
    "moe.experts": "grouped expert products",
    "moe.dispatch": "dispatch/combine (router, top-k, argsort, scatter, "
                    "gather)",
    "moe.shared": FAMILY_REST,
    "ssd.intra": "SSD intra-chunk products",
    "ssd.state": "SSD inter-chunk state",
    "rglru.scan": "RG-LRU scan",
    "optim.update": "optimizer (clipping, AdamW)",
}


def family_profile(fn, device, card, name: str) -> None:
    """One more step under ``torch.profiler``: each device kernel's time
    goes to the innermost of the model code's named ranges
    (``FAMILY_SPANS``) open when its operator ran -- or, for an operator
    of the backward pass outside them, the range of the forward operator
    whose autograd node it runs (matched by sequence number).  On the host
    the operators' own CPU time stands in for kernel time (a rehearsal of
    the attribution, not a device metric)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        _, ms = timed_call(fn, device)
    # one sweep a thread in order of start time, with a stack of the open
    # contexts: the model code's ranges; operators that record an autograd
    # node (a forward operator, also one recomputed under remat inside the
    # backward), each in the innermost range open around it; and the
    # backward's evaluate_function events, which stand for the forward
    # operator of their sequence number
    threads = {}
    for e in prof.events():
        threads.setdefault(e.thread, []).append(e)
    by_seq, owners, ranges = {}, [], 0
    for evs in threads.values():
        evs.sort(key=lambda e: (e.time_range.start, -e.time_range.end))
        stack = []
        for e in evs:
            while stack and stack[-1][0] <= e.time_range.start:
                stack.pop()
            top = stack[-1][1] if stack else FAMILY_REST
            seq = getattr(e, "sequence_nr", -1)
            own = FAMILY_SPANS.get(e.name)
            if own is not None:
                ranges += 1
                ctx = own
            elif e.name.startswith("autograd::engine::evaluate_function"):
                # sequence numbers count per thread: key by the thread
                # that ran the node's forward operator
                ctx = (getattr(e, "fwd_thread", e.thread), seq)
            elif seq is not None and seq >= 0:  # a forward operator
                ctx = top if isinstance(top, str) else FAMILY_REST
                by_seq.setdefault((e.thread, seq), ctx)
            else:  # inside a forward operator or a backward function
                ctx = top
            stack.append((e.time_range.end, ctx))
            if device.type == "cuda":
                t = sum(k.duration for k in getattr(e, "kernels", ()))
            else:  # the host rehearsal: the op's own CPU time
                t = e.self_cpu_time_total if own is None else 0
            if t:
                owners.append((ctx, t))
    split = {}
    for ctx, t in owners:
        cat = by_seq.get(ctx, FAMILY_REST) if isinstance(ctx, tuple) else ctx
        split[cat] = split.get(cat, 0.0) + t / 1e3
    busy = sum(split.values())
    what = "device_busy_ms" if device.type == "cuda" else "host_op_ms"
    if not busy:
        log("lm-family-profile", card=repr(card), arch=name,
            step_ms=f"{ms:.1f}",
            **{what: "not measured (no events with time in the trace)"})
        return
    log("lm-family-profile", card=repr(card), arch=name, step_ms=f"{ms:.1f}",
        **{what: f"{busy:.1f}"}, ranges=ranges,
        idle_share=(f"{1 - busy / ms:.3f}" if device.type == "cuda"
                    else "not measured"))
    for cat, t in sorted(split.items(), key=lambda kv: -kv[1]):
        log("lm-family-profile", arch=name, category=repr(cat),
            ms=f"{t:.1f}", share=f"{t / busy:.3f}")


def run_family_smoke(device, card, archs) -> None:
    """(d) ``train()`` at each arch's smoke width with f32 compute, on the
    card and on the host (the same seed draws the same parameters on
    both), ``LM_PARITY_STEPS`` steps.  Each step's loss is held to the
    host's within rtol 1e-4, or within twice the host's own displacement
    when every parameter is multiplied by 1 +- 2e-7 (a rounding's size,
    random signs) where that is larger: some of these configs move by
    more than 1e-4 under such a change by step 3."""
    import contextlib
    import dataclasses
    import io

    import torch

    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import TrainConfig, train
    from repro_torch.models.registry import build_model, get_config
    from repro_torch.optim import adamw_init, cosine_schedule

    root = BUILD / "chip_smoke_lm_families"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(smoke=True, steps=LM_PARITY_STEPS, global_batch=8, seq=64,
              ckpt_every=LM_PARITY_STEPS, log_every=1, peak_lr=3e-3,
              warmup=5, compute_dtype=torch.float32)

    def losses(arch, tag, dev):
        cfg = TrainConfig(arch=arch, ckpt_dir=str(root / arch / tag),
                          device=dev, **kw)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            model, hist, _ = train(cfg)
        if model.device.type != torch.device(dev).type:
            raise AssertionError(f"{arch}: train() ran on {model.device}")
        return np.array([h["loss"] for h in hist]), time.perf_counter() - t0

    def nudged_losses(arch):
        """The host's run again, every parameter times 1 +- 2e-7."""
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  compute_dtype=torch.float32)
        model = build_model(cfg, seed=TrainConfig.seed, device="cpu")
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            for p in model.parameters():
                sign = torch.randint(0, 2, p.shape, generator=gen) * 2 - 1
                p.mul_(1 + 2e-7 * sign)
        step = make_train_step(model, cfg, lr_fn=lambda s: cosine_schedule(
            s, peak_lr=kw["peak_lr"], warmup_steps=kw["warmup"],
            total_steps=kw["steps"]))
        opt = adamw_init(dict(model.named_parameters()))
        ds = SyntheticLMDataset(vocab=cfg.vocab, seq=kw["seq"],
                                global_batch=kw["global_batch"],
                                seed=TrainConfig.seed)
        out = []
        for s in range(kw["steps"]):
            b = ds.global_batch_arrays(s)
            b.update(ds.extra_arrays(s, cfg))
            m = step(opt, {k: torch.from_numpy(v) for k, v in b.items()})
            out.append(float(m["loss"]))
        return np.array(out)

    for arch in archs:
        card_loss, card_s = losses(arch, "card", device)
        host_loss, host_s = losses(arch, "host", "cpu")
        spread = np.abs(nudged_losses(arch) - host_loss)
        bar = np.maximum(1e-4 * np.abs(host_loss), 2 * spread)
        diff = np.abs(card_loss - host_loss)
        log("lm-family-smoke", card=repr(card), arch=f"{arch} smoke",
            steps=LM_PARITY_STEPS, compute="f32", card_s=f"{card_s:.1f}",
            host_s=f"{host_s:.1f}",
            card_losses=",".join(f"{x:.6f}" for x in card_loss),
            card_vs_host_rel=",".join(
                f"{x:.2e}" for x in diff / np.abs(host_loss)),
            host_nudge_rel=",".join(
                f"{x:.2e}" for x in spread / np.abs(host_loss)),
            bar_rel=",".join(f"{x:.2e}" for x in bar / np.abs(host_loss)))
        if not (diff <= bar).all():
            raise AssertionError(f"{arch}: train() on the card against the "
                                 f"host: {card_loss} vs {host_loss} (bar "
                                 f"{bar})")
    shutil.rmtree(root, ignore_errors=True)


def run_local_attention(device, card, *, seq, reps, window=None) -> None:
    """(e) ``local_attention`` (the two-block path, autograd through torch
    operations) against ``gqa_attention(window=)`` (every block of the
    double-chunked schedule, masked) at recurrentgemma's attention shape
    -- batch 1, 16 heads on one KV head, head_dim 256, window 2048 -- in
    f32 and bf16, forward and gradients, normwise; both timed beside the
    library's fused attention with a band mask."""
    import torch
    import torch.nn.functional as F

    from repro_torch.models.attention import gqa_attention, local_attention
    from repro_torch.models.registry import get_config

    cfg = get_config("recurrentgemma-9b")
    W = window or cfg.pattern[2].window
    B, H, Hkv, D, C = 1, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.kv_chunk
    gen = torch.Generator().manual_seed(SEED)
    base = [torch.randn(shape, generator=gen).to(device)
            for shape in ((B, seq, H, D), (B, seq, Hkv, D), (B, seq, Hkv, D),
                          (B, seq, H, D))]
    pos = torch.arange(seq, device=device)
    idx = torch.arange(seq, device=device)
    band = (idx[:, None] >= idx[None, :]) & (idx[:, None] - idx[None, :] < W)
    bound = {"f32": 2e-5, "bf16": 3e-2}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        q, k, v = (t.to(dt).requires_grad_(True) for t in base[:3])
        ct = base[3].to(dt)

        def local():
            return local_attention(q, k, v, pos, window=W, compute_dtype=dt)

        def windowed():
            return gqa_attention(q, k, v, pos, pos, causal=True, window=W,
                                 q_chunk=C, kv_chunk=C, compute_dtype=dt)

        def sdpa():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.repeat_interleave(H // Hkv, dim=2
                                                       ).transpose(1, 2),
                v.repeat_interleave(H // Hkv, dim=2).transpose(1, 2),
                attn_mask=band).transpose(1, 2)

        def fwd_bwd(fn):
            out = fn()
            return out, torch.autograd.grad((out.float() * ct.float()).sum(),
                                            (q, k, v))

        got, want = fwd_bwd(local), fwd_bwd(windowed)
        errs = {}
        for what, g, w in zip(("out", "dq", "dk", "dv"), (got[0], *got[1]),
                              (want[0], *want[1])):
            g, w = g.detach().float(), w.detach().float()
            errs[what] = float((g - w).abs().max() / w.abs().max())
        del got, want
        times = {}
        for key, fn in (("local", local), ("windowed", windowed),
                        ("sdpa", sdpa)):
            with torch.no_grad():
                fn()
                times[f"{key}_fwd_ms"] = timed_ms(fn, reps, device)
            fwd_bwd(fn)
            times[f"{key}_fwd_bwd_ms"] = timed_ms(lambda fn=fn: fwd_bwd(fn),
                                                  reps, device)
        peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                if device.type == "cuda" else None)
        log("lm-local-attention", card=repr(card), dtype=name, batch=B,
            seq=seq, heads=f"{H}/{Hkv}", head_dim=D, window=W, chunk=C,
            **{k: f"{t:.3f}" for k, t in times.items()},
            **{f"err_{k}": f"{e:.2e}" for k, e in errs.items()},
            bound=bound[name],
            max_memory_allocated_gib=("not measured" if peak is None
                                      else f"{peak:.2f}"))
        if not max(errs.values()) <= bound[name]:
            raise AssertionError(f"local attention {name} against the "
                                 f"windowed one: {errs} > {bound[name]}")
        del q, k, v, ct
        free_device(device)


def forced_logits(model, cfg, scfg, tokens):
    """``scfg``'s batch prefilled and decoded for ``scfg.gen_len`` steps
    fed ``tokens`` (B, gen_len) (teacher forcing): [the prefill's last
    logits, each step's], f32 numpy on the host."""
    from repro_torch.launch.serve import decode_steps, serve_inputs, serve_len
    from repro_torch.launch.steps import make_prefill_step

    inputs = serve_inputs(scfg, cfg)
    pos0, max_len = serve_len(cfg, inputs["tokens"].shape[1], scfg.gen_len)
    logits, cache = make_prefill_step(model, cfg, max_len=max_len)(inputs)
    return [logits[:, -1].float().cpu().numpy()] + [
        lg[:, -1].float().cpu().numpy() for _, lg, _ in decode_steps(
            model, cfg, cache, None, pos0=pos0, steps=scfg.gen_len,
            forced=tokens)]


@contextlib.contextmanager
def nudged(model, seed: int = 1):
    """``model`` with every parameter times 1 +- 2e-7 (random signs, a
    rounding's size), restored afterwards."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    saved = [p.detach().clone() for p in model.parameters()]
    with torch.no_grad():
        for p in model.parameters():
            sign = torch.randint(0, 2, p.shape, generator=gen) * 2 - 1
            p.mul_((1 + 2e-7 * sign).to(device=p.device, dtype=p.dtype))
    try:
        yield model
    finally:
        with torch.no_grad():
            for p, s in zip(model.parameters(), saved):
                p.copy_(s)


def run_lm_serve(device, card, *, reps, cfg=None, batch=SERVE_BATCH,
                 prompt_len=SERVE_PROMPT, gen=SERVE_GEN, warm=SERVE_WARM,
                 rows=SERVE_ROWS, length=SERVE_LEN, greedy=SERVE_GREEDY,
                 f32_layers=SERVE_F32_LAYERS) -> None:
    """Phase 15, the LM serving path: (a) ``LM_ARCH`` at full width (or
    ``cfg``, a cut of it for a rehearsal) served through ``serve_batch``;
    (b) its decode step against its forward and (c) its greedy tokens
    against the forward's argmax (:func:`run_serve_checks`: f64 at full
    depth, f32 on its first ``f32_layers`` layers, and there (b) in bf16
    too); (d) every arch's smoke config served on the card against the
    host."""
    import torch

    from repro_torch.models.registry import get_config

    cfg = cfg or get_config(LM_ARCH)
    model = run_serve_full(device, card, cfg, batch=batch,
                           prompt_len=prompt_len, gen=gen, warm=warm,
                           reps=reps)
    run_serve_checks(device, card, model, cfg, rows=rows, length=length,
                     greedy=greedy, f32_layers=f32_layers)
    del model
    free_device(device)
    run_serve_smoke(device, card)
    free_device(device)
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the LM serving phase turned TF32 on")


def run_serve_full(device, card, cfg, *, batch, prompt_len, gen, warm,
                   reps):
    """(a) The model on the card (f32 parameters, the config's bf16
    compute and cache) through ``serve_batch``; then the same prompts again
    through the serving steps with every step timed by CUDA events, a
    profiled step, and ``decode_attention`` at the model's decode shape
    beside the library's fused attention.  Returns the model."""
    import statistics

    import torch
    import torch.nn.functional as F

    from repro_torch.launch.serve import (
        ServeConfig,
        decode_steps,
        serve_batch,
        serve_inputs,
        serve_len,
    )
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.attention import decode_attention
    from repro_torch.models.registry import get_config, get_model
    from repro_torch.models.transformer import StackedLM

    free_device(device)
    t0 = time.perf_counter()
    if cfg == get_config(LM_ARCH):  # the entry point a user calls
        model, _ = get_model(LM_ARCH, seed=SEED, device=device)
    else:  # a cut of it, for a rehearsal on the host
        model = StackedLM(cfg, seed=SEED, device=device)
    sync(device)
    init_s = time.perf_counter() - t0
    scfg = ServeConfig(arch=LM_ARCH, smoke=False, batch=batch,
                       prompt_len=prompt_len, gen_len=gen, seed=SEED,
                       device=device)
    tokens, stats = serve_batch(scfg, model=model)
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device.type == "cuda" else None)
    if tokens.shape != (batch, gen) or tokens.dtype != np.int32 or not (
            (tokens >= 0) & (tokens < cfg.vocab)).all():
        raise AssertionError(f"serve_batch's tokens: {tokens.shape} "
                             f"{tokens.dtype} {tokens.min()} {tokens.max()}")

    # the same prompts through the serving steps, each step timed
    pos0, max_len = serve_len(cfg, prompt_len, gen)
    inputs = serve_inputs(scfg, cfg)
    (logits, cache), prefill_ms = timed_call(
        lambda: make_prefill_step(model, cfg, max_len=max_len)(inputs),
        device)
    finite = [torch.isfinite(logits).all()]
    steps = decode_steps(model, cfg, cache, torch.argmax(
        logits[:, -1], dim=-1).to(torch.int32), pos0=pos0, steps=gen)
    ms, again = [], []
    for _ in range(gen):
        (tok, lg, cache), t = timed_call(lambda: next(steps), device)
        again.append(tok)
        ms.append(t)
        finite.append(torch.isfinite(lg).all())
    if not bool(torch.stack(finite).all()):
        raise AssertionError("non-finite logits while serving")
    again = torch.stack(again, dim=1).cpu().numpy()
    med = statistics.median(ms[warm:])
    attn_layers = sum(s.mixer == "attn" for s in model.specs)
    cache_bytes = sum(t.nbytes for layer in cache.values()
                      for t in layer.values())
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    live = statistics.mean(pos0 + i + 1 for i in range(warm, gen))
    kv_read = (attn_layers * 2 * batch * live * cfg.n_kv * cfg.hd
               * torch.finfo(cfg.cache_dtype).bits // 8)
    bound_ms = (param_bytes + kv_read) / PEAK_BYTES_PER_S * 1e3
    log("lm-serve", card=repr(card), arch=cfg.name,
        entry="serve_batch(ServeConfig(...), model=get_model(...))",
        params=model.param_count(),
        dtypes=f"{cfg.param_dtype}/{cfg.compute_dtype}/{cfg.cache_dtype}",
        batch=batch, prompt=prompt_len, gen=gen, init_s=f"{init_s:.1f}",
        serve_prefill_s=f"{stats['prefill_s']:.3f}",
        serve_decode_s=f"{stats['decode_s']:.3f}",
        serve_tok_per_s=f"{stats['tok_per_s']:.0f}",
        prefill_ms=f"{prefill_ms:.1f}",
        prefill_tokens_per_s=f"{batch * prompt_len / (prefill_ms / 1e3):.0f}",
        decode_ms_first=f"{ms[0]:.3f}", decode_ms_median=f"{med:.3f}",
        warm_steps=len(ms[warm:]), decode_ms_min=f"{min(ms[warm:]):.3f}",
        decode_ms_max=f"{max(ms[warm:]):.3f}",
        decode_tokens_per_s=f"{batch / (med / 1e3):.0f}",
        tokens_as_serve_batch=int((again == tokens).sum()),
        tokens=tokens.size,
        max_memory_allocated_gib=("not measured" if peak is None
                                  else f"{peak:.2f}"),
        cache_bytes=cache_bytes, param_bytes=param_bytes,
        kv_read_bytes=f"{kv_read:.0f}", decode_bound_ms=f"{bound_ms:.3f}",
        bound_by="bytes (parameters as stored + the live KV cache, "
                 "3.35e12 B/s)",
        decode_over_bound=f"{med / bound_ms:.2f}")
    log("lm-serve", decode_ms=",".join(f"{x:.2f}" for x in ms))
    nxt = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
    pos = torch.full((batch,), pos0 + gen, dtype=torch.int32, device=device)
    step = make_decode_step(model, cfg)
    serve_profile(lambda: step(cache, {"tokens": nxt[:, None], "pos": pos}),
                  device, card)

    # decode_attention at the model's decode shape beside SDPA, the record
    B, Smax = batch, cache[0]["k"].shape[1]
    gen_q = torch.Generator().manual_seed(SEED)
    q = torch.randn((B, 1, cfg.n_heads, cfg.hd), generator=gen_q).to(
        device=device, dtype=cfg.compute_dtype)
    k, v = cache[0]["k"], cache[0]["v"]
    cache_len = torch.full((B,), Smax, dtype=torch.int32, device=device)
    mask = (torch.arange(Smax, device=device) < cache_len[:, None]
            )[:, None, None, :]

    def port():
        return decode_attention(q, k, v, cache_len,
                                compute_dtype=cfg.compute_dtype)

    def sdpa():
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=mask, enable_gqa=True).transpose(1, 2)

    got, want = port().float(), sdpa().float()
    err = float((got - want).abs().max() / want.abs().max())
    times = {key: timed_ms(fn, reps, device) for key, fn in
             (("port", port), ("sdpa", sdpa))}
    log("lm-serve-attention", card=repr(card), dtype=cfg.compute_dtype,
        batch=B, heads=f"{cfg.n_heads}/{cfg.n_kv}", head_dim=cfg.hd,
        cache_len=Smax, port_ms=f"{times['port']:.4f}",
        sdpa_ms=f"{times['sdpa']:.4f}", err_vs_sdpa=f"{err:.2e}",
        bar=SERVE_ATTN_BAR)
    if not (torch.isfinite(got).all() and err <= SERVE_ATTN_BAR):
        raise AssertionError(f"decode_attention at the served shape in "
                             f"{cfg.compute_dtype} against SDPA: {err} > "
                             f"{SERVE_ATTN_BAR} of max|SDPA|")
    del steps, cache, logits, lg, inputs, got, want, q
    free_device(device)
    return model


SERVE_SPANS = {"attention.decode": "attention decode", "logits": "logits"}
CAST_OPS = ("aten::to", "aten::_to_copy")
MM_OPS = ("aten::tensordot", "aten::mm", "aten::matmul", "aten::bmm",
          "aten::addmm")
SERVE_REST = "the rest (norms, RoPE, residuals, cache writes, embedding)"


def serve_profile(fn, device, card) -> None:
    """One decode step under ``torch.profiler``: each device kernel's time
    goes to the model code's innermost named range around the operator
    that launched it (the decode attention, the logits head), else by that
    operator's ancestors: a matrix product (projections and MLP), a cast
    (the f32 weights' copies to the compute dtype; the embedding table's
    too), or the rest.  Beside it the step's CUDA-event time and the idle
    share.  On the host the operators' own CPU time stands in (a rehearsal
    of the attribution, not a device metric)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        _, ms = timed_call(fn, device)
    split, kernels, ranges = {}, {}, 0
    for e in prof.events():
        if e.name in SERVE_SPANS and e.cpu_parent is None and not getattr(
                e, "kernels", ()):
            ranges += 1
        if device.type == "cuda":
            launched = [(k.name, k.duration)
                        for k in getattr(e, "kernels", ())]
        elif e.name not in SERVE_SPANS:
            launched = [(e.name, e.self_cpu_time_total)]
        else:
            launched = []
        t = sum(d for _, d in launched)
        if not t:
            continue
        rng, mm, cast, a = None, False, False, e
        while a is not None:
            rng = rng or SERVE_SPANS.get(a.name)
            mm = mm or a.name in MM_OPS
            cast = cast or a.name in CAST_OPS
            a = a.cpu_parent
        if rng == "attention decode":
            cat = rng
        elif cast and not mm:
            cat = "weight casts"
        elif rng == "logits":
            cat = rng
        elif mm:
            cat = "projections and MLP"
        else:
            cat = SERVE_REST
        split[cat] = split.get(cat, 0.0) + t / 1e3
        for name, d in launched:
            key = (cat, e.name, name[:60])
            kernels[key] = kernels.get(key, 0.0) + d / 1e3
    busy = sum(split.values())
    what = "device_busy_ms" if device.type == "cuda" else "host_op_ms"
    if not busy:
        log("lm-serve-profile", card=repr(card), step_ms=f"{ms:.3f}",
            **{what: "not measured (no events with time in the trace)"})
        return
    log("lm-serve-profile", card=repr(card), step_ms=f"{ms:.3f}",
        **{what: f"{busy:.3f}"}, ranges=ranges,
        idle_share=(f"{1 - busy / ms:.3f}" if device.type == "cuda"
                    else "not measured"))
    for cat, t in sorted(split.items(), key=lambda kv: -kv[1]):
        log("lm-serve-profile", category=repr(cat), ms=f"{t:.3f}",
            share=f"{t / busy:.3f}")
    for (cat, op, name), t in sorted(kernels.items(),
                                     key=lambda kv: -kv[1])[:10]:
        log("lm-serve-profile", category=repr(cat), op=op, kernel=repr(name),
            ms=f"{t:.3f}")


@contextlib.contextmanager
def computing_in(model, cfg, dtype):
    """``model`` with ``dtype`` as its compute and cache dtype, restored
    afterwards (the parameters stay as stored)."""
    model.cfg = dataclasses.replace(cfg, compute_dtype=dtype,
                                    cache_dtype=dtype)
    try:
        yield model
    finally:
        model.cfg = cfg


def last_logits(model, tokens):
    """``apply(tokens)``'s logits at the last position, f64."""
    import torch

    with torch.no_grad():
        return model.apply(tokens)[0][:, -1].double()


def check_decode(model, t, card, what, *, rel=5e-3) -> None:
    """(b) ``decode_step(prefill(t[:-1]), t[-1])`` against
    ``apply(t)[:, -1]`` within ``rel`` max|ref| + 1e-4."""
    import torch

    t0 = time.perf_counter()
    rows, length = t.shape
    ref = last_logits(model, t)
    _, cache = model.prefill(t[:, :-1])
    lg, _ = model.decode_step(cache, t[:, -1:], torch.full(
        (rows,), length - 1, dtype=torch.int32, device=t.device))
    del cache
    got = lg[:, 0].double()
    err = float((got - ref).abs().max())
    tol = rel * float(ref.abs().max()) + 1e-4
    log("lm-serve-decode", card=repr(card), what=what, rows=rows,
        tokens=length, check="decode(prefill(t[:-1])) vs apply(t)[:, -1]",
        max_abs_err=f"{err:.3e}", tol=f"{tol:.3e}",
        max_abs_ref=f"{float(ref.abs().max()):.4f}",
        argmax_equal=int((got.argmax(-1) == ref.argmax(-1)).sum()),
        seconds=f"{time.perf_counter() - t0:.1f}")
    if not (torch.isfinite(got).all() and err <= tol):
        raise AssertionError(f"{what}: decode_step(prefill) against apply: "
                             f"{err} > {tol}")


def check_greedy(model, t, greedy, card, what) -> None:
    """(c) ``serve_batch`` for ``greedy`` steps from the prompts ``t``:
    each token the argmax of ``apply`` over the prompt and the tokens
    before it -- one causal forward over the prompt and all but the last
    token gives each step's logits at its position.  Where that forward's
    top two lie within (b)'s tolerance the token must be one of the tied
    ones, and the row is not compared past that step."""
    import torch

    from repro_torch.launch.serve import ServeConfig, serve_batch

    t0 = time.perf_counter()
    rows, length = t.shape
    gen, _ = serve_batch(ServeConfig(arch=LM_ARCH, smoke=False, batch=rows,
                                     prompt_len=length, gen_len=greedy,
                                     seed=SEED, device=t.device),
                         prompts=t.cpu().numpy(), model=model)
    seq = torch.cat([t, torch.as_tensor(gen[:, :-1], device=t.device)], 1)
    with torch.no_grad():
        full = model.apply(seq)[0][:, length - 1:].double()
    compared, stopped = 0, [None] * rows
    for r in range(rows):
        for i in range(greedy):
            f = full[r, i]
            tol = 5e-3 * float(f.abs().max()) + 1e-4
            tied = torch.nonzero(f >= f.max() - tol)[:, 0].tolist()
            if int(gen[r, i]) not in tied:
                raise AssertionError(f"{what}: greedy row {r} step {i}: "
                                     f"token {gen[r, i]} is not the "
                                     f"forward's argmax {tied}")
            compared += 1
            if len(tied) > 1:
                stopped[r] = i
                break
    log("lm-serve-greedy", card=repr(card), what=what, rows=rows,
        prompt=length, steps=greedy, compared=compared,
        ties_stopped_at=",".join("none" if s is None else str(s)
                                 for s in stopped),
        seconds=f"{time.perf_counter() - t0:.1f}")


def run_serve_checks(device, card, model, cfg, *, rows, length, greedy,
                     f32_layers) -> None:
    """(b) and (c), at full width on ``rows`` x ``length`` seeded tokens.

    At full depth the reference's init saturates attention and the f32
    forward is ill-conditioned: it moves its logits by O(1) when the same
    rows run in another batch shape, so no f32 decode can meet (b)'s bar
    there.  So: the checks at full depth with f64 compute and cache, where
    rounding starts ~1e-9 of f32's; again with f32 compute and cache on the
    model's first ``f32_layers`` layers (the same seed draws the same
    embedding and first layers), where the f32 forward's own spread is far
    below the bar; and, for the record, f32 at full depth: the decode's
    error beside the forward's change when its first row runs alone."""
    import torch

    from repro_torch.models.transformer import StackedLM

    rng = np.random.default_rng(SEED + 1)
    t = torch.as_tensor(rng.integers(0, cfg.vocab, size=(rows, length)),
                        dtype=torch.int32, device=device)
    t0 = time.perf_counter()
    with computing_in(model, cfg, torch.float32):
        ref = last_logits(model, t)
        alone = float((last_logits(model, t[:1]) - ref[:1]).abs().max())
        _, cache = model.prefill(t[:, :-1])
        lg, _ = model.decode_step(cache, t[:, -1:], torch.full(
            (rows,), length - 1, dtype=torch.int32, device=device))
        del cache
        err = float((lg[:, 0].double() - ref).abs().max())
    log("lm-serve-f32-full-depth", card=repr(card), arch=cfg.name,
        layers=cfg.n_layers, compute="f32", record="not a check",
        decode_max_abs_err=f"{err:.3e}",
        one_row_alone_max_abs=f"{alone:.3e}",
        tol=f"{5e-3 * float(ref.abs().max()) + 1e-4:.3e}",
        seconds=f"{time.perf_counter() - t0:.1f}")
    what = f"{cfg.name} {cfg.n_layers} layers f64"
    with computing_in(model, cfg, torch.float64):
        check_decode(model, t, card, what)
        check_greedy(model, t, greedy, card, what)
    cut = dataclasses.replace(cfg, n_layers=f32_layers,
                              compute_dtype=torch.float32,
                              cache_dtype=torch.float32)
    short = StackedLM(cut, seed=SEED, device=device)
    what = f"{cfg.name} {f32_layers} layers f32"
    check_decode(short, t, card, what)
    check_greedy(short, t, greedy, card, what)
    # the served dtypes (bf16 compute and cache): the decode step against
    # the same layers' bf16 forward, within the bf16 bar (the bf16 forward
    # itself is O(1) from the f32 one at this init, so not against f32)
    with computing_in(short, cut, cfg.compute_dtype):
        check_decode(short, t, card, f"{cfg.name} {f32_layers} layers "
                     f"{cfg.compute_dtype}", rel=SERVE_BF16_BAR)


def run_serve_smoke(device, card) -> None:
    """(d) Each arch's smoke config at f32 compute and cache through
    ``serve_batch`` on the card and on the host (the same seed draws the
    same parameters and inputs on both), then the host's tokens fed to
    both (teacher forcing): each step's logits on the card within rtol
    1e-4 of the host's, with a floor of 1e-4 max|host| or twice the host's
    own displacement under a 2e-7 change of every parameter where that is
    larger."""
    import torch

    from repro_torch.launch.serve import ServeConfig, serve_batch
    from repro_torch.models.registry import ARCH_IDS, build_model, get_config

    for arch in ARCH_IDS:
        t0 = time.perf_counter()
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  compute_dtype=torch.float32,
                                  cache_dtype=torch.float32)
        host = build_model(cfg, seed=SEED, device="cpu")
        on_card = build_model(cfg, seed=SEED, device=device)
        # the defaults: batch, prompt and gen lengths
        sh = ServeConfig(arch=arch, seed=SEED, device="cpu")
        sc = dataclasses.replace(sh, device=device)
        gen_h, _ = serve_batch(sh, model=host)
        gen_c, _ = serve_batch(sc, model=on_card)
        if not ((gen_c >= 0) & (gen_c < cfg.vocab)).all():
            raise AssertionError(f"{arch}: tokens outside the vocabulary")
        lh = forced_logits(host, cfg, sh, gen_h)
        lc = forced_logits(on_card, cfg, sc, gen_h)
        with nudged(host):
            ln = forced_logits(host, cfg, sh, gen_h)
        ratio, gaps, bars = 0.0, [], []
        for h, c, n in zip(lh, lc, ln):
            if not np.isfinite(c).all():
                raise AssertionError(f"{arch}: non-finite logits on the card")
            bar = max(1e-4 * float(np.abs(h).max()),
                      2 * float(np.abs(n - h).max()))
            gap = np.abs(c.astype(np.float64) - h)
            ratio = max(ratio, float((gap / (1e-4 * np.abs(h) + bar)).max()))
            gaps.append(float(gap.max()))
            bars.append(bar)
        log("lm-serve-smoke", card=repr(card), arch=f"{arch} smoke",
            compute="f32", batch=sh.batch, prompt=sh.prompt_len,
            steps=sh.gen_len, max_gap=f"{max(gaps):.3e}",
            gap_over_bar=f"{ratio:.3f}",
            gaps=",".join(f"{x:.1e}" for x in gaps),
            bars=",".join(f"{x:.1e}" for x in bars),
            tokens_as_host=int((gen_c == gen_h).sum()), tokens=gen_h.size,
            seconds=f"{time.perf_counter() - t0:.1f}")
        if ratio > 1:
            raise AssertionError(f"{arch}: serving on the card against the "
                                 f"host: gap {max(gaps)} over its bar")


def run_lm_placement(device, card, *, cfg=None, batch=LM_BATCH, seq=LM_SEQ,
                     steps=PLACE_STEPS, f32_layers=PLACE_F32_LAYERS,
                     dry=PLACE_DRY) -> None:
    """Phase 16, LM placement: ``LM_ARCH`` at full width (or ``cfg``, a
    cut of it for a rehearsal) trained on one device and placed on meshes
    of ``device`` named at 4 positions, then moved between meshes, a
    checkpoint restored placed, and the dry run's cells."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.models.registry import get_config

    cfg = cfg or get_config(LM_ARCH)
    full = cfg == get_config(LM_ARCH)
    free_device(device)
    batches = place_batches(cfg, batch, seq, steps)
    # (a) one device, from the phase's parameters; the initial parameters
    # and the final state come back to the host
    init, one = place_one_device(device, cfg, batches, full=full)
    free_device(device)
    # (b) (data=1, model=4): bit for bit (a)
    state = place_run(device, card, cfg, init, batches, PLACE_BITWISE, one,
                      bitwise=True)
    del state
    free_device(device)
    # (c) (data=2, model=2): the JAX package's bars; its state feeds (d)
    state = place_run(device, card, cfg, init, batches, PLACE_DP, one,
                      bitwise=False)
    del one
    # (d) the elastic chain on (c)'s state
    place_elastic(device, card, cfg, state)
    del state, init
    free_device(device)
    # (c) again at f32 compute on the first layers, one step from the same
    # parameters (the placement's own arithmetic, before AdamW amplifies
    # it): the tight bars
    f32 = dataclasses.replace(cfg, n_layers=f32_layers,
                              compute_dtype=torch.float32)
    init32, one32 = place_one_device(device, f32, batches[:1], full=False)
    free_device(device)
    place_run(device, card, f32, init32, batches[:1], PLACE_DP, one32,
              bitwise=False, f32=True)
    del init32, one32
    free_device(device)
    # (d) a checkpoint restored placed, at smoke width; a mixed mesh raises
    place_restore(device, card)
    # (f) the dry run on the production mesh (meta: no card)
    for shape in dry:
        t0 = time.perf_counter()
        rec = dryrun.run_cell(LM_ARCH, shape, "single",
                              out_dir=str(BUILD / "dryrun"))
        if rec["status"] != "ok":
            raise AssertionError(f"dry run {LM_ARCH} {shape}: "
                                 f"{rec.get('error')}")
        coll = rec["collectives_raw"]
        fall = sorted({(a, d, m) for _, a, d, m in rec["fallbacks"]})
        log("lm-placement-dryrun", arch=LM_ARCH, shape=shape,
            mesh="single 16x16 (meta)", seconds=f"{time.perf_counter() - t0:.1f}",
            compile_s=rec["compile_s"],
            argument_bytes_per_position=rec["memory"][
                "argument_size_in_bytes"],
            by_part=json.dumps(rec["memory_by_part"]),
            flops=rec["cost_raw"]["flops"],
            metered_flops=rec.get("metered", {}).get("total", {}).get(
                "flops"),
            collectives=("null" if coll is None
                         else json.dumps(coll["payload_bytes"])),
            wire_bytes=None if coll is None else coll["wire_bytes"],
            fallbacks=json.dumps(fall))
        if ("kv_heads", 8) not in {(a, d) for a, d, _ in fall}:
            raise AssertionError(f"dry run {shape}: kv_heads 8 is not among "
                                 f"the fallbacks {fall}")


def place_batches(cfg, batch, seq, steps) -> list:
    """Phase 13's batches (``SyntheticLMDataset``, its seed), on the
    host."""
    import torch

    from repro_torch.data.pipeline import SyntheticLMDataset

    ds = SyntheticLMDataset(vocab=cfg.vocab, seq=seq, global_batch=batch,
                            seed=SEED)
    return [{k: torch.from_numpy(v) for k, v in
             ds.global_batch_arrays(s).items()} for s in range(steps)]


def place_one_device(device, cfg, batches, *, full) -> tuple:
    """(a): ``cfg``'s model from ``SEED`` on ``device``, ``len(batches)``
    plain steps; returns (the initial parameters on the host, the run:
    metrics, step ms, the final parameters and moments on the host)."""
    import torch

    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.registry import build_model, get_model
    from repro_torch.optim import adamw_init

    if full:  # the entry point a user calls
        model, _ = get_model(LM_ARCH, seed=SEED, device=device)
    else:
        model = build_model(cfg, seed=SEED, device=device)
    def host(t):  # a copy of its own, also when ``device`` is the host
        return t.detach().to("cpu", copy=True)

    init = {n: host(p) for n, p in model.named_parameters()}
    opt = adamw_init(dict(model.named_parameters()))
    step = make_train_step(model, cfg, lr_fn=lambda s: PLACE_LR)
    runs = [timed_call(lambda b=b: step(opt, {
        k: v.to(device) for k, v in b.items()}), device) for b in batches]
    one = {"loss": [float(m["loss"]) for m, _ in runs],
           "grad_norm": [float(m["grad_norm"]) for m, _ in runs],
           "ms": [t for _, t in runs],
           "params": {n: host(p) for n, p in model.named_parameters()},
           "mu": {n: host(t) for n, t in opt.mu.items()},
           "nu": {n: host(t) for n, t in opt.nu.items()},
           "peak_gib": (torch.cuda.max_memory_allocated() / 2 ** 30
                        if device.type == "cuda" else None)}
    return init, one


def _gib(x):
    return "not measured" if x is None else f"{x:.2f}"


def place_run(device, card, cfg, init, batches, shape, one, *, bitwise,
              f32=False) -> dict:
    """(b)/(c)/(e): the placed step on ``device`` named at the positions of
    ``shape`` (data, model) from ``init``, held to the one-device run
    ``one``; each position's bytes held to the dry run's count.  Returns
    the placed state."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import cell_shardings, make_placed_train_step
    from repro_torch.models.registry import build_model
    from repro_torch.optim import adamw_init
    from repro_torch.parallel.placement import device_put, gather

    mesh = make_test_mesh(shape, devices=[device] * int(np.prod(shape)))
    name = f"({shape[0]},{shape[1]})" + (" f32" if f32 else "")
    t0 = time.perf_counter()
    step = make_placed_train_step(build_model(cfg, device="meta"), cfg,
                                  mesh=mesh, params=init,
                                  lr_fn=lambda s: PLACE_LR)
    opt = adamw_init(step.params)
    sync(device)
    place_s = time.perf_counter() - t0
    runs = [timed_call(lambda b=b: step(opt, b), device) for b in batches]
    loss = [float(m["loss"]) for m, _ in runs]
    gnorm = [float(m["grad_norm"]) for m, _ in runs]
    ms = [t for _, t in runs]
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if device.type == "cuda" else None)
    # (e) bytes: measured storage a position against the dry run's count
    B, S = batches[0]["tokens"].shape
    cells = cell_shardings(cfg, mesh, "train", B, S)
    placed_batch = {k: device_put(v, cells["batch_sharding"][k])
                    for k, v in batches[0].items()}
    held = {"params": sum(p.nbytes_by_position()
                          for p in step.params.values()),
            "opt": (sum(m.nbytes_by_position() for m in opt.mu.values())
                    + sum(v.nbytes_by_position() for v in opt.nu.values())
                    + opt.count.nbytes_by_position()),
            "batch": sum(b.nbytes_by_position()
                         for b in placed_batch.values())}
    counted = {"params": dryrun.position_bytes(cells["abstract_params"],
                                               cells["param_sharding"]),
               "opt": dryrun.position_bytes(cells["abstract_opt"],
                                            cells["opt_sharding"]),
               "batch": dryrun.position_bytes(cells["input_specs"],
                                              cells["batch_sharding"])}
    del placed_batch
    # the state against (a), leaf by leaf on the card
    gaps = {"params": 0.0, "mu": 0.0, "nu": 0.0}
    apart = {"params": 0, "mu": 0, "nu": 0}
    equal = True
    for part, tree in (("params", step.params), ("mu", opt.mu),
                       ("nu", opt.nu)):
        for n, pt in tree.items():
            got = gather(pt, device).float()
            want = one[part][n].to(device).float()
            equal = equal and torch.equal(got, want)
            d = (got - want).abs()
            gaps[part] = max(gaps[part], float(d.max()))
            apart[part] += int((d > 1e-6).sum())
            del got, want, d
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(loss, one["loss"])]
    gn_rel = [abs(a - b) / abs(b) for a, b in zip(gnorm, one["grad_norm"])]
    log("lm-placement", card=repr(card), arch=cfg.name, mesh=name,
        positions=mesh.size, data_positions=len(step.data_positions),
        layers=cfg.n_layers, compute=str(cfg.compute_dtype),
        steps=len(batches), place_s=f"{place_s:.1f}",
        step_ms=",".join(f"{t:.1f}" for t in ms),
        one_device_step_ms=",".join(f"{t:.1f}" for t in one["ms"]),
        loss=",".join(f"{x:.6f}" for x in loss),
        one_device_loss=",".join(f"{x:.6f}" for x in one["loss"]),
        loss_rel=",".join(f"{x:.2e}" for x in loss_rel),
        grad_norm_rel=",".join(f"{x:.2e}" for x in gn_rel),
        max_abs_params=f"{gaps['params']:.3e}",
        max_abs_mu=f"{gaps['mu']:.3e}", max_abs_nu=f"{gaps['nu']:.3e}",
        apart_1e6=json.dumps(apart), bit_for_bit=equal,
        bytes_per_position=json.dumps({k: int(v.flat[0])
                                       for k, v in held.items()}),
        counted_per_position=json.dumps(counted),
        max_memory_allocated_gib=_gib(peak),
        one_device_max_memory_allocated_gib=_gib(one["peak_gib"]))
    for part in held:
        if not (held[part] == counted[part]).all():
            raise AssertionError(f"{name} {part}: positions hold "
                                 f"{held[part].ravel().tolist()} bytes, the "
                                 f"dry run counts {counted[part]}")
    if bitwise:
        if not (equal and loss == one["loss"]
                and gnorm == one["grad_norm"]):
            raise AssertionError(f"{name}: not bit for bit the one-device "
                                 f"step (losses {loss} / {one['loss']}, "
                                 f"gaps {gaps})")
    elif f32:
        np.testing.assert_allclose(loss, one["loss"], rtol=1e-5,
                                   err_msg=f"{name} losses")
        np.testing.assert_allclose(gnorm, one["grad_norm"], rtol=1e-4,
                                   err_msg=f"{name} grad norms")
    else:
        # the JAX package's bars (``tests/test_distributed.py:112-121``):
        # its test takes one step, so the first loss -- the same
        # parameters, the batch split over the data positions -- and the
        # parameters after every step are held; the later losses also
        # carry AdamW's amplification of the bf16 differences of the
        # earlier steps, so they are logged against the bar
        held = [r <= 5e-3 for r in loss_rel]
        log("lm-placement", mesh=name, loss_bar="rtol 5e-3",
            losses_within_bar=",".join(map(str, held)),
            params_bar="max-abs 5e-2",
            params_within_bar=gaps["params"] < 5e-2)
        if not held[0]:
            raise AssertionError(f"{name}: first loss {loss[0]} against "
                                 f"{one['loss'][0]} (rtol 5e-3)")
        if not gaps["params"] < 5e-2:
            raise AssertionError(f"{name}: parameters {gaps['params']} "
                                 f"from the one-device step's")
    return {"params": step.params, "mu": opt.mu, "nu": opt.nu,
            "count": opt.count, "mesh": mesh,
            "logical": {n: p.logical for n, p in
                        build_model(cfg, device="meta").named_parameters()}}


def place_elastic(device, card, cfg, state) -> None:
    """(d): each leaf of the placed state moved (2,2) -> (1,4) -> (4,1) ->
    (2,2) through ``elastic_remesh``: bit for bit at every mesh, every
    position holding the bytes its resolved spec says."""
    import torch

    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.parallel.placement import gather
    from repro_torch.runtime.elastic import elastic_remesh

    meshes = [make_test_mesh(s, devices=[device] * int(np.prod(s)))
              for s in PLACE_CHAIN]
    t0 = time.perf_counter()
    moved = leaves = 0
    per_mesh = {s: 0 for s in PLACE_CHAIN}
    for part in ("params", "mu", "nu", "count"):
        tree = state[part] if part != "count" else {"count": state[part]}
        for n, pt in tree.items():
            logical = {"x": () if part == "count" else state["logical"][n]}
            want = gather(pt, device)
            cur = {"x": pt}
            for shape, mesh in zip(PLACE_CHAIN, meshes):
                cur = elastic_remesh(cur, logical, mesh, cfg.rules)
                got = cur["x"]
                nbytes = got.sharding.shard_nbytes(tuple(got.shape),
                                                   got.dtype)
                held = got.nbytes_by_position()
                if not (held == nbytes).all() or not torch.equal(
                        gather(got, device), want):
                    raise AssertionError(f"elastic {part} {n} on {shape}: "
                                         f"{held.ravel().tolist()} bytes "
                                         f"(want {nbytes}) or values differ")
                per_mesh[shape] += nbytes
            moved += want.numel() * want.element_size()
            leaves += 1
            del want, cur, got
    sync(device)
    log("lm-placement-elastic", card=repr(card), chain="(2,2)->" + "->".join(
        f"({a},{b})" for a, b in PLACE_CHAIN), leaves=leaves,
        bytes=moved, seconds=f"{time.perf_counter() - t0:.1f}",
        bytes_per_position=json.dumps({f"({a},{b})": v for (a, b), v in
                                       per_mesh.items()}),
        bit_for_bit=True)


def place_restore(device, card) -> None:
    """(d): the smoke model's parameters saved with no mesh, restored
    placed on (2,2) of ``device`` bit for bit; a placed step on a mesh of
    two device types raises."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.steps import make_placed_train_step
    from repro_torch.models.registry import get_model
    from repro_torch.parallel.placement import gather
    from repro_torch.runtime.elastic import specs_for_mesh

    model, cfg = get_model(LM_ARCH, smoke=True, seed=SEED, device="cpu")
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    logical = {n: p.logical for n, p in model.named_parameters()}
    mesh = make_test_mesh(PLACE_DP, devices=[device] * 4)
    root = BUILD / "chip_smoke_placement"
    shutil.rmtree(root, ignore_errors=True)
    mgr = CheckpointManager(str(root))
    mgr.save(1, params, blocking=True)
    restored = mgr.restore(1, params, shardings=specs_for_mesh(
        logical, params, mesh, cfg.rules))
    same = all(torch.equal(gather(restored[n], device), p.to(device))
               and all(s.device == torch.device(device) for s in
                       restored[n].shards.flat)
               for n, p in params.items())
    shutil.rmtree(root, ignore_errors=True)
    mixed = make_test_mesh((2,), ("model",), devices=[device, "cpu"])
    try:
        make_placed_train_step(model, cfg, mesh=mixed, params=params,
                               lr_fn=lambda s: PLACE_LR)
        refused = False
    except ValueError:
        refused = True
    log("lm-placement-restore", card=repr(card), arch=f"{LM_ARCH} smoke",
        mesh="(2,2)", leaves=len(params), bit_for_bit=same,
        mixed_mesh_refused=refused)
    if not (same and (refused or device.type == "cpu")):
        raise AssertionError(f"restore onto (2,2): bit for bit {same}; "
                             f"mixed mesh refused {refused}")


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
    t0 = time.perf_counter()
    record = run(torch.device("cuda", 0))
    log("smoke", script_seconds=f"{time.perf_counter() - t0:.1f}")
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
