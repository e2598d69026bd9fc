"""Where a stacked launch's time goes: the stacked kernel's device time as
the segment count, the visit-list length and the start vary.

    PYTHONPATH=src python -m repro_torch.kernels.stacked_cost   # on the card

Builds ``chip_smoke.py``'s cell 2 (``MutableP2HIndex`` of 8 sealed
segments of 125,000 planted points, d = 128, n0 = 256; no delta, no
deletes), prepares 1024 queries against its stacked grid at the card's
defaults (bq = 64, the cluster rule's split) and times
:func:`repro_torch.kernels.stacked_sweep.stacked_sweep` on slices of those
operands: the first ``n`` segments (1, 2, 4, 8) and ``v`` tiles of every
visit list (4, 12, 48), cold (tiles 0..v-1) or seeded (tiles v..2v-1,
seeded with a cold launch's planes over tiles 0..v-1, as pass B is).
Device time per launch from a ``torch.profiler`` trace of the card.  The
time's growth with ``n`` at a fixed ``v`` is the cost of a segment, and
its growth with ``v`` the cost of the rounds.  Prints one line per case
and the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core.balltree import normalize_query
from repro_torch.data.pipeline import make_p2h_dataset
from repro_torch.kernels import stacked_sweep as tss
from repro_torch.stream import CompactionPolicy, MutableP2HIndex

SEGMENTS, POINTS, DIM, N0, QUERIES, K, REPS = 8, 1_000_000, 128, 256, 1024, \
    10, 10


def _device_ms(fn, reps: int) -> float:
    """Mean device time per call of the stacked kernel over ``reps``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if "stacked_sweep_kernel" in e.key)
    return us / 1e3 / reps


def _slice(ops: dict, n: int, lo: int, hi: int) -> dict:
    """The operands of the first ``n`` segments, visit tiles lo..hi-1."""
    out = {}
    for name, t in ops.items():
        if name == "visit":
            out[name] = t[:n, :, lo:hi].contiguous()
        elif name in ("pts_tiles", "ids_tiles", "rx_tiles", "xc_tiles",
                      "xs_tiles", "leaf_cnorm", "leaf_ip", "leaf_lb"):
            out[name] = t[:n].contiguous()
        else:
            out[name] = t
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("stacked_cost: needs a CUDA device")
    dev = torch.device("cuda", 0)
    x, q = make_p2h_dataset(POINTS, DIM, kind="planted", n_queries=QUERIES,
                            seed=0)
    chunk = POINTS // SEGMENTS
    m = MutableP2HIndex.from_data(
        x[:chunk], n0=N0, device=dev,
        policy=CompactionPolicy(delta_capacity=chunk, tombstone_frac=0.95,
                                max_segments=32))
    for r in range(1, SEGMENTS):
        m.insert_batch(x[r * chunk:(r + 1) * chunk])
        m.compact()
    stk = m.snapshot().stacked_leaves()
    arrays, _ = tss._bucketed_arrays(stk, use_kernel=True)
    grid = tss.StackedLeaves(**arrays, uids=(), n0=stk.n0, d=stk.d)
    qn = torch.from_numpy(normalize_query(q)).to(dev)
    ops, _ = tss.prepare_stacked_operands(grid, qn, bq=64, lane_pad=True)
    split = tss.default_split(ops, k=K, bq=64)
    kw = dict(k=K, bq=64, split=split)
    for v in (4, 12, 48):
        for n in (1, 2, 4, 8):
            cold = _slice(ops, n, 0, v)
            d, i, _ = tss.stacked_sweep(**cold, **kw)
            seeded = dict(_slice(ops, n, v, 2 * v), seed_d=d, seed_i=i)
            for start, case in (("cold", cold), ("seeded", seeded)):
                tss.stacked_sweep(**case, **kw)  # warm-up
                ms = _device_ms(lambda: tss.stacked_sweep(**case, **kw),
                                REPS)
                print(f"[cost] segments={n} visits={v} start={start} "
                      f"split={split} rounds_per_segment={-(-v // split)} "
                      f"device_ms={ms:.4f}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
