#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py            # full size: 1,000,000 x 128 planted

The main path is the paper's: build a BC-Tree over the data, then answer
exact top-k point-to-hyperplane queries through the hand-written CUDA sweep
kernel.  Phases, one line each:

  1. platform   the card (nvidia-smi name and power limit), precision
  2. build      nvcc for sm_90a, with ptxas' registers/shared memory/spills
  3. data       host build of the data and the tree; index size
  4. kernel     the CUDA kernel against its plain PyTorch version on the
                same operands: distances, ids (apart from ties), skip counts
  5. query      ``P2HIndex.query(method="kernel")`` on every query against
                the brute-force oracle, with the launch count of that run;
                ``sweep`` and ``dfs`` on a few queries; every exact route's
                ids held to the oracle's with ties judged on float64
                distances (``assert_exact_topk``), and the f32 oracle's own
                distance from a float64 oracle measured;
                ``beam`` with its recall
  6. timing     CUDA-event times of the kernel, of phase 1, of the plain
                version and of a brute-force scan, beside the kernel's bound
  7. kernels    one JSON line: per kernel its launches, error and times

then the card's nvidia-smi line and, last, the result line
``{"ok": true, "device": {...}}``.  Any failed check raises, and the script
exits non-zero without the result line; it also exits non-zero when there
is no CUDA device or when the package is not beside it.  It takes no
arguments; ``run`` takes smaller sizes for a rehearsal on the host.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

K, BQ, SEED, BEAM_FRAC = 10, 8, 0, 0.05
RTOL, ATOL = 1e-5, 1e-6
# NVIDIA H100 SXM data sheet: HBM3 bandwidth and f32 rate outside the
# tensor cores (dense), at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
SRC = Path(__file__).resolve().parent / "src"


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def run(device, *, n=1_000_000, d=128, queries=1024, n0=256,
        sweep_queries=64, dfs_queries=16, reps=10) -> dict:
    """All phases on ``device`` at these sizes (the defaults are the full
    size); returns the kernels record."""
    import torch

    from repro_torch.core.api import P2HIndex
    from repro_torch.core.balltree import append_ones, normalize_query
    from repro_torch.core.exact import (
        assert_exact_topk,
        assert_topk_close,
        dists64,
        exact_search,
    )
    from repro_torch.data.pipeline import make_p2h_dataset
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels.p2h_scan import p2h_sweep
    from repro_torch.kernels.ref import p2h_sweep_ref
    from repro_torch.launch import platform

    k, bq = K, BQ

    def check(what, *answers, exact=False):
        try:
            if exact:
                return assert_exact_topk(*answers, rtol=RTOL, atol=ATOL)
            return assert_topk_close(*answers, rtol=RTOL, atol=ATOL)
        except AssertionError as e:
            raise AssertionError(f"{what}: {e}") from None

    # 1. platform
    device = platform.resolve_device(device)
    report = platform.device_report()
    card = nvidia_smi() if device.type == "cuda" else "no card"
    log("platform", card=repr(card), device=report["name"],
        count=report["count"], allow_tf32=report["allow_tf32"],
        matmul_precision=report["matmul_precision"])

    # 2. build the kernel
    if device.type == "cuda":
        t0 = time.perf_counter()
        ptxas = _build.build(force=True)
        log("build", seconds=f"{time.perf_counter() - t0:.1f}",
            target="sm_90a", library=_build.library_path().name)
        for line in ptxas.splitlines():
            print(f"[build] p2h_sweep: {line.strip()}")

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

    # 4. the kernel against its plain version, same operands
    opnds, _ = ops.prepare_operands(tree, qn, bq=bq)
    kd, ki, ks = p2h_sweep(**opnds, k=k)
    order = torch.argsort(kd, dim=1, stable=True)
    kd, ki = torch.gather(kd, 1, order), torch.gather(ki, 1, order)
    rd, ri, rs, live = p2h_sweep_ref(**opnds, k=k, return_live=True)
    sync(device)
    max_err = check("kernel vs plain", kd.cpu(), ki.cpu(), rd.cpu(),
                    ri.cpu(), nxt)
    if not torch.equal(ks, rs):
        raise AssertionError(f"skip counts differ: {int(ks.sum())} vs "
                             f"{int(rs.sum())}")
    nqb, n_visit = opnds["visit"].shape
    log("kernel", match=True, max_abs_err=max_err, blocks=nqb,
        visits=nqb * n_visit, skips=int(ks.sum()),
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

    # 6. timing at the main path's shapes
    kernel_ms = timed_ms(lambda: p2h_sweep(**opnds, k=k), reps, device)
    phase1_ms = timed_ms(lambda: ops.prepare_operands(tree, qn, bq=bq),
                         reps, device)
    plain_ms = timed_ms(lambda: p2h_sweep_ref(**opnds, k=k), 1, device)
    brute_topk(pts, qn, k)  # warm-up
    library_ms = timed_ms(lambda: brute_topk(pts, qn, k), reps, device)
    # bound, at the unpadded width d: each input read once -- the tiles
    # some block scanned (d f32 and 4 tables per point), all of the rest --
    # and each output written once; operations: 2*bq*d*n0 for each
    # (block, tile) pair the kernel scanned, from its own skip counts
    d1, n0, L = tree.d, tree.n0, tree.num_leaves
    pairs = nqb * n_visit - int(ks.sum())
    if pairs != int(live.sum()):
        raise AssertionError("the kernel's and the plain version's scanned "
                             "pairs differ")
    scanned = torch.unique(opnds["visit"].long()[live]).numel()
    nbytes = scanned * n0 * (d1 + 4) * 4
    nbytes += opnds["queries"].shape[0] * d1 * 4
    nbytes += sum(t.nbytes for name, t in opnds.items() if name not in (
        "pts_tiles", "ids_tiles", "rx_tiles", "xc_tiles", "xs_tiles",
        "queries"))
    nbytes += kd.nbytes + ki.nbytes + ks.nbytes
    flops = 2.0 * bq * d1 * n0 * pairs
    bytes_ms, ops_ms = nbytes / PEAK_BYTES_PER_S * 1e3, \
        flops / PEAK_F32_FLOPS * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    log("timing", card=repr(card), kernel_ms=f"{kernel_ms:.4f}",
        phase1_ms=f"{phase1_ms:.4f}", plain_ms=f"{plain_ms:.3f}",
        library_ms=f"{library_ms:.4f}", bound_ms=f"{bound_ms:.4f}",
        bound_by=bound_by, bytes=int(nbytes), flops=int(flops),
        scanned_pairs=pairs, scanned_tiles=scanned, reps=reps)
    return {"kernels": [{
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
    }]}


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
