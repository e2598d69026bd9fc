"""Batched P2HNNS serving on the PyTorch + CUDA port: stream hyperplane
queries through ``repro_torch.serve.P2HEngine`` (micro-batching + backend
auto-dispatch + lambda warm cache).

    PYTHONPATH=src python examples/serve_batch_torch.py --n 20000 --d 32 --k 10
    PYTHONPATH=src python examples/serve_batch_torch.py --device cpu
"""
import argparse
import time

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--slot", type=int, default=8, help="micro-batch slots")
    ap.add_argument("--repeat-frac", type=float, default=0.5,
                    help="fraction of hot (repeated) queries in the stream")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from repro_torch.core import P2HIndex
    from repro_torch.serve import P2HEngine

    rng = np.random.default_rng(args.seed)
    cents = rng.normal(size=(32, args.d)) * 3
    data = (cents[rng.integers(0, 32, args.n)]
            + rng.normal(size=(args.n, args.d))).astype(np.float32)
    t0 = time.perf_counter()
    idx = P2HIndex.build(data, n0=128, device=args.device)
    print(f"built BC-Tree over {args.n} pts in "
          f"{time.perf_counter() - t0:.2f}s "
          f"({idx.report.num_leaves} leaves, "
          f"{idx.report.index_bytes / 1e6:.1f} MB index) "
          f"on {idx.tree.device}")

    engine = P2HEngine(idx, slot_size=args.slot)

    # a serving trace: cold unique queries mixed with hot repeats
    n_hot = max(1, int(args.queries * args.repeat_frac))
    hot = rng.normal(size=(4, args.d + 1)).astype(np.float32)
    trace = [hot[i % 4] for i in range(n_hot)]
    trace += [rng.normal(size=(args.d + 1,)).astype(np.float32)
              for _ in range(args.queries - n_hot)]
    rng.shuffle(trace)

    t0 = time.perf_counter()
    tickets = [engine.submit(q, k=args.k) for q in trace]
    engine.flush()
    wall = time.perf_counter() - t0
    results = [engine.result(t) for t in tickets]
    st = engine.stats()

    print(f"served {len(results)} queries in {wall * 1e3:.0f} ms "
          f"({len(results) / wall:.0f} q/s)")
    print(f"routes: {st['routes']}   "
          f"p50 {st['latency_p50_ms']:.1f} ms / "
          f"p99 {st['latency_p99_ms']:.1f} ms per micro-batch")
    print(f"lambda cache: {st['lambda_cache']}")
    d0, i0 = results[0]
    print(f"first result: ids {i0[:5]}... dists {np.round(d0[:5], 4)}...")
    return {"trace": np.stack(trace), "results": results, "stats": st,
            "seconds": wall}


if __name__ == "__main__":
    main()
