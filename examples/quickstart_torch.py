"""Quickstart on the PyTorch + CUDA port: build a BC-Tree P2HNNS index,
query it three ways, hold the exact routes to the brute-force oracle.

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu  # host
"""
import argparse

import numpy as np
import torch

from repro_torch.core import P2HIndex, exact_search
from repro_torch.core.balltree import append_ones, normalize_query
from repro_torch.data.pipeline import make_p2h_dataset


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    # 10k points in 32-d + 5 hyperplane queries (coefficients, bias)
    data, queries = make_p2h_dataset(10_000, 32, kind="clustered",
                                     n_queries=5, seed=0)

    idx = P2HIndex.build(data, n0=128, variant="bc", device=args.device)
    out = {"num_nodes": idx.report.num_nodes,
           "num_leaves": idx.report.num_leaves,
           "index_mb": idx.report.index_bytes / 1e6,
           "build_ms": idx.report.build_seconds * 1e3}
    print(f"built BC-Tree: {out['num_nodes']} nodes, {out['num_leaves']} "
          f"leaves, {out['index_mb']:.2f} MB, {out['build_ms']:.0f} ms")

    # 1) exact, paper-faithful branch-and-bound (Algorithm 5)
    d1, i1 = idx.query(queries, k=5)
    # 2) exact sweep (the sweep kernel's schedule, in plain PyTorch)
    d2, i2 = idx.query(queries, k=5, method="sweep")
    # 3) budgeted: visit only the best 5% of leaf tiles
    d3, i3 = idx.query(queries, k=5, method="beam", frac=0.05)

    device = idx.tree.device
    gt_d, gt_i = exact_search(
        torch.from_numpy(append_ones(data)).to(device),
        torch.from_numpy(normalize_query(queries)).to(device), k=5)
    gt_d, gt_i = gt_d.cpu().numpy(), gt_i.cpu().numpy()
    out["dfs_equals_exact"] = bool(np.allclose(d1, gt_d, atol=1e-5))
    out["sweep_equals_exact"] = bool(np.allclose(d2, gt_d, atol=1e-5))
    out["beam_recall"] = float(np.mean(
        [len(set(a) & set(b)) / 5 for a, b in zip(i3, gt_i)]))
    out["distances"] = d1[0]
    print("dfs   == exact:", out["dfs_equals_exact"])
    print("sweep == exact:", out["sweep_equals_exact"])
    print(f"beam(5%) recall: {out['beam_recall']:.2f}")
    print("nearest-to-hyperplane distances:", np.round(d1[0], 5))
    return out


if __name__ == "__main__":
    main()
