"""Pool-based active learning with SVM margin sampling via BC-Tree P2HNNS
-- the paper's motivating application (Section I) -- on the PyTorch + CUDA
port.

A linear SVM is trained on a small labeled seed; each round, its decision
hyperplane (w; b) is the *hyperplane query* and the BC-Tree returns the
pool points closest to the boundary (minimum margin) to be labeled next.
Compared against random sampling at equal label budget.

    PYTHONPATH=src python examples/active_learning_torch.py               # card
    PYTHONPATH=src python examples/active_learning_torch.py --device cpu  # host

On the card the query takes the sweep kernel (``method="kernel"``), on the
host the branch-and-bound DFS; both are exact.
"""
import argparse

import numpy as np

from repro_torch.core import P2HIndex


def make_task(n=20_000, d=24, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=d)
    b_true = 0.3
    x = rng.normal(size=(n, d)) + rng.normal(size=(1, d))
    y = np.sign(x @ w_true + b_true + rng.normal(scale=0.5, size=n))
    return x.astype(np.float32), y.astype(np.float32)


def train_svm(x, y, epochs=40, lam=1e-3, lr=0.5, seed=0):
    """Pegasos-style linear SVM; returns (w, b)."""
    rng = np.random.default_rng(seed)
    n, d = x.shape
    w = np.zeros(d)
    b = 0.0
    t = 1
    for _ in range(epochs):
        for i in rng.permutation(n):
            t += 1
            eta = lr / (lam * t)
            margin = y[i] * (x[i] @ w + b)
            w *= 1 - eta * lam
            if margin < 1:
                w += eta * y[i] * x[i]
                b += eta * y[i] * 0.1
    return w, b


def accuracy(w, b, x, y):
    return float(np.mean(np.sign(x @ w + b) == y))


def main(rounds=6, per_round=40, seed=0, device=None) -> dict:
    """The per-round test accuracies of both strategies."""
    x, y = make_task(seed=seed)
    rng = np.random.default_rng(seed)
    test = rng.choice(len(x), 4000, replace=False)
    pool = np.setdiff1d(np.arange(len(x)), test)
    xte, yte = x[test], y[test]

    index = P2HIndex.build(x[pool], n0=128, variant="bc", device=device)
    method = "kernel" if index.tree.device.type == "cuda" else "dfs"

    results = {}
    for strategy in ("margin (BC-Tree)", "random"):
        labeled = list(rng.choice(len(pool), 40, replace=False))
        accs = []
        for r in range(rounds):
            w, b = train_svm(x[pool][labeled], y[pool][labeled], seed=r)
            accs.append(accuracy(w, b, xte, yte))
            if strategy.startswith("margin"):
                # hyperplane query = (w; b): the paper's P2HNNS use case
                q = np.concatenate([w, [b]]).astype(np.float32)
                _, ids = index.query(q, k=per_round + len(labeled),
                                     method=method)
                new = [i for i in ids[0] if i not in set(labeled)]
                labeled += new[:per_round]
            else:
                cand = rng.choice(len(pool), per_round * 2, replace=False)
                labeled += [c for c in cand if c not in set(labeled)
                            ][:per_round]
        results[strategy] = accs
        print(f"{strategy:18s} acc/round: "
              + " ".join(f"{a:.3f}" for a in accs))
    final_m = results["margin (BC-Tree)"][-1]
    final_r = results["random"][-1]
    print(f"\nfinal: margin {final_m:.3f} vs random {final_r:.3f} "
          f"({'+' if final_m >= final_r else ''}{(final_m-final_r)*100:.1f} pts"
          f" at equal label budget)")
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    main(rounds=args.rounds, device=args.device)
