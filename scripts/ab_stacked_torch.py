"""Phase 7's stacked batch on the card with this tree's stacked program and
an older one, in turns.

Usage, from the repository's root on a machine with a CUDA card::

    git show REV:src/repro_torch/kernels/stacked_sweep.py > build/old.py
    python3 scripts/ab_stacked_torch.py build/old.py

``OLD`` is a ``stacked_sweep.py`` of the PyTorch port whose
``_run_stacked(arrays, queries, lambda_cap, extra_d, extra_i, seg_shard,
n_true, **statics)`` is the single launch (the port before the single
launch became the one-part case of the mesh program).  The script runs
``chip_smoke.run_stacked`` at full size (1M x 128 in 8 segments, 1024
queries), then times ``MutableP2HIndex.query(method="stacked")`` in every
probe mode with the new program and with ``OLD``'s, in the order new, old,
old, new, 10 calls each, and exits non-zero unless the answers are equal
bit for bit.
"""
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.data.pipeline import make_p2h_dataset  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import stacked_sweep as tss  # noqa: E402


def main(old_path: str) -> int:
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    print(card, flush=True)
    _build.build(force=True)
    spec = importlib.util.spec_from_file_location("old_stacked_sweep",
                                                  old_path)
    old = importlib.util.module_from_spec(spec)
    sys.modules["old_stacked_sweep"] = old
    spec.loader.exec_module(old)
    _, mutable = cs.run_stacked(dev, card, n=1_000_000, d=128, queries=1024,
                                n0=256, reps=10)
    m = mutable["index"]
    _, q = make_p2h_dataset(1_000_000, 128, kind="planted", n_queries=1024,
                            seed=cs.SEED)
    new_run = tss._run_stacked

    def old_run(parts, qq, cap, ed, ei, seg, n_true, n_leaves, *, mesh,
                mesh_axis, **statics):
        assert mesh is None and len(parts) == 1
        return old._run_stacked(parts[0], qq, cap, ed, ei, seg, n_true,
                                **statics)

    for name, kw in (("f32", {}), ("single", dict(probe_tiles=0)),
                     ("bf16", dict(probe_dtype="bf16")),
                     ("int8", dict(probe_dtype="int8"))):
        def batch(kw=kw):
            return m.query(q, cs.K, method="stacked", **kw)

        outs, ms = {}, {"new": [], "old": []}
        try:
            for which in ("new", "old", "old", "new"):
                tss._run_stacked = new_run if which == "new" else old_run
                outs[which] = batch()
                ms[which].append(cs.timed_ms(batch, 10, dev))
        finally:
            tss._run_stacked = new_run
        eq = all(np.array_equal(a, b)
                 for a, b in zip(outs["new"], outs["old"]))
        cs.log("ab7", card=repr(card), mode=name, bit_equal=eq,
               new_batch_ms=",".join(f"{t:.3f}" for t in ms["new"]),
               old_batch_ms=",".join(f"{t:.3f}" for t in ms["old"]),
               reps=10)
        if not eq:
            return 1
    return 0


if __name__ == "__main__":
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        sys.exit("usage, on a CUDA card: ab_stacked_torch.py OLD_MODULE.py")
    sys.exit(main(sys.argv[1]))
