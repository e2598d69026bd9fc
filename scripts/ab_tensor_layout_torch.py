"""One timing turn of phase 16 (g)'s tensor layout from a checkout of the
repository, on the card.

Usage, from the repository's root on a machine with a CUDA card, with two
checkouts unpacked under ``build/`` (e.g. ``git archive REV | tar -x -C
build/old``), in turns so that drift on the card falls on both::

    for t in old new new old; do
        python3 scripts/ab_tensor_layout_torch.py build/$t
    done

Each turn imports ``chip_smoke`` and ``repro_torch`` from ``TREE``, draws
llama3.2-1b at full width (bf16 compute, ``full`` remat, phase 16's
batches), runs it on one device and then runs the placed step's tensor
layout on the card named at (2,2) positions without and with
``seqshard``, 3 steps each, through ``chip_smoke.place_run``: its
``[lm-placement]`` lines carry each step's ms (CUDA events) and its checks
hold as in phase 16.  ``[ab] tree=TREE`` opens each turn.
"""
import sys
from pathlib import Path

TREE = Path(sys.argv[1]).resolve()
sys.path[:0] = [str(TREE), str(TREE / "src")]
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.models.registry import get_config  # noqa: E402


def main() -> None:
    dev = torch.device("cuda", 0)
    card = cs.nvidia_smi()
    cfg = get_config(cs.LM_ARCH)
    batches = cs.place_batches(cfg, cs.LM_BATCH, cs.LM_SEQ, 3)
    init, one = cs.place_one_device(dev, cfg, batches, full=True)
    cs.free_device(dev)
    print(f"[ab] tree={TREE} card={card!r}", flush=True)
    for seqshard in (False, True):
        cs.place_run(dev, card, cfg, init, batches, (2, 2), one,
                     bitwise=False, layout="tensor", seqshard=seqshard)
        cs.free_device(dev)


if __name__ == "__main__":
    main()
