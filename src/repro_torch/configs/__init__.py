"""One config module per architecture, the same numbers as the JAX
package's ``configs/``: ``CONFIG`` (full size) and ``SMOKE`` (a reduced
config of the same family, for the CPU tests).

``SHAPES`` maps the input-shape ids of the dry run's cells to (kind, seq,
global batch), and ``shape_applicable`` says which arch x shape cells run,
both as in the JAX package.
"""
from repro_torch.models.registry import (  # noqa: F401
    ARCH_IDS,
    MODEL_FAMILIES,
    get_config,
    get_model,
)

__all__ = ["ARCH_IDS", "MODEL_FAMILIES", "get_config", "get_model",
           "SHAPES", "shape_applicable"]

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def shape_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """long_500k needs sub-quadratic attention or O(1)-state decode: it
    runs for the SSM and hybrid archs and is skipped for the pure
    full-attention ones."""
    if shape == "long_500k" and MODEL_FAMILIES[arch] not in ("ssm", "hybrid"):
        return False, ("skip: pure full-attention architecture -- 500k-token "
                       "KV-cache decode requires sub-quadratic attention "
                       "(see DESIGN.md table)")
    return True, ""
