"""One config module per architecture, the same numbers as the JAX
package's ``configs/``: ``CONFIG`` (full size) and ``SMOKE`` (a reduced
config of the same family, for the CPU tests).

Every architecture of the JAX package is here.  ``SHAPES`` and
``shape_applicable`` belong to placement (ROADMAP.md, queue 1, item
15.4).
"""
from repro_torch.models.registry import (  # noqa: F401
    ARCH_IDS,
    MODEL_FAMILIES,
    get_config,
    get_model,
)

__all__ = ["ARCH_IDS", "MODEL_FAMILIES", "get_config", "get_model"]
