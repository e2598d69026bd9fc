"""The optimiser of the LM substrate: AdamW with f32 moments, global-norm
clipping, int8 error-feedback compression and the cosine schedule -- plain
functions on tensors, as in the JAX package's ``optim/``."""
from repro_torch.optim.adamw import OptState, adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.grad import (  # noqa: F401
    clip_by_global_norm,
    compress_int8,
    decompress_int8,
    ef_compress_grads,
)
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401

__all__ = ["OptState", "adamw_init", "adamw_update", "cosine_schedule",
           "clip_by_global_norm", "compress_int8", "decompress_int8",
           "ef_compress_grads"]
