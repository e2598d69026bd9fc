"""Atomic checkpoints in the JAX package's on-disk format."""
from repro_torch.checkpoint.manager import (CheckpointManager,  # noqa: F401
                                            read_json, write_json_atomic)

__all__ = ["CheckpointManager", "read_json", "write_json_atomic"]
