"""PyTorch model library, the JAX package's ``models/``: ``StackedLM`` (an
``nn.Module``, every decoder-only family) and ``WhisperED`` (the
encoder-decoder) with ``apply``, the training forward; the layers, the
attention with its flash-style backward and the two-block local path, the
MoE FFN, the Mamba-2 and RG-LRU mixers, the registry, and ``convert`` to
carry parameters across from the JAX package's pytrees."""
from repro_torch.models.registry import MODEL_FAMILIES, get_model  # noqa: F401

__all__ = ["get_model", "MODEL_FAMILIES"]
