"""PyTorch model library, the dense decoder-only family of the JAX
package's ``models/``: ``StackedLM`` (an ``nn.Module``) with ``apply``, the
training forward; the layers, the attention with its flash-style backward,
the registry, and ``convert`` to carry parameters across from the JAX
package's pytrees."""
from repro_torch.models.registry import MODEL_FAMILIES, get_model  # noqa: F401

__all__ = ["get_model", "MODEL_FAMILIES"]
