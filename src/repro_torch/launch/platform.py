"""Device and precision policy of the PyTorch port.

Entry points run on the CUDA card unless the caller asks for the host with
``device="cpu"``.  ``device=None`` means "the card": with no CUDA device it
raises -- it never falls back to the CPU, so a measurement can never be taken
on the wrong device by accident.

Every node bound of the search is built on ``q @ leaf_centers.T``.  Under
TF32 those products keep about three decimal digits, the bounds stop being
lower bounds and the search stops being exact, so every CUDA entry point
pins float32 matrix products to full precision and checks that it holds.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "ensure_full_precision", "device_report"]


def ensure_full_precision(device: torch.device | str | None = None) -> None:
    """Pin full-precision float32 products for CUDA work and assert it.

    A no-op for host tensors: CPU matmuls never use TF32.
    """
    if device is not None and torch.device(device).type != "cuda":
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("float32 matmuls are not at full precision; the "
                           "search's bounds would not be valid")


def resolve_device(device: torch.device | str | None = None) -> torch.device:
    """``None`` -> the current CUDA device, raising if there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the host")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda":
        ensure_full_precision(device)
    return device


def device_report() -> dict:
    """Name and count of the CUDA devices (``count`` 0 on a host), and the
    float32 matmul precision in force."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return {
        "name": torch.cuda.get_device_name(0) if count else None,
        "count": count,
        "allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "matmul_precision": torch.get_float32_matmul_precision(),
    }
