"""Serving placement on one device: the topology signature and the mesh
rule.

The JAX package keys its warm-template registries by
``mesh_signature()`` -- backend and visible device count off-mesh, the
mesh's axes and devices on one -- so a template recorded on one topology
never replays on another.  The port serves on one device, so the
signature is a one-device stand-in: ``("default", "cuda" | "cpu", 1)``,
keyed as the stacked registry keys its signatures
(:func:`repro_torch.kernels.stacked_sweep._placement`).

A serving "mesh" here is ``None`` or one device (a ``torch.device``, a
device string, or a sequence holding one).  Anything spanning more
devices is refused with ``NotImplementedError``:
the multi-device mesh, ``shard_map_compat`` and the LM sharding rules are
ROADMAP.md, queue 1, items 12 and 15.
"""
from __future__ import annotations

import torch

__all__ = ["mesh_signature", "mesh_devices", "require_one_device"]

MULTI_DEVICE_LATER = ("a serving mesh of more than one device is not ported "
                      "yet (ROADMAP.md, queue 1, item 12: multi-device)")


def _devices(mesh) -> list:
    """The devices a mesh value names: one device, or a (nested) sequence
    of them, flattened."""
    if isinstance(mesh, (list, tuple)):
        return [dev for item in mesh for dev in _devices(item)]
    return [torch.device(mesh)]


def mesh_devices(mesh) -> int:
    """Device count of a serving mesh (1 for ``None`` or one device)."""
    if mesh is None:
        return 1
    return max(1, len(_devices(mesh)))


def require_one_device(mesh):
    """``None`` or the one ``torch.device`` ``mesh`` names; raises
    ``NotImplementedError`` (naming item 12) for more than one device."""
    if mesh is None:
        return None
    devs = _devices(mesh)
    if len(devs) != 1:
        raise NotImplementedError(MULTI_DEVICE_LATER)
    return devs[0]


def mesh_signature(mesh=None) -> tuple:
    """Hashable topology signature for the warm-template registries.

    ``None`` is the default single-program placement: ``("default",
    "cuda", 1)`` where a CUDA device is visible, else ``("default", "cpu",
    1)``.  One device is ``("device", type, index)``; more raise (item
    12)."""
    if mesh is None:
        return ("default", "cuda" if torch.cuda.is_available() else "cpu", 1)
    dev = require_one_device(mesh)
    return ("device", dev.type, dev.index)
