"""Serving placement: the topology signature that keys the warm-template
registries, and the size of a serving mesh.

The JAX package keys its warm-template registries by
``mesh_signature()`` -- backend and visible device count off-mesh, the
mesh's axes, sizes, devices and platform on one -- so a template recorded
on one topology never replays on another.  The port keys its registries
the same way, over a :class:`repro_torch.launch.mesh.DeviceMesh`.

The LM half of the JAX module (``logical_to_spec``, ``shard``,
``resolve_param_specs``, ``pad_vocab``, the fallback log) is ROADMAP.md,
queue 1, item 15.
"""
from __future__ import annotations

import torch

__all__ = ["mesh_signature", "mesh_devices"]


def mesh_devices(mesh) -> int:
    """Positions of a serving mesh (1 for ``None``)."""
    return 1 if mesh is None else mesh.size


def mesh_signature(mesh=None) -> tuple:
    """Hashable topology signature for the warm-template registries.

    ``None`` is the default single-program placement: ``("default",
    "cuda", count)`` with the visible CUDA device count, else ``("default",
    "cpu", 1)``.  A mesh is ``("mesh", axis names, sizes, devices in order,
    platform)``."""
    if mesh is None:
        if torch.cuda.is_available():
            return ("default", "cuda", torch.cuda.device_count())
        return ("default", "cpu", 1)
    devs = tuple(str(d) for d in mesh.devices.flat)
    return ("mesh", tuple(mesh.axis_names),
            tuple(int(mesh.shape[a]) for a in mesh.axis_names), devs,
            mesh.devices.flat[0].type)


def _mesh_axis_size(mesh, axes) -> int:
    """Positions along ``axes`` (a name or a tuple of names): 1 for no
    axes, 0 when an axis is not on the mesh."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    size = 1
    for a in axes:
        if a not in mesh.shape:
            return 0  # axis not present on this mesh
        size *= mesh.shape[a]
    return size
