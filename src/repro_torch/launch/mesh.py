"""Meshes: named device grids for the multi-device read path, LM
placement and the dry run.

The JAX package's mesh is a ``jax.sharding.Mesh``, and its mapped programs
(``shard_map``) run every position inside one ``jit`` of one process.  The
port keeps that single-controller shape: a :class:`DeviceMesh` names a grid
of ``torch.device``\\ s, and one process drives every position -- each on
its own CUDA stream (:func:`repro_torch.parallel.collectives.per_position`)
-- with the collectives as explicit steps between launches.

Building a mesh touches no device: the grid is a value, and a position
costs nothing until work is placed on it.  The production meshes of the
dry run (``make_production_mesh``: 16 x 16, or 2 x 16 x 16 across pods)
name the ``meta`` device at every position by default -- the counterpart
of the JAX package's 512 forced host devices: tensors placed there have
shapes and no storage.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools

import numpy as np
import torch

__all__ = ["DeviceMesh", "make_mesh", "make_serving_mesh", "mesh_context",
           "make_production_mesh", "make_test_mesh"]


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceMesh:
    """A named n-dimensional grid of devices.

    ``devices`` is an object array of ``torch.device`` shaped like the mesh;
    ``axis_names`` names its axes and ``shape`` maps each name to its size
    (as ``jax.sharding.Mesh.shape`` does).  Two meshes are equal when their
    axes, sizes and devices (in order) are.  A device may appear more than
    once: the positions then share it, each with its own stream.
    """

    devices: np.ndarray
    axis_names: tuple
    #: one CUDA stream per position, made on first use; a cache, not part
    #: of the mesh's value
    _streams: dict = dataclasses.field(default_factory=dict, repr=False)

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"{self.devices.ndim}-d devices for axes "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated axis name in {self.axis_names}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def _key(self) -> tuple:
        return (self.axis_names, self.devices.shape,
                tuple(str(d) for d in self.devices.flat))

    def __eq__(self, other):
        return isinstance(other, DeviceMesh) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def axis_devices(self, axes) -> list:
        """The devices of the positions along ``axes`` (a name or a tuple
        of names), in the order the shard index composes them
        (``i_0 * size_1 + i_1 ...``), each at coordinate 0 of every other
        axis: one position per shard, replicas left out."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"axis {a!r} not in {self.axis_names}")
        sizes = [self.shape[a] for a in axes]
        out = []
        for coord in itertools.product(*(range(s) for s in sizes)):
            at = dict(zip(axes, coord))
            out.append(self.devices[tuple(at.get(a, 0)
                                          for a in self.axis_names)])
        return out

    def stream(self, position: int, device: torch.device):
        """The CUDA stream of ``position`` (on ``device``), made once."""
        key = (position, str(device))
        s = self._streams.get(key)
        if s is None:
            s = self._streams.setdefault(key, torch.cuda.Stream(device))
        return s


def make_mesh(shape, axes, *, devices=None) -> DeviceMesh:
    """A mesh of ``shape`` over ``axes``.

    ``devices`` (a flat sequence of ``prod(shape)`` devices or device
    strings, in row-major order) defaults to the visible CUDA devices, the
    first ``prod(shape)`` of them.  A device may be named more than once:
    that stands in for the JAX package's forced host devices
    (``XLA_FLAGS=--xla_force_host_platform_device_count``), so a mesh of
    ``cpu`` four times, or of ``cuda:0`` four times on one card, runs every
    mapped program at four positions.
    """
    shape = tuple(int(s) for s in shape)
    axes = tuple(str(a) for a in axes)
    n = int(np.prod(shape))
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise ValueError(f"a mesh of {n} devices needs {n} visible CUDA "
                             f"devices; {count} are visible (pass devices= "
                             f"to name them)")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a mesh of shape "
                         f"{shape}")
    grid = np.empty((n,), dtype=object)
    grid[:] = devices
    return DeviceMesh(devices=grid.reshape(shape), axis_names=axes)


def make_serving_mesh(devices: int | None = None, *,
                      axis: str = "shard") -> DeviceMesh:
    """1-D mesh for the serving read path: ``devices`` CUDA devices
    (default: all visible) along one ``axis``, which the stacked sweep
    shards its segment axis over (``ShardedMutableP2HIndex.set_mesh``,
    ``stacked_sweep_query(mesh=...)``).  Raises when asked for more
    devices than are visible."""
    n = (torch.cuda.device_count() if torch.cuda.is_available() else 0) \
        if devices is None else int(devices)
    if n < 1:
        raise ValueError("a serving mesh needs at least one CUDA device")
    return make_mesh((n,), (axis,))


def make_production_mesh(*, multi_pod: bool = False) -> DeviceMesh:
    """The JAX package's production mesh: 16 x 16 over (``data``,
    ``model``), or 2 x 16 x 16 over (``pod``, ``data``, ``model``) with
    ``multi_pod``, ``meta`` at every position: the dry run's placement, no
    allocation."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_test_mesh(shape, axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), *,
                   devices=None) -> DeviceMesh:
    """A mesh of ``shape`` over ``axes`` naming ``devices`` (``meta`` at
    every position by default; e.g. ``["cpu"] * 8`` for the host tests,
    ``["cuda:0"] * 4`` for one card at four positions)."""
    n = int(np.prod(shape))
    return make_mesh(shape, axes,
                     devices=["meta"] * n if devices is None else devices)


def mesh_context(mesh):
    """A context that does nothing.  It exists only so that code written
    against the JAX package's ``mesh_context`` imports and runs unchanged:
    the port's programs take their mesh as an argument, so there is no
    ambient mesh to set."""
    del mesh
    return contextlib.nullcontext()
