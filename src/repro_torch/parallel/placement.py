"""Placed tensors: a tensor split over a
:class:`repro_torch.launch.mesh.DeviceMesh` by a resolved spec -- the
counterpart of ``jax.sharding.NamedSharding`` and a sharded ``jax.Array``.

A :class:`NamedSharding` pairs a mesh with a
:class:`repro_torch.parallel.sharding.PartitionSpec`.  :func:`device_put`
splits a tensor by it into a :class:`PlacedTensor`: every mesh position
holds its own shard on its own device -- split along the dimensions the
spec names mesh axes for, whole along the others, and repeated over the
mesh axes the spec does not use.  Each shard is a tensor of its own (its
own storage), so :meth:`PlacedTensor.nbytes_by_position` measures what
each position holds, and on a device named at several positions each
position still holds its copy, as each card of a real mesh would.
:func:`gather` reassembles the whole tensor on one device with the
collectives of :mod:`repro_torch.parallel.collectives`.

On the ``meta`` device nothing is allocated: a mesh of ``meta`` named at
every position (``launch.mesh.make_production_mesh``) places the full
width models of the dry run by shape alone.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.parallel import collectives
from repro_torch.parallel.sharding import PartitionSpec, _mesh_axis_size

__all__ = ["NamedSharding", "PlacedTensor", "device_put", "gather"]


def _axes(entry) -> tuple:
    return (entry,) if isinstance(entry, str) else tuple(entry or ())


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where each block of a tensor lives."""

    mesh: object
    spec: PartitionSpec

    def __post_init__(self):
        spec = PartitionSpec(*self.spec)
        object.__setattr__(self, "spec", spec)
        for a in spec.mesh_axes():
            if a not in self.mesh.shape:
                raise ValueError(f"spec {spec} names axis {a!r}, not on the "
                                 f"mesh {self.mesh.axis_names}")
        if len(set(spec.mesh_axes())) != len(spec.mesh_axes()):
            raise ValueError(f"spec {spec} uses a mesh axis twice")

    def _entries(self, ndim: int) -> tuple:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} for a {ndim}-d tensor")
        return tuple(self.spec) + (None,) * (ndim - len(self.spec))

    def blocks(self, shape) -> tuple:
        """Blocks along each dimension (1 where it is whole); a dimension
        the blocks do not divide raises ``ValueError``."""
        out = []
        for dim, entry in zip(shape, self._entries(len(shape))):
            n = _mesh_axis_size(self.mesh, entry)
            if dim % n:
                raise ValueError(f"dimension {dim} does not split into {n} "
                                 f"blocks ({self.spec})")
            out.append(n)
        return tuple(out)

    def shard_shape(self, shape) -> tuple:
        return tuple(d // n for d, n in zip(shape, self.blocks(shape)))

    def block_index(self, ndim: int, coord) -> tuple:
        """The block a position (its coordinates on the mesh) holds: per
        dimension, the index composed over the entry's mesh axes, the
        first axis major."""
        at = dict(zip(self.mesh.axis_names, coord))
        out = []
        for entry in self._entries(ndim):
            idx = 0
            for a in _axes(entry):
                idx = idx * self.mesh.shape[a] + at[a]
            out.append(idx)
        return tuple(out)

    def slices(self, shape, coord) -> tuple:
        """The index of the block ``coord`` holds, as slices."""
        size = self.shard_shape(shape)
        return tuple(slice(i * s, (i + 1) * s) for i, s in
                     zip(self.block_index(len(shape), coord), size))

    def shard_nbytes(self, shape, dtype) -> int:
        """Bytes a position holds of a tensor of ``shape`` and ``dtype``
        (every position holds as much)."""
        n = int(np.prod(self.shard_shape(shape), dtype=np.int64))
        return n * dtype.itemsize


@dataclasses.dataclass(eq=False)
class PlacedTensor:
    """A tensor of ``shape`` and ``dtype`` held as one shard a mesh
    position: ``shards`` is an object array shaped like the mesh, each
    entry the block :meth:`NamedSharding.slices` names, on that
    position's device."""

    sharding: NamedSharding
    shape: torch.Size
    dtype: torch.dtype
    shards: np.ndarray

    @property
    def mesh(self):
        return self.sharding.mesh

    @property
    def ndim(self) -> int:
        return len(self.shape)

    def shard(self, coord=None) -> torch.Tensor:
        """The shard at ``coord`` (the first position when None)."""
        return self.shards[tuple(coord) if coord is not None
                           else (0,) * self.shards.ndim]

    def nbytes_by_position(self) -> np.ndarray:
        """The bytes each position's shard holds (its storage), shaped like
        the mesh."""
        out = np.zeros(self.shards.shape, dtype=np.int64)
        for coord in np.ndindex(self.shards.shape):
            out[coord] = self.shards[coord].untyped_storage().nbytes()
        return out

    def __repr__(self):
        return (f"PlacedTensor(shape={tuple(self.shape)}, dtype={self.dtype}"
                f", spec={self.sharding.spec}, mesh={self.mesh.shape})")


def device_put(x, sharding: NamedSharding) -> PlacedTensor:
    """``x`` (a tensor, or a :class:`PlacedTensor` on any mesh) split by
    ``sharding``: every position gets a fresh copy of its block on its own
    device, bit for bit ``x``'s values.  A placed ``x`` with this sharding
    is returned as it is; one with another is gathered onto the new
    mesh's first device and split again."""
    if isinstance(x, PlacedTensor):
        if x.sharding == sharding:
            return x
        x = gather(x, sharding.mesh.devices.flat[0])
    x = x.detach()
    mesh = sharding.mesh
    shape = tuple(x.shape)
    size = sharding.shard_shape(shape)
    shards = np.empty(mesh.devices.shape, dtype=object)
    for coord in np.ndindex(mesh.devices.shape):
        t = torch.empty(size, dtype=x.dtype, device=mesh.devices[coord])
        if t.device.type != "meta":
            t.copy_(x[sharding.slices(shape, coord)])
        shards[coord] = t
    return PlacedTensor(sharding, torch.Size(shape), x.dtype, shards)


def gather(placed: PlacedTensor, device=None, *, at=None) -> torch.Tensor:
    """The whole tensor on ``device`` (the first position's when None):
    one block from each group of positions that hold the same block, read
    at ``at`` (mesh axis -> coordinate; 0 for an axis not named) on the
    mesh axes the spec does not use, joined by tiled ``all_gather`` along
    each split dimension.  A tensor split nowhere is the shard at ``at``
    (no copy when it is on ``device`` already)."""
    sh, mesh = placed.sharding, placed.mesh
    at = dict(at or {})
    used = set(sh.spec.mesh_axes())
    pin = {a: at.get(a, 0) for a in mesh.axis_names if a not in used}
    device = (torch.device(device) if device is not None
              else placed.shard().device)
    blocks = {}
    for coord in np.ndindex(mesh.devices.shape):
        c = dict(zip(mesh.axis_names, coord))
        if any(c[a] != i for a, i in pin.items()):
            continue
        blocks.setdefault(sh.block_index(placed.ndim, coord),
                          placed.shards[coord])
    counts = sh.blocks(tuple(placed.shape))
    split = [d for d, n in enumerate(counts) if n > 1]

    def join(level, prefix):
        if level == len(split):
            return blocks[tuple(prefix)]
        d = split[level]
        parts = []
        for j in range(counts[d]):
            nxt = list(prefix)
            nxt[d] = j
            parts.append(join(level + 1, nxt))
        return collectives.all_gather(parts, tiled=True, axis=d,
                                      device=device)

    return join(0, [0] * placed.ndim).to(device)
