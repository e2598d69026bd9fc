"""Collectives between a mesh's positions, driven by one process.

The JAX package writes each multi-device program as one ``shard_map`` whose
body calls ``jax.lax.all_gather``, ``pmin`` and ``psum``.  The port writes
the same programs as explicit phases: :func:`per_position` runs a phase at
every position -- on a CUDA device under that position's own stream, so
positions overlap on the card -- and the collectives below join the
per-position results between phases.  A collective's result lands on one
device (the first position's, unless told otherwise); a phase that needs
it at every position copies it there, which on a repeated device is no
copy at all.

Stream safety: a position's stream first waits for the caller's stream on
its device, so it sees every input the caller made; the caller's stream
then waits for the position's event, and every tensor the position returns
is marked as used by the caller's stream (``Tensor.record_stream``), so the
caching allocator cannot hand its memory out again while the caller still
reads it.

Across positions, differentiably: a :class:`PositionGroup` names the
positions one collective joins (a tensor-parallel group, the data
positions of one model index, ...), and :func:`all_reduce`,
:func:`all_gather_each`, :func:`reduce_scatter` and :func:`all_max` take
one tensor a position and return one a position, each on its position's
device, computed under its stream.  The first three are
``torch.autograd.Function``\\ s whose backward is the dual collective
(all-reduce <-> all-reduce, all-gather <-> reduce-scatter), made of the
same ``.to()`` copies and sums; :func:`all_max` carries no gradient.  A
sum adds the positions' parts in position order (in f32 for a 16-bit
type), so every position receives bit for bit the same result.  The
older :func:`psum`, :func:`pmin`, :func:`all_gather` and :func:`scatter`
reduce or gather onto one device.

Accounting: under :func:`record_collectives` every collective of more
than one position is noted as a :class:`Note`, (kind under the JAX
package's HLO names, payload bytes a receiving position, receiving
positions): ``all_gather`` as ``all-gather`` (its output), ``psum``/
``pmin`` as ``all-reduce`` (one part), :func:`scatter` as
``collective-permute`` (a shard to each position but the source);
:func:`all_reduce` and :func:`all_max` as ``all-reduce`` of one part at
every position, :func:`all_gather_each` as ``all-gather`` of the output,
:func:`reduce_scatter` as ``reduce-scatter`` of the input (the whole
tensor reduced, of which each position keeps its part), so that on a
ring an all-reduce's wire bytes (twice its payload) equal a
reduce-scatter's and an all-gather's of the same tensor together.  A
note carries the ``part`` of the step it belongs to (:func:`part`, or
the group's), e.g. ``"activations"`` or ``"gradients"``.  A group's notes
go to the record that was open when the group was made, so the backward
pass's collectives (on another thread on a CUDA device) are noted too.
The dry run reads its collective bytes from these notes
(``launch/dryrun.py``); a collective of one position moves nothing and
is not noted, as XLA drops a collective over a group of one.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

__all__ = ["per_position", "all_gather", "pmin", "psum", "scatter",
           "record_collectives", "record_notes", "part", "Note",
           "PositionGroup",
           "all_reduce", "all_gather_each", "reduce_scatter", "all_max"]

_NOTES = threading.local()


@contextlib.contextmanager
def record_collectives():
    """Collect ``(kind, payload bytes a receiver, receivers)`` of every
    collective this thread runs inside the block, in a list."""
    notes, prev = [], getattr(_NOTES, "log", None)
    _NOTES.log = notes
    try:
        yield notes
    finally:
        _NOTES.log = prev


class Note(tuple):
    """One collective: ``(kind, payload bytes a receiver, receivers)``,
    with the step's ``part`` it belongs to as an attribute (not part of
    the tuple, so notes compare and sort by what they move)."""

    def __new__(cls, kind, nbytes, receivers, part=None):
        note = super().__new__(cls, (kind, int(nbytes), int(receivers)))
        note.part = part
        return note


@contextlib.contextmanager
def part(name):
    """Note the collectives this thread runs inside the block (outside a
    :class:`PositionGroup`) under the step's part ``name``."""
    prev = getattr(_NOTES, "part", None)
    _NOTES.part = name
    try:
        yield
    finally:
        _NOTES.part = prev


def record_notes(notes) -> None:
    """Append ``notes`` (counted, not run: the dry run's reckoning of a
    step) to the record this thread has open, if any."""
    log = getattr(_NOTES, "log", None)
    if log is not None:
        log.extend(notes)


def _note(kind: str, t: torch.Tensor, receivers: int = 1) -> None:
    log = getattr(_NOTES, "log", None)
    if log is not None and receivers > 0:
        log.append(Note(kind, t.numel() * t.element_size(), receivers,
                        getattr(_NOTES, "part", None)))


def _tensors(obj):
    """Every tensor in a (nested) tuple, list or dict result."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (tuple, list)):
        for item in obj:
            yield from _tensors(item)
    elif isinstance(obj, dict):
        for item in obj.values():
            yield from _tensors(item)


def per_position(mesh, axes, fn, *args) -> list:
    """``[fn(i, device_i, args[0][i], args[1][i], ...)]`` over the positions
    along ``axes`` (:meth:`repro_torch.launch.mesh.DeviceMesh.axis_devices`).

    On a CUDA device each call runs under position ``i``'s stream and the
    caller's stream joins it before this returns; host positions run one
    after another.  An exception at any position propagates."""
    devices = mesh.axis_devices(axes)
    return _run(mesh, list(range(len(devices))), devices, fn, args)


def _run(mesh, keys, devices, fn, args) -> list:
    """``fn(i, device_i, *per-position args)`` at every position, position
    ``i`` under the stream ``mesh.stream(keys[i], devices[i])`` on a CUDA
    device (see :func:`per_position`)."""
    for a in args:
        if len(a) != len(devices):
            raise ValueError(f"{len(a)} per-position arguments for "
                             f"{len(devices)} positions")
    out, joins = [], []
    for i, dev in enumerate(devices):
        per = tuple(a[i] for a in args)
        if dev.type != "cuda":
            out.append(fn(i, dev, *per))
            continue
        stream = mesh.stream(keys[i], dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            res = fn(i, dev, *per)
            done = torch.cuda.Event()
            done.record(stream)
        out.append(res)
        joins.append((dev, done, res))
    for dev, done, res in joins:
        caller = torch.cuda.current_stream(dev)
        caller.wait_event(done)
        for t in _tensors(res):
            if t.device.type == "cuda":
                t.record_stream(torch.cuda.current_stream(t.device))
    return out


def _dest(parts, device):
    return torch.device(device) if device is not None else parts[0].device


def all_gather(parts, *, tiled: bool = False, device=None, axis: int = 0):
    """The per-position tensors gathered onto ``device``: stacked along a
    new axis ``axis`` (``jax.lax.all_gather(..., tiled=False)``), or, with
    ``tiled``, concatenated along ``axis`` -- contiguous blocks of
    positions restore the order they were cut from."""
    out = _gather(parts, tiled=tiled, device=device, axis=axis)
    if len(parts) > 1:
        _note("all-gather", out)
    return out


def _gather(parts, *, tiled=False, device=None, axis=0):
    dest = _dest(parts, device)
    moved = [p.to(dest) for p in parts]
    return torch.cat(moved, axis) if tiled else torch.stack(moved, axis)


def pmin(parts, *, device=None):
    """Elementwise minimum over the positions' tensors, on ``device``."""
    out = torch.amin(_gather(parts, device=device), dim=0)
    if len(parts) > 1:
        _note("all-reduce", parts[0])
    return out


def psum(parts, *, device=None):
    """Elementwise sum over the positions' tensors, on ``device``."""
    out = torch.sum(_gather(parts, device=device), dim=0)
    if len(parts) > 1:
        _note("all-reduce", parts[0])
    return out


def scatter(tensor, sharding, *, source=None) -> np.ndarray:
    """Each position's shard of ``tensor`` under ``sharding`` (a
    :class:`repro_torch.parallel.placement.NamedSharding`), on the
    position's device: an object array shaped like the mesh.  A shard on
    ``tensor``'s own device is a view of it; ``source`` (a position's
    coordinates) is the position that holds ``tensor`` and receives
    nothing."""
    mesh = sharding.mesh
    out = np.empty(mesh.devices.shape, dtype=object)
    views = {}
    for coord in np.ndindex(mesh.devices.shape):
        block = sharding.block_index(tensor.dim(), coord)
        if block not in views:
            views[block] = tensor[sharding.slices(tensor.shape, coord)]
        out[coord] = views[block].to(mesh.devices[coord])
    if mesh.size > 1:
        _note("collective-permute", out.flat[0],
              mesh.size - (source is not None))
    return out


# ----------------------------------------------------------------------
# collectives across positions, to every position, with gradients
# ----------------------------------------------------------------------


class PositionGroup:
    """The positions (mesh coordinates, in order) one collective joins.
    A group made inside :func:`record_collectives` notes its collectives
    there, under ``part``, from whatever thread runs them."""

    def __init__(self, mesh, coords, *, part=None):
        self.mesh = mesh
        self.coords = [tuple(int(i) for i in c) for c in coords]
        self.devices = [mesh.devices[c] for c in self.coords]
        self.keys = [int(np.ravel_multi_index(c, mesh.devices.shape))
                     for c in self.coords]
        self.log = getattr(_NOTES, "log", None)
        self.part = part

    @property
    def size(self) -> int:
        return len(self.coords)

    def note(self, kind: str, nbytes: int) -> None:
        if self.log is not None and self.size > 1:
            self.log.append(Note(kind, nbytes, self.size, self.part))

    def run(self, fn, *args) -> list:
        """``[fn(i, device_i, args[0][i], ...)]``, each under its
        position's stream (:func:`per_position`)."""
        return _run(self.mesh, self.keys, self.devices, fn, args)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _acc_dtype(dtype):
    return torch.float32 if dtype in (torch.bfloat16, torch.float16) \
        else dtype


def _sum_at(parts, dev, pick=None):
    """``sum(pick(p).to(dev) for p in parts)`` in position order, in f32
    for a 16-bit type, cast back; a new tensor."""
    pick = pick or (lambda j, p: p)
    dtype = parts[0].dtype
    acc_t = _acc_dtype(dtype)
    acc = pick(0, parts[0]).to(dev, dtype=acc_t, copy=True)
    for j in range(1, len(parts)):
        acc.add_(pick(j, parts[j]).to(dev, dtype=acc_t))
    return acc.to(dtype)


def _reduce_each(group, parts):
    group.note("all-reduce", _nbytes(parts[0]))
    return group.run(lambda i, dev: _sum_at(parts, dev))


def _gather_each(group, parts, axis):
    out = group.run(lambda i, dev: torch.cat([p.to(dev) for p in parts],
                                             axis))
    group.note("all-gather", _nbytes(out[0]))
    return out


def _scatter_each(group, parts, axis):
    group.note("reduce-scatter", _nbytes(parts[0]))
    k = parts[0].shape[axis] // group.size

    def at(i, dev):
        return _sum_at(parts, dev,
                       lambda j, p: p.narrow(axis, i * k, k)).contiguous()

    return group.run(at)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *parts):
        ctx.group = group
        return tuple(_reduce_each(group, parts))

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + tuple(_reduce_each(ctx.group, grads))


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, axis, *parts):
        ctx.group, ctx.axis = group, axis
        return tuple(_gather_each(group, parts, axis))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(_scatter_each(ctx.group, grads, ctx.axis))


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, axis, *parts):
        ctx.group, ctx.axis = group, axis
        return tuple(_scatter_each(group, parts, axis))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(_gather_each(ctx.group, grads, ctx.axis))


def _check(group, parts):
    if len(parts) != group.size:
        raise ValueError(f"{len(parts)} parts for a group of {group.size} "
                         f"positions")


def all_reduce(group: PositionGroup, parts) -> list:
    """The sum of the positions' tensors at every position (its backward:
    the gradients' all-reduce).  A group of one returns its part."""
    _check(group, parts)
    if group.size == 1:
        return list(parts)
    return list(_AllReduce.apply(group, *parts))


def all_gather_each(group: PositionGroup, parts, axis: int) -> list:
    """The positions' tensors concatenated along ``axis`` in position
    order, at every position (its backward: the gradients'
    reduce-scatter)."""
    _check(group, parts)
    if group.size == 1:
        return list(parts)
    return list(_AllGather.apply(group, axis, *parts))


def reduce_scatter(group: PositionGroup, parts, axis: int) -> list:
    """The sum of the positions' tensors, cut into ``group.size`` equal
    blocks along ``axis``: position ``i`` receives block ``i`` (its
    backward: the gradients' all-gather).  The dimension must divide."""
    _check(group, parts)
    if group.size == 1:
        return list(parts)
    if parts[0].shape[axis] % group.size:
        raise ValueError(f"dimension {parts[0].shape[axis]} does not split "
                         f"over {group.size} positions")
    return list(_ReduceScatter.apply(group, axis, *parts))


@torch.no_grad()
def all_max(group: PositionGroup, parts) -> list:
    """The elementwise maximum of the positions' tensors at every
    position, with no gradient."""
    _check(group, parts)
    if group.size == 1:
        return [p.detach() for p in parts]
    group.note("all-reduce", _nbytes(parts[0]))

    def at(i, dev):
        acc = parts[0].detach().to(dev, copy=True)
        for p in parts[1:]:
            acc = torch.maximum(acc, p.detach().to(dev))
        return acc

    return group.run(at)
