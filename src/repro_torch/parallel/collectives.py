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

Accounting: under :func:`record_collectives` every collective of more
than one position is noted as (kind under the JAX package's HLO names,
payload bytes a receiving position, receiving positions): ``all_gather``
as ``all-gather`` (its output), ``psum``/``pmin`` as ``all-reduce`` (one
part), :func:`scatter` as ``collective-permute`` (a shard to each
position but the source).  The dry run reads its collective bytes from
these notes (``launch/dryrun.py``); a collective of one position moves
nothing and is not noted, as XLA drops a collective over a group of one.
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np
import torch

__all__ = ["per_position", "all_gather", "pmin", "psum", "scatter",
           "record_collectives"]

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


def _note(kind: str, t: torch.Tensor, receivers: int = 1) -> None:
    log = getattr(_NOTES, "log", None)
    if log is not None and receivers > 0:
        log.append((kind, t.numel() * t.element_size(), receivers))


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
        stream = mesh.stream(i, dev)
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
