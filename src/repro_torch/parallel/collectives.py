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
"""
from __future__ import annotations

import torch

__all__ = ["per_position", "all_gather", "pmin", "psum"]


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


def all_gather(parts, *, tiled: bool = False, device=None):
    """The per-position tensors gathered onto ``device``: stacked along a
    new leading axis (``jax.lax.all_gather(..., tiled=False)``), or, with
    ``tiled``, concatenated along axis 0 -- contiguous blocks of positions
    restore the order they were cut from."""
    dest = _dest(parts, device)
    moved = [p.to(dest) for p in parts]
    return torch.cat(moved) if tiled else torch.stack(moved)


def pmin(parts, *, device=None):
    """Elementwise minimum over the positions' tensors, on ``device``."""
    return torch.amin(all_gather(parts, device=device), dim=0)


def psum(parts, *, device=None):
    """Elementwise sum over the positions' tensors, on ``device``."""
    return torch.sum(all_gather(parts, device=device), dim=0)
