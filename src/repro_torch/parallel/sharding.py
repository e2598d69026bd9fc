"""Placement by logical axes: the mesh-independent half of the JAX
package's ``parallel/sharding.py``, over a
:class:`repro_torch.launch.mesh.DeviceMesh`.

Models record each parameter's *logical* axes ("embed", "heads", "mlp",
"vocab", ...; :class:`repro_torch.models.layers.ParamInit`), caches and
batches theirs (``cache_logical``, ``launch.steps.batch_logical``).
:data:`RULES` maps each logical axis to mesh axes, and
:func:`logical_to_spec` resolves a leaf against a mesh into a
:class:`PartitionSpec`: a dimension that the mapped mesh axes do not
divide is replicated instead, and the fallback is recorded in the
bounded, lock-guarded :data:`fallback_log` (the dry-run report's
``fallbacks``: smollm's 15 heads on a 16-way model axis, llama's 8 KV
heads).  A mesh axis is used once a spec: the first dimension that maps
to it keeps it.  :class:`repro_torch.parallel.placement.NamedSharding`
pairs a spec with a mesh, and ``placement.device_put`` splits a tensor by
it.

``shard(x, *logical)`` is the JAX package's activation constraint.
Without an ambient mesh (``launch.mesh.mesh_context``), or on a mesh of
one position, it is the identity, as there.  Under an ambient mesh it
resolves the activation's spec as the JAX package's does
(``logical_to_spec(..., name="act")``), so an activation dimension that
its mesh axes do not divide lands in :data:`fallback_log`, and returns
the tensor it was given.  The layout itself is not a property of one
tensor in the port: the placed train step under an ambient mesh runs each
mesh position on its own part of every product and joins the parts with
explicit collectives (``parallel/tensor.py``).  While it does, it names
the global sizes of the split logical axes (:func:`activation_context`),
so a position's part resolves as the whole activation would, and each
distinct activation is resolved once a forward, not once a call.  The
dry run's train cells run their forward under the ambient mesh, so
their records carry these ``"act"`` fallbacks as the JAX package's do.

The serving half keys the warm-template registries by
``mesh_signature()``, as the JAX package does: backend and visible device
count off-mesh, the mesh's axes, sizes, devices and platform on one, so a
template recorded on one topology never replays on another.
"""
from __future__ import annotations

import contextlib
import logging
import threading
from collections import deque
from typing import Any, Mapping, Sequence

import torch

from repro_torch.launch.mesh import current_mesh

logger = logging.getLogger(__name__)

__all__ = [
    "RULES", "PartitionSpec", "P", "shard", "activation_context",
    "logical_to_spec",
    "resolve_param_specs", "pad_vocab", "fallback_log", "mesh_signature",
    "mesh_devices", "is_logical",
]

# logical axis -> mesh axis (or tuple of mesh axes); None = replicated.
# "data"-like axes compose the pod axis so pure DP crosses pods.  The JAX
# package's table, entry for entry.
RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,            # activations: sequence stays unsharded by default
    "seq_res": None,        # residual stream: "model" = Megatron-style SP
    "seq_shard": "data",    # opt-in sequence sharding (long-context prefill)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "conv": None,
    "state": None,
    "rnn": "model",
    "layers": None,
    "stack": None,
    "cache_seq": None,
}


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s counterpart: one entry a dimension,
    each None (replicated), a mesh axis name, or a tuple of names (the
    dimension split over their product, the first name major)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return "PartitionSpec" + tuple.__repr__(self)

    def mesh_axes(self) -> tuple:
        """Every mesh axis the spec uses, in order."""
        out = []
        for e in self:
            out.extend((e,) if isinstance(e, str) else (e or ()))
        return tuple(out)


P = PartitionSpec


class _FallbackLog:
    """Bounded, lock-guarded record of ``(tensor_name, logical_axis, dim,
    mesh_axes)`` sharding fallbacks.

    ``logical_to_spec`` appends from whatever thread resolves a spec, so
    the log keeps the last ``maxlen`` entries (the dry-run report
    deduplicates anyway) behind a lock, counts the appends the bound
    evicted, and iterates over a snapshot taken under the lock."""

    def __init__(self, maxlen: int = 256):
        self._lock = threading.Lock()
        self._entries: deque = deque(maxlen=maxlen)
        self.dropped = 0  # appends evicted by the bound since last clear

    def append(self, entry: tuple) -> None:
        with self._lock:
            if len(self._entries) == self._entries.maxlen:
                self.dropped += 1
            self._entries.append(entry)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.dropped = 0

    def __iter__(self):
        with self._lock:
            return iter(tuple(self._entries))

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __bool__(self) -> bool:
        return len(self) > 0


#: (tensor_name, logical_axis, dim, mesh_axes) of every fallback, for the
#: dry-run report
fallback_log = _FallbackLog()


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


def _present(mesh, axes):
    """The mapped axes that ``mesh`` has: None, one name, or a tuple."""
    if axes is None:
        return None
    if isinstance(axes, str):
        axes = (axes,)
    have = tuple(a for a in axes if a in mesh.shape)
    if not have:
        return None
    return have if len(have) > 1 else have[0]


def is_logical(node) -> bool:
    """A logical-axes leaf: a tuple of axis names and Nones."""
    return isinstance(node, tuple) and all(
        isinstance(a, (str, type(None))) for a in node)


def logical_to_spec(logical: Sequence[str | None],
                    shape: Sequence[int] | None = None, mesh=None, *,
                    rules: Mapping[str, Any] | None = None,
                    name: str = "?") -> PartitionSpec:
    """Map logical axis names to a :class:`PartitionSpec` against ``mesh``
    (no mesh: every dimension replicated).

    If ``shape`` is given, a dimension that the mapped mesh-axis size does
    not divide is replicated instead, and the fallback logged.  A mesh
    axis is used once: a later dimension mapped to an axis already used is
    replicated."""
    rules = dict(RULES, **(rules or {}))
    out = []
    for i, ax in enumerate(logical):
        mapped = rules.get(ax) if ax is not None else None
        if mapped is None or mesh is None:
            out.append(None)
            continue
        mapped = _present(mesh, mapped)
        if mapped is None:
            out.append(None)
            continue
        size = _mesh_axis_size(mesh, mapped)
        if shape is not None and size and shape[i] % size != 0:
            fallback_log.append((name, ax, shape[i], mapped))
            logger.info("sharding fallback: %s axis %r dim %d !%% mesh %s",
                        name, ax, shape[i], mapped)
            out.append(None)
            continue
        out.append(mapped)
    seen: set[str] = set()
    cleaned = []
    for ax in out:
        axes = (ax,) if isinstance(ax, str) else (ax or ())
        if any(a in seen for a in axes):
            cleaned.append(None)
            continue
        seen.update(axes)
        cleaned.append(ax)
    return PartitionSpec(*cleaned)


_ACT = threading.local()


@contextlib.contextmanager
def activation_context(sizes=None, rules=None):
    """Inside the block, :func:`shard` on this thread resolves a logical
    axis named in ``sizes`` (axis -> global size) at that size, whatever
    the tensor's own dimension (a position's part of the activation), and
    takes ``rules`` when the call names none.  Each distinct activation
    (logical axes, resolved shape, mesh and rules) is resolved once a
    block, as the JAX package resolves a constraint once when it traces
    a step; the block's later calls for it return at once."""
    prev = getattr(_ACT, "ctx", None)
    _ACT.ctx = (dict(sizes or {}), rules, set())
    try:
        yield
    finally:
        _ACT.ctx = prev


def shard(x, *logical: str | None, rules: Mapping[str, Any] | None = None):
    """The activation layout constraint by logical axis names: the
    identity without an ambient mesh or on one position; under one, the
    spec is resolved (fallbacks logged under ``"act"``) and ``x`` returned
    (see the module docstring)."""
    mesh = current_mesh()
    if mesh is None or mesh.size == 1:
        return x
    sizes, ctx_rules, seen = getattr(_ACT, "ctx", None) or ({}, None, None)
    shape = tuple(sizes.get(ax, d) if ax is not None else d
                  for ax, d in zip(logical, x.shape))
    rules = rules if rules is not None else ctx_rules
    if seen is not None:
        key = (logical, shape, id(mesh), id(rules))
        if key in seen:
            return x
        seen.add(key)
    logical_to_spec(logical, shape, mesh, rules=rules, name="act")
    return x


def resolve_param_specs(logical_tree, shapes_tree, mesh, *, rules=None):
    """Resolve a tree (nested dicts) of logical-axis tuples into
    :class:`PartitionSpec`\\ s; ``shapes_tree`` is congruent, its leaves
    anything with a ``shape``.  A leaf's fallbacks are logged under its
    path, the keys joined by ``/``."""

    def walk(logical, shapes, path):
        if is_logical(logical):
            name = "/".join(str(p) for p in path)
            return logical_to_spec(logical, tuple(shapes.shape), mesh,
                                   rules=rules, name=name)
        return {k: walk(logical[k], shapes[k], path + (k,))
                for k in logical}

    return walk(logical_tree, shapes_tree, ())


def pad_vocab(vocab: int, tp: int, multiple: int = 128) -> int:
    """Megatron-style vocab padding: to a multiple of ``multiple * tp``."""
    q = multiple * max(tp, 1)
    return -(-vocab // q) * q
