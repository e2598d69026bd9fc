"""Carry parameters between the JAX package's pytree and the port's
modules.

The JAX package's ``StackedLM.init`` returns a nested dict: ``embed``,
``final_norm/{scale,bias}``, ``head`` when the embedding is untied,
``periods/slot<i>/...`` with every leaf stacked on a leading period axis,
and ``tail<i>/...`` unstacked.  The port keeps one module per layer
(``layers.<n>``, period by period, then the tail), with the same leaf names
below the layer (``ln1.scale``, ``attn.wq``, ``ssm.A_log``, ``rec.lam``,
``ffn.wi``, ``ffn.router``, ``ffn.shared.wg``, ...) and the same shapes.
The JAX package's ``WhisperED`` stacks ``enc_layers/...`` and
``dec_layers/...`` on a leading layer axis; the port's holds
``enc_layers.<n>`` and ``dec_layers.<n>``.  The two packages draw their
initial parameters from different generators, so parity tests load the
JAX package's parameters with :func:`from_reference_arrays` and read the
port's back (or its gradients, or its optimiser moments) with
:func:`to_reference_arrays`.

Decode caches the same way: the JAX package's ``StackedLM`` cache stacks
each pattern slot's leaves on the period axis (``periods/slot<i>/k``, ...,
``tail<i>/...``), its ``WhisperED`` cache stacks ``self/{k,v}`` and
``cross/{k,v}`` on the layer axis; the port's is a dict from the layer's
index to its leaves (Whisper's ``cross_k``/``cross_v`` beside ``k``/``v``).
:func:`cache_from_reference` and :func:`cache_to_reference` map them.

Placement: a port parameter's logical axes are the JAX package's less the
leading ``"stack"`` axis of a stacked leaf (the period or layer axis,
which ``RULES`` never shards).  :func:`logical_to_reference` and
:func:`specs_to_reference` put it back -- ``"stack"`` before the axes, a
None before the spec -- so the two packages' placements compare leaf for
leaf; :func:`cache_logical_to_reference` and
:func:`cache_specs_to_reference` do the same for the decode cache.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["from_reference_arrays", "to_reference_arrays",
           "cache_from_reference", "cache_to_reference",
           "logical_to_reference", "specs_to_reference",
           "cache_logical_to_reference", "cache_specs_to_reference"]


def _reference_path(cfg, name: str):
    """A port parameter name -> (its path in the JAX package's tree, its
    index on the stacked period axis or None)."""
    parts = tuple(name.split("."))
    if cfg.enc_dec and parts[0] in ("enc_layers", "dec_layers"):
        return (parts[0],) + parts[2:], int(parts[1])
    if parts[0] != "layers":
        return parts, None
    idx, rest = int(parts[1]), parts[2:]
    n = len(cfg.pattern)
    if idx < cfg.n_periods * n:
        return ("periods", f"slot{idx % n}") + rest, idx // n
    return (f"tail{idx - cfg.n_periods * n}",) + rest, None


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for key, sub in tree.items():
            yield from _leaves(sub, prefix + (key,))
    else:
        yield prefix, tree


@torch.no_grad()
def from_reference_arrays(model, tree) -> None:
    """Load the JAX package's parameter tree (numpy arrays, or anything
    ``np.asarray`` takes) into ``model`` in place; every leaf of the tree
    must land on a parameter of the same shape."""
    used = set()
    for name, p in model.named_parameters():
        path, layer = _reference_path(model.cfg, name)
        node = tree
        for key in path:
            node = node[key]
        arr = np.asarray(node)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        if layer is not None:
            arr = arr[layer]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(p.shape)} against the "
                             f"tree's {tuple(arr.shape)} at {'/'.join(path)}")
        p.copy_(torch.from_numpy(np.array(arr)).to(p.dtype))
        used.add(path)
    missing = [p for p, _ in _leaves(tree) if p not in used]
    if missing:
        raise ValueError(f"tree leaves with no parameter: {missing}")


def to_reference_arrays(model, values=None) -> dict:
    """The JAX package's tree of ``model``'s parameters, or of ``values``
    (a mapping from parameter name to tensor, e.g. gradients or optimiser
    moments), as numpy arrays; bf16 comes back as f32."""
    if values is None:
        values = dict(model.named_parameters())
    stacks: dict = {}
    tree: dict = {}
    for name, _ in model.named_parameters():
        path, layer = _reference_path(model.cfg, name)
        t = values[name].detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.numpy()
        if layer is not None:
            stacks.setdefault(path, {})[layer] = arr
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    for path, per_layer in stacks.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([per_layer[i]
                                   for i in range(len(per_layer))])
    return tree


_WHISPER_CACHE = {"k": ("self", "k"), "v": ("self", "v"),
                  "cross_k": ("cross", "k"), "cross_v": ("cross", "v")}


def _cache_paths(model):
    """(layer index, leaf name, path in the JAX package's cache, index on
    its stacked axis or None, the port's dtype) for every leaf of
    ``model``'s decode cache."""
    cfg = model.cfg
    for i, leaves in model.abstract_cache(1, 1).items():
        for name, t in leaves.items():
            if cfg.enc_dec:
                yield i, name, _WHISPER_CACHE[name], i, t.dtype
            else:
                path, layer = _reference_path(cfg, f"layers.{i}.{name}")
                yield i, name, path, layer, t.dtype


def cache_from_reference(model, tree, *, device=None) -> dict:
    """The port's decode cache from the JAX package's cache tree (numpy
    arrays, or anything ``np.asarray`` takes), each leaf in the port's
    dtype on ``device`` (the model's when None); every leaf of the tree
    must be used."""
    dev = model.device if device is None else torch.device(device)
    out: dict = {}
    used = set()
    for i, name, path, layer, dtype in _cache_paths(model):
        node = tree
        for key in path:
            node = node[key]
        arr = np.asarray(node)
        if arr.dtype.name == "bfloat16":
            arr = arr.astype(np.float32)
        if layer is not None:
            arr = arr[layer]
        out.setdefault(i, {})[name] = torch.from_numpy(np.array(arr)).to(
            device=dev, dtype=dtype)
        used.add(path)
    missing = [p for p, _ in _leaves(tree) if p not in used]
    if missing:
        raise ValueError(f"cache leaves with no counterpart: {missing}")
    return out


def cache_to_reference(model, cache) -> dict:
    """The JAX package's cache tree of the port's ``cache``, as numpy
    arrays; bf16 comes back as f32."""
    stacks: dict = {}
    tree: dict = {}
    for i, name, path, layer, _ in _cache_paths(model):
        t = cache[i][name].detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.numpy()
        if layer is not None:
            stacks.setdefault(path, {})[layer] = arr
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    for path, per_layer in stacks.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.stack([per_layer[i]
                                   for i in sorted(per_layer)])
    return tree


def _reference_tree(entries, lead) -> dict:
    """The JAX package's tree of per-leaf values from ``(path, index on
    the stacked axis or None, value)``: a stacked path's layers must agree,
    and its value becomes ``lead(value)``."""
    tree: dict = {}
    stacked: dict = {}
    for path, layer, value in entries:
        if layer is not None:
            stacked.setdefault(path, set()).add(value)
            continue
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = value
    for path, values in stacked.items():
        if len(values) != 1:
            raise ValueError(f"the layers of {'/'.join(path)} disagree: "
                             f"{sorted(map(str, values))}")
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = lead(values.pop())
    return tree


def _param_entries(model, values):
    for name, _ in model.named_parameters():
        path, layer = _reference_path(model.cfg, name)
        yield path, layer, values[name]


def _cache_entries(model, values):
    for i, name, path, layer, _ in _cache_paths(model):
        yield path, layer, values[i][name]


def logical_to_reference(model, logical: dict) -> dict:
    """The JAX package's logical-axes tree from the port's (parameter name
    -> axes): ``"stack"`` before a stacked leaf's axes."""
    return _reference_tree(_param_entries(model, logical),
                           lambda v: ("stack",) + tuple(v))


def specs_to_reference(model, specs: dict) -> dict:
    """The JAX package's tree of specs, as tuples, from the port's
    (parameter name -> spec): None (the replicated stack axis) before a
    stacked leaf's."""
    return _reference_tree(_param_entries(model, {
        k: tuple(v) for k, v in specs.items()}), lambda v: (None,) + v)


def cache_logical_to_reference(model, logical: dict) -> dict:
    """The JAX package's cache-axes tree from the port's
    (``cache_logical``)."""
    return _reference_tree(_cache_entries(model, logical),
                           lambda v: ("stack",) + tuple(v))


def cache_specs_to_reference(model, specs: dict) -> dict:
    """The JAX package's cache specs, as tuples, from the port's (layer ->
    leaf -> spec)."""
    return _reference_tree(_cache_entries(model, {
        i: {k: tuple(v) for k, v in leaves.items()}
        for i, leaves in specs.items()}), lambda v: (None,) + v)
