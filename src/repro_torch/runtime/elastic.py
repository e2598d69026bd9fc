"""Elastic scaling: move a run to another mesh shape -- the JAX package's
``runtime/elastic.py``.

Checkpoints are mesh-independent (whole leaves, and the logical axes live
on the model), so changing the mesh between runs needs only:

  1. build the new mesh,
  2. resolve the logical axes against it (the divisibility fallbacks are
     judged again: 15 heads shard on a 5-way model axis, not a 16-way),
  3. ``CheckpointManager.restore(..., shardings=specs_for_mesh(...))``.

:func:`elastic_remesh` moves a live tree -- plain tensors or
:class:`repro_torch.parallel.placement.PlacedTensor`\\ s on any mesh -- onto
a new mesh while the run goes on, bit for bit: each leaf is gathered
whole and split again (``placement.device_put``).

Trees are nested dicts and lists; a logical leaf is a tuple of axis names
and Nones (``sharding.is_logical``), and the shapes tree holds anything
with a ``shape`` (tensors, ``meta`` tensors, placed tensors).
"""
from __future__ import annotations

from repro_torch.parallel.placement import NamedSharding, device_put
from repro_torch.parallel.sharding import is_logical, logical_to_spec

__all__ = ["elastic_remesh", "specs_for_mesh", "tree_map"]


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of nested dicts and lists (``rest``
    congruent with ``tree``); ``is_leaf`` stops the descent early."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def specs_for_mesh(logical_tree, shapes_tree, mesh, rules=None):
    """A tree of :class:`NamedSharding` for ``mesh`` from logical axis
    names; a leaf's fallbacks are logged under its key."""

    def paths(tree, prefix=()):
        if is_logical(tree):
            return "/".join(str(p) for p in prefix)
        if isinstance(tree, dict):
            return {k: paths(v, prefix + (k,)) for k, v in tree.items()}
        return [paths(v, prefix + (i,)) for i, v in enumerate(tree)]

    def one(logical, shaped, name):
        spec = logical_to_spec(logical, tuple(shaped.shape), mesh,
                               rules=rules, name=name)
        return NamedSharding(mesh, spec)

    return tree_map(one, logical_tree, shapes_tree, paths(logical_tree),
                    is_leaf=is_logical)


def elastic_remesh(tree, logical_tree, new_mesh, rules=None):
    """Place a live tree on ``new_mesh`` by its logical axes, bit for
    bit; returns the tree of placed tensors."""
    shardings = specs_for_mesh(logical_tree, tree, new_mesh, rules)
    return tree_map(lambda sh, x: device_put(x, sh), shardings, tree,
                    is_leaf=lambda t: isinstance(t, NamedSharding))
