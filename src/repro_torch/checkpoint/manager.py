"""Atomic checkpoints of nested dicts/lists of arrays, in the JAX package's
on-disk format.

A checkpoint is written to ``step_N.tmp/`` -- one ``leaf_<i>.npy`` per
array and a ``manifest.json`` with each leaf's shape, dtype and sha256 --
and renamed to ``step_N/`` only after every file is fsync'd, so a save
killed midway never leaves a checkpoint that a restore would pick up.  A
save over an existing ``step_N/`` moves it aside to ``prev_step_N/`` (a
name both packages' ``all_steps`` skip) before the rename and removes it
only after, and a manager opened on the directory puts back an aside
whose ``step_N/`` never landed: a kill between the two renames leaves the
old ``step_N``, never only an older step.

Leaves are numbered in ``jax.tree_util``'s order -- dict keys sorted, lists
in order -- so a checkpoint written by either package reads in the other
(:func:`flatten` / :func:`unflatten` stand in for the pytree utilities).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.parallel.placement import PlacedTensor, device_put

__all__ = ["CheckpointManager", "write_json_atomic", "read_json",
           "fsync_dir", "flatten", "unflatten"]

#: the name a step being rewritten is moved aside to; it does not start
#: with ``step_``, so neither package's ``all_steps`` reads it
_ASIDE = "prev_step_"


def fsync_dir(path: str) -> None:
    """fsync a directory: a rename is durable only once the parent
    directory's metadata is flushed.  Best-effort on filesystems that
    refuse a directory fsync."""
    fd = os.open(path or ".", getattr(os, "O_DIRECTORY", os.O_RDONLY))
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_json_atomic(path: str, obj: Any) -> None:
    """Write a JSON document through an fsync'd tmp file, a rename and a
    parent-directory fsync: a reader never sees a torn document."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path))


def read_json(path: str) -> Any:
    with open(path) as fh:
        return json.load(fh)


def flatten(tree) -> list:
    """The leaves of nested dicts/lists, in ``jax.tree_util`` order (dict
    keys sorted, lists in order)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in flatten(tree[key])]
    if isinstance(tree, list):
        return [leaf for sub in tree for leaf in flatten(sub)]
    return [tree]


def unflatten(skeleton, leaves):
    """Fill ``skeleton`` (nested dicts/lists, any leaf values) with
    ``leaves`` in :func:`flatten`'s order."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            return {key: fill(node[key]) for key in sorted(node)}
        if isinstance(node, list):
            return [fill(sub) for sub in node]
        return next(it)

    out = fill(skeleton)
    if next(it, None) is not None:
        raise ValueError("more leaves than the skeleton holds")
    return out


def _treedef_str(tree) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))`` prints
    it, for the manifest's ``treedef`` field."""
    def rec(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"'{key}': {rec(node[key])}"
                                   for key in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(rec(sub) for sub in node) + "]"
        return "*"
    return f"PyTreeDef({rec(tree)})"


def _host(x) -> tuple[np.ndarray, str]:
    """A leaf as a host array of its own and the dtype its manifest
    records.  numpy has no bf16: a bf16 tensor is stored as its uint16
    bits under ``"bfloat16"``, as the JAX package stores one."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return np.array(x.view(torch.int16).numpy().view(np.uint16)), \
                "bfloat16"
        arr = np.array(x.numpy())
    else:
        arr = np.array(x)
    return arr, str(arr.dtype)


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """The inverse of :func:`_host`."""
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: list[BaseException] = []
        self._restore_asides()

    def _restore_asides(self):
        """Finish or undo a rewrite of a step that a kill interrupted: an
        aside whose new ``step_N`` landed is removed, one whose new step
        did not is renamed back to ``step_N``."""
        for name in os.listdir(self.dir):
            if not name.startswith(_ASIDE):
                continue
            aside = os.path.join(self.dir, name)
            final = os.path.join(self.dir, "step_" + name[len(_ASIDE):])
            if os.path.exists(os.path.join(final, "manifest.json")):
                shutil.rmtree(aside, ignore_errors=True)
            else:
                os.rename(aside, final)
                fsync_dir(self.dir)

    # ------------------------------------------------------------------
    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error.pop()

    def save(self, step: int, tree: Any, *, blocking: bool = False,
             extra_meta: dict | None = None):
        """Atomic save of nested dicts/lists of arrays (numpy or torch),
        in a background thread unless ``blocking``.  ``extra_meta``: a
        JSON-serialisable dict stored under the manifest's ``"extra"`` key
        (the non-array state a caller needs to rebuild its structure)."""
        self.wait()
        host = [_host(x) for x in flatten(tree)]  # decoupled copies
        treedef_str = _treedef_str(tree)

        def write():
            try:
                tmp = os.path.join(self.dir, f"step_{step}.tmp")
                final = os.path.join(self.dir, f"step_{step}")
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp)
                manifest = {"step": step, "treedef": treedef_str,
                            "leaves": [], "time": time.time()}
                if extra_meta is not None:
                    manifest["extra"] = extra_meta
                for i, (arr, dtype) in enumerate(host):
                    np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
                    manifest["leaves"].append({
                        "shape": list(arr.shape),
                        "dtype": dtype,
                        "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
                    })
                with open(os.path.join(tmp, "manifest.json"), "w") as fh:
                    json.dump(manifest, fh)
                    fh.flush()
                    os.fsync(fh.fileno())
                aside = os.path.join(self.dir, f"{_ASIDE}{step}")
                if os.path.isdir(final):  # a rewrite: the old step stays
                    os.rename(final, aside)  # whole until the new is in
                os.rename(tmp, final)
                fsync_dir(self.dir)  # make the rename itself durable
                shutil.rmtree(aside, ignore_errors=True)
                self._gc()
            except BaseException as e:  # surfaced at the next wait()
                try:  # an old step moved aside goes back to its place
                    self._restore_asides()
                except OSError:
                    pass  # a manager opened on the directory retries it
                self._error.append(e)

        if blocking:
            write()
            if self._error:
                raise self._error.pop()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _gc(self):
        for s in sorted(self.all_steps())[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # ------------------------------------------------------------------
    def all_steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def read_manifest(self, step: int) -> dict:
        """The manifest dict of a saved step (shapes, checksums, extra)."""
        return read_json(os.path.join(self.dir, f"step_{step}",
                                      "manifest.json"))

    def restore_leaves(self, step: int, *, verify: bool = True):
        """A step's flat leaf list (numpy; a ``"bfloat16"`` leaf as its
        uint16 bits) and its manifest; the caller reassembles the structure
        (:func:`unflatten`).  Checksums are verified unless
        ``verify=False``."""
        path = os.path.join(self.dir, f"step_{step}")
        manifest = self.read_manifest(step)
        leaves = []
        for i, meta in enumerate(manifest["leaves"]):
            arr = np.load(os.path.join(path, f"leaf_{i}.npy"))
            if verify:
                digest = hashlib.sha256(arr.tobytes()).hexdigest()
                if digest != meta["sha256"]:
                    raise IOError(f"checkpoint leaf {i} corrupt "
                                  f"(sha mismatch) in {path}")
            leaves.append(arr)
        return leaves, manifest

    def restore(self, step: int, like: Any, *, shardings: Any = None,
                verify: bool = True):
        """A step as tensors in ``like``'s structure (nested dicts/lists of
        tensors or placed tensors), each leaf on the device of ``like``'s
        tensor at its place; a shape or dtype that differs from
        ``like``'s raises ``ValueError``.  ``shardings``
        (congruent with ``like``, or a flat list in its leaf order, of
        :class:`repro_torch.parallel.placement.NamedSharding` or None)
        places each leaf by its sharding instead -- the elastic path: a
        checkpoint written on any mesh, or none, restores onto this one,
        bit for bit."""
        leaves, manifest = self.restore_leaves(step, verify=verify)
        want = flatten(like)
        if len(want) != len(leaves):
            raise ValueError(f"step {step} holds {len(leaves)} leaves, the "
                             f"structure asked for {len(want)}")
        placing = ([None] * len(want) if shardings is None
                   else flatten(shardings))
        if len(placing) != len(want):
            raise ValueError(f"{len(placing)} shardings for {len(want)} "
                             f"leaves")
        out = []
        for i, (arr, meta, ref, sh) in enumerate(zip(
                leaves, manifest["leaves"], want, placing)):
            t = _tensor(arr, meta["dtype"])
            if isinstance(ref, (torch.Tensor, PlacedTensor)):
                if t.shape != tuple(ref.shape) or t.dtype != ref.dtype:
                    raise ValueError(
                        f"leaf {i}: {t.dtype} {tuple(t.shape)} against "
                        f"{ref.dtype} {tuple(ref.shape)}")
            if sh is not None:
                t = device_put(t, sh)
            elif isinstance(ref, torch.Tensor):
                t = t.to(ref.device)
            out.append(t)
        return unflatten(like, out)
