"""High-level P2HNNS index API of the PyTorch port.

    >>> idx = P2HIndex.build(data, n0=256, variant="bc")    # on the card
    >>> dists, ids = idx.query(q, k=10)                     # exact, DFS
    >>> dists, ids = idx.query(q, k=10, method="sweep")     # exact sweep
    >>> dists, ids = idx.query(q, k=10, method="kernel")    # exact, CUDA
    >>> dists, ids = idx.query(q, k=10, method="beam", frac=0.05)  # approx

``build`` and ``load`` put the tree on ``device`` (default: the CUDA card;
it raises when there is none -- pass ``device="cpu"`` for the host).
Queries are numpy arrays and results come back as numpy, as in the JAX
package, so code written for one runs on the other.

Variants:
  * ``"ball"`` -- plain Ball-Tree (Algorithm 3): node-level bound only.
  * ``"bc"``   -- BC-Tree (Algorithm 5): + point-level ball & cone bounds
                  and collaborative inner products.

Indexes are saved in the JAX package's format (``.npz`` with a JSON
``__header__``, ``"p2h-index"`` version 2), so a file written by either
package loads in the other.
"""
from __future__ import annotations

import dataclasses
import json
import time
import zipfile
from typing import Any

import numpy as np
import torch

from repro_torch.core import search
from repro_torch.core.balltree import FlatTree, build_tree, normalize_query
from repro_torch.kernels import ops
from repro_torch.launch.platform import resolve_device

__all__ = ["P2HIndex", "BuildReport"]

#: on-disk format: a plain ``.npz`` (one member per FlatTree array) plus a
#: ``__header__`` JSON string member carrying version / statics / report.
#: No pickle on the load path.  Readers reject unknown majors.
_FORMAT_NAME = "p2h-index"
_FORMAT_VERSION = 2


@dataclasses.dataclass
class BuildReport:
    build_seconds: float
    index_bytes: int
    num_nodes: int
    num_leaves: int
    max_depth: int


@dataclasses.dataclass
class P2HIndex:
    tree: FlatTree
    variant: str  # "ball" | "bc"
    report: BuildReport

    # ------------------------------------------------------------------
    @classmethod
    def build(
        cls,
        data: np.ndarray,
        n0: int = 256,
        *,
        variant: str = "bc",
        seed: int = 0,
        append_one: bool = True,
        device=None,
    ) -> "P2HIndex":
        if variant not in ("ball", "bc"):
            raise ValueError(f"unknown variant {variant!r}")
        device = resolve_device(device)
        t0 = time.perf_counter()
        tree = build_tree(data, n0=n0, seed=seed, append_one=append_one)
        dt = time.perf_counter() - t0
        report = BuildReport(
            build_seconds=dt,
            index_bytes=tree.index_bytes(bc=variant == "bc"),
            num_nodes=tree.num_nodes,
            num_leaves=tree.num_leaves,
            max_depth=tree.max_depth,
        )
        return cls(tree=tree.to(device), variant=variant, report=report)

    # ------------------------------------------------------------------
    def query(
        self,
        queries: np.ndarray,
        k: int = 1,
        *,
        method: str = "dfs",
        frac: float = 1.0,
        branch: str = "center",
        normalize: bool = True,
        return_stats: bool = False,
        engine: Any = None,
        **kw: Any,
    ):
        """Top-k P2HNNS. ``queries`` is (B, d) (or (d,)).

        With ``normalize=True`` the hyperplane coefficient vectors are
        rescaled so the normal has unit norm (paper Section II): distances
        are then true point-to-hyperplane distances.

        ``method``: ``"dfs"`` (default), ``"sweep"``, ``"beam"`` (with
        ``frac``) or ``"kernel"`` (the fused CUDA sweep; ``"pallas"`` is the
        same route under the JAX package's name).

        ``engine``: a :class:`repro_torch.serve.P2HEngine` to serve the call
        through (micro-batching, backend auto-dispatch, lambda warm start).
        The engine's policy picks the backend; ``method`` is ignored (use
        ``engine.query(..., method=...)`` to force a route).
        ``return_stats`` keeps the direct path's per-call counter shape
        (summed over whatever routes the call was dispatched to).
        """
        recall_target = kw.pop("recall_target", 1.0)
        if engine is not None:
            if engine.index is not self:
                raise ValueError("engine serves a different index")
            # serve anything already pending in the engine's streaming
            # queue first, so the counter delta below is this call's only
            engine.flush()
            before = engine.total_counters()
            bd, bi = engine.query(queries, k, normalize=normalize,
                                  recall_target=recall_target)
            if return_stats:
                delta = engine.total_counters() - before
                return bd, bi, search.SearchStats(delta)
            return bd, bi
        if recall_target < 1.0:
            raise ValueError(
                "recall_target needs a serving engine (engine=...) or an "
                "explicit budgeted route: method='beam', frac=...")
        q = np.atleast_2d(np.asarray(queries))
        if normalize:
            q = normalize_query(q)
        q = torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32)).to(
            self.tree.device)
        is_bc = self.variant == "bc"
        common = dict(use_ball=is_bc and kw.pop("use_ball", True),
                      use_cone=is_bc and kw.pop("use_cone", True))
        order = branch if branch == "bound" else "center"
        if method == "dfs":
            bd, bi, cnt = search.dfs_search(
                self.tree, q, k, branch=branch,
                use_collab=is_bc and kw.pop("use_collab", True),
                max_candidates=kw.pop("max_candidates", None),
                **common, **kw)
        elif method == "sweep":
            bd, bi, cnt = search.sweep_search(
                self.tree, q, k, order=order, frac=1.0, **common, **kw)
        elif method == "beam":
            bd, bi, cnt = search.sweep_search(
                self.tree, q, k, order=order, frac=frac, **common, **kw)
        elif method in ("kernel", "pallas"):
            bd, bi, cnt = ops.sweep_search_kernel(
                self.tree, q, k, frac=frac, **common, **kw)
        else:
            raise ValueError(f"unknown method {method!r}")
        bd, bi = bd.cpu().numpy(), bi.cpu().numpy()
        if return_stats:
            return bd, bi, search.SearchStats(cnt)
        return bd, bi

    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        header = {
            "format": _FORMAT_NAME,
            "version": _FORMAT_VERSION,
            "variant": self.variant,
            "report": dataclasses.asdict(self.report),
            "tree_static": self.tree.statics(),
        }
        # np.savez munges extensions when given a str path; a file object
        # writes exactly where asked.
        with open(path, "wb") as fh:
            np.savez(fh, __header__=np.asarray(json.dumps(header)),
                     **self.tree.to_numpy())

    @classmethod
    def load(cls, path: str, *, device=None) -> "P2HIndex":
        """Load an index saved by :meth:`save` (this package's or the JAX
        package's) onto ``device``.  Loading never unpickles: legacy pickle
        indexes are rejected, re-save them with the JAX package first."""
        device = resolve_device(device)
        if not zipfile.is_zipfile(path):
            raise ValueError(
                f"{path} is not a {_FORMAT_NAME} .npz file (legacy pickle "
                "indexes are not read here: load and re-save them with the "
                "JAX package)")
        with np.load(path, allow_pickle=False) as z:
            header = json.loads(str(z["__header__"][()]))
            if header.get("format") != _FORMAT_NAME:
                raise ValueError(f"{path}: not a {_FORMAT_NAME} file")
            if header.get("version", 0) > _FORMAT_VERSION:
                raise ValueError(
                    f"{path}: format version {header['version']} is newer "
                    f"than this reader ({_FORMAT_VERSION})")
            arrays = {k: z[k] for k in z.files if k != "__header__"}
        tree = FlatTree.from_numpy(arrays, header["tree_static"])
        return cls(tree=tree.to(device), variant=header["variant"],
                   report=BuildReport(**header["report"]))
