"""Flat Ball-Tree / BC-Tree construction (paper Algorithms 1, 2, 4).

Construction runs on the host in numpy -- one-time O(d n log n) index-build
work that is sequential by nature -- and is the same code as the JAX
package's, so the same data and seed give bit-identical arrays.  The result
is a :class:`FlatTree` of torch tensors:

  * nodes in preorder: ``centers (m,d)``, ``radii (m,)``, ``counts (m,)``,
    ``left/right (m,)`` child ids (-1 for leaves), ``node_leaf (m,)`` leaf
    slot (-1 for internal nodes);
  * leaves padded to exactly ``n0`` points; leaf ``j`` owns rows
    ``[j*n0, (j+1)*n0)`` of the reordered ``points`` (pad rows are zeros
    with ``point_ids == -1``) -- leaves are the sweep's tiles;
  * BC-Tree cone tables aligned with ``points``: ``rx = ||x - N.c||``,
    ``xcos = ||x|| cos(phi_x)``, ``xsin = ||x|| sin(phi_x)``; within a leaf
    points are sorted by descending ``rx`` (Alg. 4 line 9).

Internal-node centers come from the children's by the linearity of the
centroid (Lemma 1, Alg. 4 line 16).  Ids stay int32 (the on-disk format
depends on it); searches cast them to int64 only to index.
"""
from __future__ import annotations

import dataclasses
import functools
import sys

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["FlatTree", "build_tree", "append_ones", "normalize_query",
           "leaf_pad_quantum", "pad_tree_leaves", "built_leaves"]


def append_ones(data: np.ndarray) -> np.ndarray:
    """Paper Section II: x = (p; 1)."""
    n = data.shape[0]
    return np.concatenate([data, np.ones((n, 1), dtype=data.dtype)], axis=1)


def normalize_query(q: np.ndarray) -> np.ndarray:
    """Rescale hyperplane coefficients so ||q[:-1]|| = 1 (paper Section II)."""
    q = np.asarray(q, dtype=np.float64)
    scale = np.linalg.norm(q[..., :-1], axis=-1, keepdims=True)
    scale = np.where(scale == 0, 1.0, scale)
    return (q / scale).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class FlatTree:
    """Flattened Ball/BC-Tree: tensor fields plus static ints."""

    # --- node arrays (length m, preorder) ---
    centers: torch.Tensor  # (m, d) f32
    radii: torch.Tensor  # (m,) f32
    counts: torch.Tensor  # (m,) i32  -- |N|
    left: torch.Tensor  # (m,) i32  -- child node id or -1
    right: torch.Tensor  # (m,) i32
    node_leaf: torch.Tensor  # (m,) i32  -- leaf slot or -1
    # --- leaf arrays (length L = num leaves) ---
    leaf_centers: torch.Tensor  # (L, d) f32
    leaf_radii: torch.Tensor  # (L,) f32
    leaf_cnorm: torch.Tensor  # (L,) f32  -- ||leaf center|| (clamped)
    # --- point arrays (length L * n0, leaf-tiled) ---
    points: torch.Tensor  # (L*n0, d) f32, zero pad rows
    point_ids: torch.Tensor  # (L*n0,) i32, -1 for pad
    rx: torch.Tensor  # (L*n0,) f32, descending within each leaf (pad = -1)
    xcos: torch.Tensor  # (L*n0,) f32
    xsin: torch.Tensor  # (L*n0,) f32
    # --- static metadata ---
    n0: int = dataclasses.field(metadata=dict(static=True))
    n: int = dataclasses.field(metadata=dict(static=True))
    d: int = dataclasses.field(metadata=dict(static=True))
    num_nodes: int = dataclasses.field(metadata=dict(static=True))
    num_leaves: int = dataclasses.field(metadata=dict(static=True))
    max_depth: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def array_names() -> list[str]:
        return [f.name for f in dataclasses.fields(FlatTree)
                if not f.metadata.get("static", False)]

    @staticmethod
    def static_names() -> list[str]:
        return [f.name for f in dataclasses.fields(FlatTree)
                if f.metadata.get("static", False)]

    @classmethod
    def from_numpy(cls, arrays: dict, statics: dict) -> "FlatTree":
        """A host tree from numpy arrays (e.g. the JAX package's tree, or an
        ``.npz`` member dict) and the static ints."""
        return cls(**{name: torch.from_numpy(np.array(arrays[name]))
                      for name in cls.array_names()},
                   **{name: int(statics[name]) for name in cls.static_names()})

    def to_numpy(self) -> dict:
        return {name: getattr(self, name).cpu().numpy()
                for name in self.array_names()}

    def statics(self) -> dict:
        return {name: getattr(self, name) for name in self.static_names()}

    @property
    def device(self) -> torch.device:
        return self.points.device

    @functools.cached_property
    def points_padded(self) -> torch.Tensor:
        """``points`` with zero columns up to a multiple of 4 (16-byte rows
        for the sweep kernel's loads; zero columns change no product), made
        once per tree on first use and kept beside ``points``; ``points``
        itself when ``d`` is a multiple of 4 already."""
        pad = -self.d % 4
        return F.pad(self.points, (0, pad)) if pad else self.points

    def with_point_ids(self, point_ids) -> "FlatTree":
        """The same tree with another ``point_ids`` plane (tombstones): the
        geometry tensors are shared, and so is the padded points plane
        when it was made already."""
        out = dataclasses.replace(self, point_ids=point_ids)
        if "points_padded" in self.__dict__:
            out.__dict__["points_padded"] = self.__dict__["points_padded"]
        return out

    def to(self, device) -> "FlatTree":
        return dataclasses.replace(
            self, **{name: getattr(self, name).to(device)
                     for name in self.array_names()})

    def index_bytes(self, bc: bool = True) -> int:
        """Index size in bytes (Table III metric): nodes + the reordered
        layout's ids; BC-Tree adds the three n-sized cone/radius tables
        (Theorem 6: O(nd + 3n)).  The data points count as data."""
        node_bytes = sum(getattr(self, name).nbytes for name in (
            "centers", "radii", "counts", "left", "right", "node_leaf",
            "point_ids"))
        if bc:
            node_bytes += self.rx.nbytes + self.xcos.nbytes + self.xsin.nbytes
        return int(node_bytes)


# ----------------------------------------------------------------------
# Construction
# ----------------------------------------------------------------------


def _split(points: np.ndarray, idx: np.ndarray, rng: np.random.Generator):
    """Paper Algorithm 2 (seed-grow rule) with a degenerate-split guard."""
    sub = points[idx]
    v = sub[rng.integers(len(idx))]
    xl = sub[np.argmax(((sub - v) ** 2).sum(axis=1))]
    xr = sub[np.argmax(((sub - xl) ** 2).sum(axis=1))]
    dl = ((sub - xl) ** 2).sum(axis=1)
    dr = ((sub - xr) ** 2).sum(axis=1)
    left_mask = dl <= dr
    if left_mask.all() or (~left_mask).all():
        # all points coincide (duplicates) -- split in half arbitrarily
        half = len(idx) // 2
        left_mask = np.zeros(len(idx), dtype=bool)
        left_mask[:half] = True
    return idx[left_mask], idx[~left_mask]


def build_tree(
    data: np.ndarray,
    n0: int = 256,
    *,
    seed: int = 0,
    append_one: bool = True,
    dtype=np.float32,
) -> FlatTree:
    """Build a flat BC-Tree (superset of Ball-Tree) on the host.

    Args:
      data: (n, d-1) raw points, or (n, d) if ``append_one=False``.
      n0: max leaf size == sweep tile size.
    Returns a host :class:`FlatTree`; move it with ``.to(device)``.
    """
    data = np.asarray(data, dtype=np.float64)
    if append_one:
        data = append_ones(data)
    n, d = data.shape
    rng = np.random.default_rng(seed)

    nodes = []  # (center, radius, count, left, right, leaf_slot, depth)
    leaf_point_idx: list[np.ndarray] = []

    sys.setrecursionlimit(max(10000, sys.getrecursionlimit()))
    max_depth = [0]

    def rec(idx: np.ndarray, depth: int) -> int:
        node_id = len(nodes)
        nodes.append(None)  # reserve preorder slot
        max_depth[0] = max(max_depth[0], depth)
        sub = data[idx]
        if len(idx) <= n0:  # leaf
            center = sub.mean(axis=0)
            radius = float(np.sqrt(((sub - center) ** 2).sum(axis=1).max()))
            slot = len(leaf_point_idx)
            leaf_point_idx.append(idx)
            nodes[node_id] = (center, radius, len(idx), -1, -1, slot, depth)
        else:
            li, ri = _split(data, idx, rng)
            lid = rec(li, depth + 1)
            rid = rec(ri, depth + 1)
            # Lemma 1: centroid linearity (BC-Tree Alg. 4 line 16)
            cl, nl = nodes[lid][0], nodes[lid][2]
            cr, nr = nodes[rid][0], nodes[rid][2]
            center = (cl * nl + cr * nr) / (nl + nr)
            radius = float(np.sqrt(((sub - center) ** 2).sum(axis=1).max()))
            nodes[node_id] = (center, radius, len(idx), lid, rid, -1, depth)
        return node_id

    rec(np.arange(n), 0)

    m = len(nodes)
    L = len(leaf_point_idx)
    centers = np.zeros((m, d), dtype=dtype)
    radii = np.zeros((m,), dtype=dtype)
    counts = np.zeros((m,), dtype=np.int32)
    left = np.full((m,), -1, dtype=np.int32)
    right = np.full((m,), -1, dtype=np.int32)
    node_leaf = np.full((m,), -1, dtype=np.int32)
    for i, (c, r, cnt, lc, rc, slot, _) in enumerate(nodes):
        centers[i] = c
        radii[i] = r
        counts[i] = cnt
        left[i] = lc
        right[i] = rc
        node_leaf[i] = slot

    points = np.zeros((L * n0, d), dtype=dtype)
    point_ids = np.full((L * n0,), -1, dtype=np.int32)
    rx = np.full((L * n0,), -1.0, dtype=dtype)  # pad sorts to the end (desc)
    xcos = np.zeros((L * n0,), dtype=dtype)
    xsin = np.zeros((L * n0,), dtype=dtype)
    leaf_centers = np.zeros((L, d), dtype=dtype)
    leaf_radii = np.zeros((L,), dtype=dtype)

    leaf_node_ids = np.where(node_leaf >= 0)[0]
    for node_id in leaf_node_ids:
        slot = int(node_leaf[node_id])
        idx = leaf_point_idx[slot]
        c = np.asarray(nodes[node_id][0])
        sub = data[idx]
        r_x = np.sqrt(((sub - c) ** 2).sum(axis=1))
        order = np.argsort(-r_x, kind="stable")  # descending rx (Alg. 4 l.9)
        idx, sub, r_x = idx[order], sub[order], r_x[order]
        xn = np.sqrt((sub**2).sum(axis=1))
        cn = max(float(np.sqrt((c**2).sum())), 1e-12)
        x_cos = (sub @ c) / cn  # ||x|| cos(phi_x)
        x_sin = np.sqrt(np.maximum(xn**2 - x_cos**2, 0.0))
        s, e = slot * n0, slot * n0 + len(idx)
        points[s:e] = sub
        point_ids[s:e] = idx
        rx[s:e] = r_x
        xcos[s:e] = x_cos
        xsin[s:e] = x_sin
        leaf_centers[slot] = c
        leaf_radii[slot] = nodes[node_id][1]

    leaf_cnorm = np.maximum(
        np.sqrt((leaf_centers.astype(np.float64) ** 2).sum(axis=1)), 1e-12
    ).astype(dtype)

    arrays = dict(
        centers=centers, radii=radii, counts=counts, left=left, right=right,
        node_leaf=node_leaf, leaf_centers=leaf_centers, leaf_radii=leaf_radii,
        leaf_cnorm=leaf_cnorm, points=points, point_ids=point_ids, rx=rx,
        xcos=xcos, xsin=xsin)
    statics = dict(n0=n0, n=n, d=d, num_nodes=m, num_leaves=L,
                   max_depth=max_depth[0])
    return FlatTree.from_numpy(arrays, statics)


def built_leaves(tree: FlatTree) -> int:
    """Leaf count of the *built* tree, excluding :func:`pad_tree_leaves`
    padding (pad leaves own no node)."""
    return int(tree.node_leaf.max()) + 1


def leaf_pad_quantum(num_leaves: int) -> int:
    """Leaf-count quantum for :func:`pad_tree_leaves`: coarser as trees
    grow."""
    if num_leaves <= 128:
        return 8
    if num_leaves <= 512:
        return 16
    return 32


def pad_tree_leaves(tree: FlatTree, num_leaves: int) -> FlatTree:
    """Pad ``tree``'s leaf/point arrays to ``num_leaves`` leaf slots.

    Pad leaves replicate leaf 0's geometry but hold no valid points
    (``point_ids == -1``, ``rx == -1``), so every search treats them as
    skippable and exact results equal the unpadded tree's.  The node arrays
    are untouched: no node references a pad leaf, so the DFS never sees one.
    """
    pl = num_leaves - tree.num_leaves
    if pl <= 0:
        return tree
    n0 = tree.n0

    def padl(a):  # leaf arrays: replicate row 0 geometry
        return torch.cat([a, a[:1].expand((pl,) + tuple(a.shape[1:]))])

    def padp(a, fill):  # point rows: empty tiles
        return torch.cat([a, a.new_full((pl * n0,) + tuple(a.shape[1:]),
                                        fill)])

    return dataclasses.replace(
        tree,
        leaf_centers=padl(tree.leaf_centers),
        leaf_radii=padl(tree.leaf_radii),
        leaf_cnorm=padl(tree.leaf_cnorm),
        points=padp(tree.points, 0.0),
        point_ids=padp(tree.point_ids, -1),
        rx=padp(tree.rx, -1.0),  # pad sorts to the end (desc)
        xcos=padp(tree.xcos, 0.0),
        xsin=padp(tree.xsin, 0.0),
        num_leaves=num_leaves,
    )
