"""Segment-parallel P2H sweep: N stacked leaf tile-sets, one launch.

The mutable index's read path (:mod:`repro_torch.stream`) holds a snapshot
of several sealed segments.  Walking them one by one re-serialises the
paper's pruning on the host; this module stacks their leaf arrays into one
padded ``(N, L, n0, d)`` tile grid (a :class:`StackedLeaves`, cached per
snapshot because segments are sealed) and sweeps all of them in one launch
of the stacked kernel (``csrc/stacked_sweep.cu``, wrapper
:func:`stacked_sweep`).  Inside the launch each query block walks the
segments in order and carries an in-launch global top-k of values from one
segment to the next, so later segments prune against the earlier ones'
distances.

The serving form is the **two-pass** program :func:`_run_stacked`: pass A
("probe") sweeps only the first ``probe_tiles`` preference-ordered tiles of
every segment under the entry cap; :func:`repro_torch.core.search.
merge_topk_planes` reduces the per-segment probe planes to one tightened
cap ``lambda_probe``; pass B sweeps the remaining tiles under it, seeded
with pass A's per-segment top-k so probed tiles are never rescanned; the
cross-segment merge with the delta's candidates finishes the answer.  The
probe may score a bf16 or int8 copy of the tiles (``probe_dtype``), each
score widened by a conservative quantisation slack; pass B then rescans
the whole visit list in f32, so answers stay exact.  Pad tiles (ragged
segments padded to a common tile count) and dead tiles (every point
tombstoned) carry a ``+inf`` node bound: always skipped, always counted.

Exactness: the entry cap (the delta scan's k-th, or an external valid cap)
bounds the global k-th from above; the probe's merged k-th is the distance
of k real scanned points (or, widened, an upper bound on them), hence a
valid cap too; pruning against ``min(cap, running k-th)`` only discards
candidates that cannot enter the merged top-k.

Where it runs: the device of the tensors decides.  CUDA tensors launch the
kernel (or raise); host tensors run its plain version,
:func:`repro_torch.kernels.ref.stacked_sweep_ref`.  The port pads ``d`` to
a multiple of 4 (16-byte rows) for the kernel, where the JAX package pads
to the TPU's lane width of 128; the plain version on the host keeps the
true ``d``, as the JAX package's reference path does.

On a serving mesh (``mesh=``, a :class:`repro_torch.launch.mesh.DeviceMesh`
with more than one position along ``mesh_axis``) the program is
:func:`_run_stacked` over one part per position: every position sweeps its
own contiguous block of segments, and the probe hand-off and the final merge become gathers
between the positions' launches.  The answers equal the single launch's
bit for bit; only the skip counters may differ.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import threading
import weakref

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import bounds
from repro_torch.kernels import _build, p2h_scan, ref
from repro_torch.launch.platform import ensure_full_precision
from repro_torch.parallel.collectives import all_gather, per_position
from repro_torch.parallel.sharding import mesh_signature

__all__ = ["StackedLeaves", "stacked_sweep", "stacked_sweep_search",
           "stacked_sweep_query", "prepare_stacked_operands",
           "concat_cached", "tile_density", "resolve_probe_tiles",
           "resolve_probe_dtype", "quantization_slack",
           "probe_bytes_per_tile", "warm_stacked", "stacked_compile_stats",
           "reset_stacked_compile_stats", "STACKED_FANOUT_DEFAULT",
           "STACKED_DENSITY_DEFAULT", "STACKED_PROBE_TILES_DEFAULT",
           "STACKED_PROBE_TILES_ROUND2_DEFAULT", "PROBE_DTYPES"]

_PAD = 4  # the kernel's row unit: 16-byte f32 rows
_INF = float("inf")

#: segment fan-out at/above which exact sweeps auto-promote to the stacked
#: launch (``Snapshot.query``).
STACKED_FANOUT_DEFAULT = 4

#: minimum live-tile fraction of the common grid for auto-promotion: a
#: heavily ragged stack spends most of the launch on pad tiles.
STACKED_DENSITY_DEFAULT = 0.5

#: default probe-pass width of the two-pass sweep (tiles per segment and
#: query block swept under the entry cap before the cap is tightened).
STACKED_PROBE_TILES_DEFAULT = 4

#: probe-pass width for round 2 of the two-round exchange: 0 (one pass),
#: since round 2 already enters with the exchange's merged cap.
STACKED_PROBE_TILES_ROUND2_DEFAULT = 0

#: probe-pass precisions: all-f32, or a bf16/int8 probe whose scores are
#: widened by :func:`quantization_slack` before they tighten the cap.
PROBE_DTYPES = ("f32", "bf16", "int8")
_MODE = {"f32": 0, "bf16": 1, "int8": 2}  # the kernel's template modes

#: unit roundoff of a bf16 significand; the bf16 slack uses 4u (a ~2x
#: margin over the ||q||*||x||*u*(2+O(u)) error of one rounding each).
_BF16_EPS = 2.0 ** -8

#: safety margin on the int8 slack (covers the f32 dequantisation).
_INT8_SAFETY = 1.05

SUPPORTED_BQ = p2h_scan.SUPPORTED_BQ  # the tile engine of both kernels
SUPPORTED_SPLIT = p2h_scan.SUPPORTED_SPLIT
MAX_N0 = p2h_scan.MAX_N0
_ESIZE = {"f32": 4, "bf16": 2, "int8": 1}  # bytes per point value


def _segment_live_tiles(seg) -> int:
    """Tiles of ``seg`` holding >= 1 live point, judged on the *current*
    ids plane (memoised per segment object: a tombstone makes a new one)."""
    n = getattr(seg, "_live_tiles", None)
    if n is None:
        t = seg.tree
        pid = t.point_ids.view(t.num_leaves, t.n0)
        n = int((pid >= 0).any(dim=1).sum())
        try:
            object.__setattr__(seg, "_live_tiles", n)
        except AttributeError:
            pass  # slotted stand-ins: recompute per call
    return n


def tile_density(segments) -> float:
    """Live-tile fraction of the grid ``segments`` stack into (1.0 = even,
    fully live segments), against each tree's *built* leaf count (leaf
    padding for shape reuse is not held against the stack)."""
    from repro_torch.core.balltree import built_leaves
    counts = [built_leaves(s.tree) for s in segments]
    if not counts:
        return 1.0
    live = sum(_segment_live_tiles(s) for s in segments)
    return live / (len(counts) * max(counts))


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


#: base tile-count quantum of the common grid (the max segment's tile count
#: is rounded up to a multiple of :func:`_tile_quantum`), so snapshots that
#: differ by a few leaves keep one grid shape.
_TILE_QUANTUM = 8


def _tile_quantum(max_leaves: int) -> int:
    """Size-scaled tile quantum: bigger grids take coarser rounding."""
    if max_leaves <= 128:
        return _TILE_QUANTUM
    if max_leaves <= 512:
        return 2 * _TILE_QUANTUM
    return 4 * _TILE_QUANTUM


def _bucket_segments(n: int) -> int:
    """Segment count the launch is padded to: exact up to 4, then coarser
    steps, so republishes after compaction land on a known shape."""
    if n <= 4:
        return n
    if n <= 16:
        return _ceil_to(n, 2)
    if n <= 32:
        return _ceil_to(n, 4)
    if n <= 64:
        return _ceil_to(n, 8)
    return _ceil_to(n, 16)


#: ``StackedLeaves._derived`` keys that depend only on tile geometry (kept
#: through ids-plane rewrites); so does every key starting with ``geom:``.
_GEOMETRY_DERIVED = frozenset({"pts_lane"})


@dataclasses.dataclass(frozen=True)
class StackedLeaves:
    """Leaf tile arrays of N sealed segments, padded to one common grid, on
    the segments' device.

    Built once per compaction; tombstone-only republishes swap just the
    ``ids``/``valid`` planes (:meth:`with_updated_ids`) because deletes
    never touch tile geometry.  ``ids`` holds **global** ids (-1 = pad or
    tombstone), so the kernel's output needs no id translation.
    """

    pts: torch.Tensor  # (N, L, n0, d) f32, true d
    ids: torch.Tensor  # (N, L, n0) i32 -- global ids, -1 = pad/tombstone
    rx: torch.Tensor  # (N, L, n0) f32
    xc: torch.Tensor  # (N, L, n0) f32
    xs: torch.Tensor  # (N, L, n0) f32
    leaf_centers: torch.Tensor  # (N, L, d) f32
    leaf_radii: torch.Tensor  # (N, L) f32
    leaf_cnorm: torch.Tensor  # (N, L, 1) f32
    valid: torch.Tensor  # (N, L) bool -- tile holds >= 1 live point
    n_leaves: torch.Tensor  # (N,) i32 -- real (unpadded) tile counts
    uids: tuple  # segment uids, in stack order
    n0: int
    d: int
    #: planes derived from the geometry (the padded and quantised points),
    #: made once per stack and shared through :meth:`with_updated_ids`; a
    #: cache, not part of the stack's value.
    _derived: dict = dataclasses.field(default_factory=dict,
                                       compare=False, repr=False)

    @property
    def num_segments(self) -> int:
        return self.pts.shape[0]

    @property
    def num_tiles(self) -> int:
        return self.pts.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pts.device

    def padded_pts(self) -> torch.Tensor:
        """The points plane zero-padded to a multiple of 4 columns (the
        kernel's 16-byte rows; zero columns change no product), made once
        per stack."""
        dp = _ceil_to(self.d, _PAD)
        if dp == self.pts.shape[-1]:
            return self.pts
        hit = self._derived.get("pts_lane")
        if hit is None:
            hit = F.pad(self.pts, (0, dp - self.pts.shape[-1]))
            self._derived["pts_lane"] = hit
        return hit

    def quantized_pts(self, dtype: str, lane_pad: bool = True):
        """The probe's low-precision points plane, made once per geometry
        and kept through tombstone republishes (a ``geom:`` key).

        Returns ``(qpts, scale)``: ``qpts`` is ``(N, L, n0, dp)`` bf16 or
        int8 (with ``lane_pad``, ``dp`` zero-padded to 16-byte rows for the
        kernel's bulk copies: a multiple of 8 or 16 columns); ``scale`` is
        int8's per-tile dequantisation factor ``(N, L, 1)`` f32 (``None``
        for bf16):
        ``max |x| / 127`` over the tile, 1.0 where the tile is all zeros
        (pad rows), so no 0/0 is ever formed."""
        if dtype not in ("bf16", "int8"):
            raise ValueError(f"no quantised plane for {dtype!r}")
        key = f"geom:quant:{dtype}:{'lane' if lane_pad else 'raw'}"
        hit = self._derived.get(key)
        if hit is None:
            base = self.pts
            if lane_pad:
                dq = _ceil_to(self.d, 16 // _ESIZE[dtype])
                base = F.pad(base, (0, dq - self.d))
            if dtype == "bf16":
                hit = (base.to(torch.bfloat16), None)
            else:
                maxabs = torch.amax(torch.abs(self.pts), dim=(2, 3))
                scale = torch.where(maxabs > 0.0, maxabs / 127.0,
                                    torch.ones_like(maxabs))
                q = torch.clamp(torch.round(base / scale[:, :, None, None]),
                                -127.0, 127.0).to(torch.int8)
                hit = (q, scale[:, :, None])
            self._derived[key] = hit
        return hit

    # ------------------------------------------------------------------
    @classmethod
    def from_segments(cls, segments) -> "StackedLeaves":
        """Stack ``segments`` (objects with ``.uid``, ``.tree`` -- a
        :class:`repro_torch.core.balltree.FlatTree` -- and ``.gids``, the
        local-id -> global-id table) into one padded tile grid, on the
        trees' device."""
        segments = tuple(segments)
        if not segments:
            raise ValueError("cannot stack zero segments")
        t0 = segments[0].tree
        n0, d, dev = t0.n0, t0.d, t0.device
        max_leaves = max(s.tree.num_leaves for s in segments)
        L = _ceil_to(max_leaves, _tile_quantum(max_leaves))
        N = len(segments)

        def full(shape, fill, dtype=torch.float32):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        pts = full((N, L, n0, d), 0.0)
        ids = full((N, L, n0), -1, torch.int32)
        rx = full((N, L, n0), -1.0)
        xc = full((N, L, n0), 0.0)
        xs = full((N, L, n0), 0.0)
        centers = full((N, L, d), 0.0)
        radii = full((N, L), 0.0)
        cnorm = full((N, L, 1), 0.0)
        n_leaves = torch.zeros((N,), dtype=torch.int32)
        for s, seg in enumerate(segments):
            t = seg.tree
            Ls = t.num_leaves
            if t.n0 != n0 or t.d != d:
                raise ValueError("segments disagree on tiling")
            pts[s, :Ls] = t.points.view(Ls, n0, d)
            ids[s, :Ls] = _global_ids(t, seg.gids)
            rx[s, :Ls] = t.rx.view(Ls, n0)
            xc[s, :Ls] = t.xcos.view(Ls, n0)
            xs[s, :Ls] = t.xsin.view(Ls, n0)
            centers[s, :Ls] = t.leaf_centers
            radii[s, :Ls] = t.leaf_radii
            cnorm[s, :Ls, 0] = t.leaf_cnorm
            n_leaves[s] = Ls
        return cls(pts=pts, ids=ids, rx=rx, xc=xc, xs=xs,
                   leaf_centers=centers, leaf_radii=radii, leaf_cnorm=cnorm,
                   valid=(ids >= 0).any(dim=2), n_leaves=n_leaves.to(dev),
                   uids=tuple(seg.uid for seg in segments), n0=n0, d=d)

    def with_updated_ids(self, changed: dict) -> "StackedLeaves":
        """New stack with the ids/valid planes of ``changed`` segments
        (``{stack index: segment}``) rewritten -- the tombstone-only
        republish: the geometry tensors and the geometry-keyed derived
        planes are shared, not copied; the ids-derived ones are dropped."""
        ids = self.ids.clone()
        uids = list(self.uids)
        for s, seg in changed.items():
            Ls = seg.tree.num_leaves
            ids[s, :Ls] = _global_ids(seg.tree, seg.gids)
            ids[s, Ls:] = -1
            uids[s] = seg.uid
        keep = {key: v for key, v in self._derived.items()
                if key in _GEOMETRY_DERIVED or key.startswith("geom:")}
        return dataclasses.replace(self, ids=ids,
                                   valid=(ids >= 0).any(dim=2),
                                   uids=tuple(uids), _derived=keep)

    @staticmethod
    def concat(stacks) -> "StackedLeaves":
        """Concatenate stacks along the segment axis, re-padding smaller
        tile grids to the largest."""
        stacks = list(stacks)
        if not stacks:
            raise ValueError("cannot concatenate zero stacks")
        if len(stacks) == 1:
            return stacks[0]
        n0, d = stacks[0].n0, stacks[0].d
        if not all(s.n0 == n0 and s.d == d for s in stacks):
            raise ValueError("stacks disagree on tiling")
        L = max(s.num_tiles for s in stacks)

        def padL(a, fill):
            pad = L - a.shape[1]
            if pad == 0:
                return a
            return torch.cat([a, a.new_full(
                (a.shape[0], pad) + tuple(a.shape[2:]), fill)], dim=1)

        def cat(name, fill):
            return torch.cat([padL(getattr(s, name), fill) for s in stacks])

        return StackedLeaves(
            pts=cat("pts", 0.0), ids=cat("ids", -1), rx=cat("rx", -1.0),
            xc=cat("xc", 0.0), xs=cat("xs", 0.0),
            leaf_centers=cat("leaf_centers", 0.0),
            leaf_radii=cat("leaf_radii", 0.0),
            leaf_cnorm=cat("leaf_cnorm", 0.0), valid=cat("valid", False),
            n_leaves=torch.cat([s.n_leaves for s in stacks]),
            uids=tuple(u for s in stacks for u in s.uids), n0=n0, d=d)


#: identity-keyed LRU over concatenations, holding its sources by weakref:
#: an entry is dropped the moment a source stack is garbage-collected.
_CONCAT_CACHE: "collections.OrderedDict[tuple, tuple]" = (
    collections.OrderedDict())
_CONCAT_CACHE_SIZE = 8
_CONCAT_LOCK = threading.RLock()  # re-entrant: eviction may run inside


def concat_cached(stacks) -> StackedLeaves:
    """:meth:`StackedLeaves.concat` behind a small identity-keyed LRU;
    entries self-evict when a source stack is garbage-collected."""
    stacks = tuple(stacks)
    if len(stacks) == 1:
        return stacks[0]  # caching it would pin it under its own weakref
    key = tuple(id(s) for s in stacks)
    with _CONCAT_LOCK:
        hit = _CONCAT_CACHE.pop(key, None)
        if hit is not None:
            live = tuple(r() for r in hit[0])
            if all(a is b for a, b in zip(live, stacks)):
                _CONCAT_CACHE[key] = hit  # most recently used
                return hit[1]
    combined = StackedLeaves.concat(stacks)  # built outside the lock

    def _evict(_ref, _key=key):
        with _CONCAT_LOCK:
            _CONCAT_CACHE.pop(_key, None)

    refs = tuple(weakref.ref(s, _evict) for s in stacks)
    with _CONCAT_LOCK:
        _CONCAT_CACHE[key] = (refs, combined)
        while len(_CONCAT_CACHE) > _CONCAT_CACHE_SIZE:
            _CONCAT_CACHE.popitem(last=False)
    return combined


def _global_ids(tree, gids) -> torch.Tensor:
    """(L, n0) global-id tiles on the tree's device: ``point_ids`` through
    the segment's gid table (-1 pad/tombstone rows stay -1)."""
    pid = tree.point_ids.view(tree.num_leaves, tree.n0)
    gids = torch.as_tensor(np.asarray(gids, np.int32), device=pid.device)
    if gids.numel() == 0:
        return torch.full_like(pid, -1)
    safe = torch.clamp(pid, 0, gids.numel() - 1).long()
    return torch.where(pid >= 0, gids[safe], -1).to(torch.int32)


def quantization_slack(probe_dtype: str, *, d: int, leaf_cnorm,
                       leaf_radii, tile_scale=None):
    """Per-tile slack coefficients ``(sa, sb)`` (each ``(N, L, 1)`` f32)
    such that for every point ``x`` of tile ``t`` and query ``q``::

        |score_quant(q, x) - |<q, x>||  <=  ||q|| * sa[t] + sq * sb[t]

    with ``sq`` the query's int8 scale (0 for bf16), so widened probe
    scores never fall below the true distance (``||x|| <= ||c_t|| + r_t``):

    * bf16: ``sa = (||c_t|| + r_t) * 4u``, ``sb = 0``;
    * int8: ``sa = safety*(sqrt(d)/2)*s_t`` and
      ``sb = safety*((sqrt(d)/2)*(||c_t||+r_t) + (d/4)*s_t)``.

    ``d`` is the **true** dimensionality: pad columns are zeros on both
    sides and add no error."""
    cr = (leaf_cnorm[..., 0] + leaf_radii)[..., None]  # (N, L, 1)
    if probe_dtype == "bf16":
        sa = cr * (4.0 * _BF16_EPS)
        return sa, torch.zeros_like(sa)
    if probe_dtype != "int8":
        raise ValueError(f"no slack for {probe_dtype!r}")
    s_t = tile_scale  # (N, L, 1)
    half_rd = 0.5 * float(np.sqrt(d))
    sa = _INT8_SAFETY * half_rd * s_t
    sb = _INT8_SAFETY * (half_rd * cr + 0.25 * float(d) * s_t)
    return sa, sb


def probe_bytes_per_tile(probe_dtype: str, n0: int, d: int) -> int:
    """Bytes the probe pass streams per (n0, d) tile of points, plus the
    per-tile scalars the low-precision modes read."""
    if probe_dtype == "f32":
        return n0 * d * 4
    if probe_dtype == "bf16":
        return n0 * d * 2 + 4
    if probe_dtype != "int8":
        raise ValueError(f"unknown probe_dtype {probe_dtype!r}")
    return n0 * d + 12


# ======================================================================
# phase 1: stacked bounds + per-(segment, query-block) visit order
# ======================================================================


def prepare_stacked_operands(stk: StackedLeaves, queries, *, frac=1.0,
                             bq=8, lambda_cap=None, lane_pad=False):
    """Stacked twin of :func:`repro_torch.kernels.ops.prepare_operands`.

    One batched matmul gives ``<q, leaf.c>`` for every (segment, leaf);
    invalid (pad / all-tombstone) tiles get a ``+inf`` node bound -- always
    skipped, always counted -- and sort to the end of each visit list.
    ``lane_pad`` zero-pads point/query columns to a multiple of 4 (the
    kernel's rows); the plain version on the host keeps the true ``d``.
    """
    ensure_full_precision(stk.device)
    N, L, d = stk.num_segments, stk.num_tiles, stk.d
    dev = stk.device
    dp = _ceil_to(d, _PAD) if lane_pad else d
    B0 = queries.shape[0]
    Bp = _ceil_to(B0, bq)
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    if Bp != B0:  # replicate the last query (rows discarded on return)
        q = torch.cat([q, q[-1:].expand(Bp - B0, d)], dim=0)
    qn = torch.sqrt(torch.sum(q * q, dim=1, keepdim=True))  # (Bp, 1)
    if lambda_cap is None:
        cap = torch.full((Bp, 1), _INF, dtype=torch.float32, device=dev)
    else:
        cap = F.pad(torch.as_tensor(lambda_cap, dtype=torch.float32,
                                    device=dev).reshape(B0, 1),
                    (0, 0, 0, Bp - B0), value=_INF)

    ipc = torch.matmul(q, stk.leaf_centers.transpose(1, 2))  # (N, Bp, L)
    lb = bounds.node_ball_bound(ipc, qn[None], stk.leaf_radii[:, None, :])
    valid = stk.valid[:, None, :]
    lb = torch.where(valid, lb, _INF)
    pref = torch.abs(ipc).view(N, Bp // bq, bq, L).amin(dim=2)
    pref = torch.where(valid, pref, _INF)
    visit = torch.argsort(pref, dim=2, stable=True).to(torch.int32)
    n_visit = max(1, min(L, int(round(frac * L))))
    visit = visit[:, :, :n_visit].contiguous()

    # the stack may hand over its already-padded points plane
    pts = (stk.pts if stk.pts.shape[-1] == dp
           else F.pad(stk.pts, (0, dp - stk.pts.shape[-1])))
    ops = dict(
        pts_tiles=pts,
        ids_tiles=stk.ids,
        rx_tiles=stk.rx,
        xc_tiles=stk.xc,
        xs_tiles=stk.xs,
        leaf_cnorm=stk.leaf_cnorm,
        queries=F.pad(q, (0, dp - d)).contiguous(),
        qnorm=qn,
        cap=cap,
        leaf_ip=ipc.contiguous(),
        leaf_lb=lb.contiguous(),
        visit=visit,
    )
    return ops, B0


# ======================================================================
# the kernel wrapper
# ======================================================================

_PTS_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16,
              "int8": torch.int8}
_I32 = ("ids_tiles", "visit", "seed_i")


def _lib() -> ctypes.CDLL:
    lib = _build.load("stacked_sweep")
    if lib.stacked_sweep_launch.argtypes is None:  # first use: the ABI
        lib.stacked_sweep_launch.argtypes = (
            [ctypes.c_void_p] * 23 + [ctypes.c_int] * 13 + [ctypes.c_void_p])
        lib.stacked_sweep_launch.restype = ctypes.c_int
        lib.stacked_sweep_smem_bytes.argtypes = [ctypes.c_int] * 7
        lib.stacked_sweep_smem_bytes.restype = ctypes.c_longlong
        lib.stacked_sweep_smem_limit.argtypes = [ctypes.c_int]
        lib.stacked_sweep_smem_limit.restype = ctypes.c_int
        lib.stacked_sweep_max_clusters.argtypes = [ctypes.c_int] * 7
        lib.stacked_sweep_max_clusters.restype = ctypes.c_int
    return lib


def _check(ops: dict, *, k: int, bq: int, probe_dtype: str,
           split: int = 1) -> tuple:
    """Validate the operands for the kernel; returns (N, B, dp, L, n0, nqb,
    n_visit)."""
    if probe_dtype not in _PTS_DTYPE:
        raise ValueError(f"probe_dtype {probe_dtype!r} not in {PROBE_DTYPES}")
    dev = ops["queries"].device
    for name, t in ops.items():
        if name in ("pts_tiles", "queries"):
            want = _PTS_DTYPE[probe_dtype]
        else:
            want = torch.int32 if name in _I32 else torch.float32
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, dp = ops["queries"].shape
    N, L, n0, dpt = ops["pts_tiles"].shape
    _, nqb, n_visit = ops["visit"].shape
    shapes = dict(ids_tiles=(N, L, n0), rx_tiles=(N, L, n0),
                  xc_tiles=(N, L, n0), xs_tiles=(N, L, n0),
                  leaf_cnorm=(N, L, 1), tile_scale=(N, L, 1),
                  slack_a=(N, L, 1), slack_b=(N, L, 1), qnorm=(B, 1),
                  sq=(B, 1), cap=(B, 1), global_seed=(B, k),
                  seed_d=(N, B, k), seed_i=(N, B, k), leaf_ip=(N, B, L),
                  leaf_lb=(N, B, L), visit=(N, nqb, n_visit))
    for name, shape in shapes.items():
        if tuple(ops[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(ops[name].shape)}, "
                             f"expected {shape}")
    unit = 16 // _ESIZE[probe_dtype]  # columns of a 16-byte row unit
    if dpt != dp or dp % unit:
        raise ValueError(f"points and queries need the same width, a "
                         f"multiple of {unit} (got {dpt} and {dp})")
    if bq not in SUPPORTED_BQ:
        raise ValueError(f"bq={bq}: the kernel takes bq in {SUPPORTED_BQ}")
    if split not in SUPPORTED_SPLIT:
        raise ValueError(f"split={split}: the kernel takes split in "
                         f"{SUPPORTED_SPLIT}")
    if B != nqb * bq:
        raise ValueError(f"{B} queries do not make {nqb} blocks of {bq}")
    if not 1 <= n0 <= MAX_N0:
        raise ValueError(f"n0={n0}: the kernel takes 1 <= n0 <= {MAX_N0}")
    if k < 1 or n_visit < 1 or N < 1:
        raise ValueError(f"need k >= 1, a visit list and a segment (k={k}, "
                         f"n_visit={n_visit}, N={N})")
    if ops["pts_tiles"].data_ptr() % 16 or ops["queries"].data_ptr() % 4:
        raise ValueError("pts_tiles must be 16-byte and queries 4-byte "
                         "aligned")
    return N, B, dp, L, n0, nqb, n_visit


def ring_stages(lib, *, probe_dtype: str, bq: int, split: int, n0: int,
                dp: int, k: int, device_index: int) -> tuple[int, int]:
    """``(stages, bytes)``: the deepest slab ring whose shared memory fits
    one block on the card (:func:`repro_torch.kernels.p2h_scan.
    deepest_ring`)."""
    mode = _MODE[probe_dtype]
    return p2h_scan.deepest_ring(
        lambda stages: lib.stacked_sweep_smem_bytes(mode, bq, split, n0, dp,
                                                    k, stages),
        lib.stacked_sweep_smem_limit(device_index),
        f"k={k}, n0={n0}, dp={dp}, bq={bq}, split={split}")


@functools.lru_cache(maxsize=None)
def max_active_clusters(*, probe_dtype: str, bq: int, split: int, n0: int,
                        dp: int, k: int) -> int:
    """How many clusters of ``split`` CTAs the current card runs at once at
    these shapes (``cudaOccupancyMaxActiveClusters``; -1 on an error)."""
    lib = _lib()
    stages, _ = ring_stages(lib, probe_dtype=probe_dtype, bq=bq, split=split,
                            n0=n0, dp=dp, k=k,
                            device_index=torch.cuda.current_device())
    return lib.stacked_sweep_max_clusters(_MODE[probe_dtype], bq, split, n0,
                                          dp, k, stages)


def default_split(ops: dict, *, k: int, bq: int,
                  probe_dtype: str = "f32") -> int:
    """The split :func:`stacked_sweep` takes for these operands when given
    none: :func:`repro_torch.kernels.p2h_scan.card_split` with the card's
    SM count and cluster occupancy at these shapes on a CUDA device, 1 on
    the host."""
    dev = ops["queries"].device
    nqb = ops["visit"].shape[1]
    if dev.type != "cuda":
        return 1
    n0, dp = ops["pts_tiles"].shape[2:]
    with torch.cuda.device(dev):
        return p2h_scan.resolve_split(
            None, nqb, dev, lambda sp: max_active_clusters(
                probe_dtype=probe_dtype, bq=bq, split=sp, n0=n0, dp=dp, k=k))


# kernel launches of :func:`stacked_sweep` (and nothing else): a run that
# zeroes it before a query and reads it after sees whether the kernel ran
LAUNCHES = 0


def stacked_sweep(
    pts_tiles,   # (N, L, n0, dp) -- f32, or the bf16/int8 probe plane
    ids_tiles,   # (N, L, n0) i32
    rx_tiles,    # (N, L, n0) f32
    xc_tiles,    # (N, L, n0) f32
    xs_tiles,    # (N, L, n0) f32
    leaf_cnorm,  # (N, L, 1) f32
    queries,     # (B, dp), B % bq == 0 -- dtype matches pts_tiles
    qnorm,       # (B, 1) f32
    cap,         # (B, 1) f32 -- the entry cap
    leaf_ip,     # (N, B, L) f32
    leaf_lb,     # (N, B, L) f32 (+inf = pad or dead tile)
    visit,       # (N, B // bq, n_visit) i32
    *,
    k: int,
    bq: int = 8,
    split: int | None = None,
    use_ball: bool = True,
    use_cone: bool = True,
    seed_d=None,       # (N, B, k) f32 -- per-segment top-k seed (None: cold)
    seed_i=None,       # (N, B, k) i32
    global_seed=None,  # (B, k) f32 -- in-launch global top-k value seed
    probe_dtype: str = "f32",
    sq=None,           # (B, 1) f32 -- per-query int8 scale
    tile_scale=None,   # (N, L, 1) f32 -- per-tile int8 scale
    slack_a=None,      # (N, L, 1) f32 -- quantisation slack (* ||q||)
    slack_b=None,      # (N, L, 1) f32 -- quantisation slack (* sq)
):
    """The stacked sweep over ``N`` segments in one launch.

    Returns ``(dists (N, B, k), ids (N, B, k), skips (N, B//bq, 1) i32)``;
    each segment's top-k sorted ascending.  ``skips`` counts block-granular
    tile skips per segment, pad and dead tiles included.  ``split`` is the
    visit schedule of :func:`repro_torch.kernels.ref.stacked_sweep_ref`
    (CTAs per query block on the card); ``None`` is
    :func:`default_split`'s choice for the device.  ``probe_dtype !=
    "f32"`` is the quantised probe: the returned dists are widened upper
    bounds, not distances.  Host tensors run the plain version; CUDA
    tensors launch ``csrc/stacked_sweep.cu`` or raise.
    """
    dev = queries.device
    if dev.type == "cpu":
        return ref.stacked_sweep_ref(
            pts_tiles, ids_tiles, rx_tiles, xc_tiles, xs_tiles, leaf_cnorm,
            queries, qnorm, cap, leaf_ip, leaf_lb, visit, k=k, bq=bq,
            split=1 if split is None else split, use_ball=use_ball,
            use_cone=use_cone, seed_d=seed_d, seed_i=seed_i,
            global_seed=global_seed, probe_dtype=probe_dtype, sq=sq,
            tile_scale=tile_scale, slack_a=slack_a, slack_b=slack_b)
    if dev.type != "cuda":
        raise ValueError(f"stacked_sweep runs on cuda or cpu tensors, not "
                         f"{dev}")
    N, L = pts_tiles.shape[:2]
    B = queries.shape[0]

    def filled(t, shape, fill, dtype=torch.float32):
        return (torch.full(shape, fill, dtype=dtype, device=dev)
                if t is None else t)

    ops = dict(
        pts_tiles=pts_tiles, ids_tiles=ids_tiles, rx_tiles=rx_tiles,
        xc_tiles=xc_tiles, xs_tiles=xs_tiles, leaf_cnorm=leaf_cnorm,
        queries=queries, qnorm=qnorm, cap=cap, leaf_ip=leaf_ip,
        leaf_lb=leaf_lb, visit=visit,
        seed_d=filled(seed_d, (N, B, k), _INF),
        seed_i=filled(seed_i, (N, B, k), -1, torch.int32),
        global_seed=filled(global_seed, (B, k), _INF),
        sq=filled(sq, (B, 1), 0.0),
        tile_scale=filled(tile_scale, (N, L, 1), 1.0),
        slack_a=filled(slack_a, (N, L, 1), 0.0),
        slack_b=filled(slack_b, (N, L, 1), 0.0))
    N, B, dp, L, n0, nqb, n_visit = _check(
        ops, k=k, bq=bq, probe_dtype=probe_dtype,
        split=1 if split is None else split)
    if split is None:
        split = default_split(ops, k=k, bq=bq, probe_dtype=probe_dtype)
    lib = _lib()
    stages, _ = ring_stages(lib, probe_dtype=probe_dtype, bq=bq, split=split,
                            n0=n0, dp=dp, k=k, device_index=dev.index)
    rows = p2h_scan.visit_rows(ids_tiles, visit)
    out_d = torch.empty((N, B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((N, B, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((N, nqb, 1), dtype=torch.int32, device=dev)
    ptr = {name: t.data_ptr() for name, t in ops.items()}
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.stacked_sweep_launch(
            ptr["visit"], rows.data_ptr(), ptr["queries"], ptr["qnorm"],
            ptr["sq"], ptr["cap"], ptr["global_seed"], ptr["seed_d"],
            ptr["seed_i"], ptr["leaf_ip"], ptr["leaf_lb"],
            ptr["leaf_cnorm"], ptr["tile_scale"], ptr["slack_a"],
            ptr["slack_b"], ptr["pts_tiles"], ptr["ids_tiles"],
            ptr["rx_tiles"], ptr["xc_tiles"], ptr["xs_tiles"],
            out_d.data_ptr(), out_i.data_ptr(), out_s.data_ptr(),
            _MODE[probe_dtype], N, nqb, bq, split, L, n0, dp, n_visit, k,
            int(use_ball), int(use_cone), stages, stream)
    if err != 0:
        raise RuntimeError(f"stacked_sweep kernel launch failed: CUDA error "
                           f"{err} (bq={bq}, split={split}, "
                           f"stages={stages})")
    global LAUNCHES
    LAUNCHES += 1
    return out_d, out_i, out_s


# ======================================================================
# the two-pass program
# ======================================================================


def _quant_probe_operands(probe_dtype, ops, qpts, qscale, radii, cnorm, d):
    """The probe pass's quantised operands: the low-precision points and
    queries plus the dequantisation and slack scalars.  Returns
    ``(qops, quant_kw)``: ``run(**qops, **quant_kw)`` is the quantised
    pass A."""
    # the queries at the plane's width (zero columns change no product)
    qf = F.pad(ops["queries"], (0, qpts.shape[-1] - ops["queries"].shape[1]))
    if probe_dtype == "bf16":
        qq = qf.to(torch.bfloat16)
        sqv = torch.zeros_like(ops["qnorm"])
        ts = None
    else:  # int8: a per-query scale, zero-guarded like the tile scales
        mq = torch.amax(torch.abs(qf), dim=1, keepdim=True)
        sqv = torch.where(mq > 0.0, mq / 127.0, torch.ones_like(mq))
        qq = torch.clamp(torch.round(qf / sqv), -127.0, 127.0).to(torch.int8)
        ts = qscale
    sa, sb = quantization_slack(probe_dtype, d=d, leaf_cnorm=cnorm,
                                leaf_radii=radii, tile_scale=qscale)
    qops = dict(ops, pts_tiles=qpts, queries=qq.contiguous())
    return qops, dict(probe_dtype=probe_dtype, sq=sqv, tile_scale=ts,
                      slack_a=sa, slack_b=sb)


def _widened_probe_cap(cap, pd, k):
    """``lambda_probe`` of the quantised probe: the merged widened k-th,
    nudged *strictly* above itself.  Widened values cannot seed the f32
    main pass, which rescans the whole visit list cold, and a candidate
    whose true distance equals the cap must survive the strict ``<``
    prunes; the margin restores that."""
    kth = pd[:, k - 1:k]
    return torch.minimum(cap, kth * (1.0 + 2.0 ** -16) + 1e-30)


def _padded_extra(extra_d, extra_i, B0: int, Bp: int, k: int):
    """The extra candidates (the delta scan's top-k) padded to the ``Bp``
    rows of the query blocks, and the in-launch global top-k seed they
    make (their ``k`` smallest values); ``(None, None, None)`` without."""
    if extra_d is None:
        return None, None, None
    extra_d = F.pad(extra_d.to(torch.float32), (0, 0, 0, Bp - B0),
                    value=_INF)
    extra_i = F.pad(extra_i.to(torch.int32), (0, 0, 0, Bp - B0), value=-1)
    gseed = (extra_d if extra_d.shape[1] == k
             else torch.sort(extra_d, dim=1).values[:, :k]).contiguous()
    return extra_d, extra_i, gseed


def _gather_planes(outs, device) -> tuple:
    """Each field of the positions' outputs in stack order on ``device``:
    one position's as it is, more concatenated along the segment axis."""
    if len(outs) == 1:
        return tuple(outs[0])
    return tuple(all_gather(list(xs), tiled=True, device=device)
                 for xs in zip(*outs))


def _finish_stacked(bd, bi, skips, probe_skips, extra_d, extra_i,
                    seg_shard, n_true, n_leaves, *, k, B0, num_shards,
                    sort_planes, nqb, n_visit):
    """The cross-source finish on full bucket-padded planes: the global
    merge of the per-segment planes (+ the extra candidates) into one
    (B, k) answer, the per-shard k-ths, the optional plane sort, and the
    counters (block-granular tile skips, pad and dead tiles included;
    the two passes cover each visit list once, so the totals do not
    depend on the pass count)."""
    from repro_torch.core import search

    dev = bd.device
    true_row = torch.arange(bd.shape[0], device=dev) < n_true
    fd, fi = search.merge_topk_planes(bd, bi, k, extra_d=extra_d,
                                      extra_i=extra_i)
    fd, fi = fd[:B0], fi[:B0]
    shard_kth = None
    if num_shards:
        rows = []
        for s in range(num_shards):
            m = (seg_shard == s)[:, None, None]
            skd, _ = search.merge_topk_planes(
                torch.where(m, bd, _INF), torch.where(m, bi, -1), k)
            rows.append(skd[:B0, k - 1])
        shard_kth = torch.stack(rows)  # (S, B)
    if sort_planes:  # planes from elsewhere may come unsorted
        order = torch.argsort(bd, dim=2, stable=True)
        bd = torch.gather(bd, 2, order)[:, :B0]
        bi = torch.gather(bi, 2, order)[:, :B0]
    else:
        bd, bi = bd[:, :B0], bi[:, :B0]
    seg_skips = torch.sum(skips, dim=(1, 2)).to(torch.int32)  # (N,)
    total_skip = torch.sum(torch.where(true_row, seg_skips, 0))
    counters = torch.zeros((8,), dtype=torch.int32, device=dev)
    counters[3] = B0 * torch.sum(n_leaves).to(torch.int32)
    counters[2] = n_true * (nqb * n_visit) - total_skip
    counters[7] = total_skip
    return bd, bi, fd, fi, counters, seg_skips, shard_kth, probe_skips


def _run_stacked(parts, queries, lambda_cap, extra_d, extra_i, seg_shard,
                 n_true, n_leaves, *, mesh, mesh_axis, n0, d, k, frac, bq,
                 split, use_ball, use_cone, use_kernel, probe_tiles,
                 probe_dtype, num_shards, sort_planes):
    """Probe pass + main pass + cross-segment merge.

    Pass A sweeps the first ``probe_tiles`` preference-ordered tiles of
    every segment; its per-segment planes merge into ``lambda_probe``.
    Pass B sweeps the remaining tiles under it, seeded with pass A's
    per-segment top-k, so the two passes cover each visit list once.  A
    quantised probe cannot seed pass B: pass B then rescans the whole
    visit list cold under the widened cap.  The extra candidates (the
    delta scan's top-k) seed the in-launch global top-k of both passes --
    never pass A's planes, which pass B already holds in its seeds and
    would count twice.  Bucket-pad segment rows are swept (force-skipped)
    but never counted (``n_true``).

    ``parts`` holds one arrays dict per position.  With ``mesh=None`` it
    is the single launch: one part on the queries' device, on the
    caller's stream.  On a mesh, ``parts`` holds each position's
    contiguous block of the (bucket- and position-count-padded) segment
    axis, on its device (:func:`_placed_arrays`), and every position
    sweeps its block over the whole query batch on its own stream.  The
    probe hand-off then gathers every position's pass-A planes (tiled:
    the blocks restore stack order) before the one merge, and the result
    planes, skips and probe skips are gathered the same way before
    :func:`_finish_stacked` runs once, on the queries' device.  Within a
    position the launch still threads its global top-k from one segment
    to the next; across positions the tightening travels through the
    probe merge instead.  Every threshold stays a valid upper bound on the
    global k-th, so the answers are the single launch's; only the skip
    counters may differ.
    """
    from repro_torch.core import search

    dev0 = queries.device
    B0 = queries.shape[0]
    Bp = _ceil_to(B0, bq)
    nqb = Bp // bq
    L = parts[0]["pts"].shape[1]
    n_visit = max(1, min(L, int(round(frac * L))))
    p = max(0, min(probe_tiles, n_visit))
    quant = probe_dtype != "f32" and p > 0
    two_pass = quant or 0 < p < n_visit
    cap0 = (None if lambda_cap is None
            else torch.as_tensor(lambda_cap, dtype=torch.float32,
                                 device=dev0).reshape(-1))
    extra_d, extra_i, gseed = _padded_extra(extra_d, extra_i, B0, Bp, k)
    run = functools.partial(stacked_sweep, k=k, bq=bq, split=split,
                            use_ball=use_ball, use_cone=use_cone)

    def each(fn, per):
        if mesh is None:  # the single launch: no stream switch
            return [fn(0, dev0, per[0])]
        return per_position(mesh, mesh_axis, fn, per)

    def pass_a(_i, dev, arrs):
        arrs = dict(arrs)
        qpts = arrs.pop("qpts", None)
        qscale = arrs.pop("qscale", None)
        stk_l = StackedLeaves(**arrs, uids=(), n0=n0, d=d)
        ops, _ = prepare_stacked_operands(
            stk_l, queries.to(dev), frac=frac, bq=bq,
            lambda_cap=None if cap0 is None else cap0.to(dev),
            lane_pad=use_kernel)
        gs = None if gseed is None else gseed.to(dev)
        visit = ops["visit"]
        if quant:
            qops, quant_kw = _quant_probe_operands(
                probe_dtype, ops, qpts, qscale, arrs["leaf_radii"],
                arrs["leaf_cnorm"], d)
            out = run(**dict(qops, visit=visit[:, :, :p].contiguous()),
                      global_seed=gs, **quant_kw)
        elif two_pass:
            out = run(**dict(ops, visit=visit[:, :, :p].contiguous()),
                      global_seed=gs)
        else:  # p == 0 (one pass) or p == n_visit (the probe is the sweep)
            out = run(**ops, global_seed=gs)
        return ops, gs, out

    firsts = each(pass_a, parts)
    if two_pass:
        # the lambda exchange: every position's probe planes meet here, and
        # the merged k-th is the bound pass B sweeps under
        da, ia = _gather_planes([o[2][:2] for o in firsts], dev0)
        pd, _ = search.merge_topk_planes(da, ia, k)
        entry = firsts[0][0]["cap"].to(dev0)
        cap_b = (_widened_probe_cap(entry, pd, k) if quant
                 else torch.minimum(entry, pd[:, k - 1:k]))

        def pass_b(_i, dev, first):
            ops, gs, (da, ia, sk_a) = first
            cb = cap_b.to(dev)
            if quant:  # widened values never seed: a cold f32 rescan
                bd, bi, sk = run(**dict(ops, cap=cb), global_seed=gs)
            else:
                bd, bi, sk_b = run(
                    **dict(ops, visit=ops["visit"][:, :, p:].contiguous(),
                           cap=cb),
                    seed_d=da, seed_i=ia, global_seed=gs)
                sk = sk_a + sk_b
            return bd, bi, sk, sk_a

        outs = each(pass_b, firsts)
    else:
        outs = [(bd, bi, sk, sk) for _, _, (bd, bi, sk) in firsts]
    bd, bi, skips, psk = _gather_planes(outs, dev0)
    true_row = torch.arange(bd.shape[0], device=dev0) < n_true
    probe_skips = (torch.sum(torch.where(true_row[:, None, None], psk, 0))
                   if p else torch.zeros((), dtype=torch.int64, device=dev0))
    return _finish_stacked(bd, bi, skips, probe_skips, extra_d, extra_i,
                           seg_shard, n_true, n_leaves.to(dev0), k=k, B0=B0,
                           num_shards=num_shards, sort_planes=sort_planes,
                           nqb=nqb, n_visit=n_visit)


def _n_visit(stk: StackedLeaves, frac: float) -> int:
    """The visit-list length ``prepare_stacked_operands`` will produce."""
    L = stk.num_tiles
    return max(1, min(L, int(round(frac * L))))


def resolve_probe_tiles(probe_tiles, n_visit: int,
                        route: str = "snapshot") -> int:
    """Clamp the probe knob to ``[0, n_visit]``; ``None`` is the route's
    default (``STACKED_PROBE_TILES_DEFAULT`` on the snapshot route,
    ``STACKED_PROBE_TILES_ROUND2_DEFAULT`` on round 2 of the exchange)."""
    if probe_tiles is None:
        probe_tiles = (STACKED_PROBE_TILES_ROUND2_DEFAULT
                       if route == "round2"
                       else STACKED_PROBE_TILES_DEFAULT)
    return max(0, min(int(probe_tiles), n_visit))


def resolve_probe_dtype(probe_dtype, probe_tiles_resolved: int) -> str:
    """``None`` -> ``"f32"``, ``"auto"`` -> ``"bf16"``; any dtype becomes
    ``"f32"`` when no probe pass runs (width 0)."""
    if probe_dtype is None:
        probe_dtype = "f32"
    elif probe_dtype == "auto":
        probe_dtype = "bf16"
    if probe_dtype not in PROBE_DTYPES:
        raise ValueError(
            f"probe_dtype {probe_dtype!r} not in {PROBE_DTYPES}")
    return "f32" if probe_tiles_resolved == 0 else probe_dtype


def _pad_rows(a, pad: int, fill):
    """Append ``pad`` constant-filled rows along the leading axis."""
    if pad == 0:
        return a
    return torch.cat([a, a.new_full((pad,) + tuple(a.shape[1:]), fill)])


def _bucketed_arrays(stk: StackedLeaves, *, use_kernel: bool,
                     multiple: int = 1, probe_dtype: str = "f32"):
    """The launch's arrays with the segment axis padded to the
    :func:`_bucket_segments` bucket.  Pad rows are dead (``valid=False``,
    ``n_leaves=0``, ids -1), so the sweep force-skips them.  The padded
    geometry planes are memoised in ``_derived`` under ``geom:`` keys
    (kept through tombstone republishes), the ids-derived pads under plain
    keys.  ``use_kernel`` takes the points padded to 4 columns.
    ``probe_dtype`` != "f32" adds the quantised plane (``qpts``) and the
    int8 tile scales (``qscale``, pad 1.0).  ``multiple`` rounds the
    bucket up to whole blocks of segments per mesh position.  Returns
    ``(arrays, padded segment count)``."""
    N = stk.num_segments
    Np = _bucket_segments(N)
    if multiple > 1:
        Np = _ceil_to(Np, multiple)
    pad = Np - N
    tag = "lane" if use_kernel else "raw"
    pts = stk.padded_pts() if use_kernel else stk.pts
    quant = {}
    if probe_dtype != "f32":
        qpts, qscale = stk.quantized_pts(probe_dtype, lane_pad=use_kernel)
        if pad == 0:
            quant = dict(qpts=qpts)
            if qscale is not None:
                quant["qscale"] = qscale
        else:
            qkey = f"geom:quant:bucket:{Np}:{probe_dtype}:{tag}"
            quant = stk._derived.get(qkey)
            if quant is None:
                quant = dict(qpts=_pad_rows(qpts, pad, 0))
                if qscale is not None:
                    quant["qscale"] = _pad_rows(qscale, pad, 1.0)
                stk._derived[qkey] = quant
    if pad == 0:
        return dict(pts=pts, ids=stk.ids, rx=stk.rx, xc=stk.xc,
                    xs=stk.xs, leaf_centers=stk.leaf_centers,
                    leaf_radii=stk.leaf_radii, leaf_cnorm=stk.leaf_cnorm,
                    valid=stk.valid, n_leaves=stk.n_leaves, **quant), Np
    gkey = f"geom:bucket:{Np}:{tag}"
    geom = stk._derived.get(gkey)
    if geom is None:
        geom = dict(pts=_pad_rows(pts, pad, 0.0),
                    rx=_pad_rows(stk.rx, pad, -1.0),
                    xc=_pad_rows(stk.xc, pad, 0.0),
                    xs=_pad_rows(stk.xs, pad, 0.0),
                    leaf_centers=_pad_rows(stk.leaf_centers, pad, 0.0),
                    leaf_radii=_pad_rows(stk.leaf_radii, pad, 0.0),
                    leaf_cnorm=_pad_rows(stk.leaf_cnorm, pad, 0.0))
        stk._derived[gkey] = geom
    lkey = f"bucket:{Np}:ids"
    live = stk._derived.get(lkey)
    if live is None:
        live = dict(ids=_pad_rows(stk.ids, pad, -1),
                    valid=_pad_rows(stk.valid, pad, False),
                    n_leaves=_pad_rows(stk.n_leaves, pad, 0))
        stk._derived[lkey] = live
    return {**geom, **live, **quant}, Np


#: arrays-dict fields whose placement rides tombstone republishes (tile
#: geometry; ``geom:`` keys) and the ids planes that deletes move
_GEOM_FIELDS = ("pts", "rx", "xc", "xs", "leaf_centers", "leaf_radii",
                "leaf_cnorm")
_IDS_FIELDS = ("ids", "valid", "n_leaves")


def _placed_arrays(stk: StackedLeaves, arrays: dict, Np: int, mesh,
                   axis: str, use_kernel: bool,
                   probe_dtype: str = "f32") -> list:
    """``arrays`` cut into one dict per position along ``axis``: position
    ``i`` holds segments ``[i * Np / D, (i + 1) * Np / D)`` on its device.
    On the stack's own device a block is a view, not a copy.

    Memoised in ``stk._derived`` by the mesh's topology signature, so a
    copy to another device is paid once per stack; geometry entries ride
    tombstone republishes (``geom:`` keys), the ids planes are placed
    again when deletes move them."""
    sig = mesh_signature(mesh)
    tag = "lane" if use_kernel else "raw"
    devices = mesh.axis_devices(axis)
    per = Np // len(devices)

    def put(names):
        return {f: [arrays[f][i * per:(i + 1) * per].to(dev)
                    for i, dev in enumerate(devices)]
                for f in names if f in arrays}

    groups = [(f"geom:mesh:{sig}:{axis}:{Np}:{tag}", _GEOM_FIELDS),
              (f"mesh:{sig}:{axis}:{Np}:ids", _IDS_FIELDS)]
    if probe_dtype != "f32":  # the quantised plane is geometry too
        groups.append((f"geom:quant:mesh:{sig}:{axis}:{Np}:{probe_dtype}:"
                       f"{tag}", ("qpts", "qscale")))
    placed = {}
    for key, names in groups:
        hit = stk._derived.get(key)
        if hit is None:
            hit = put(names)
            stk._derived[key] = hit
        placed.update(hit)
    return [{f: v[i] for f, v in placed.items()}
            for i in range(len(devices))]


# ----------------------------------------------------------------------
# signature registry: every `_call_run_stacked` dispatch is counted as a
# hit (a signature seen before: shapes + statics) or a miss, and the
# recent templates (signatures minus the stack's grid dims) are kept for
# `warm_stacked`.  The JAX package compiles a program per signature; here
# nothing is compiled, and the registry keeps the same keys and counters
# so callers and benches read the same numbers.
# ----------------------------------------------------------------------
_COMPILE_LOCK = threading.Lock()
_COMPILE_SIGS: "dict[tuple, int]" = {}
_COMPILE_STATS = {"misses": 0, "hits": 0,
                  "warm_compiles": 0, "warm_hits": 0}
_RECENT_TEMPLATES: "collections.OrderedDict[tuple, bool]" = \
    collections.OrderedDict()
_RECENT_TEMPLATES_SIZE = 16
_RECENT_MISSES: "collections.deque[tuple]" = collections.deque(maxlen=8)


def _record_sig(sig: tuple, template: tuple, warm: bool) -> bool:
    """Count one dispatch against the signature registry; remember the
    template (LRU) unless this is itself a warmup."""
    with _COMPILE_LOCK:
        known = sig in _COMPILE_SIGS
        _COMPILE_SIGS[sig] = _COMPILE_SIGS.get(sig, 0) + 1
        if warm:
            _COMPILE_STATS["warm_hits" if known else "warm_compiles"] += 1
        else:
            _COMPILE_STATS["hits" if known else "misses"] += 1
            if not known:
                _RECENT_MISSES.append(sig)
            _RECENT_TEMPLATES.pop(template, None)
            _RECENT_TEMPLATES[template] = True
            while len(_RECENT_TEMPLATES) > _RECENT_TEMPLATES_SIZE:
                _RECENT_TEMPLATES.popitem(last=False)
        return known


def stacked_compile_stats() -> dict:
    """Registry counters: ``misses``/``hits`` (dispatches with a new / a
    known signature), ``warm_compiles``/``warm_hits`` (the same for
    :func:`warm_stacked`), ``signatures``, ``recent_misses``, and the
    aliases ``compile_count`` (misses + warm_compiles) and ``cache_hit``
    (hits)."""
    with _COMPILE_LOCK:
        st = dict(_COMPILE_STATS)
        st["signatures"] = len(_COMPILE_SIGS)
        st["recent_misses"] = list(_RECENT_MISSES)
    st["compile_count"] = st["misses"] + st["warm_compiles"]
    st["cache_hit"] = st["hits"]
    return st


def reset_stacked_compile_stats(full: bool = False) -> None:
    """Zero the counters; ``full=True`` also forgets the seen signatures
    and recent templates."""
    with _COMPILE_LOCK:
        for key in _COMPILE_STATS:
            _COMPILE_STATS[key] = 0
        _RECENT_MISSES.clear()
        if full:
            _COMPILE_SIGS.clear()
            _RECENT_TEMPLATES.clear()


def _mesh_axis_size(mesh, mesh_axis: str) -> int:
    """Devices along ``mesh_axis`` (0 when the axis is absent)."""
    if mesh is None:
        return 0
    return int(dict(mesh.shape).get(mesh_axis, 0))


def _placement(device: torch.device, mesh=None) -> tuple:
    """The placement a signature was recorded against: the mesh's topology
    signature, or the single program's device type and count."""
    if mesh is not None:
        return mesh_signature(mesh)
    count = torch.cuda.device_count() if device.type == "cuda" else 1
    return ("default", device.type, count)


def _signature(stk: StackedLeaves, template: tuple):
    """``(sig, Np, p, probe_dtype)`` of a dispatch of ``template`` against
    ``stk``: the template's knobs resolved against the stack's grid."""
    (B, k, frac, bq, split, use_ball, use_cone, use_kernel, interpret,
     probe_tiles, probe_route, probe_dtype, num_shards, has_extra, extra_k,
     has_cap, sort_planes, mesh, mesh_axis) = template
    p = resolve_probe_tiles(probe_tiles, _n_visit(stk, frac),
                            route=probe_route)
    pdt = resolve_probe_dtype(probe_dtype, p)
    Np = _bucket_segments(stk.num_segments)
    if mesh is not None:  # whole blocks of segments per position
        Np = _ceil_to(Np, _mesh_axis_size(mesh, mesh_axis))
    sig = (Np, stk.num_tiles, stk.n0, stk.d, B, k, frac, bq, split,
           use_ball, use_cone, use_kernel, interpret, p, pdt, num_shards,
           has_extra, extra_k, has_cap, sort_planes,
           _placement(stk.device, mesh), mesh_axis)
    return sig, Np, p, pdt


def _call_run_stacked(stk: StackedLeaves, queries, k, *, frac, bq, split,
                      use_ball, use_cone, lambda_cap, probe_tiles,
                      probe_route="snapshot", probe_dtype=None,
                      extra_d=None, extra_i=None, shard_bounds=None,
                      sort_planes=True, mesh=None, mesh_axis="shard"):
    D = _mesh_axis_size(mesh, mesh_axis)
    if D <= 1:
        mesh = None  # a one-position (or axis-less) mesh IS the single launch
    else:
        types = {dev.type for dev in mesh.axis_devices(mesh_axis)}
        if types != {stk.device.type}:
            raise ValueError(f"mesh positions on {sorted(types)} for a stack "
                             f"on {stk.device}")
    use_kernel = stk.device.type == "cuda"  # the device decides
    N = stk.num_segments
    bounds_ = tuple(int(x) for x in shard_bounds) if shard_bounds else ()
    num_shards = len(bounds_)
    has_extra = extra_d is not None
    q2 = torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32,
                                          device=stk.device))
    B = int(q2.shape[0])
    bq = p2h_scan.resolve_bq(bq, B, stk.device)
    extra_k = int(extra_d.shape[1]) if has_extra else 0
    template = (B, k, float(frac), int(bq),
                None if split is None else int(split), bool(use_ball),
                bool(use_cone), use_kernel, False,
                None if probe_tiles is None else int(probe_tiles),
                probe_route, probe_dtype, num_shards, has_extra, extra_k,
                lambda_cap is not None, bool(sort_planes), mesh, mesh_axis)
    sig, Np, p, pdt = _signature(stk, template)
    _record_sig(sig, template, False)
    arrays, Np = _bucketed_arrays(stk, use_kernel=use_kernel,
                                  multiple=D if mesh is not None else 1,
                                  probe_dtype=pdt)
    seg_shard = torch.full((Np,), -1, dtype=torch.int32)
    if bounds_:
        if sum(bounds_) != N:
            raise ValueError(f"shard_bounds {bounds_} do not cover {N} "
                             f"segments")
        seg_shard[:N] = torch.repeat_interleave(
            torch.arange(num_shards, dtype=torch.int32),
            torch.tensor(bounds_))
    statics = dict(n0=stk.n0, d=stk.d, k=k, frac=frac, bq=bq, split=split,
                   use_ball=use_ball, use_cone=use_cone,
                   use_kernel=use_kernel, probe_tiles=p, probe_dtype=pdt,
                   num_shards=num_shards, sort_planes=sort_planes)
    parts = ([arrays] if mesh is None
             else _placed_arrays(stk, arrays, Np, mesh, mesh_axis,
                                 use_kernel, probe_dtype=pdt))
    out = _run_stacked(parts, q2, lambda_cap, extra_d, extra_i,
                       seg_shard.to(stk.device), N, arrays["n_leaves"],
                       mesh=mesh, mesh_axis=mesh_axis, **statics)
    if Np != N:  # per-segment outputs slice back to the true rows
        bd, bi, fd, fi, counters, seg_skips, shard_kth, probe_skips = out
        out = (bd[:N], bi[:N], fd, fi, counters, seg_skips[:N],
               shard_kth, probe_skips)
    return out, p, pdt, bq


def warm_stacked(stk: StackedLeaves, templates=None) -> int:
    """Record the recent templates (default: the registry's) against a
    soon-to-be-published stack, as the JAX package's pre-publish warmup
    compiles them; here a signature costs nothing to prepare, so nothing
    runs.  Returns the number of templates recorded."""
    if templates is None:
        with _COMPILE_LOCK:
            templates = list(_RECENT_TEMPLATES)
    for t in templates:
        _record_sig(_signature(stk, t)[0], t, True)
    return len(templates)


def stacked_sweep_search(stk: StackedLeaves, queries, k: int = 1, *,
                         frac: float = 1.0, bq: int | None = None,
                         split: int | None = None,
                         use_ball: bool = True, use_cone: bool = True,
                         lambda_cap=None, probe_tiles: int = 0,
                         probe_dtype: str | None = None,
                         mesh=None, mesh_axis: str = "shard"):
    """Sweep all of ``stk``'s segments in one launch; per-segment planes.

    Returns ``(dists (N, B, k) ascending, global ids (N, B, k),
    counters (8,), per-segment skip counts (N,))``.  ``probe_tiles > 0``
    runs the two-pass form; the default 0 is one pass under the entry cap.
    The serving entry point is :func:`stacked_sweep_query`; ``bq`` and
    ``split`` are as there.
    """
    out, _, _, _ = _call_run_stacked(stk, queries, k, frac=frac, bq=bq,
                                     split=split, use_ball=use_ball,
                                     use_cone=use_cone,
                                     lambda_cap=lambda_cap,
                                     probe_tiles=probe_tiles,
                                     probe_dtype=probe_dtype,
                                     mesh=mesh, mesh_axis=mesh_axis)
    bd, bi, _, _, counters, seg_skips, _, _ = out
    return bd, bi, counters, seg_skips


def stacked_sweep_query(stk: StackedLeaves, queries, k: int = 1, *,
                        frac: float = 1.0, bq: int | None = None,
                        split: int | None = None,
                        use_ball: bool = True, use_cone: bool = True,
                        lambda_cap=None, probe_tiles: int | None = None,
                        probe_route: str = "snapshot",
                        probe_dtype: str | None = None,
                        extra_d=None, extra_i=None, shard_bounds=None,
                        mesh=None, mesh_axis: str = "shard"):
    """Serving entry point: probe + main + merge, with no host merge.

    Returns ``(dists (B, k), global ids (B, k), counters (8,), info)`` --
    the merged global top-k over every segment plus the optional
    ``extra_d``/``extra_i`` ``(B, M)`` candidates (the delta scan's top-k),
    which must be real, de-duplicated and disjoint from every segment:
    they also seed the in-launch global top-k.  ``probe_tiles=None`` is
    ``probe_route``'s default.  ``shard_bounds`` (segments per shard, in
    stack order) adds per-shard merged k-ths (``info["shard_kth"]``).
    ``bq`` and ``split`` are the kernel's query block and CTAs per block
    (``None``: the device's defaults, as for the sweep kernel --
    :func:`repro_torch.kernels.p2h_scan.resolve_bq` and
    :func:`default_split`: 64 and as many CTAs as fill the card in one
    wave on a CUDA device, the JAX package's 8 and one walker on the
    host).

    ``info``: ``seg_skips`` (N,), ``forced_skips`` (N,) -- the pad/dead
    tiles each segment's visit lists force-skip -- ``shard_kth``,
    ``probe`` (resolved width, scanned, skipped, dtype) and
    ``mesh_devices``, the positions the launch spanned (1: the single
    launch).  ``mesh`` (a :class:`repro_torch.launch.mesh.DeviceMesh`)
    with more than one position along ``mesh_axis`` runs
    :func:`_run_stacked` at every position: the same answers, one launch
    per position and pass.
    """
    out, p, pdt, bq = _call_run_stacked(
        stk, queries, k, frac=frac, bq=bq, split=split, use_ball=use_ball,
        use_cone=use_cone, lambda_cap=lambda_cap, probe_tiles=probe_tiles,
        probe_route=probe_route, probe_dtype=probe_dtype, extra_d=extra_d,
        extra_i=extra_i, shard_bounds=shard_bounds, sort_planes=False,
        mesh=mesh, mesh_axis=mesh_axis)
    _, _, fd, fi, counters, seg_skips, shard_kth, probe_skips = out
    B = int(torch.atleast_2d(torch.as_tensor(queries)).shape[0])
    nqb = -(-B // bq)
    n_visit = _n_visit(stk, frac)
    live = stk._derived.get("live_tiles")  # ids-derived: dropped by
    if live is None:  # ids-plane rewrites
        live = stk.valid.sum(dim=1).cpu().numpy().astype(np.int64)
        stk._derived["live_tiles"] = live
    forced = nqb * np.maximum(0, n_visit - live)  # invalid tiles visited
    probe_scanned = int(stk.num_segments * nqb * p) - int(probe_skips)
    info = {
        "seg_skips": seg_skips,
        "forced_skips": forced,
        "shard_kth": shard_kth,
        "probe": {"tiles": p, "scanned": probe_scanned,
                  "skipped": int(probe_skips), "dtype": pdt},
        "mesh_devices": max(1, _mesh_axis_size(mesh, mesh_axis)),
    }
    return fd, fi, counters, info
