"""Fused P2HNNS sweep: the wrapper around the CUDA kernel.

The kernel is ``csrc/p2h_sweep.cu`` (its note says what bounds it and how
it is laid out), built by :mod:`repro_torch.kernels._build` at first use
and called through ctypes on PyTorch's current stream.  For tensors on the
host the wrapper runs the plain version, :func:`repro_torch.kernels.ref.
p2h_sweep_ref`; for CUDA tensors it launches the kernel or raises.

``p2h_sweep.launches`` counts kernel launches (and nothing else), so a run
can show that its main path went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, ref

__all__ = ["p2h_sweep", "SUPPORTED_BQ", "SUPPORTED_SPLIT", "MAX_N0",
           "card_bq", "card_split", "resolve_bq", "resolve_split",
           "ring_stages", "deepest_ring", "max_active_clusters",
           "default_split", "visit_rows"]

SUPPORTED_BQ = (1, 2, 4, 8, 16, 32, 64)
SUPPORTED_SPLIT = tuple(range(1, 9))  # CTAs per cluster (8: portable most)
MAX_N0 = 1024
HOST_BQ = 8  # the JAX package's default block
STAGES = (4, 3, 2)  # slab ring depths tried, deepest first

_F32 = ("pts_tiles", "rx_tiles", "xc_tiles", "xs_tiles", "leaf_cnorm",
        "queries", "qnorm", "cap", "leaf_ip", "leaf_lb")  # the rest: int32


def card_bq(batch: int) -> int:
    """The card's query block for a batch: the smallest supported block
    that holds the whole batch, at most 64."""
    return next((b for b in SUPPORTED_BQ if b >= batch), SUPPORTED_BQ[-1])


def card_split(nqb: int, sm_count: int, clusters=None) -> int:
    """CTAs per query block on the card: the largest ``split`` <= 8 with
    ``nqb * split <= sm_count`` and, where ``clusters(split)`` says how many
    clusters of that size the card holds at once, ``nqb <= clusters(split)``
    -- so every query block runs in the first wave (at least 1)."""
    for split in SUPPORTED_SPLIT[:0:-1]:
        if nqb * split <= sm_count and (clusters is None
                                        or nqb <= clusters(split)):
            return split
    return 1


def resolve_bq(bq, batch: int, device) -> int:
    """``bq=None`` means :func:`card_bq` on a CUDA device and the JAX
    package's 8 on the host."""
    if bq is not None:
        return bq
    return card_bq(batch) if torch.device(device).type == "cuda" else HOST_BQ


def resolve_split(split, nqb: int, device, clusters=None) -> int:
    """``split=None`` means :func:`card_split` for the device's SM count
    (and ``clusters``) on a CUDA device and 1 (one walker) on the host."""
    if split is not None:
        return split
    device = torch.device(device)
    if device.type != "cuda":
        return 1
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return card_split(nqb, sms, clusters)


def visit_rows(ids_tiles, visit):
    """i32 of ``visit``'s shape: for each visit entry, the tile's rows up to
    its last non-pad point -- the rows a sweep kernel loads (0 for a tile
    without a valid point, which is never loaded).  ``ids_tiles`` is
    ``(L, n0)`` with ``visit`` ``(nqb, n_visit)``, or stacked, ``(N, L,
    n0)`` with ``(N, nqb, n_visit)``."""
    n0 = ids_tiles.shape[-1]
    pos = torch.arange(1, n0 + 1, dtype=torch.int32, device=ids_tiles.device)
    rows = torch.where(ids_tiles >= 0, pos, 0).amax(dim=-1)  # (..., L)
    at = visit.long().reshape(rows.shape[:-1] + (-1,))
    return torch.gather(rows, -1, at).view(visit.shape).contiguous()


def _lib() -> ctypes.CDLL:
    lib = _build.load()
    if lib.p2h_sweep_launch.argtypes is None:  # first use: declare the ABI
        lib.p2h_sweep_launch.argtypes = (
            [ctypes.c_void_p] * 16 + [ctypes.c_int] * 11 + [ctypes.c_void_p])
        lib.p2h_sweep_launch.restype = ctypes.c_int
        lib.p2h_sweep_smem_bytes.argtypes = [ctypes.c_int] * 6
        lib.p2h_sweep_smem_bytes.restype = ctypes.c_longlong
        lib.p2h_sweep_smem_limit.argtypes = [ctypes.c_int]
        lib.p2h_sweep_smem_limit.restype = ctypes.c_int
        lib.p2h_sweep_max_clusters.argtypes = [ctypes.c_int] * 6
        lib.p2h_sweep_max_clusters.restype = ctypes.c_int
    return lib


def _check(ops: dict, *, k: int, bq: int, split: int = 1) -> tuple[int, ...]:
    """Validate the operands for the kernel; returns (B, dp, L, n0, nqb,
    n_visit)."""
    dev = ops["queries"].device
    for name, t in ops.items():
        want = torch.float32 if name in _F32 else torch.int32
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    B, dp = ops["queries"].shape
    L, n0, dpt = ops["pts_tiles"].shape
    nqb, n_visit = ops["visit"].shape
    shapes = dict(ids_tiles=(L, n0), rx_tiles=(L, n0), xc_tiles=(L, n0),
                  xs_tiles=(L, n0), leaf_cnorm=(L, 1), qnorm=(B, 1),
                  cap=(B, 1), leaf_ip=(B, L), leaf_lb=(B, L))
    for name, shape in shapes.items():
        if tuple(ops[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(ops[name].shape)}, "
                             f"expected {shape}")
    if dpt != dp or dp % 4:
        raise ValueError(f"points and queries need the same width, a "
                         f"multiple of 4 (got {dpt} and {dp})")
    if bq not in SUPPORTED_BQ:
        raise ValueError(f"bq={bq}: the kernel takes bq in {SUPPORTED_BQ}")
    if split not in SUPPORTED_SPLIT:
        raise ValueError(f"split={split}: the kernel takes split in "
                         f"{SUPPORTED_SPLIT}")
    if B != nqb * bq:
        raise ValueError(f"{B} queries do not make {nqb} blocks of {bq}")
    if not 1 <= n0 <= MAX_N0:
        raise ValueError(f"n0={n0}: the kernel takes 1 <= n0 <= {MAX_N0}")
    if k < 1 or n_visit < 1:
        raise ValueError(f"need k >= 1 and a visit list (k={k}, "
                         f"n_visit={n_visit})")
    if ops["pts_tiles"].data_ptr() % 16:
        raise ValueError("pts_tiles must be 16-byte aligned")
    return B, dp, L, n0, nqb, n_visit


def deepest_ring(smem_of, limit: int, what: str) -> tuple[int, int]:
    """``(stages, bytes)``: the deepest of :data:`STAGES` whose shared
    memory ``smem_of(stages)`` fits a block's ``limit``; raises
    ``ValueError`` naming ``what`` if not even two stages fit."""
    for stages in STAGES:
        smem = smem_of(stages)
        if smem <= limit:
            return stages, smem
    raise ValueError(
        f"{what} need {smem} bytes of shared memory per block even with "
        f"{STAGES[-1]} stages; this card allows {limit}")


def ring_stages(lib, *, bq: int, split: int, n0: int, dp: int, k: int,
                device_index: int) -> tuple[int, int]:
    """``(stages, bytes)``: the deepest slab ring whose shared memory fits
    one block on the card (:func:`deepest_ring`)."""
    return deepest_ring(
        lambda stages: lib.p2h_sweep_smem_bytes(bq, split, n0, dp, k, stages),
        lib.p2h_sweep_smem_limit(device_index),
        f"k={k}, n0={n0}, dp={dp}, bq={bq}, split={split}")


def _launch(ops: dict, *, k: int, bq: int, split: int, use_ball: bool,
            use_cone: bool):
    """Launch the kernel on checked operands; raises ``RuntimeError`` if
    the launch is refused (no fallback)."""
    B, dp, L, n0, nqb, n_visit = (*ops["queries"].shape,
                                  *ops["pts_tiles"].shape[:2],
                                  *ops["visit"].shape)
    dev = ops["queries"].device
    lib = _lib()
    stages, _ = ring_stages(lib, bq=bq, split=split, n0=n0, dp=dp, k=k,
                            device_index=dev.index)
    rows = visit_rows(ops["ids_tiles"], ops["visit"])
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((nqb, 1), dtype=torch.int32, device=dev)
    ptrs = [ops[name].data_ptr() for name in (
        "visit", "queries", "qnorm", "cap", "leaf_ip", "leaf_lb",
        "leaf_cnorm", "pts_tiles", "ids_tiles", "rx_tiles", "xc_tiles",
        "xs_tiles")]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.p2h_sweep_launch(
            *ptrs, rows.data_ptr(), out_d.data_ptr(), out_i.data_ptr(),
            out_s.data_ptr(), nqb, bq, split, L, n0, dp, n_visit, k,
            int(use_ball), int(use_cone), stages, stream)
    if err != 0:
        raise RuntimeError(f"p2h_sweep kernel launch failed: CUDA error {err}"
                           f" (bq={bq}, split={split}, stages={stages})")
    p2h_sweep.launches += 1
    return out_d, out_i, out_s


@functools.lru_cache(maxsize=None)
def max_active_clusters(*, bq: int, split: int, n0: int, dp: int,
                        k: int) -> int:
    """How many clusters of ``split`` CTAs the current card runs at once at
    these shapes (``cudaOccupancyMaxActiveClusters``; -1 on an error)."""
    lib = _lib()
    stages, _ = ring_stages(lib, bq=bq, split=split, n0=n0, dp=dp, k=k,
                            device_index=torch.cuda.current_device())
    return lib.p2h_sweep_max_clusters(bq, split, n0, dp, k, stages)


def default_split(ops: dict, *, k: int, bq: int) -> int:
    """The split :func:`p2h_sweep` takes for these operands when given
    none: :func:`card_split` with the card's SM count and cluster
    occupancy at these shapes on a CUDA device, 1 on the host."""
    dev = ops["queries"].device
    nqb = ops["visit"].shape[0]
    if dev.type != "cuda":
        return 1
    _, n0, dp = ops["pts_tiles"].shape
    with torch.cuda.device(dev):
        return resolve_split(None, nqb, dev, lambda sp: max_active_clusters(
            bq=bq, split=sp, n0=n0, dp=dp, k=k))


def p2h_sweep(
    pts_tiles,   # (L, n0, dp) f32, dp % 4 == 0
    ids_tiles,   # (L, n0) i32
    rx_tiles,    # (L, n0) f32
    xc_tiles,    # (L, n0) f32
    xs_tiles,    # (L, n0) f32
    leaf_cnorm,  # (L, 1) f32
    queries,     # (B, dp) f32, B % bq == 0
    qnorm,       # (B, 1) f32
    cap,         # (B, 1) f32
    leaf_ip,     # (B, L) f32 -- <q, leaf.c>
    leaf_lb,     # (B, L) f32 -- node-level ball bound
    visit,       # (B // bq, n_visit) i32
    *,
    k: int,
    bq: int = 8,
    split: int | None = None,
    use_ball: bool = True,
    use_cone: bool = True,
):
    """Returns ``(dists (B,k), ids (B,k), skips (B//bq, 1) i32)``, sorted
    ascending; ``skips`` counts, per query block, the tiles skipped because
    every query's node ball bound was >= its lambda.  ``split`` is the
    visit schedule of :func:`repro_torch.kernels.ref.p2h_sweep_ref` (CTAs
    per query block on the card); ``None`` is :func:`default_split`'s
    choice for the device."""
    ops = dict(pts_tiles=pts_tiles, ids_tiles=ids_tiles, rx_tiles=rx_tiles,
               xc_tiles=xc_tiles, xs_tiles=xs_tiles, leaf_cnorm=leaf_cnorm,
               queries=queries, qnorm=qnorm, cap=cap, leaf_ip=leaf_ip,
               leaf_lb=leaf_lb, visit=visit)
    dev = queries.device
    if dev.type == "cpu":
        return ref.p2h_sweep_ref(**ops, k=k, bq=bq,
                                 split=resolve_split(split, 0, dev),
                                 use_ball=use_ball, use_cone=use_cone)
    if dev.type != "cuda":
        raise ValueError(f"p2h_sweep runs on cuda or cpu tensors, not {dev}")
    _check(ops, k=k, bq=bq, split=1 if split is None else split)
    if split is None:
        split = default_split(ops, k=k, bq=bq)
    return _launch(ops, k=k, bq=bq, split=split, use_ball=use_ball,
                   use_cone=use_cone)


p2h_sweep.launches = 0
