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

import torch

from repro_torch.kernels import _build, ref

__all__ = ["p2h_sweep", "SUPPORTED_BQ", "MAX_N0"]

SUPPORTED_BQ = (1, 2, 4, 8, 16)
MAX_N0 = 1024  # one thread per tile point

_F32 = ("pts_tiles", "rx_tiles", "xc_tiles", "xs_tiles", "leaf_cnorm",
        "queries", "qnorm", "cap", "leaf_ip", "leaf_lb")  # the rest: int32


def _lib() -> ctypes.CDLL:
    lib = _build.load()
    if lib.p2h_sweep_launch.argtypes is None:  # first use: declare the ABI
        lib.p2h_sweep_launch.argtypes = (
            [ctypes.c_void_p] * 15 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        lib.p2h_sweep_launch.restype = ctypes.c_int
        lib.p2h_sweep_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.p2h_sweep_smem_bytes.restype = ctypes.c_longlong
        lib.p2h_sweep_smem_limit.argtypes = [ctypes.c_int]
        lib.p2h_sweep_smem_limit.restype = ctypes.c_int
    return lib


def _check(ops: dict, *, k: int, bq: int) -> tuple[int, ...]:
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
    use_ball: bool = True,
    use_cone: bool = True,
):
    """Returns ``(dists (B,k), ids (B,k), skips (B//bq, 1) i32)``.  On the
    card the top-k is unsorted; ``skips`` counts, per query block, the tiles
    skipped because every query's node ball bound was >= its lambda."""
    ops = dict(pts_tiles=pts_tiles, ids_tiles=ids_tiles, rx_tiles=rx_tiles,
               xc_tiles=xc_tiles, xs_tiles=xs_tiles, leaf_cnorm=leaf_cnorm,
               queries=queries, qnorm=qnorm, cap=cap, leaf_ip=leaf_ip,
               leaf_lb=leaf_lb, visit=visit)
    dev = queries.device
    if dev.type == "cpu":
        return ref.p2h_sweep_ref(**ops, k=k, bq=bq, use_ball=use_ball,
                                 use_cone=use_cone)
    if dev.type != "cuda":
        raise ValueError(f"p2h_sweep runs on cuda or cpu tensors, not {dev}")
    B, dp, L, n0, nqb, n_visit = _check(ops, k=k, bq=bq)
    lib = _lib()
    smem = lib.p2h_sweep_smem_bytes(bq, n0, dp, k)
    limit = lib.p2h_sweep_smem_limit(dev.index)
    if smem > limit:
        raise ValueError(
            f"k={k}, n0={n0}, dp={dp}, bq={bq} need {smem} bytes of shared "
            f"memory per block; this card allows {limit}")
    out_d = torch.empty((B, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, k), dtype=torch.int32, device=dev)
    out_s = torch.empty((nqb, 1), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.p2h_sweep_launch(
            visit.data_ptr(), queries.data_ptr(), qnorm.data_ptr(),
            cap.data_ptr(), leaf_ip.data_ptr(), leaf_lb.data_ptr(),
            leaf_cnorm.data_ptr(), pts_tiles.data_ptr(), ids_tiles.data_ptr(),
            rx_tiles.data_ptr(), xc_tiles.data_ptr(), xs_tiles.data_ptr(),
            out_d.data_ptr(), out_i.data_ptr(), out_s.data_ptr(),
            nqb, bq, L, n0, dp, n_visit, k, int(use_ball), int(use_cone),
            stream)
    if err != 0:
        raise RuntimeError(f"p2h_sweep kernel launch failed: CUDA error {err}")
    p2h_sweep.launches += 1
    return out_d, out_i, out_s


p2h_sweep.launches = 0
