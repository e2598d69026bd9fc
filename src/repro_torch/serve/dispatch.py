"""Backend auto-dispatch policy for the P2H serving engine.

Backend choice is workload-dependent (see the quantitative NNS comparison,
arXiv:2307.05235): the paper-faithful DFS wins single-query latency on a
host (tiny batches, deep pruning, no wasted tile work), the matmul-shaped
sweep and the fused sweep kernel win batched throughput, and the budgeted
beam trades recall for time when the caller allows it.  ``DispatchPolicy``
encodes those crossovers as explicit, test-overridable thresholds; the
engine resolves one :class:`Route` per micro-batch.

For mutable snapshots the serving view is a *stack* of sealed segments
plus a delta, and a second crossover appears: below it each segment is
one backend call (sequential, tightest caps), above it the ``stacked``
route sweeps every segment in one two-pass program -- a probe pass
tightens the entry cap before the main sweep, and the cross-segment merge
runs in the same launch (``repro_torch.kernels.stacked_sweep``;
``probe_tiles`` is the probe-width knob).  The crossover folds in the
snapshot's composition, not just its fan-out: tombstone-heavy segments
lower the bar, delta-heavy snapshots raise it, and the density signal
reads the segments' *current* ids planes.

Fields, defaults and route names are the JAX package's.  Two knobs default
to ``None`` and the engine resolves them from the index's device:
``prefer_pallas`` (True on a CUDA device: the ``"pallas"`` route is the
port's CUDA sweep kernel) and ``small_batch`` (the JAX package's 2 on the
host; 0 on a CUDA device, where the DFS is a host-driven loop that a
kernel launch beats even for one query -- PERF.md, serving).  A
``small_batch`` of 0 opens no DFS window at all.
"""
from __future__ import annotations

import dataclasses

__all__ = ["Route", "DispatchPolicy"]

#: the DFS window on the host: the JAX package's ``small_batch`` default
HOST_SMALL_BATCH = 2


@dataclasses.dataclass(frozen=True)
class Route:
    """A resolved dispatch decision: backend + backend kwargs."""

    method: str  # "dfs" | "sweep" | "beam" | "pallas" | "sharded" | "stacked"
    frac: float = 1.0
    reason: str = ""
    #: probe-pass width for the two-pass stacked program (None = library
    #: default); only meaningful on the "stacked" route
    probe_tiles: int | None = None
    #: probe-pass precision for the stacked program ("f32" | "bf16" |
    #: "int8"; None = library default f32).  Pass B always rescans in
    #: f32, so this changes probe bandwidth, never answers.
    probe_dtype: str | None = None


@dataclasses.dataclass(frozen=True)
class DispatchPolicy:
    """Threshold-based router; every field is a knob.

    * ``recall_target < 1``          -> ``beam`` with ``frac`` from
      ``frac_table`` (the paper's candidate-fraction time/recall knob).
    * segment fan-out >= the (density-adjusted) stacked threshold
      -> ``stacked`` (one launch over all segments, single entry cap).
    * occupancy <= ``small_batch`` (scaled down by the fan-out, at least
      1; no window at 0) -> ``dfs`` (single-query latency).
    * else                           -> ``pallas`` (the CUDA sweep kernel,
      or its plain version on the host) when preferred, otherwise the
      plain ``sweep``.

    ``sharded`` is not chosen here: a sharded index is a deployment
    decision, so the engine routes to it whenever it serves one.
    """

    # <= this many live queries -> dfs.  None = auto: the engine resolves
    # it to HOST_SMALL_BATCH (the JAX package's 2) on the host and to 0 (no
    # DFS window) on a CUDA device; route() reads None as the host's.
    small_batch: int | None = None
    # batched exact work -> pallas (the sweep kernel) backend.  None =
    # auto: the engine resolves it to True on a CUDA device (the kernel)
    # and False on the host (the plain version is a parity tool there).
    prefer_pallas: bool | None = None
    frac_table: tuple = (         # (min recall target, candidate fraction)
        (0.99, 0.5),
        (0.95, 0.25),
        (0.90, 0.10),
        (0.00, 0.05),
    )
    # -- segment-parallel (stacked) crossover knobs --------------------
    stacked_min_fanout: int = 4   # live segments before one-launch sweep
    # tombstone-heavy snapshots cross over earlier: sequential launches
    # spend their tiles on dead rows the stacked grid skips wholesale
    stacked_tombstone_frac: float = 0.2
    # delta-heavy snapshots cross over later: the (exact, host-side)
    # delta scan dominates, batching the segment remnant amortizes little
    stacked_delta_frac: float = 0.5
    # heavily ragged stacks (live-tile fraction of the common grid below
    # this) stay sequential
    stacked_min_density: float = 0.5
    # probe-pass width of the two-pass stacked program: pass A sweeps
    # this many preference-ordered tiles per (segment, query block), the
    # merged probe k-th tightens the cap pass B prunes against.  None =
    # the library default (STACKED_PROBE_TILES_DEFAULT); 0 = one pass.
    probe_tiles: int | None = None
    # probe-pass precision on the stacked route.  "auto" (default)
    # resolves to bf16 exactly when the stacked route is chosen (pass B
    # rescans in f32, so answers stay bit-exact); "f32"/"bf16"/"int8"
    # force a precision; the probe-width 0 case falls back to f32 inside
    # the kernel layer, never here.
    probe_dtype: str = "auto"

    def frac_for_recall(self, recall_target: float) -> float:
        for floor, frac in self.frac_table:
            if recall_target >= floor:
                return frac
        return self.frac_table[-1][1]

    def stacked_fanout_threshold(self, delta_frac: float = 0.0,
                                 tombstone_frac: float = 0.0) -> int:
        """Live-segment fan-out at which the stacked launch wins,
        adjusted for snapshot composition (the JAX package's delta-aware
        crossover, not refit on the card yet)."""
        thr = self.stacked_min_fanout
        if tombstone_frac >= self.stacked_tombstone_frac:
            thr = max(2, thr - 1)
        if delta_frac >= self.stacked_delta_frac:
            thr += 2
        return thr

    def route(self, occupancy: int, k: int, recall_target: float = 1.0,
              *, sharded: bool = False, segments: int = 1,
              stackable: int = 0, delta_frac: float = 0.0,
              tombstone_frac: float = 0.0,
              tile_density: float = 1.0,
              mesh_devices: int = 1) -> Route:
        """Pick a backend for a micro-batch with ``occupancy`` live slots.

        ``segments``: fan-out width of the serving view (a mutable
        snapshot's segment stack + delta; 1 for a frozen index).  Each
        segment is one backend call, so the per-call batched-matmul
        amortization kicks in ``segments`` times per query -- the dfs
        latency window shrinks proportionally.

        ``stackable``: how many of those are *live sealed segments* (the
        units the stacked launch can absorb); ``delta_frac`` /
        ``tombstone_frac`` describe the snapshot's composition (live
        delta rows over live points, dead sealed rows over sealed rows)
        and shift the stacked crossover as documented above;
        ``tile_density`` is the live-tile fraction of the common stacked
        grid (``repro_torch.kernels.stacked_sweep.tile_density``).

        ``mesh_devices``: device count of the serving mesh the snapshot
        carries (1 = single program).  Only the stacked launch shards
        across a mesh, so a multi-device view crosses over at the floor
        fan-out (2) regardless of composition -- the sequential walk
        would leave every device but one idle -- and the density bar
        drops proportionally (pad tiles are split across devices, so
        the masked-tile overhead per device shrinks by the same
        factor).
        """
        if recall_target < 1.0:
            return Route("beam", frac=self.frac_for_recall(recall_target),
                         reason=f"recall_target={recall_target:g}")
        if sharded:
            return Route("sharded", reason="index is sharded")
        thr = self.stacked_fanout_threshold(delta_frac, tombstone_frac)
        min_density = self.stacked_min_density
        if mesh_devices > 1:
            thr = min(thr, 2)
            min_density = min_density / mesh_devices
        if stackable >= thr and tile_density >= min_density:
            mesh_note = (f", mesh={mesh_devices}" if mesh_devices > 1
                         else "")
            return Route("stacked", probe_tiles=self.probe_tiles,
                         probe_dtype=("bf16"
                                      if self.probe_dtype == "auto"
                                      else self.probe_dtype),
                         reason=f"fanout={stackable}>={thr} "
                                f"(delta={delta_frac:.2f}, "
                                f"dead={tombstone_frac:.2f}"
                                f"{mesh_note})")
        small = (HOST_SMALL_BATCH if self.small_batch is None
                 else self.small_batch)
        dfs_window = max(1, small // max(1, segments)) if small > 0 else 0
        if occupancy <= dfs_window:
            return Route("dfs", reason=f"occupancy={occupancy}"
                                       f"<={dfs_window}")
        if self.prefer_pallas:
            return Route("pallas", reason=f"occupancy={occupancy}: batched")
        return Route("sweep", reason=f"occupancy={occupancy}: batched")
