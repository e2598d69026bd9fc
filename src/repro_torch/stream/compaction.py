"""Compaction policy for the mutable index: when to rebuild what.

The paper's whole argument for revitalizing Ball-Tree is that
construction is roughly linear and 1-3 orders of magnitude cheaper than
the hashing baselines' indexing -- cheap enough that *rebuilding* is a
viable update strategy.  Compaction exploits exactly that: it takes the
live rows of the delta buffer (and optionally of tombstone-heavy or
too-numerous segments), runs them through the ordinary ``build_tree``
path, and seals the result as a fresh segment.

:class:`CompactionPolicy` is pure decision logic (easy to test, easy to
tune); the executor lives in ``repro_torch.stream.mutable`` where the locking
discipline is.  Triggers:

  * ``delta full``            -> flush the delta into a new segment;
  * ``tombstone_frac``        -> rewrite any segment whose dead fraction
                                 exceeds the threshold (reclaims space
                                 and restores bound tightness -- masked
                                 points still inflate node radii);
  * ``max_segments``          -> merge everything into one segment when
                                 the fan-out (and with it per-query work)
                                 grows past the threshold.
"""
from __future__ import annotations

import dataclasses

__all__ = ["CompactionPolicy", "CompactionPlan"]


@dataclasses.dataclass(frozen=True)
class CompactionPlan:
    """What one compaction run consumes."""

    include_delta: bool
    segment_uids: tuple  # uids of segments to rewrite into the new one
    reason: str = ""

    def __bool__(self) -> bool:
        return self.include_delta or bool(self.segment_uids)


@dataclasses.dataclass(frozen=True)
class CompactionPolicy:
    """Threshold knobs; every field is a tuning point."""

    delta_capacity: int = 1024  # write-buffer rows before a forced flush
    tombstone_frac: float = 0.25  # dead/total per segment before rewrite
    max_segments: int = 4  # segment-stack depth before a full merge
    min_flush: int = 1  # don't build trees over fewer live rows
    # admission control: a writer hitting a full delta while the
    # background compactor is busy seals the delta and keeps going, up
    # to this many sealed-but-unconsumed buffers; past it the writer
    # blocks (bounded memory) -- the only place backpressure may stall
    # an acknowledged write
    max_pending_seals: int = 2

    def plan(self, *, delta_full: bool, delta_live: int,
             segments) -> CompactionPlan:
        """Decide off the current snapshot state.  ``segments`` is the
        sealed-segment sequence (objects with uid/live/tombstone_frac)."""
        rotten = tuple(s.uid for s in segments
                       if s.dead and s.tombstone_frac >= self.tombstone_frac)
        if len(segments) + (1 if delta_full else 0) > self.max_segments:
            return CompactionPlan(
                include_delta=delta_live >= self.min_flush or delta_full,
                segment_uids=tuple(s.uid for s in segments),
                reason=f"segment fan-out > {self.max_segments}")
        if delta_full:
            return CompactionPlan(
                include_delta=True, segment_uids=rotten,
                reason="delta buffer full")
        if rotten:
            return CompactionPlan(
                include_delta=False, segment_uids=rotten,
                reason=f"tombstone fraction >= {self.tombstone_frac:g}")
        return CompactionPlan(include_delta=False, segment_uids=())
