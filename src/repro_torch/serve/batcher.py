"""Fixed-shape micro-batching for the P2H serving engine.

A ``MicroBatcher`` owns ``slot_size`` static slots (host numpy, as in the
JAX package, where the fixed shape keeps jitted programs from retracing;
here it keeps every launch of a route at one shape); pending requests are
drained into the slots, and partially-filled batches are padded by
replicating the first live slot (replica results are dropped on
scatter-back -- the same trick ``repro_torch.kernels.ops`` uses for
query-block padding).  Each drained batch reports its *occupancy* (live slots) so the
dispatch policy can route small trailing batches to the latency backend.

Admission control (``max_pending``): under overload, queue growth turns
every request's latency into queue-drain time -- rejecting at submit
with :class:`repro_torch.serve.resilience.QueryRejected` keeps the p99 of the
admitted requests bounded.  Requests whose deadline is already exhausted
at submit are likewise rejected (running them can only waste budget the
answer no longer has).  Deadlines ride the request into the drained
``MicroBatch`` (``deadline`` = earliest across the batch's deadlined
members) so the execution path can clamp per-shard budgets.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

__all__ = ["Request", "MicroBatch", "MicroBatcher"]


@dataclasses.dataclass
class Request:
    ticket: int
    query: np.ndarray          # (d,) normalized hyperplane coefficients
    k: int
    recall_target: float = 1.0
    deadline: object = None    # repro_torch.serve.resilience.Deadline | None


@dataclasses.dataclass
class MicroBatch:
    queries: np.ndarray        # (slot_size, d) -- static shape, padded
    tickets: list              # len == occupancy, ticket per live slot
    occupancy: int             # live slots (<= slot_size)
    k: int
    recall_target: float
    #: per-live-slot deadlines (aligned with ``tickets``); empty when no
    #: member carries one
    deadlines: list = dataclasses.field(default_factory=list)

    @property
    def deadline(self):
        """Earliest member deadline (the exchange's budget clamp), or
        None when no member carries one."""
        with_dl = [d for d in self.deadlines if d is not None]
        if not with_dl:
            return None
        return min(with_dl, key=lambda d: d.expires_at)


class MicroBatcher:
    """FIFO request queue drained into fixed-shape slot batches.

    Requests with different ``(k, recall_target)`` never share a batch
    (they would need different launches anyway); within a group the
    arrival order is preserved so results are deterministic.

    ``max_pending`` bounds the queue depth: a submit beyond it raises
    :class:`repro_torch.serve.resilience.QueryRejected` unless ``force=True``
    (the engine's drop-in ``query`` drains immediately, so its own rows
    never count as backlog).
    """

    def __init__(self, d: int, slot_size: int = 8,
                 max_pending: int | None = None):
        assert slot_size >= 1
        self.d = int(d)
        self.slot_size = int(slot_size)
        self.max_pending = None if max_pending is None else int(max_pending)
        self._queue: deque[Request] = deque()
        self._next_ticket = 0

    def __len__(self) -> int:
        return len(self._queue)

    # ------------------------------------------------------------------
    def submit(self, query: np.ndarray, k: int,
               recall_target: float = 1.0, *, deadline=None,
               force: bool = False) -> int:
        """Enqueue one request; returns its ticket.  Raises
        :class:`~repro_torch.serve.resilience.QueryRejected` when the queue is
        at ``max_pending`` (unless ``force``) or ``deadline`` is already
        exhausted -- shedding at admission, not after queueing."""
        from repro_torch.serve.resilience import QueryRejected

        if not force:
            # the request's own exhausted budget outranks system state
            if deadline is not None and deadline.expired:
                raise QueryRejected("deadline")
            if (self.max_pending is not None
                    and len(self._queue) >= self.max_pending):
                raise QueryRejected("queue_full")
        q = np.asarray(query, np.float32).reshape(-1)
        assert q.shape == (self.d,), (q.shape, self.d)
        t = self._next_ticket
        self._next_ticket += 1
        self._queue.append(Request(t, q, int(k), float(recall_target),
                                   deadline))
        return t

    # ------------------------------------------------------------------
    def drain(self, *, min_fill: int = 1):
        """Yield ``MicroBatch``es until fewer than ``min_fill`` requests
        remain queued.  Slot refill keeps the static shape: every yielded
        batch is exactly ``slot_size`` rows."""
        while len(self._queue) >= min_fill and self._queue:
            head = self._queue[0]
            group_key = (head.k, head.recall_target)
            batch: list[Request] = []
            # take the longest FIFO prefix with the same (k, recall) so
            # arrival order is preserved within and across batches
            while (self._queue and len(batch) < self.slot_size
                   and (self._queue[0].k,
                        self._queue[0].recall_target) == group_key):
                batch.append(self._queue.popleft())
            occ = len(batch)
            q = np.empty((self.slot_size, self.d), np.float32)
            for i, r in enumerate(batch):
                q[i] = r.query
            if occ < self.slot_size:  # pad: replicate the first live slot
                q[occ:] = q[0]
            yield MicroBatch(queries=q, tickets=[r.ticket for r in batch],
                             occupancy=occ, k=head.k,
                             recall_target=head.recall_target,
                             deadlines=[r.deadline for r in batch])
