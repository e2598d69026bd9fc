"""Read-path resilience for the serving engine: deadlines, per-shard
supervision (timeouts, circuit breakers, hedged retry), load shedding,
and deterministic fault injection.

The two-round lambda exchange makes principled degradation uniquely
cheap: a shard missing from round 1 merely *loosens* ``lambda0`` (the
min over the responding shards' round-1 k-ths is still a valid upper
bound for the surviving shard set), so a query that loses a shard can
return the **exact** answer over the live shards instead of an error.
This module supplies the mechanisms; the policy lives in the two-round
exchange's degraded branch (:func:`repro_torch.core.distributed.
two_round_exchange` with ``deadline=``/``resilience=``) and
:class:`repro_torch.serve.engine.P2HEngine` (deadline propagation into
per-shard budgets, admission control, expired-batch shedding).

Pieces:

``Deadline``
    A monotonic-clock absolute deadline threaded engine -> batcher ->
    exchange -> per-shard calls.  Per-shard budgets are
    ``min(shard_timeout_s, deadline.remaining())``.

``CircuitBreaker``
    Per-shard closed -> open -> half-open state machine over
    *consecutive* failures.  Open shards fast-fail to degraded mode
    (no thread, no timeout wait); after ``reset_s`` one half-open probe
    is admitted and its outcome closes or re-opens the breaker.

``ShardSupervisor``
    Runs one shard-backend call in a daemon worker thread under a
    budget, converting hangs into failures with
    :class:`repro_torch.runtime.fault_tolerance.StepWatchdog` (the same
    hang->failure contract the training runtime uses).  A single hedged
    duplicate fires at ``hedge_after_s`` for slow-but-alive shards, and
    :class:`repro_torch.runtime.fault_tolerance.RetryPolicy` governs which
    backend exceptions earn an in-budget retry.  Reads are idempotent
    (snapshot-pinned), so duplicate calls are always safe.

``FaultInjector``
    Deterministic, seedable fault schedules per shard (latency spikes,
    exceptions, hangs, flapping windows) applied at the supervisor's
    call boundary -- exactly where the timeouts that must catch them
    are enforced.  Same seed + same call sequence => identical action
    log (asserted by tests), so chaos runs replay.

``QueryRejected``
    Load-shedding rejection (queue depth / budget already exhausted):
    rejecting at admission beats queueing into a 2-second p99.
"""
from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time

from repro_torch.runtime.fault_tolerance import (RetryPolicy, StepWatchdog,
                                           StragglerMonitor)

logger = logging.getLogger(__name__)

__all__ = ["Deadline", "CircuitBreaker", "DeviceFault", "FaultError",
           "FaultInjector",
           "FaultSpec", "QueryRejected", "ResilienceConfig",
           "ShardSupervisor", "RESILIENCE_COUNTERS"]


class FaultError(RuntimeError):
    """An injected (or injected-equivalent) shard-backend failure."""


class DeviceFault(RuntimeError):
    """A failure of the device or a kernel that every shard shares (a
    build or launch error of one launch over several shards' segments):
    no shard's fault, so :class:`ShardSupervisor` raises it rather than
    degrading around a shard."""


class QueryRejected(RuntimeError):
    """Admission control rejected the request before any work ran.

    ``reason`` is ``"queue_full"`` (queue-depth shedding) or
    ``"deadline"`` (budget already exhausted at submit time).
    """

    def __init__(self, reason: str):
        super().__init__(f"query rejected: {reason}")
        self.reason = reason


class Deadline:
    """Absolute monotonic-clock deadline; ``remaining()`` may go
    negative (callers treat <= 0 as exhausted)."""

    __slots__ = ("expires_at",)

    def __init__(self, expires_at: float):
        self.expires_at = float(expires_at)

    @classmethod
    def after(cls, seconds: float) -> "Deadline":
        return cls(time.monotonic() + float(seconds))

    def remaining(self) -> float:
        return self.expires_at - time.monotonic()

    @property
    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def __repr__(self) -> str:
        return f"Deadline(remaining={self.remaining():.3f}s)"


class CircuitBreaker:
    """Consecutive-failure breaker: closed -> open -> half-open.

    ``failures`` consecutive failures trip the breaker open; while open,
    :meth:`admit` fast-fails (no call is made).  ``reset_s`` after the
    trip, one half-open probe call is admitted; its success closes the
    breaker (``recoveries`` += 1), its failure re-opens it.  ``clock``
    is injectable for deterministic tests.
    """

    def __init__(self, *, failures: int = 3, reset_s: float = 2.0,
                 clock=time.monotonic):
        self.failures = int(failures)
        self.reset_s = float(reset_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive = 0
        self._opened_at = 0.0
        self._probing = False
        self.trips = 0
        self.recoveries = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state_locked()

    def _state_locked(self) -> str:
        if (self._state == "open"
                and self._clock() - self._opened_at >= self.reset_s):
            self._state = "half_open"
            self._probing = False
        return self._state

    def admit(self) -> bool:
        """May a call proceed?  In half-open, admits exactly one probe
        at a time (abandon/record_* releases the slot)."""
        with self._lock:
            st = self._state_locked()
            if st == "closed":
                return True
            if st == "half_open" and not self._probing:
                self._probing = True
                return True
            return False

    def abandon(self) -> None:
        """Release an admitted-but-never-run half-open probe slot."""
        with self._lock:
            self._probing = False

    def record_success(self) -> None:
        with self._lock:
            if self._state_locked() == "half_open":
                self.recoveries += 1
            self._state = "closed"
            self._consecutive = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            st = self._state_locked()
            self._consecutive += 1
            self._probing = False
            if st == "half_open" or (st == "closed"
                                     and self._consecutive >= self.failures):
                self._state = "open"
                self._opened_at = self._clock()
                self.trips += 1


@dataclasses.dataclass
class FaultSpec:
    """One scheduled fault on one shard's call sequence.

    ``kind``: ``"latency"`` (sleep ``latency_s`` then proceed),
    ``"error"`` (raise :class:`FaultError`), ``"hang"`` (block until
    the injector's release event or ``FaultInjector.hang_s``), or
    ``"flap"`` (alternate error/healthy windows of ``period`` calls).
    Active on call indices ``[after, until)``; ``p`` < 1 makes the
    fault probabilistic under the injector's seeded per-shard rng
    (still deterministic for a fixed seed + call sequence).
    """

    kind: str
    p: float = 1.0
    latency_s: float = 0.05
    after: int = 0
    until: int | None = None
    period: int = 1


class FaultInjector:
    """Deterministic per-shard fault schedules, applied at the
    supervisor's call boundary (so timeouts/breakers see exactly the
    faults the schedule describes).

    ``plans`` maps shard index -> sequence of :class:`FaultSpec`.
    Every applied decision is appended to ``log`` as
    ``(shard, call_index, action)`` -- the replay-identity surface the
    determinism tests assert on.  ``reset()`` restores the initial
    state so the same call sequence replays the same schedule.
    """

    def __init__(self, plans: dict | None = None, *, seed: int = 0,
                 hang_s: float = 30.0):
        self.plans = {int(s): tuple(specs)
                      for s, specs in (plans or {}).items()}
        self.seed = int(seed)
        self.hang_s = float(hang_s)
        self._lock = threading.Lock()
        self.reset()

    def reset(self) -> None:
        with self._lock:
            self._calls: dict[int, int] = collections.defaultdict(int)
            self._rngs: dict[int, object] = {}
            self._release = threading.Event()
            self.log: list[tuple[int, int, str]] = []

    def release(self) -> None:
        """Unblock every in-flight ``hang`` (test teardown)."""
        self._release.set()

    def _decide(self, shard: int) -> tuple[int, str, float]:
        """Pick (call_index, action, latency_s) for the next call on
        ``shard``; pure bookkeeping under the lock, side effects happen
        outside."""
        import numpy as np

        i = self._calls[shard]
        self._calls[shard] += 1
        action, latency = "ok", 0.0
        for spec in self.plans.get(shard, ()):
            if i < spec.after or (spec.until is not None and i >= spec.until):
                continue
            if spec.kind == "flap":
                # alternate faulty/healthy windows of `period` calls,
                # starting faulty at `after`
                if ((i - spec.after) // max(1, spec.period)) % 2 == 1:
                    continue
            if spec.p < 1.0:
                rng = self._rngs.get(shard)
                if rng is None:
                    rng = self._rngs[shard] = np.random.default_rng(
                        (self.seed << 16) + shard)
                if float(rng.random()) >= spec.p:
                    continue
            action = "error" if spec.kind == "flap" else spec.kind
            latency = spec.latency_s
            break
        self.log.append((shard, i, action))
        return i, action, latency

    def act(self, shard: int) -> str:
        """Apply the next scheduled action for ``shard`` (called from
        the supervisor's worker thread, immediately before the backend
        call).  Returns the action taken."""
        with self._lock:
            i, action, latency = self._decide(int(shard))
            release = self._release
        if action == "latency":
            time.sleep(latency)
        elif action == "hang":
            release.wait(self.hang_s)
            raise FaultError(f"injected hang on shard {shard} (call {i})")
        elif action == "error":
            raise FaultError(f"injected error on shard {shard} (call {i})")
        return action


def _default_retry() -> RetryPolicy:
    # one hedged/retried duplicate max; backend failures worth retrying
    # are the transient kinds the training runtime also restarts on
    return RetryPolicy(max_restarts=1, backoff_s=0.0,
                       restartable=(FaultError, RuntimeError, IOError,
                                    TimeoutError))


@dataclasses.dataclass
class ResilienceConfig:
    """Knobs for the read-path resilience layer.

    ``shard_timeout_s``: per-shard-call budget (further clamped by the
    request deadline's remaining time).  ``hedge_after_s``: when set,
    a single duplicate call fires if the first has not completed by
    then (slow-but-alive shards lose a straggler, not the query).
    ``breaker_failures``/``breaker_reset_s``: consecutive failures to
    trip a shard's breaker / open-time before a half-open probe.
    ``retry``: which backend exceptions earn one in-budget relaunch
    (``max_restarts`` caps hedges + retries combined).
    ``max_pending``: engine queue-depth admission bound (None = no
    shedding).  ``fault_injector``: chaos-suite schedule applied at the
    call boundary.
    """

    shard_timeout_s: float | None = 0.5
    hedge_after_s: float | None = None
    breaker_failures: int = 3
    breaker_reset_s: float = 2.0
    retry: RetryPolicy = dataclasses.field(default_factory=_default_retry)
    max_pending: int | None = None
    fault_injector: FaultInjector | None = None


#: the uniform counter vocabulary every stats surface exposes (engine,
#: sharded index, benches) -- zero-filled when the layer is inactive,
#: so dashboards never key-error on a healthy deployment.
RESILIENCE_COUNTERS = ("calls", "ok", "timeouts", "errors",
                       "breaker_open_skips", "breaker_trips",
                       "breaker_recoveries", "hedges", "hedge_wins",
                       "retries", "degraded_batches", "shed_queue_full",
                       "shed_deadline", "shed_expired_batches")

_TIMEOUT_SENTINEL = -1


class ShardSupervisor:
    """Supervised execution of shard-backend calls: per-call budget
    (hang -> failure via :class:`StepWatchdog`), per-shard circuit
    breakers, one hedged duplicate for stragglers, and retry of
    transient errors under :class:`RetryPolicy` -- all off the caller's
    thread, so one wedged shard never wedges the exchange.

    Breakers are keyed by shard index on demand, so live resharding
    (shard count changes) needs no rebuild.  Thread-safe; one instance
    serves an engine's whole lifetime and its counters are cumulative.
    """

    def __init__(self, config: ResilienceConfig | None = None):
        self.cfg = config or ResilienceConfig()
        self._lock = threading.Lock()
        self._breakers: dict[int, CircuitBreaker] = {}
        self._counters = {k: 0 for k in RESILIENCE_COUNTERS}
        self.straggler = StragglerMonitor()
        self._steps = 0

    # ------------------------------------------------------------------
    def breaker(self, shard: int) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(int(shard))
            if br is None:
                br = self._breakers[int(shard)] = CircuitBreaker(
                    failures=self.cfg.breaker_failures,
                    reset_s=self.cfg.breaker_reset_s)
            return br

    def count(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._counters[key] = self._counters.get(key, 0) + n

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            breakers = list(self._breakers.items())
        out["breaker_trips"] = sum(b.trips for _, b in breakers)
        out["breaker_recoveries"] = sum(b.recoveries for _, b in breakers)
        out["breaker_states"] = {si: b.state for si, b in sorted(breakers)}
        out["stragglers_flagged"] = len(self.straggler.flagged)
        return out

    # ------------------------------------------------------------------
    def call(self, shard_ids, fn, *, deadline: Deadline | None = None):
        """Run ``fn()`` (a call against the shards in ``shard_ids``)
        under supervision; returns ``(ok, value, reason)`` with reason
        in {"ok", "timeout", "error", "breaker_open", "deadline"}.
        Never raises on backend failure -- bounded degradation is the
        caller's contract -- but raises a :class:`DeviceFault`, which is
        no shard's."""
        ids = tuple(int(s) for s in shard_ids)
        self.count("calls")
        admitted = []
        for si in ids:
            if self.breaker(si).admit():
                admitted.append(si)
            else:
                for aj in admitted:
                    self.breaker(aj).abandon()
                self.count("breaker_open_skips")
                return False, None, "breaker_open"
        budget = self.cfg.shard_timeout_s
        if deadline is not None:
            rem = deadline.remaining()
            budget = rem if budget is None else min(budget, rem)
            if budget <= 0:
                self.count("timeouts")
                self._fail(ids)
                return False, None, "deadline"
        return self._run(ids, fn, budget)

    def call_parallel(self, items, *, deadline: Deadline | None = None):
        """Run ``[(shard_ids, fn), ...]`` concurrently (one supervised
        call each); returns the list of ``(ok, value, reason)`` in item
        order.  A straggling shard costs min(budget, straggler), not
        the sum over shards."""
        items = list(items)
        if len(items) <= 1:
            return [self.call(ids, fn, deadline=deadline)
                    for ids, fn in items]
        out = [None] * len(items)
        raised = []

        def run(i, ids, fn):
            try:
                out[i] = self.call(ids, fn, deadline=deadline)
            except DeviceFault as e:
                raised.append(e)

        threads = [threading.Thread(target=run, args=(i, ids, fn),
                                    daemon=True)
                   for i, (ids, fn) in enumerate(items)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if raised:
            raise raised[0]
        return out

    # ------------------------------------------------------------------
    def _succeed(self, ids) -> None:
        for si in ids:
            self.breaker(si).record_success()

    def _fail(self, ids) -> None:
        for si in ids:
            self.breaker(si).record_failure()

    def _run(self, ids, fn, budget):
        results: queue.Queue = queue.Queue()
        injector = self.cfg.fault_injector

        def launch(idx: int) -> None:
            def runner():
                try:
                    if injector is not None:
                        for si in ids:
                            injector.act(si)
                    results.put((idx, True, fn(), None))
                except BaseException as e:  # noqa: BLE001 -- boundary
                    results.put((idx, False, None, e))

            threading.Thread(target=runner, daemon=True,
                             name=f"shard-call{list(ids)}").start()

        t0 = time.monotonic()
        wd = None
        if budget is not None:
            # hang -> failure: the watchdog wakes the waiter with a
            # timeout sentinel; the worker thread is abandoned (daemon)
            wd = StepWatchdog(budget, on_expire=lambda: results.put(
                (_TIMEOUT_SENTINEL, False, None, None)))
            wd.beat()
        max_attempts = 1 + max(0, int(self.cfg.retry.max_restarts))
        hedge_at = (None if self.cfg.hedge_after_s is None
                    else t0 + self.cfg.hedge_after_s)
        launch(0)
        attempts, inflight = 1, 1
        hedged = False
        try:
            while True:
                wait = None
                if (hedge_at is not None and not hedged
                        and attempts < max_attempts):
                    wait = max(0.0, hedge_at - time.monotonic())
                try:
                    idx, ok, val, exc = results.get(timeout=wait)
                except queue.Empty:
                    # hedge point reached, first call still running:
                    # fire ONE duplicate (reads are snapshot-pinned and
                    # idempotent), race them to completion
                    hedged = True
                    if budget is None or time.monotonic() - t0 < budget:
                        self.count("hedges")
                        launch(attempts)
                        attempts += 1
                        inflight += 1
                    continue
                if idx == _TIMEOUT_SENTINEL:
                    self.count("timeouts")
                    self._fail(ids)
                    return False, None, "timeout"
                inflight -= 1
                if ok:
                    self.count("ok")
                    if idx > 0:
                        self.count("hedge_wins")
                    self._succeed(ids)
                    with self._lock:
                        self._steps += 1
                        step = self._steps
                    self.straggler.record(step, time.monotonic() - t0)
                    return True, val, "ok"
                if isinstance(exc, DeviceFault):
                    for si in ids:  # no verdict on any shard
                        self.breaker(si).abandon()
                    raise exc
                retryable = self.cfg.retry.retryable(exc)
                if inflight > 0:
                    continue  # a hedge is still racing; let it finish
                if (retryable and attempts < max_attempts
                        and (budget is None
                             or time.monotonic() - t0 < budget)):
                    self.count("retries")
                    launch(attempts)
                    attempts += 1
                    inflight += 1
                    continue
                self.count("errors")
                self._fail(ids)
                logger.debug("shard call %s failed: %r", ids, exc)
                return False, None, f"error:{type(exc).__name__}"
        finally:
            if wd is not None:
                wd.stop()
