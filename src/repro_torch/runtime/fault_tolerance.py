"""Fault-tolerance runtime: restart supervision, step watchdog, straggler
detection.

At 1000+ nodes the failure model is: (a) hard node loss -> the coordinator
tears the job down and relaunches on the surviving/replacement set; (b)
hangs (network partitions, stuck collectives) -> a per-step watchdog
deadline converts hangs into failures so (a) handles them; (c) stragglers
-> per-step timing outliers are flagged and exported so the scheduler can
cordon slow hosts.  On this single-host container the same machinery is
exercised in-process: ``run_with_restarts`` supervises a function that
may raise, rebuilding its state from the last checkpoint on every retry.

The serving layer's shard supervisor (``repro_torch.serve.resilience``)
runs on these pieces: ``StepWatchdog`` turns a hung call into a failure,
``RetryPolicy`` decides which failures earn a retry and
``StragglerMonitor`` flags slow calls.  Pure host code, the same as the
JAX package's module of the same name.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable

logger = logging.getLogger(__name__)

__all__ = ["RetryPolicy", "run_with_restarts", "StepWatchdog",
           "StragglerMonitor"]


@dataclasses.dataclass
class RetryPolicy:
    max_restarts: int = 3
    backoff_s: float = 0.0        # container tests: no sleep
    restartable: tuple = (RuntimeError, IOError, TimeoutError)

    def retryable(self, exc: BaseException) -> bool:
        """Does this exception class earn a restart/retry?"""
        return isinstance(exc, tuple(self.restartable))


def run_with_restarts(make_state: Callable[[], Any],
                      train: Callable[[Any], Any],
                      *, policy: RetryPolicy = RetryPolicy()):
    """Supervise ``train(state)``; on a restartable failure, rebuild state
    (which restores from the latest checkpoint) and retry.

    ``make_state()`` must be idempotent and read the latest checkpoint --
    that is the whole restart contract (matches the deterministic data
    pipeline so the replayed steps are bit-identical).
    Returns (result, restarts_used).
    """
    restarts = 0
    while True:
        state = make_state()
        try:
            return train(state), restarts
        except policy.restartable as e:
            restarts += 1
            logger.warning("restartable failure (%s); restart %d/%d",
                           e, restarts, policy.max_restarts)
            if restarts > policy.max_restarts:
                raise
            if policy.backoff_s:
                time.sleep(policy.backoff_s * restarts)


class StepWatchdog:
    """Converts hangs into failures: if ``beat()`` is not called within
    ``deadline_s``, ``expired`` flips and (optionally) a callback fires
    (at scale: abort the collective / kill the process so the supervisor
    relaunches)."""

    def __init__(self, deadline_s: float, on_expire: Callable | None = None):
        self.deadline_s = deadline_s
        self.on_expire = on_expire
        self.expired = False
        self._timer: threading.Timer | None = None

    def _expire(self):
        self.expired = True
        if self.on_expire:
            self.on_expire()

    def beat(self):
        if self._timer is not None:
            self._timer.cancel()
        self._timer = threading.Timer(self.deadline_s, self._expire)
        self._timer.daemon = True
        self._timer.start()

    def stop(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def __enter__(self) -> "StepWatchdog":
        self.beat()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class StragglerMonitor:
    """Online per-step timing stats; flags steps (or, with per-host
    timings, hosts) slower than ``k`` MADs above the median."""

    def __init__(self, window: int = 64, k: float = 5.0):
        self.window = window
        self.k = k
        self.times: list[float] = []
        self.flagged: list[int] = []

    def record(self, step: int, seconds: float) -> bool:
        import numpy as np

        self.times.append(seconds)
        hist = self.times[-self.window:]
        if len(hist) < 8:
            return False
        med = float(np.median(hist))
        mad = float(np.median(np.abs(np.asarray(hist) - med))) + 1e-9
        is_straggler = seconds > med + self.k * 1.4826 * mad
        if is_straggler:
            self.flagged.append(step)
        return is_straggler
