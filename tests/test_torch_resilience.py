"""The port's read-path resilience units (``repro_torch.serve.resilience``,
``repro_torch.runtime.fault_tolerance``) and the engine's shedding, on the
CPU.

Deterministic units: deadlines, the circuit breaker under an injected
clock, the fault injector (its action log equal to the JAX package's on
the same plans and call sequence), retry, restarts and the straggler
monitor, the supervisor's error/retry and breaker paths, batcher and engine
shedding.  Tests that wait on a real clock (timeouts, hedging, a hung call,
an expired deadline) are marked ``resilience``; every wait in them is
bounded by an event, a join or a deadline, and no assertion on elapsed time
is tighter than ten times the time it expects.  The degraded exchange over
a sharded index is ``test_torch_sharded.py``'s.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serve.resilience import FaultInjector as JInjector  # noqa: E402
from repro.serve.resilience import FaultSpec as JSpec  # noqa: E402
from repro_torch.runtime import (  # noqa: E402
    RetryPolicy,
    StepWatchdog,
    StragglerMonitor,
    run_with_restarts,
)
from repro_torch.serve import P2HEngine  # noqa: E402
from repro_torch.serve.batcher import MicroBatcher  # noqa: E402
from repro_torch.serve.resilience import (  # noqa: E402
    RESILIENCE_COUNTERS,
    CircuitBreaker,
    Deadline,
    FaultError,
    FaultInjector,
    FaultSpec,
    QueryRejected,
    ResilienceConfig,
    ShardSupervisor,
)
from repro_torch.stream import MutableP2HIndex  # noqa: E402

DIM = 8


def _mkdata(n, seed=0, dim=DIM):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(
        np.float32)


def _queries(b=3, seed=7):
    return np.random.default_rng(seed).normal(
        size=(b, DIM + 1)).astype(np.float32)


# ---------------------------------------------------------------- deadline
def test_deadline_basics():
    d = Deadline.after(60.0)
    assert not d.expired and 59.0 < d.remaining() <= 60.0
    past = Deadline(0.0)  # monotonic epoch is long gone
    assert past.expired and past.remaining() < 0
    assert "remaining" in repr(d)


# ----------------------------------------------------------------- breaker
def test_breaker_trips_resets_and_recovers():
    clk = [0.0]
    br = CircuitBreaker(failures=3, reset_s=2.0, clock=lambda: clk[0])
    assert br.state == "closed" and br.admit()
    br.record_failure()
    br.record_failure()
    assert br.state == "closed"  # 2 < 3 consecutive
    br.record_success()
    for _ in range(3):  # success reset the streak; 3 fresh ones trip
        br.record_failure()
    assert br.state == "open" and br.trips == 1
    assert not br.admit()
    clk[0] = 1.9
    assert not br.admit()  # reset_s not yet elapsed
    clk[0] = 2.0
    assert br.state == "half_open"
    assert br.admit()       # the single half-open probe
    assert not br.admit()   # slot taken until its outcome lands
    br.record_success()
    assert br.state == "closed" and br.recoveries == 1


def test_breaker_probe_failure_reopens_and_abandon_releases():
    clk = [0.0]
    br = CircuitBreaker(failures=1, reset_s=1.0, clock=lambda: clk[0])
    br.record_failure()
    assert br.state == "open" and br.trips == 1
    clk[0] = 1.0
    assert br.admit()
    br.record_failure()  # probe failed -> re-open, fresh reset window
    assert br.state == "open" and br.trips == 2
    clk[0] = 2.0
    assert br.admit() and not br.admit()
    br.abandon()         # probe never ran
    assert br.admit()
    br.record_success()
    assert br.state == "closed" and br.recoveries == 1


# ---------------------------------------------------------- fault injector
def _drive(inj, schedule, error=FaultError):
    for shard, reps in schedule:
        for _ in range(reps):
            try:
                inj.act(shard)
            except error:
                pass


_PLANS = {0: [("error", dict(after=1, until=3))],
          1: [("error", dict(p=0.5))],
          2: [("flap", dict(period=2, after=1))]}
_SCHEDULE = [(0, 2), (1, 3), (2, 4), (0, 2), (1, 2), (2, 3)]


def _plans(spec_cls):
    return {s: [spec_cls(kind, **kw) for kind, kw in specs]
            for s, specs in _PLANS.items()}


@pytest.mark.parametrize("seed", [42, 43])
def test_fault_injector_replays_and_equals_jax(seed):
    """Same seed + call sequence => the same action log, after reset(), and
    the same as the JAX package's injector (its per-shard rng included)."""
    from repro.serve.resilience import FaultError as JFaultError

    inj = FaultInjector(_plans(FaultSpec), seed=seed)
    _drive(inj, _SCHEDULE)
    assert len(inj.log) == sum(r for _, r in _SCHEDULE)
    replay = list(inj.log)
    inj.reset()
    _drive(inj, _SCHEDULE)
    assert inj.log == replay
    jinj = JInjector(_plans(JSpec), seed=seed)
    _drive(jinj, _SCHEDULE, error=JFaultError)
    assert inj.log == jinj.log
    other = FaultInjector(_plans(FaultSpec), seed=85 - seed)  # 42 <-> 43
    _drive(other, _SCHEDULE)
    # the p=0.5 shard depends on the seed (else p is being ignored)
    assert [e for e in other.log if e[0] == 1] != \
        [e for e in inj.log if e[0] == 1]


def test_fault_injector_windows_and_flap():
    inj = FaultInjector({0: [FaultSpec("error", after=2, until=4)],
                         1: [FaultSpec("flap", period=2, after=0)]})
    acts = {0: [], 1: []}
    for shard, n in ((0, 6), (1, 8)):
        for _ in range(n):
            try:
                acts[shard].append(inj.act(shard))
            except FaultError:
                acts[shard].append("error")
    assert acts[0] == ["ok", "ok", "error", "error", "ok", "ok"]
    assert acts[1] == ["error", "error", "ok", "ok",
                       "error", "error", "ok", "ok"]


@pytest.mark.resilience
def test_fault_injector_hang_blocks_until_release():
    inj = FaultInjector({0: [FaultSpec("hang")]}, hang_s=60.0)
    entered = threading.Event()
    raised = []

    def call():
        entered.set()
        try:
            inj.act(0)
        except FaultError as e:
            raised.append(e)

    t = threading.Thread(target=call, daemon=True)
    t.start()
    assert entered.wait(10.0)
    inj.release()
    t.join(30.0)  # well inside hang_s: the release, not the timer, ended it
    assert not t.is_alive() and len(raised) == 1


# --------------------------------------------------------- retry / runtime
def test_retry_policy_and_restarts():
    pol = RetryPolicy(max_restarts=1, restartable=(FaultError, IOError))
    assert pol.retryable(FaultError("x")) and pol.retryable(IOError("y"))
    assert not pol.retryable(ValueError("z"))
    calls = []

    def flaky(state):
        calls.append(state)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "done"

    made = []
    out, restarts = run_with_restarts(lambda: made.append(1) or len(made),
                                      flaky,
                                      policy=RetryPolicy(max_restarts=3))
    assert (out, restarts) == ("done", 2) and calls == [1, 2, 3]

    def down(state):
        raise RuntimeError("always down")

    with pytest.raises(RuntimeError, match="always down"):
        run_with_restarts(dict, down, policy=RetryPolicy(max_restarts=2))


def test_watchdog_context_and_straggler_monitor():
    fired = []
    with StepWatchdog(30.0, on_expire=lambda: fired.append(1)) as wd:
        wd.beat()
    assert not fired and not wd.expired
    mon = StragglerMonitor(window=32, k=5.0)
    assert not any(mon.record(i, 0.1 + 0.001 * (i % 3)) for i in range(20))
    assert mon.record(20, 1.5) is True and mon.flagged == [20]


@pytest.mark.resilience
def test_watchdog_fires_on_hang():
    fired = threading.Event()
    dog = StepWatchdog(0.05, on_expire=fired.set)
    dog.beat()
    assert fired.wait(10.0) and dog.expired
    dog.stop()


# -------------------------------------------------------------- supervisor
def test_supervisor_error_retry_and_counters():
    sup = ShardSupervisor(ResilienceConfig(
        shard_timeout_s=None, retry=RetryPolicy(max_restarts=0)))
    assert sup.call([0], lambda: "fine") == (True, "fine", "ok")

    def boom():
        raise ValueError("not transient")

    ok, _, why = sup.call([0], boom)
    assert not ok and why == "error:ValueError"
    st = sup.stats()
    assert st["calls"] == 2 and st["ok"] == 1 and st["errors"] == 1
    assert set(RESILIENCE_COUNTERS) - {"shed_queue_full", "shed_deadline",
                                       "shed_expired_batches"} <= set(st)
    # a transient first failure earns one in-budget relaunch
    inj = FaultInjector({3: [FaultSpec("error", until=1)]})
    sup2 = ShardSupervisor(ResilienceConfig(
        shard_timeout_s=None, fault_injector=inj,
        retry=RetryPolicy(max_restarts=1, restartable=(FaultError,))))
    assert sup2.call([3], lambda: "recovered") == (True, "recovered", "ok")
    assert sup2.stats()["retries"] == 1 and sup2.stats()["errors"] == 0
    assert [a for _, _, a in inj.log] == ["error", "ok"]
    # exhausted before launch: no call is made
    ok, _, why = sup.call([0], lambda: "x", deadline=Deadline(0.0))
    assert not ok and why == "deadline"


def test_supervisor_breaker_fast_fails_without_calling():
    inj = FaultInjector({2: [FaultSpec("error")]})
    sup = ShardSupervisor(ResilienceConfig(
        shard_timeout_s=None, breaker_failures=2, breaker_reset_s=60.0,
        fault_injector=inj, retry=RetryPolicy(max_restarts=0)))
    for _ in range(2):
        ok, _, why = sup.call([2], lambda: "x")
        assert not ok and why == "error:FaultError"
    n_log = len(inj.log)
    ok, _, why = sup.call([2], lambda: "x")
    assert not ok and why == "breaker_open"
    assert len(inj.log) == n_log  # fast-fail: the backend was never hit
    st = sup.stats()
    assert st["breaker_open_skips"] == 1 and st["breaker_trips"] == 1
    assert st["breaker_states"] == {2: "open"}


def test_supervisor_call_parallel_keeps_item_order():
    sup = ShardSupervisor(ResilienceConfig(shard_timeout_s=None))
    out = sup.call_parallel([([s], (lambda s=s: s * 10)) for s in range(4)])
    assert out == [(True, s * 10, "ok") for s in range(4)]


@pytest.mark.resilience
def test_supervisor_timeout_and_deadline_clamp():
    """A call that outlives its budget reports a timeout; the request's
    deadline clamps a long shard budget."""
    release = threading.Event()

    def hang():
        release.wait(60.0)

    try:
        sup = ShardSupervisor(ResilienceConfig(
            shard_timeout_s=0.1, retry=RetryPolicy(max_restarts=0)))
        ok, _, why = sup.call([0], hang)
        assert not ok and why == "timeout"
        assert sup.stats()["timeouts"] == 1
        sup = ShardSupervisor(ResilienceConfig(shard_timeout_s=60.0))
        t0 = time.monotonic()
        ok, _, why = sup.call([0], hang, deadline=Deadline.after(0.1))
        assert not ok and why == "timeout"
        assert time.monotonic() - t0 < 30.0  # the deadline, not the 60 s
    finally:
        release.set()


@pytest.mark.resilience
def test_supervisor_hedge_beats_a_hung_first_call():
    """The shard's first call hangs (until released, 60 s at most); the one
    duplicate fired at ``hedge_after_s`` answers.  Which of the two threads
    draws the hang is up to the scheduler, so only their sum is checked."""
    inj = FaultInjector({5: [FaultSpec("hang", until=1)]}, hang_s=60.0)
    sup = ShardSupervisor(ResilienceConfig(
        shard_timeout_s=None, hedge_after_s=0.05, fault_injector=inj,
        retry=RetryPolicy(max_restarts=1, restartable=(FaultError,))))
    try:
        ok, val, why = sup.call([5], lambda: "answer")
        assert (ok, val, why) == (True, "answer", "ok")
        assert sup.stats()["hedges"] == 1
        assert sorted(a for _, _, a in inj.log) == ["hang", "ok"]
    finally:
        inj.release()


# ----------------------------------------------------- batcher / shedding
def test_batcher_sheds_and_batches_carry_deadlines():
    b = MicroBatcher(d=3, slot_size=4, max_pending=2)
    b.submit(np.zeros(3, np.float32), k=1)
    b.submit(np.zeros(3, np.float32), k=1, deadline=Deadline.after(30.0))
    with pytest.raises(QueryRejected) as e:
        b.submit(np.zeros(3, np.float32), k=1)
    assert e.value.reason == "queue_full"
    # an exhausted budget outranks queue state in the rejection reason
    with pytest.raises(QueryRejected) as e:
        b.submit(np.zeros(3, np.float32), k=1, deadline=Deadline(0.0))
    assert e.value.reason == "deadline"
    # force=True bypasses admission control (the engine's drop-in path)
    near = Deadline.after(5.0)
    b.submit(np.zeros(3, np.float32), k=1, deadline=near, force=True)
    (mb,) = list(b.drain())
    assert mb.occupancy == 3 and len(mb.deadlines) == 3
    assert mb.deadline is near  # earliest across the batch


# ----------------------------------------------------------------- engine
def test_engine_sheds_queue_full_and_expired_deadline():
    m = MutableP2HIndex.from_data(_mkdata(64, seed=3), n0=32, device="cpu")
    eng = P2HEngine(m, slot_size=4,
                    resilience=ResilienceConfig(max_pending=1))
    q = _queries(1)[0]
    eng.submit(q, k=2)
    with pytest.raises(QueryRejected) as e:
        eng.submit(q, k=2)
    assert e.value.reason == "queue_full"
    eng.flush()
    with pytest.raises(QueryRejected) as e:
        eng.submit(q, k=2, deadline_s=0.0)
    assert e.value.reason == "deadline"
    with pytest.raises(QueryRejected):
        eng.query(q, k=2, deadline_s=0.0)
    res = eng.stats()["resilience"]
    assert res["shed_queue_full"] == 1 and res["shed_deadline"] == 2
    assert set(RESILIENCE_COUNTERS) <= set(res)
    m.close()


def test_engine_armed_serves_the_plain_path_bit_for_bit():
    """On a single index an armed engine (deadlines included) runs the
    plain path: the same answers, and the exchange's supervisor is never
    called -- only a sharded index's exchange is supervised."""
    m = MutableP2HIndex.from_data(_mkdata(300, seed=1), n0=32, device="cpu")
    q = _queries(5)
    bd0, bi0 = P2HEngine(m, slot_size=4).query(q, k=4)
    armed = P2HEngine(m, slot_size=4,
                      resilience=ResilienceConfig(shard_timeout_s=60.0))
    bd1, bi1, metas = armed.query(q, k=4, deadline_s=60.0, return_meta=True)
    assert np.array_equal(bd0, bd1) and np.array_equal(bi0, bi1)
    assert all(mt["complete"] and not mt["degraded"] for mt in metas)
    assert armed.stats()["resilience"]["calls"] == 0
    m.close()


@pytest.mark.resilience
def test_engine_expired_batch_shed_returns_inf_not_exception():
    m = MutableP2HIndex.from_data(_mkdata(64, seed=4), n0=32, device="cpu")
    eng = P2HEngine(m, slot_size=4)
    t = eng.submit(_queries(1)[0], k=2, deadline_s=0.05)
    dl = eng.batcher._queue[0].deadline
    for _ in range(1000):  # the budget dies in the queue (bounded wait)
        if dl.expired:
            break
        time.sleep(0.01)
    assert dl.expired
    eng.flush()
    mt = eng.result_meta(t)  # meta travels with the result: read it first
    assert mt["shed"] and not mt["complete"]
    bd, bi = eng.result(t)
    assert np.all(np.isinf(bd)) and np.all(bi == -1)
    assert eng.stats()["resilience"]["shed_expired_batches"] == 1
    t2 = eng.submit(_queries(1)[0], k=2)
    eng.flush()
    assert eng.result_meta(t2)["complete"]
    eng.result(t2)
    m.close()
