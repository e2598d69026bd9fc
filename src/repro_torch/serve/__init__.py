"""P2HNNS query-serving subsystem of the port: micro-batching, backend
auto-dispatch and a lambda warm-start cache over the BC-Tree backends,
with the JAX package's public names.

``P2HEngine`` (engine.py)
    The front-end.  Streaming (``submit``/``flush``/``result``) or
    drop-in (``query``, also via ``P2HIndex.query(..., engine=...)`` and
    ``MutableP2HIndex.query(..., engine=...)``).

Micro-batching (batcher.py)
    Incoming queries are drained into fixed-shape slot batches (static
    ``slot_size`` rows, padded by replicating a live slot).

Dispatch policy (dispatch.py)
    Decided per micro-batch:

      * ``recall_target < 1``   -> ``beam`` (candidate-fraction knob);
      * high segment fan-out    -> ``stacked`` (every sealed segment of a
        mutable snapshot in one two-pass launch of the stacked kernel);
      * tiny occupancy          -> ``dfs`` (on the host only: on a CUDA
        device the engine opens no DFS window);
      * batched exact           -> ``pallas`` (the CUDA sweep kernel; the
        engine prefers it on a CUDA device) or the plain ``sweep``.

Lambda cache (lambda_cache.py)
    Caps from previously-served queries with nearby normals
    (sign-canonical SRP buckets), epoch-tagged against a mutable index's
    deletes.  A valid cap only prunes candidates whose lower bound exceeds
    the true k-th distance, so warm answers equal cold ones bit for bit.

Resilience (resilience.py)
    Deadlines, admission control (``QueryRejected``), the shard
    supervisor (timeouts, circuit breakers, hedging) and a deterministic
    ``FaultInjector``.  The supervisor runs the degraded-capable
    two-round exchange of a sharded mutable index: a failing shard's
    answer is dropped whole, and the rest is exact over the live shards
    (``missing_shards``, ``complete``).
"""
from repro_torch.serve.batcher import MicroBatch, MicroBatcher, Request
from repro_torch.serve.dispatch import DispatchPolicy, Route
from repro_torch.serve.engine import P2HEngine
from repro_torch.serve.lambda_cache import LambdaCache
from repro_torch.serve.resilience import (CircuitBreaker, Deadline,
                                          DeviceFault, FaultError,
                                          FaultInjector,
                                          FaultSpec, QueryRejected,
                                          ResilienceConfig, ShardSupervisor)

__all__ = ["P2HEngine", "DispatchPolicy", "Route", "LambdaCache",
           "MicroBatcher", "MicroBatch", "Request", "Deadline",
           "CircuitBreaker", "DeviceFault", "FaultError", "FaultInjector", "FaultSpec",
           "QueryRejected", "ResilienceConfig", "ShardSupervisor"]
