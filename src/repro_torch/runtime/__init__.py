"""Host runtime of the port: restart supervision, the step watchdog and
straggler detection (``fault_tolerance``), which the serving layer's shard
supervisor runs on, and elastic resharding onto another mesh
(``elastic``)."""
from repro_torch.runtime.elastic import (  # noqa: F401
    elastic_remesh,
    specs_for_mesh,
)
from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    RetryPolicy,
    StepWatchdog,
    StragglerMonitor,
    run_with_restarts,
)

__all__ = ["RetryPolicy", "run_with_restarts", "StepWatchdog",
           "StragglerMonitor", "elastic_remesh", "specs_for_mesh"]
