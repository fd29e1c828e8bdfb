from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    HeartbeatMonitor,
    StragglerDetector,
)
