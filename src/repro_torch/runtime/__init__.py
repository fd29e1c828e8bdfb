from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    ElasticPlan,
    HeartbeatMonitor,
    StragglerDetector,
    plan_elastic_mesh,
)
