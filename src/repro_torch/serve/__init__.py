"""Serving: the continuous-batching engine, its page bookkeeping and the
timed workload driver."""

from repro_torch.serve.engine import (  # noqa: F401
    Engine,
    Request,
    ServeConfig,
    make_serve_step,
)
from repro_torch.serve.paging import (  # noqa: F401
    HostPagePool,
    PageAllocator,
    PageTable,
    PrefixCache,
    hash_chunks,
    pages_needed,
)
from repro_torch.serve.workload import (  # noqa: F401
    WorkloadDraw,
    draw_workload,
    run_timed_workload,
)
