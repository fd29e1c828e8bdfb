"""Serving: the continuous-batching engine and its page bookkeeping."""

from repro_torch.serve.engine import Engine, Request, ServeConfig  # noqa: F401
from repro_torch.serve.paging import (  # noqa: F401
    PageAllocator,
    PageTable,
    pages_needed,
)
