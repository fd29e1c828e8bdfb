"""Static-analysis gate for the port's serving hot-path contracts (port
of ``repro.staticcheck``).

Two layers:

* **AST rules** (``ast_rules``) lint the ``src/repro_torch`` tree for
  host syncs and capture hazards in the engine's stage bodies, ad-hoc
  syncs in ``serve/``, caches rebound instead of written in place, and
  ``serve/paging.py`` staying host-side numpy.
* **Graph rules** (``graph_rules``) build tiny engines across a quant x
  mode grid, run every stage's body once more on zero tensors of each
  recorded signature under a ``TorchDispatchMode``, and check the dtype,
  cache-storage, host-sync and signature-pin contracts on what ran.  The
  same walk counts each stage's MACs, flops and bytes (``flops``), the
  same whichever implementation runs it (the kernels' cost hook), checked
  against the closed-form model and ``torch.utils.flop_counter``: the
  roofline's static front-end.

Findings flow through a committed suppression baseline (``baseline.json``
beside this file); the CLI is ``python -m repro_torch.staticcheck``.
"""

from repro_torch.staticcheck.ast_rules import run_ast_rules
from repro_torch.staticcheck.findings import (Finding, apply_baseline,
                                              load_baseline)
from repro_torch.staticcheck.runner import (GRID_CELLS, run_gate,
                                            run_graph_layer)

__all__ = ["Finding", "load_baseline", "apply_baseline",
           "run_ast_rules", "GRID_CELLS", "run_gate",
           "run_graph_layer"]
