"""Layer 2: rules over a walk of each stage's body (the port's counterpart
of ``repro.staticcheck.jaxpr_rules``).

Each rule reads one :class:`~repro_torch.staticcheck.flops.StageWalk` of a
stage body run on zero tensors of a recorded signature, or the engine's
recorded signatures; no workload is re-run.

* **SC301** — an int8 operand widened to a float dtype feeds a
  matmul-class op (through layout-only ops) outside a ``kernels/ops``
  entry point: that projection silently runs in float.  Inside an entry
  point the plain version's arithmetic is not linted; the kernel tests
  hold it.
* **SC302** — after the walk every cache leaf keeps its storage
  (``untyped_storage().data_ptr()``: a CUDA graph holds raw pointers),
  and no op of the walk copies a whole pool (``clone``, ``_to_copy`` or
  ``cat`` of a pool leaf).  The counterpart of the reference's failed
  donation.
* **SC303** — a host sync or transfer inside the body:
  ``aten._local_scalar_dense`` / ``aten.item``, a copy between devices,
  or an op whose output shape depends on the data (``nonzero``,
  ``masked_select``, indexing by a boolean mask).
* **SC304** — distinct recorded signatures per stage equal the mode's
  pins (``GridCell.expected_pins``); on the card a captured stage's
  ``captures`` also equal its signatures.
* **SC305** — ``torch.utils.flop_counter.FlopCounterMode``'s count of
  the same run lies in the static bracket ``[dot_flops x (1 -
  FLOPS_RTOL), (dot_flops + 2 x padding_macs) x (1 + FLOPS_RTOL)]`` (it
  counts matmul-class ops only, so the static number it checks is the
  dot flops; it also counts what ``fixed_bmm``'s calls run on their zero
  padding, which the static count reports apart), and ``io_bytes`` is at
  most ``bytes_accessed`` x (1 + ``FLOPS_RTOL``).  Plain-route walks
  only: on the card the kernels are extension calls the dispatcher never
  sees, as the reference exempts its Pallas cells.

(**SC306**, static against analytic MACs, lives in ``runner``: it needs
the cell's stage geometry.)
"""

from __future__ import annotations

import hashlib

from repro_torch.staticcheck.findings import Finding
from repro_torch.staticcheck.flops import walk_stage
from repro_torch.tree import tree_leaves

# the flop counter and the static walk are two counts of one run: the
# counter sees the plain versions' products inside the costed calls, the
# walk their costs from shapes
FLOPS_RTOL = 0.50


def signature_hash(signature) -> str:
    """Deterministic digest of one recorded call signature."""
    h = hashlib.blake2b(digest_size=12)
    h.update(repr(signature).encode())
    return h.hexdigest()


def _pointers(leaves) -> list:
    return [t.untyped_storage().data_ptr() for t in leaves]


def check_stage(stage, stage_name: str, cell: str, caches,
                plain_route: bool = True):
    """SC301/SC302/SC303 (and SC305 on the plain route) over every
    recorded signature of one stage; ``caches()`` returns the engine's
    cache tree (called again after each walk: a body may rebind it).
    Returns ``(findings, costs)``, ``costs`` one dict per signature."""
    path = f"graph:{cell}"
    findings: list = []
    costs: list = []
    for sig in stage.signatures:
        pools = tree_leaves(caches())
        before = _pointers(pools)
        walk, counted = walk_stage(stage, sig, pools,
                                   flop_counter=plain_route)
        cost = walk.cost
        for what in dict.fromkeys(walk.widened_products):
            findings.append(Finding(
                "SC301", path, stage_name,
                f"quantized operand {what} outside a kernels/ops entry "
                "point: the projection silently runs in float"))
        after = _pointers(tree_leaves(caches()))
        moved = len(after) != len(before) or sum(
            a != b for a, b in zip(before, after))
        if moved:
            findings.append(Finding(
                "SC302", path, stage_name,
                f"cache leaves changed storage in a rerun ({len(before)} "
                "before): a captured graph writes the old pools"))
        for what in dict.fromkeys(walk.pool_copies):
            findings.append(Finding(
                "SC302", path, stage_name,
                f"{what} in the body: the pool is copied every dispatch"))
        for what in dict.fromkeys(walk.host_ops):
            findings.append(Finding(
                "SC303", path, stage_name,
                f"host sync or transfer {what!r} in a stage body: a stage "
                "is pure device work, read back once by the engine"))
        row = {"stage": stage_name, "cell": cell,
               "signature": signature_hash(sig), **cost.to_dict(),
               "hooked_calls": walk.hooked_calls}
        if plain_route:
            lo = cost.dot_flops * (1 - FLOPS_RTOL)
            hi = (cost.dot_flops + 2 * cost.padding_macs) * (1 + FLOPS_RTOL)
            if not lo <= counted <= hi:
                findings.append(Finding(
                    "SC305", path, stage_name,
                    f"FlopCounterMode counts {counted} flops, outside the "
                    f"static bracket [{lo:.0f}, {hi:.0f}] (dot flops "
                    f"{cost.dot_flops}, padding {2 * cost.padding_macs}, "
                    f"+/- {FLOPS_RTOL:.0%}): the static front-end is off"))
            if cost.io_bytes > cost.bytes_accessed * (1 + FLOPS_RTOL):
                findings.append(Finding(
                    "SC305", path, stage_name,
                    f"static io_bytes {cost.io_bytes} exceeds the ops' "
                    f"bytes accessed {cost.bytes_accessed}"))
            row["flop_counter_flops"] = counted
        costs.append(row)
    return findings, costs


def check_pins(engine, expected: dict, cell: str,
               captured: bool = False) -> list:
    """SC304: distinct recorded signatures per stage == the pinned
    counts, proven by hashing the signatures; with ``captured`` (an engine
    on the card), a captured stage's graphs equal its signatures too."""
    findings = []
    path = f"graph:{cell}"
    stages = engine.stage_programs()
    for name, pin in expected.items():
        stage = stages.get(name)
        sigs = stage.signatures if stage is not None else ()
        if len(sigs) != pin:
            hashes = sorted(signature_hash(s) for s in sigs)
            findings.append(Finding(
                "SC304", path, name,
                f"{len(sigs)} distinct signatures recorded (hashes "
                f"{hashes[:4]}) but the pin is {pin}: a new signature "
                "means a new capture"))
    for name, stage in stages.items():
        if name not in expected and stage.signatures:
            findings.append(Finding(
                "SC304", path, name,
                f"stage ran {len(stage.signatures)} signatures but has "
                "no pin for this mode"))
    if captured:
        for name, n in engine.capture_counts.items():
            sigs = len(stages[name].signatures) if name in stages else 0
            if n != sigs:
                findings.append(Finding(
                    "SC304", path, name,
                    f"{n} CUDA graphs captured for {sigs} signatures"))
    return findings
