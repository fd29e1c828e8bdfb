"""Static flop/byte counts of a stage's body, and the analytic bridge (port
of ``repro.staticcheck.flops``).

The reference walks a stage's jaxpr.  The port has no graph to walk
before a run, so :func:`walk_stage` runs the stage's *body* once, eagerly,
on zero tensors of a recorded signature (``_StageCounter.abstract_args``)
under a ``TorchDispatchMode`` that sees every aten op, and counts:

* ``int_dot_macs`` / ``float_dot_macs``: ``batch * M * N * K`` per
  matmul-class op (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``_int_mm``,
  ``mv``, ``dot``), split by operand dtype class;
* ``elementwise_flops``: one per output element of arithmetic ops;
* ``bytes_accessed``: every op's tensor inputs and outputs summed (view
  ops move no bytes and count nothing, nor do metadata queries);
* ``padding_macs``: what ``fixed_bmm``'s fixed-shape calls run on their
  zero padding, beyond the stage's work (not in the MACs);
* ``io_bytes``: the dispatch's HBM floor, see below.

**The kernel cost hook.**  While a walk runs it sets
``kernels.ops.cost_hook``: every costed entry point (``quant_matmul``,
``flash_mha``, ``flash_mha_bwd``, ``paged_flash_decode``, and
``models.layers.fixed_bmm``,
whose fixed-shape calls pad with zeros) hands over its call with its cost
from shapes alone, and the walk counts nothing inside it.  So a stage
counts the same on the plain route (CPU tensors: the plain versions run
inside) and on the CUDA route (extension calls the dispatcher never
sees).  Nibble-format products count twice their K, one per activation
plane, the reference's plane-concatenated contract.

**``io_bytes`` differs from the reference's.**  The reference counts a
stage's input and output avals, and params and caches are among them
because they are jit arguments.  The port's params and caches are engine
attributes, not arguments, and the params keep the bf16 weights beside
the int8 ones (an entry of yi-6b stores 17.66 GB).  So the port counts
every distinct storage that existed before the body and that the body
reads, once; plus every such storage it writes in place, once; plus the
storages of what it returns.  Caches written in place count on both
sides, as the reference's donated pools do.  Storages the body makes and
drops count nothing.

The port has no scan, so ``scan_once_flops`` equals ``total_flops``.

``analytic_macs`` computes the MACs in closed form from the
``ModelConfig`` and the stage geometry (two independent derivations of
one number); ``cycle_bridge`` turns MACs into multiplier cycles through
``core.cycle_model.cycles_per_operand``.
"""

from __future__ import annotations

import dataclasses
import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.core.cycle_model import cycles_per_operand
from repro_torch.kernels import ops

# arithmetic ops counted at one flop per output element (in-place forms
# too: a trailing underscore is dropped before the lookup)
_ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "remainder", "fmod", "maximum",
    "minimum", "pow", "exp", "exp2", "log", "log1p", "expm1", "tanh",
    "sigmoid", "rsqrt", "sqrt", "reciprocal", "sign", "abs", "neg",
    "floor", "ceil", "round", "erf", "cos", "sin", "where", "clamp",
    "clamp_min", "clamp_max", "atan2", "silu", "gelu", "_softmax",
    "_log_softmax",
}
# ops that rearrange or copy bytes unchanged: a widened integer operand
# on the far side of these is still the same operand (SC301)
_LAYOUT = {"clone", "cat", "constant_pad_nd", "flip", "_unsafe_view",
           "repeat", "index_select", "copy"}
# whole-pool copies a rerun must not make (SC302)
_POOL_COPIES = {"clone", "_to_copy", "cat", "copy"}
# host syncs and ops whose output shape depends on the data (SC303)
_HOST_SYNCS = {"_local_scalar_dense", "item", "nonzero", "masked_select",
               "_unique", "_unique2", "unique_dim", "unique_consecutive"}
_QUANT_DTYPES = (torch.int8, torch.uint8)


@dataclasses.dataclass
class StageCost:
    int_dot_macs: int = 0       # integer-operand products (the quant path)
    float_dot_macs: int = 0     # float-operand products (attention, dense)
    elementwise_flops: int = 0
    io_bytes: int = 0
    bytes_accessed: int = 0
    # MACs the fixed-shape calls run on their zero padding, beyond the
    # stage's work (not in ``dot_macs``; executed all the same)
    padding_macs: int = 0

    @property
    def dot_macs(self) -> int:
        return self.int_dot_macs + self.float_dot_macs

    @property
    def dot_flops(self) -> int:
        return 2 * self.dot_macs

    @property
    def total_flops(self) -> int:
        return self.dot_flops + self.elementwise_flops

    @property
    def scan_once_flops(self) -> int:
        """The port has no scan: the total."""
        return self.total_flops

    def to_dict(self) -> dict:
        return {
            "dot_flops": self.dot_flops,
            "dot_macs": self.dot_macs,
            "int_dot_macs": self.int_dot_macs,
            "float_dot_macs": self.float_dot_macs,
            "elementwise_flops": self.elementwise_flops,
            "total_flops": self.total_flops,
            "scan_once_flops": self.scan_once_flops,
            "io_bytes": self.io_bytes,
            "bytes_accessed": self.bytes_accessed,
            "padding_macs": self.padding_macs,
        }


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage(t: torch.Tensor):
    """``(key, bytes)`` of ``t``'s storage; None for an empty one.  A
    fake (or ``meta``) storage has no address, so its identity keys it."""
    st = t.untyped_storage()
    n = st.nbytes()
    if n == 0:
        return None
    fake = isinstance(t, FakeTensor) or t.device.type == "meta"
    return (str(t.device), st._cdata if fake else st.data_ptr()), n


def _fresh(ins, outs) -> list:
    """The tensors of ``outs`` on storages none of ``ins`` holds (not a
    view, nor an input handed back)."""
    held = {k[0] for k in map(_storage, ins) if k is not None}
    return [t for t in outs if (_storage(t) or (None,))[0] not in held]


def _name(func) -> str:
    return func.overloadpacket.__name__


def _product_macs(name: str, args) -> tuple | None:
    """``(macs, operands)`` of a matmul-class op, None for any other."""
    if name in ("mm", "_int_mm"):
        a, b = args[0], args[1]
        return a.shape[0] * a.shape[1] * b.shape[1], (a, b)
    if name == "addmm":
        a, b = args[1], args[2]
        return a.shape[0] * a.shape[1] * b.shape[1], (a, b)
    if name == "bmm":
        a, b = args[0], args[1]
        return a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2], (a, b)
    if name == "baddbmm":
        a, b = args[1], args[2]
        return a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2], (a, b)
    if name in ("mv", "dot", "vdot"):
        a, b = args[0], args[1]
        return a.numel(), (a, b)
    return None


class StageWalk(TorchDispatchMode):
    """One walk of a stage body: its :class:`StageCost` and what the
    graph rules read (``widened_products`` for SC301, ``pool_copies`` for
    SC302, ``host_ops`` for SC303).  ``pools``: the engine's cache leaves.
    Enter it (``with``) around the body; it sets and clears the kernels'
    cost hook."""

    def __init__(self, pools=()):
        super().__init__()
        self.cost = StageCost()
        self.widened_products: list = []
        self.pool_copies: list = []
        self.host_ops: list = []
        self.hooked_calls = 0
        self._pools = {}
        for p in pools:
            key = _storage(p)
            if key is not None:
                self._pools[key[0]] = p.numel()
        self._depth = 0                       # inside a costed call
        self._created: set = set()            # storages made in the walk
        self._read: dict = {}                 # older storages read
        self._written: dict = {}              # older storages written
        # id(tensor) -> (weak ref, integer dtype it was widened from);
        # tensors compare elementwise, so they are never dict keys
        self._widened: dict = {}

    # -- the hook -----------------------------------------------------------

    def _hook(self, fn, cost, args, kwargs):
        if self._depth:
            return fn(*args, **kwargs)
        int_macs, float_macs, nbytes, padding = cost(*args, **kwargs)
        ins = _tensors((args, kwargs))
        self._reads(ins)
        self._depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            self._depth -= 1
        self._make(_fresh(ins, _tensors(out)))
        self.cost.int_dot_macs += int_macs
        self.cost.float_dot_macs += float_macs
        self.cost.bytes_accessed += nbytes
        self.cost.padding_macs += padding
        self.hooked_calls += 1
        return out

    def __enter__(self):
        if ops.cost_hook is not None:
            raise RuntimeError("a static walk is already running")
        ops.cost_hook = self._hook
        return super().__enter__()

    def __exit__(self, *exc):
        ops.cost_hook = None
        return super().__exit__(*exc)

    def _widened_from(self, t):
        entry = self._widened.get(id(t))
        return entry[1] if entry is not None and entry[0]() is t else None

    def _widen(self, t, dtype) -> None:
        self._widened[id(t)] = (weakref.ref(t), dtype)

    # -- storages -----------------------------------------------------------

    def _reads(self, tensors) -> None:
        for t in tensors:
            key = _storage(t)
            if key is not None and key[0] not in self._created:
                self._read[key[0]] = key[1]

    def _make(self, tensors) -> None:
        for t in tensors:
            key = _storage(t)
            if key is not None:
                self._created.add(key[0])

    def finish(self, outputs) -> StageCost:
        """Close the walk on the body's outputs: ``io_bytes``."""
        out = {}
        for t in _tensors(outputs):
            key = _storage(t)
            if key is not None:
                out[key[0]] = key[1]
        self.cost.io_bytes = (sum(self._read.values())
                              + sum({**self._written, **out}.values()))
        return self.cost

    # -- the ops ------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._depth:
            self._observe(func, args, kwargs, out)
        else:
            # made inside a costed call: never an older storage, even
            # where autograd keeps it for the backward pass
            self._make(_fresh(_tensors((args, kwargs)), _tensors(out)))
        return out

    def _observe(self, func, args, kwargs, out) -> None:
        name = _name(func)
        schema = func._schema
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        rets = [r.alias_info for r in schema.returns]
        is_view = bool(rets) and all(a is not None and not a.is_write
                                     for a in rets)
        written = []
        for i, arg in enumerate(schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            val = args[i] if i < len(args) else kwargs.get(arg.name)
            written += _tensors(val)

        if name in _HOST_SYNCS:
            self.host_ops.append(name)
        if name in ("index", "index_put", "index_put_") and any(
                t.dtype == torch.bool for t in _tensors(args[1])):
            self.host_ops.append(f"{name} by a boolean mask")
        if name in ("_to_copy", "copy_", "copy") and ins and outs:
            src = args[1] if name in ("copy_", "copy") else ins[0]
            dst = outs[0]
            if src.device != dst.device:
                self.host_ops.append(f"{name} {src.device} -> {dst.device}")
        if name in _POOL_COPIES:
            for t in ins:
                key = _storage(t)
                if (key is not None and key[0] in self._pools
                        and t.numel() >= self._pools[key[0]]):
                    self.pool_copies.append(
                        f"{name} of a pool leaf {tuple(t.shape)}")

        # SC301: integer operands widened to float, through layout ops
        src_int = next((d for d in map(self._widened_from, ins)
                        if d is not None), None)
        if name == "_to_copy" and ins and outs:
            if ins[0].dtype in _QUANT_DTYPES and outs[0].is_floating_point():
                self._widen(outs[0], ins[0].dtype)
        elif src_int is not None and (is_view or name in _LAYOUT):
            for t in outs:
                self._widen(t, src_int)

        if not outs and not written:
            return          # a metadata query (``prim::device``)
        if name == "lift_fresh":
            self._make(ins)     # a constant the body made
        self._reads(ins)
        for t in written:
            key = _storage(t)
            if key is not None and key[0] not in self._created:
                self._written[key[0]] = key[1]
        if is_view:
            return
        self._make(t for t in outs if not any(t is w for w in written))

        nbytes = sum(t.numel() * t.element_size() for t in ins + outs)
        self.cost.bytes_accessed += nbytes
        prod = _product_macs(name, args)
        if prod is not None:
            macs, operands = prod
            if all(not t.is_floating_point() and not t.is_complex()
                   for t in operands):
                self.cost.int_dot_macs += macs
            else:
                self.cost.float_dot_macs += macs
            for t in operands:
                src = self._widened_from(t)
                if src is not None:
                    self.widened_products.append(
                        f"{src} widened to {t.dtype} feeds "
                        f"{name} {tuple(operands[0].shape)} x "
                        f"{tuple(operands[1].shape)}")
            return
        if name.rstrip("_") in _ELEMENTWISE and outs:
            self.cost.elementwise_flops += outs[0].numel()


def walk_stage(stage, signature, pools=(), flop_counter: bool = False):
    """Run ``stage``'s body once on zero tensors of ``signature`` (the base
    ``_StageCounter.rerun``'s arguments: a captured stage's replay runs no
    Python, so its body is called, never its graph) under a
    :class:`StageWalk`.  The body writes the caches in place: walk a
    drained engine and ``reset`` it afterwards.  Returns ``(walk,
    flop_counter_flops)``; the second is ``torch.utils.flop_counter``'s
    count of the same run (which counts the plain versions' products
    inside the costed calls) when asked, else None."""
    from torch.utils.flop_counter import FlopCounterMode
    args = stage.abstract_args(signature)
    walk = StageWalk(pools)
    counter = FlopCounterMode(display=False) if flop_counter else None
    if counter is not None:
        with counter, walk:
            out = stage.body(*args)
    else:
        with walk:
            out = stage.body(*args)
    walk.finish(out)
    return walk, (counter.get_total_flops() if counter is not None
                  else None)


# ---------------------------------------------------------------------------
# Analytic closed-form MACs from ModelConfig — the independent derivation
# ---------------------------------------------------------------------------

def analytic_macs(cfg, tokens: int, kv_len: int, logit_positions: int,
                  quantized: bool) -> dict:
    """Closed-form per-dispatch MACs for a stage that runs ``tokens``
    tokens, attends over a padded ``kv_len`` context and projects
    ``logit_positions`` positions through the LM head (the reference's,
    copied).  Projections count q, k, v, o and a three-matrix FFN per
    layer.  The nibble plane-concat contract doubles the integer
    contraction length of every projection, so a quantized stage counts
    its linear MACs twice: the paper's W/4-cycles-per-operand trade made
    visible in the MAC count."""
    d, hd = cfg.d_model, cfg.head_dim
    per_token = cfg.n_layers * (d * cfg.n_heads * hd
                                + 2 * d * cfg.n_kv_heads * hd
                                + cfg.n_heads * hd * d
                                + 3 * d * cfg.d_ff)
    linear = tokens * per_token
    head = logit_positions * cfg.d_model * cfg.vocab_size
    attn = (tokens * kv_len * cfg.n_heads * cfg.head_dim * 2
            * cfg.n_layers)
    weight_factor = 2 if quantized else 1
    return {
        "linear_macs": linear * weight_factor,
        "attn_macs": attn,
        "head_macs": head,
        "total_macs": linear * weight_factor + attn + head,
    }


def cycle_bridge(macs: int, arch: str = "nibble_precompute",
                 width: int = 8) -> int:
    """MACs -> multiplier cycles via the paper's Table 2 model: each MAC
    streams one operand through the multiplier at
    ``cycles_per_operand(arch, width)`` cycles."""
    return macs * cycles_per_operand(arch, width)
