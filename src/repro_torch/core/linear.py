"""QuantLinear: the projection layer (port of ``repro.core.linear``).

===============  ==========================================================
``dense``        plain bf16 matmul (the "no paper" baseline)
``qat``          f32 matmul over fake-quantized operands (training mode;
                 straight-through gradients, serves what it trains)
``w8a8_nibble``  int8 activations x int8 weights through the nibble planes:
                 ``X.W = (X_hi.W) << 4 + X_lo.W``
``w4a8_nibble``  int8 activations x int4-valued weights (same product)
``lut``          int8 x int8 by selection from tables of pre-scaled
                 weights (the paper's LUT-array design)
===============  ==========================================================

Two backends for the integer modes: ``"torch"`` is the reference's
``"xla"`` formula (``linear.py:154-160``: plane-concatenated integer
product, or the LUT selection formula, then the scales applied outside),
and ``"cuda"`` is its ``"pallas"`` routing (``linear.py:144-152``: one
``ops.quant_matmul`` call; the nibble kernel runs the epilogue itself,
the LUT kernel returns int32 and the epilogue below applies it).  All apply
``acc.float() * x_scale * w_scale`` and then the cast, in that order, so
every route is bit-identical to the others.  ``dense`` and ``qat`` are
plain products that the reference leaves to XLA, so both backends run
``torch.matmul``.

Weights are stored ``(in, out)`` like the reference.  Serving quantizes
each weight once (:func:`prepare_quantized`) - the values are a pure
function of the weight, identical to quantizing on every call - and keeps
the int8 copy N-major, the layout the kernels read.

Tensor parallelism (``distributed.sharding``): a column-parallel
projection is :func:`linear_apply` on each shard's slice of N (the input
is replicated, so every shard takes the same per-tensor activation
scale).  A row-parallel one is :func:`linear_apply_row`: each shard holds
a slice of K, and in the int modes the shards agree on the activation
scale (a max of their amaxes), take their exact int32 partial products,
sum them and apply the epilogue once, so the result is the unsharded
projection bit for bit.  ``dense`` and ``qat`` sum f32 partial products
in shard order and round once (``qat`` with the unsharded fake-quant
scales): within a rounding of the unsharded projection.

A data axis (``dp`` rows, each running its own slots): the int modes'
per-tensor activation scale spans the whole batch, so every row
quantizes with the max of all rows' amaxes (:func:`rows_amax`, passed as
``x_amax``) and each row's output is its slots' rows of the unsplit
projection, bit for bit.  ``qat`` quantizes per row and needs nothing.
"""

from __future__ import annotations

import torch

from repro_torch.core import quantize as q
from repro_torch.distributed.collectives import all_reduce_max, \
    broadcast, reduce_sum
from repro_torch.kernels import ops
from repro_torch.kernels.lut_matmul import lut_matmul_plain
from repro_torch.kernels.nibble_matmul import nibble_matmul_plain

__all__ = ["linear_init", "linear_apply", "linear_apply_row",
           "prepare_quantized", "weight_bits", "rows_amax"]

_INT_MODES = ("w8a8_nibble", "w4a8_nibble", "lut")   # int8 activations


def linear_init(in_dim: int, out_dim: int, *, generator: torch.Generator,
                device, dtype=torch.bfloat16) -> dict:
    """He-style init, weights stored (in_dim, out_dim)."""
    scale = (2.0 / (in_dim + out_dim)) ** 0.5
    w = torch.randn((in_dim, out_dim), generator=generator, device=device,
                    dtype=torch.float32) * scale
    return {"w": w.to(dtype)}


def weight_bits(mode: str) -> int:
    return 4 if mode == "w4a8_nibble" else 8


def _quantize_weight(w: torch.Tensor, bits: int):
    """Per-output-channel symmetric quantization (``quantize.py:79``):
    returns the int8 values N-major (out, in) and the (1, out) scale."""
    wq = q.quantize(w.to(torch.float32), bits=bits,
                    granularity="per_channel", axis=0)
    return wq.values.t().contiguous(), wq.scale.reshape(1, -1)


def prepare_quantized(params: dict, mode: str) -> None:
    """Quantize one linear's weight for ``mode`` once, in place (adds
    ``qt{bits}`` (out, in) int8 and ``s{bits}`` (1, out) f32); a linear
    that already carries ``qt{bits}`` is left as it is, and ``w`` always
    stays (a dense verifier reads it beside a quantized draft)."""
    if mode in _INT_MODES:
        bits = weight_bits(mode)
        if f"qt{bits}" not in params:
            params[f"qt{bits}"], params[f"s{bits}"] = _quantize_weight(
                params["w"], bits)


def _weight(params: dict, bits: int):
    """(K, N) int8 weight view and its (1, N) scale: the prepared copy, or
    quantized now when the weight was never prepared."""
    if f"qt{bits}" in params:
        qt, s = params[f"qt{bits}"], params[f"s{bits}"]
    else:
        qt, s = _quantize_weight(params["w"], bits)
    return qt.t(), s


def _amax(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).abs().max()


def rows_amax(rows: list, mode: str) -> list | None:
    """The batch-wide activation amax over data rows: ``rows[d]`` holds
    row ``d``'s inputs of one projection, one per model shard (the same
    tensor, or copies, where the input is replicated; each shard's slice
    for a row-parallel one).  In the int modes with more than one row,
    the max over every input (exact in any order) on each entry's
    device, ``[d][m]``; else None (each call takes its own)."""
    if len(rows) < 2 or mode not in _INT_MODES:
        return None
    seen: dict = {}
    for row in rows:
        for x in row:
            seen.setdefault(id(x), x)
    amax = all_reduce_max([_amax(x) for x in seen.values()])[0]
    return [broadcast(amax, [x.device for x in row]) for row in rows]


def linear_apply(params: dict, x: torch.Tensor, *, mode: str = "dense",
                 backend: str = "torch", x_amax=None) -> torch.Tensor:
    """Apply the projection; the output dtype follows ``x``.  ``x_amax``
    (int modes) replaces the per-tensor amax of ``x`` (a data row's
    projection takes the whole batch's, :func:`rows_amax`)."""
    if mode == "dense":
        return torch.matmul(x, params["w"].to(x.dtype))
    if mode == "qat":
        xq = q.fake_quant(x.to(torch.float32), bits=8, axis=-1)
        wq = q.fake_quant(params["w"].to(torch.float32), bits=8, axis=0)
        return torch.matmul(xq, wq).to(x.dtype)
    if mode not in _INT_MODES:
        raise NotImplementedError(f"quant mode {mode!r} is not ported")

    x_qt = q.quantize(x.to(torch.float32), bits=8, granularity="per_tensor",
                      scale=None if x_amax is None
                      else q.scale_from_amax(x_amax))
    w_q, w_scale = _weight(params, weight_bits(mode))
    if backend == "cuda" and mode != "lut":
        return ops.quant_matmul(x_qt.values, w_q, x_scale=x_qt.scale,
                                w_scale=w_scale, out_dtype=x.dtype)
    acc = _int_product(x_qt.values, w_q, mode, backend)
    out = acc.to(torch.float32) * x_qt.scale * w_scale
    return out.to(x.dtype)


def _int_product(x_q, w_q, mode: str, backend: str) -> torch.Tensor:
    """The exact int32 product of int8 activations and weights: the LUT
    kernel or the nibble kernel's unscaled mode on ``"cuda"`` (their
    plain versions on CPU tensors), the reference's formulas on
    ``"torch"``."""
    if backend == "cuda":
        return ops.quant_matmul(x_q, w_q,
                                w_format="lut" if mode == "lut" else "int8")
    if backend == "torch":
        matmul = lut_matmul_plain if mode == "lut" else nibble_matmul_plain
        return matmul(x_q, w_q)
    raise ValueError(f"quant_backend must be 'torch' or 'cuda', got "
                     f"{backend!r}")


def linear_apply_row(shards: list, xs: list, *, mode: str = "dense",
                     backend: str = "torch", x_amax=None) -> list:
    """A row-parallel projection: shard ``s`` holds rows ``[s K/tp, (s +
    1) K/tp)`` of the weight (its ``qt{bits}`` the same K slice, its
    scales whole) and ``xs[s]`` the matching columns of the input.
    Returns the whole output on every shard.  In the int modes: the
    activation amax is reduced by max, so the per-tensor scale is the
    unsharded one; each shard's exact int32 partial product is summed in
    shard order; the epilogue ``(float(acc) * x_scale) * w_scale`` then
    the cast run once on the sum: bit for bit the unsharded projection.
    ``dense`` sums f32 partial products and rounds once; ``qat`` takes
    the activation's per-row and the weight's per-column scales from the
    max of the shards' amaxes (the unsharded scales), fake-quantizes each
    shard's slices with them and sums the f32 partial products the same
    way: within a rounding of the unsharded projection, not bit for
    bit.  One shard is :func:`linear_apply`.  ``x_amax`` (one per shard,
    int modes) replaces the shards' reduced amax (a data row takes the
    whole batch's)."""
    if len(shards) == 1:
        return [linear_apply(shards[0], xs[0], mode=mode, backend=backend,
                             x_amax=None if x_amax is None else x_amax[0])]
    dtype = xs[0].dtype
    devices = [x.device for x in xs]
    if mode == "dense":
        parts = [torch.matmul(x.to(torch.float32),
                              p["w"].to(torch.float32))
                 for p, x in zip(shards, xs)]
        return broadcast(reduce_sum(parts).to(dtype), devices)
    if mode == "qat":
        # the per-row activation scale and the per-column weight scale
        # each span the whole K: a max of the shards' amaxes
        xs = [x.to(torch.float32) for x in xs]
        ws = [p["w"].to(torch.float32) for p in shards]
        x_amax = all_reduce_max([x.abs().amax(dim=-1, keepdim=True)
                                 for x in xs])
        w_amax = all_reduce_max([w.abs().amax(dim=0, keepdim=True)
                                 for w in ws])
        parts = [torch.matmul(
            q.fake_quant(x, bits=8, scale=q.scale_from_amax(xa)),
            q.fake_quant(w, bits=8, scale=q.scale_from_amax(wa)))
            for x, w, xa, wa in zip(xs, ws, x_amax, w_amax)]
        return broadcast(reduce_sum(parts).to(dtype), devices)
    if mode not in _INT_MODES:
        raise NotImplementedError(f"quant mode {mode!r} has no "
                                  f"row-parallel projection")
    bits = weight_bits(mode)
    amax = x_amax or all_reduce_max([_amax(x) for x in xs])
    accs = []
    for p, x, a in zip(shards, xs, amax):
        x_q = q.quantize(x.to(torch.float32), bits=8,
                         scale=q.scale_from_amax(a)).values
        accs.append(_int_product(x_q, _weight(p, bits)[0], mode, backend))
    # the epilogue once, on shard 0's device, then a copy per device
    out = (reduce_sum(accs).to(torch.float32)
           * q.scale_from_amax(amax[0])) * _weight(shards[0], bits)[1]
    return broadcast(out.to(dtype), devices)
