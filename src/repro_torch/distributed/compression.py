"""Gradient compression: int8 + per-tensor scale with error feedback
(port of ``repro.distributed.compression``).

Every leaf is quantized to int8 with one abs-max scale; the dequantized
tree is what the optimizer consumes after the (cross-pod) transfer.
Error feedback carries the quantization residual to the next step, so
the compression noise averages out over steps.

Over a mesh (:func:`compress_pieces_int8`) a leaf's pieces share one
scale, from the max of their amaxes: the whole tensor's, as the
reference's global leaf has.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantize import scale_from_amax
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["compress_tree_int8", "decompress_tree_int8", "ef_compress",
           "compressed_bytes", "compress_pieces_int8"]


def _comp(g, amax=None):
    g = g.to(torch.float32)
    scale = scale_from_amax(g.abs().max() if amax is None else amax,
                            floor=1e-12)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale}


def _is_packed(node) -> bool:
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def compress_tree_int8(grads):
    """Returns (dequantized f32 grads, packed tree of ``{"q", "scale"}``)."""
    packed = tree_map(_comp, grads)
    return decompress_tree_int8(packed), packed


def decompress_tree_int8(packed):
    if _is_packed(packed):
        return packed["q"].to(torch.float32) * packed["scale"]
    if isinstance(packed, dict):
        return {k: decompress_tree_int8(v) for k, v in packed.items()}
    return type(packed)(decompress_tree_int8(v) for v in packed)


def ef_compress(grads, residual):
    """Compress ``grads + residual`` and carry the new residual;
    ``residual=None`` starts from zero."""
    if residual is None:
        residual = tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                                  device=g.device), grads)
    corrected = tree_map(lambda g, r: g.to(torch.float32) + r, grads,
                         residual)
    deq, packed = compress_tree_int8(corrected)
    return deq, packed, tree_map(lambda c, d: c - d, corrected, deq)


def compressed_bytes(grads) -> tuple[int, int]:
    """(raw bytes, compressed bytes) for the wire-savings report."""
    leaves = tree_leaves(grads)
    raw = sum(g.numel() * g.element_size() for g in leaves)
    return raw, sum(g.numel() + 4 for g in leaves)


def compress_pieces_int8(grads: list, devices, tp: int) -> list:
    """The int8 round trip of every leaf over the mesh entries: ``grads[e]``
    entry ``e``'s gradient pieces (``tree_leaves`` order), each leaf
    quantized with the scale of the max over all its pieces' amaxes.
    Returns the dequantized f32 pieces, ``[e][j]``."""
    from repro_torch.distributed.collectives import mesh_all_reduce
    entries = list(range(len(grads)))
    out = [[] for _ in entries]
    for j in range(len(grads[0])):
        amax = mesh_all_reduce([g[j].to(torch.float32).abs().max()
                                for g in grads], entries, devices, tp,
                               op="max")
        for e in entries:
            out[e].append(decompress_tree_int8(_comp(grads[e][j], amax[e])))
    return out
