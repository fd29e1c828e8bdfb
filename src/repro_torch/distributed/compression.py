"""Gradient compression: int8 + per-tensor scale with error feedback
(port of ``repro.distributed.compression``).

Every leaf is quantized to int8 with one abs-max scale; the dequantized
tree is what the optimizer consumes after the (cross-pod) transfer.
Error feedback carries the quantization residual to the next step, so
the compression noise averages out over steps.
"""

from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["compress_tree_int8", "decompress_tree_int8", "ef_compress",
           "compressed_bytes"]


def _comp(g):
    g = g.to(torch.float32)
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
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
