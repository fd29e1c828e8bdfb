"""Operations and bytes: per kernel call, from the call's shapes, and the
model work of the tokens a window served.

A kernel call's roofline floor is the larger of its operations over the
chip's peak rate and its bytes over the HBM bandwidth, counting each
input byte read once and each output byte written once (what these
inputs need, not what the kernel happens to read again).  Peaks are NVIDIA's
published dense rates for one H100 SXM at its 700 W limit; a run prints
the card's own power limit beside them.
"""

from __future__ import annotations

import math

__all__ = ["INT8_PEAK", "BF16_PEAK", "HBM_BPS", "floor_s", "nibble_call",
           "paged_decode_call", "flash_prefill_call", "projections",
           "token_work", "prefill_work", "mfu_seconds"]

INT8_PEAK = 1979e12          # int8 tensor-core ops/s (dense)
BF16_PEAK = 989e12           # bf16 tensor-core FLOP/s (dense)
HBM_BPS = 3.35e12            # HBM3 bytes/s


def floor_s(ops: float, nbytes: float, peak: float) -> float:
    return max(ops / peak, nbytes / HBM_BPS)


def nibble_call(m: int, k: int, n: int) -> tuple[int, int]:
    """The scaled int8 product ``(M, K) x (K, N) -> (M, N)`` bf16: 2MKN
    int8 operations; int8 activations and weights, the f32 activation
    scale and the (1, N) weight scales read, the bf16 result written."""
    return 2 * m * k * n, m * k + k * n + 4 + 4 * n + 2 * m * n


def paged_decode_call(rows, heads: int, kv_heads: int, head_dim: int,
                      page_size: int) -> tuple[int, int]:
    """One paged decode call over slots attending ``rows[b]`` cached
    keys each: QK and PV at 2 FLOP a MAC; each bf16 K and V row read
    once, q read and the output written, each slot's position and the
    page-table entries its rows span read."""
    total = sum(rows)
    ops = 4 * heads * head_dim * total
    kv = 2 * 2 * kv_heads * head_dim * total
    qo = 2 * 2 * len(rows) * heads * head_dim
    table = 4 * sum(math.ceil(r / page_size) for r in rows) + 4 * len(rows)
    return ops, kv + qo + table


def flash_prefill_call(s: int, heads: int, kv_heads: int,
                       head_dim: int) -> tuple[int, int]:
    """Causal attention of one ``s``-token prompt: query ``i`` meets
    ``i + 1`` keys in QK and PV; bf16 q, k, v read and the output
    written once."""
    ops = 2 * heads * head_dim * s * (s + 1)
    nbytes = 2 * s * head_dim * (2 * heads + 2 * kv_heads)
    return ops, nbytes


def projections(m: dict, family: str) -> list[tuple[int, int]]:
    """``(K, N)`` of every quantized projection of one layer."""
    d = m["d_model"]
    if family == "dense":
        h, kvh, hd, ff = m["n_heads"], m["n_kv_heads"], m["head_dim"], \
            m["d_ff"]
        return [(d, h * hd), (d, kvh * hd), (d, kvh * hd), (h * hd, d),
                (d, ff), (d, ff), (ff, d)]
    d_in = m["ssm_expand"] * d
    heads = d_in // m["ssm_head_dim"]
    gn = m["ssm_groups"] * m["ssm_state"]
    return [(d, 2 * d_in + 2 * gn + heads), (d_in, d)]


def _layer_float_ops(m: dict, family: str, ctx: int) -> int:
    """A token's non-projection matrix work in one layer: attention over
    ``ctx`` keys, or the SSD state update and read-out."""
    if family == "dense":
        return 4 * m["n_heads"] * m["head_dim"] * ctx
    d_in = m["ssm_expand"] * m["d_model"]
    return 4 * d_in * m["ssm_state"]


def token_work(m: dict, family: str, ctx: int) -> tuple[int, int]:
    """``(int8 ops, bf16 FLOP)`` of one decode token that attends
    ``ctx`` keys, its head included."""
    proj = 2 * sum(k * n for k, n in projections(m, family))
    flt = _layer_float_ops(m, family, ctx)
    head = 2 * m["d_model"] * m["vocab_size"]
    return m["n_layers"] * proj, m["n_layers"] * flt + head


def prefill_work(m: dict, family: str, s: int) -> tuple[int, int]:
    """``(int8 ops, bf16 FLOP)`` of one ``s``-token prefill: every token
    through the projections, causal attention (or the SSD per token) and
    the head once, for the first token."""
    proj = 2 * s * sum(k * n for k, n in projections(m, family))
    if family == "dense":
        flt = 2 * m["n_heads"] * m["head_dim"] * s * (s + 1)
    else:
        flt = s * _layer_float_ops(m, family, 0)
    head = 2 * m["d_model"] * m["vocab_size"]
    return m["n_layers"] * proj, m["n_layers"] * flt + head


def mfu_seconds(int_ops: float, float_ops: float) -> float:
    """The least time the chip's peaks allow for this work."""
    return int_ops / INT8_PEAK + float_ops / BF16_PEAK
