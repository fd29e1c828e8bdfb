"""Bit-faithful models of the paper's five multiplier architectures (port
of ``repro.core.multipliers``).

Each function computes an N-lane vector-scalar product ``R[i] = A[i] * B``
the way the corresponding RTL datapath does (same decomposition, same
per-cycle partial values, same accumulation order, in int32) and returns
a :class:`MultiplyTrace` with the products and the cycle accounting that
Table 2 and Fig. 4 use:

* ``shift_add``: sequential, one multiplier bit a cycle, W cycles an
  operand;
* ``booth_radix2``: modified-Booth recoding, two bits a cycle, W/2 cycles
  (signed operands);
* ``nibble_precompute``: the paper's Algorithm 2, two nibble passes
  through the precompute logic, W/4 cycles (unsigned, or signed int8 via
  the signed nibble split);
* ``wallace``: every partial product formed and reduced in one cycle;
* ``lut_array``: the paper's Algorithm 1 (hex-string lookup, slice, shift
  and add), one cycle; ``lut_array_16bit`` is its full 16-bit-A form.

A sequential design's cycles run as a Python loop over the same cycles.
Tensor operands keep their device; Python and NumPy operands go to
``device`` (CUDA unless the caller asks for the CPU).  ``b`` is the
broadcast scalar: a Python or NumPy int, a 0-d tensor, or (all but the
LUT models) an int tensor broadcastable against ``a``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.nibble import (
    pl_scale,
    split_nibbles_signed,
    split_nibbles_unsigned,
)

__all__ = ["MultiplyTrace", "shift_add", "booth_radix2", "nibble_precompute",
           "wallace", "lut_array", "lut_array_16bit", "build_hex_string_lut",
           "MULTIPLIERS"]


@dataclasses.dataclass(frozen=True)
class MultiplyTrace:
    """Result of a vector-scalar multiply plus architectural accounting."""

    products: torch.Tensor       # (N,) int32 exact products
    cycles: int                  # total clock cycles for the N-lane op
    cycles_per_operand: int      # latency per vector element
    name: str

    def __iter__(self):  # allow ``products, cycles = trace`` unpacking
        yield self.products
        yield self.cycles


def _as_lanes(a, device) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.asarray(a).astype(np.int64),
                            device=resolve_device(device))
    return torch.atleast_1d(a).to(torch.int32)


def _operand(b, lanes: torch.Tensor) -> torch.Tensor:
    """The broadcast operand as int32 on the lanes' device."""
    if not isinstance(b, torch.Tensor):
        b = torch.as_tensor(np.asarray(b).astype(np.int64))
    return b.to(device=lanes.device, dtype=torch.int32)


# ---------------------------------------------------------------------------
# Sequential baselines
# ---------------------------------------------------------------------------

def shift_add(a, b, width: int = 8, *, device="cuda") -> MultiplyTrace:
    """Classic shift-add: one multiplier bit examined per cycle."""
    a = _as_lanes(a, device) & ((1 << width) - 1)
    b = _operand(b, a) & ((1 << width) - 1)
    acc = torch.zeros_like(a)
    for step in range(width):
        bit = (b >> step) & 1                 # the bit under the scan head
        acc = acc + bit * (a << step)         # add shifted multiplicand if set
    n = int(a.shape[0])
    return MultiplyTrace(acc, cycles=width * n, cycles_per_operand=width,
                         name="shift_add")


# Booth digit for each 3-bit window value 0..7
_BOOTH_DIGITS = (0, 1, 1, 2, -2, -1, -1, 0)


def booth_radix2(a, b, width: int = 8, *, device="cuda") -> MultiplyTrace:
    """Modified-Booth recoding: two multiplier bits retired per cycle.

    Recodes b into width/2 digits in {-2, -1, 0, +1, +2}; each cycle adds
    one recoded, shifted multiple of ``a``.  Signed (two's-complement)
    operands: exact over int8 x int8 in ``width // 2`` cycles."""
    a = _as_lanes(a, device)
    b = _operand(b, a)
    b_ext = b << 1  # append the Booth guard zero below bit 0
    digits = torch.tensor(_BOOTH_DIGITS, dtype=torch.int32, device=a.device)
    acc = torch.zeros_like(a)
    for step in range(width // 2):
        window = (b_ext >> (2 * step)) & 0x7          # bits [2i+1 : 2i-1]
        d = digits[window.long()]
        acc = acc + d * (a << (2 * step))
    n = int(a.shape[0])
    return MultiplyTrace(acc, cycles=(width // 2) * n,
                         cycles_per_operand=width // 2, name="booth_radix2")


# ---------------------------------------------------------------------------
# The paper's contribution: precompute-reuse nibble multiplier (Algorithm 2)
# ---------------------------------------------------------------------------

def nibble_precompute(a, b, *, signed: bool = False,
                      device="cuda") -> MultiplyTrace:
    """Algorithm 2: two nibble passes through the precompute logic (PL).

    ``b`` is split once into (lo, hi) nibbles; every lane then evaluates
    ``PL(A, b_lo) + (PL(A, b_hi) << 4)`` (Fig. 2(c): PL block, fixed
    shift, accumulate; two cycles an 8-bit element).  ``signed``: ``b``
    is int8 and its high nibble may be negative; the PL takes its
    magnitude and the sign is folded in."""
    a = _as_lanes(a, device)
    b = _operand(b, a)
    if signed:
        b_lo, b_hi = split_nibbles_signed(b.to(torch.int8))
        one = torch.ones((), dtype=torch.int32, device=a.device)
        hi_sign = torch.where(b_hi < 0, -one, one)
        partial_lo = pl_scale(a, b_lo)
        partial_hi = hi_sign * pl_scale(a, b_hi.abs())
    else:
        b_lo, b_hi = split_nibbles_unsigned(b)
        partial_lo = pl_scale(a, b_lo)          # cycle 0: PL pass, shift 0
        partial_hi = pl_scale(a, b_hi)          # cycle 1: PL pass, shift 4
    acc = partial_lo + (partial_hi << 4)        # fixed alignment + accumulate
    n = int(a.shape[0])
    return MultiplyTrace(acc, cycles=2 * n, cycles_per_operand=2,
                         name="nibble_precompute")


# ---------------------------------------------------------------------------
# Combinational baselines
# ---------------------------------------------------------------------------

def wallace(a, b, width: int = 8, *, device="cuda") -> MultiplyTrace:
    """Wallace tree: all partial products formed, reduced in one cycle
    (the full partial-product matrix is built, as the RTL's)."""
    a = _as_lanes(a, device) & ((1 << width) - 1)
    b = _operand(b, a) & ((1 << width) - 1)
    pp = [((b >> i) & 1) * (a << i) for i in range(width)]  # all PPs at once
    products = torch.stack(pp, 0).sum(0, dtype=torch.int32)
    return MultiplyTrace(products, cycles=1, cycles_per_operand=1,
                         name="wallace")


def build_hex_string_lut() -> np.ndarray:
    """The hex-string LUT of Fig. 1(a) as a (16, 16) uint16 product table:
    row ``b`` is the ResString of nibble ``b`` (the 8-bit segments
    ``b*1 ... b*15``; segment 0 is the zero the ``A != 0`` guards of
    Algorithm 1 handle), ``table[b, a]`` the segment slice ``a`` takes."""
    b = np.arange(16, dtype=np.uint16)[:, None]
    a = np.arange(16, dtype=np.uint16)[None, :]
    return (b * a).astype(np.uint16)  # every entry < 256: fits the 8-bit slice


def _lut(lanes: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(build_hex_string_lut().astype(np.int32),
                           device=lanes.device)


def _b_nibbles(b, lanes):
    """The two ResString indices of a scalar ``b``."""
    b = _operand(b, lanes) & 0xFF
    if b.dim():
        raise ValueError("the LUT array takes one broadcast operand b")
    b0, b1 = split_nibbles_unsigned(b)
    return b0.long(), b1.long()


def lut_array(a, b, width: int = 8, *, device="cuda") -> MultiplyTrace:
    """Algorithm 1: the LUT-based array multiplier (the paper's LM block).

    Line 5: select ResString0/1 with the B nibbles.  Lines 6-13: each A
    nibble slices an 8-bit segment from each string.  Lines 14-15: fixed
    shifts and accumulation.  One combinational cycle."""
    if width != 8:
        raise NotImplementedError("LM block is specified for 8-bit operands")
    a = _as_lanes(a, device) & 0xFF
    lut = _lut(a)
    b0, b1 = _b_nibbles(b, a)
    a0, a1 = (t.long() for t in split_nibbles_unsigned(a))  # slice indices
    res_string0 = lut[b0]                    # (16,) selected hex string rows
    res_string1 = lut[b1]

    p0 = res_string0[a0]                     # slice extraction (Alg.1 L6-9)
    p2 = res_string1[a0]
    p1 = res_string0[a1]
    p3 = res_string1[a1]
    out = p0 + (p2 << 4) + (p1 << 4) + (p3 << 8)   # Alg.1 L14
    return MultiplyTrace(out, cycles=1, cycles_per_operand=1,
                         name="lut_array")


def lut_array_16bit(a16, b, *, device="cuda"
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Algorithm 1 in full: 16-bit A (4 nibbles), 8-bit B, two 16-bit
    outputs (lines 14-15): Out1 covers A[7:0]*B and Out2 A[15:8]*B; the
    caller composes ``Out1 + (Out2 << 8)``."""
    a16 = _as_lanes(a16, device) & 0xFFFF
    lut = _lut(a16)
    b0, b1 = _b_nibbles(b, a16)
    rs0, rs1 = lut[b0], lut[b1]
    a0 = (a16 & 0xF).long()
    a1 = ((a16 >> 4) & 0xF).long()
    a2 = ((a16 >> 8) & 0xF).long()
    a3 = ((a16 >> 12) & 0xF).long()
    out1 = rs0[a0] + (rs1[a0] << 4) + (rs0[a1] << 4) + (rs1[a1] << 8)
    out2 = rs0[a2] + (rs1[a2] << 4) + (rs0[a3] << 4) + (rs1[a3] << 8)
    return out1, out2


MULTIPLIERS = {
    "shift_add": shift_add,
    "booth_radix2": booth_radix2,
    "nibble_precompute": nibble_precompute,
    "wallace": wallace,
    "lut_array": lut_array,
}
