"""Hand-written Hopper kernels and their plain PyTorch versions.

* ``nibble_matmul``   - plane-fused nibble matmul (int8 tensor cores)
* ``lut_matmul``      - the paper's LUT-array multiplier (table selection)
* ``flash_attention`` - flash forward and backward, paged decode attention
* ``ops``             - public entry points in the reference's layouts
* ``ref``             - plain oracles the tests assert against
* ``_build``          - nvcc build at first use, ctypes loading

CUDA sources live in ``repro_torch/csrc``.
"""
