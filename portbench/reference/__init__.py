"""Plain references of the benchmark's models.

Each module follows the published architecture with plain ``torch``
operations in float32 (TF32 off: :func:`strict_f32`), storing
activations in bf16 between operations as the configurations state, and
redoes the serving quantization itself from the raw weights the
benchmark made: int8 weights per output channel, int8 activations per
tensor.  A module
gives ``weight_layout(model)`` (the leaves the benchmark makes from the
seed) and ``logits(weights, model, samples)`` (the logits at the
positions that produced each sample's served tokens).  Nothing here
imports the program under test.
"""

import torch

__all__ = ["strict_f32"]


def strict_f32() -> None:
    """Float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
