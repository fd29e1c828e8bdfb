"""PyTorch + CUDA port of the nibble-multiplier serving and training
system.

The JAX package ``repro`` is the reference; this package runs the same
model, quantization, serving and training paths on an NVIDIA Hopper card
through hand-written CUDA kernels (``repro_torch/csrc``), with a plain
PyTorch version beside every kernel.  Entry points take ``device=`` and default
to ``"cuda"``; only tests pass ``device="cpu"``.
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  Asking for CUDA on a machine
    without a card raises instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch entry points run on a CUDA device by default, and "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path")
    return dev
