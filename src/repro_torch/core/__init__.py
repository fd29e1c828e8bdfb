"""Core: the paper's contribution (nibble precompute-reuse multiplication).

* ``nibble``      - nibble decomposition, the 16 precompute-logic recipes
* ``multipliers`` - bit-faithful models of all five architectures
* ``quantize``    - int8/int4 quantization + QAT straight-through estimator
* ``cycle_model`` - analytical Table-2 / Fig-4 model (NumPy)
* ``linear``      - QuantLinear, the framework-facing layer

``linear``, ``linear_apply`` and ``linear_init`` load at first use:
``linear`` imports the kernels, and the kernels import ``core.nibble``.
"""

import importlib

from repro_torch.core import (  # noqa: F401
    cycle_model,
    multipliers,
    nibble,
    quantize,
)
from repro_torch.core.multipliers import MULTIPLIERS  # noqa: F401

_LINEAR = ("linear", "linear_apply", "linear_init")


def __getattr__(name):
    if name in _LINEAR:
        linear = importlib.import_module("repro_torch.core.linear")
        return linear if name == "linear" else getattr(linear, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
