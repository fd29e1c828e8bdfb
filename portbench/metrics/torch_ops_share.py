"""PyTorch's own ops: device time of kernels that are not the program's
hand-written ones (``csrc/``) over all device time in the traced slice,
in percent."""

from portbench.trace import kernel_class


def read(run):
    t = run.trace
    if t is None or not t.kernels:
        return None
    total = sum(k.dur_ns for k in t.kernels)
    own = sum(k.dur_ns for k in t.kernels if kernel_class(k.name) == "torch")
    return 100.0 * own / total
