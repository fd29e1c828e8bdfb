"""Device: the share of the traced slice in which no operation ran on the
device, in percent."""


def read(run):
    t = run.trace
    if t is None or not t.kernels or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
