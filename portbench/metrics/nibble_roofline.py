"""Kernels: the nibble matmul's roofline share in the traced slice, the
floor of every call it made there (each decode chunk's projections at M
= slots, each prefill's at M = its prompt length) over its traced
device time, in percent."""

from portbench import cost


def read(run):
    t = run.trace
    if t is None:
        return None
    secs = t.seconds("nibble")
    if secs <= 0:
        return None
    lo, hi, c0, c1 = run.trace_bounds
    m = run.model
    projs = cost.projections(m, run.family)
    steps = (c1 - c0) * int(run.config["serve"]["decode_chunk"])
    calls = [run.mix.slots] * steps + run.prefills(lo, hi)
    floor = sum(cost.floor_s(*cost.nibble_call(rows, k, n), cost.INT8_PEAK)
                for rows in calls for k, n in projs)
    return 100.0 * m["n_layers"] * floor / secs
