"""Kernels: the flash prefill kernel's roofline share in the traced
slice: causal attention of each prompt prefilled there, one call per
layer, over the kernel's traced device time, in percent."""

from portbench import cost


def read(run):
    t = run.trace
    if t is None:
        return None
    secs = t.seconds("flash_prefill")
    if secs <= 0:
        return None
    lo, hi, _, _ = run.trace_bounds
    m = run.model
    floor = sum(cost.floor_s(*cost.flash_prefill_call(
        s, m["n_heads"], m["n_kv_heads"], m["head_dim"]), cost.BF16_PEAK)
        for s in run.prefills(lo, hi))
    return 100.0 * m["n_layers"] * floor / secs
