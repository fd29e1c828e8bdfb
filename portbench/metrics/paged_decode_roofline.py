"""Kernels: the paged decode kernel's roofline share in the traced slice.
Each decode step of a chunk is one call per layer over the slots that
emitted a token in it, each attending its prompt and earlier tokens
(frozen slots are left out: their reads serve no token); the floor of
those calls over the kernel's traced device time, in percent."""

from portbench import cost


def read(run):
    t = run.trace
    if t is None:
        return None
    secs = t.seconds("paged_decode")
    if secs <= 0:
        return None
    lo, hi, _, _ = run.trace_bounds
    m = run.model
    calls: dict = {}
    for s in run.served:
        p, seen = len(s.prompt), {}
        for i, stamp in enumerate(s.t_tokens):
            if i == 0 or not lo <= stamp <= hi:
                continue
            j = seen.get(stamp, 0)
            seen[stamp] = j + 1
            calls.setdefault((stamp, j), []).append(p + i)
    page = int(run.config["serve"]["page_size"])
    floor = sum(cost.floor_s(*cost.paged_decode_call(
        rows, m["n_heads"], m["n_kv_heads"], m["head_dim"], page),
        cost.BF16_PEAK) for rows in calls.values())
    return 100.0 * m["n_layers"] * floor / secs
