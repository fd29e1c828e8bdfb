"""Model step: the window's served model work (projections at the int8
peak, attention or the SSD and the head at the bf16 peak; counted from
the configuration's shapes and the tokens served) as a share of what
the chip's peaks allow in the window, in percent."""

from portbench import cost


def read(run):
    int_ops, float_ops = run.window_work()
    if int_ops + float_ops == 0:
        return None
    return 100.0 * cost.mfu_seconds(int_ops, float_ops) / run.seconds
