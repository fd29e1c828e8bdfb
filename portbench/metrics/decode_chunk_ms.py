"""Model step: the mean time of the window's engine steps that ran only
the captured decode chunk (no admission), outside the traced slice, by
the host's clock around each step, in milliseconds.  Steadier than the
rate it moves: it leaves out the eager prefills."""


def read(run):
    n, secs = run.step_seconds(False, untraced=True)
    if n == 0:
        return None
    return 1e3 * secs / n
