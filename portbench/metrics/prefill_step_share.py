"""Scheduler: the share of the window's time spent in engine steps that
admitted and prefilled requests (the eager prefills of replacements
between decode chunks), by the host's clock around each step, in
percent."""


def read(run):
    if not run.steps or run.seconds <= 0:
        return None
    return 100.0 * run.step_seconds(True)[1] / run.seconds
