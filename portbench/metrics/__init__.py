"""Per-layer metric readers, one file each, found by the metric's name
(``<name>.py``, or ``<base>.py`` for ``<base>.<suffix>``, the suffix
naming the end-to-end metric it moves).  ``read(run)`` takes the
harness's ``Run`` and returns the value, or None where the run gave it
nothing to read."""
