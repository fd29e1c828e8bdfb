"""Pytest config: no XLA device-count fakery here — smoke tests and
benches must see the real (single) CPU device; only the dry-run and
explicitly-marked subprocess tests use placeholder device counts.

``hypothesis`` is a dev dependency (see requirements-dev.txt) and the
property-based tests (9 ``@given`` properties across test_substrate /
test_attention / test_quantize / test_kernels / test_moe_mamba /
test_multipliers / test_nibble) always *execute*.  When the wheel is
missing we install a **mini-runner** into ``sys.modules`` before test
modules import it: deterministic seeded draws, boundary values first
(min, max, 0, 1, empty/full list lengths), bounded ``.filter``
retries, and a reduced example budget.  No shrinking and no example
database — install the real wheel for those — but a property that
fails under the real runner fails here too, instead of silently
skipping.  CI installs requirements-dev.txt, so the fallback must
never fire there; the report header below makes a regression of that
visible.
"""


import sys
import types
import zlib

import numpy as np
import pytest

_HYPOTHESIS_FALLBACK = False

# the fallback's example budget: enough to exercise every boundary
# case plus a seeded random spread, small enough that the 200-example
# multiplier properties don't dominate the tier-1 wall clock
_MINI_MAX_EXAMPLES = 20
_MINI_FILTER_RETRIES = 100


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line("markers", "cuda: needs a CUDA device; skipped without one")


def pytest_report_header(config):
    if _HYPOTHESIS_FALLBACK:
        return ("hypothesis: NOT INSTALLED — property-based tests run "
                "under the built-in mini-runner (deterministic draws, "
                f"<= {_MINI_MAX_EXAMPLES} examples, no shrinking; "
                "pip install -r requirements-dev.txt for the real "
                "runner)")
    return "hypothesis: installed (property-based tests run)"


try:
    import hypothesis  # noqa: F401
except ImportError:  # pragma: no cover - exercised only without hypothesis
    class _MiniStrategy:
        """Executable stand-in for a hypothesis strategy: ``example``
        draws the ``i``-th example — boundary values for small ``i``,
        seeded random draws after (``i=None`` forces a random draw)."""

        def __init__(self, draw):
            self._draw = draw

        def example(self, rng, i):
            return self._draw(rng, i)

        def filter(self, pred):
            base = self

            def draw(rng, i):
                v = base.example(rng, i)
                for _ in range(_MINI_FILTER_RETRIES):
                    if pred(v):
                        return v
                    v = base.example(rng, None)
                raise RuntimeError(
                    "mini-hypothesis: .filter predicate rejected "
                    f"{_MINI_FILTER_RETRIES} consecutive draws")
            return _MiniStrategy(draw)

        def map(self, fn):
            base = self
            return _MiniStrategy(lambda rng, i: fn(base.example(rng, i)))

    def _mini_integers(min_value, max_value):
        bounds = []
        for b in (min_value, max_value, 0, 1):
            if min_value <= b <= max_value and b not in bounds:
                bounds.append(b)

        def draw(rng, i):
            if i is not None and i < len(bounds):
                return bounds[i]
            return int(rng.integers(min_value, max_value + 1))
        return _MiniStrategy(draw)

    def _mini_sampled_from(elements):
        seq = list(elements)

        def draw(rng, i):
            if i is not None and i < len(seq):
                return seq[i]
            return seq[int(rng.integers(len(seq)))]
        return _MiniStrategy(draw)

    def _mini_lists(elements, min_size=0, max_size=None):
        hi = max_size if max_size is not None else min_size + 10

        def draw(rng, i):
            if i == 0:
                n = min_size
            elif i == 1:
                n = hi
            else:
                n = int(rng.integers(min_size, hi + 1))
            return [elements.example(rng, None) for _ in range(n)]
        return _MiniStrategy(draw)

    def _given(*arg_strats, **kw_strats):
        def deco(fn):
            budget = getattr(fn, "_mini_settings", {}).get(
                "max_examples", _MINI_MAX_EXAMPLES)
            budget = min(budget, _MINI_MAX_EXAMPLES)

            # zero-arg wrapper (no functools.wraps: pytest must not see
            # the strategy parameters, or it hunts for fixtures)
            def wrapper():
                rng = np.random.default_rng(
                    zlib.crc32(fn.__name__.encode()))
                for i in range(budget):
                    args = [s.example(rng, i) for s in arg_strats]
                    kwargs = {k: s.example(rng, i)
                              for k, s in kw_strats.items()}
                    try:
                        fn(*args, **kwargs)
                    except Exception as exc:
                        raise AssertionError(
                            f"mini-hypothesis falsified {fn.__name__} "
                            f"on example {i}: args={args!r} "
                            f"kwargs={kwargs!r}") from exc
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            return wrapper
        return deco

    def _settings(**kwargs):
        def deco(fn):
            fn._mini_settings = kwargs
            return fn
        return deco

    _HYPOTHESIS_FALLBACK = True
    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _mini_integers
    _st.sampled_from = _mini_sampled_from
    _st.lists = _mini_lists
    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st
