"""Shared test configuration.

This container has no network installs, and `hypothesis` is not baked into
the image — at the seed state that made three test modules fail at
*collection*, taking the whole tier-1 run down with them.  When the real
package is unavailable we install a minimal deterministic stand-in into
``sys.modules`` before collection: ``@given`` re-runs the test body over a
fixed-seed sample of each strategy (capped draws, so property tests stay
fast on the 1-core container) and ``@settings`` carries ``max_examples``.
With the real hypothesis installed (e.g. in CI) this shim is inert.

Only the strategy surface the suite uses is implemented:
``st.integers(lo, hi)`` and ``st.sampled_from(seq)``.
"""

from __future__ import annotations

import sys
import types

try:
    import hypothesis  # noqa: F401  (real package wins when present)
except ImportError:
    import numpy as np

    _MAX_DRAWS = 10   # cap regardless of requested max_examples (runtime)

    class _Strategy:
        def __init__(self, draw):
            self.draw = draw

    def _integers(min_value: int, max_value: int) -> _Strategy:
        return _Strategy(
            lambda rng: int(rng.integers(min_value, max_value + 1)))

    def _sampled_from(elements) -> _Strategy:
        xs = list(elements)
        return _Strategy(lambda rng: xs[int(rng.integers(0, len(xs)))])

    def _given(**strategies):
        def deco(fn):
            # NOTE: zero-arg wrapper without functools.wraps — pytest must
            # not see the original parameters (it would treat them as
            # fixtures) and must not follow __wrapped__.
            def wrapper():
                n = min(getattr(wrapper, "_max_examples", _MAX_DRAWS),
                        _MAX_DRAWS)
                rng = np.random.default_rng(0)
                for _ in range(n):
                    fn(**{k: s.draw(rng) for k, s in strategies.items()})
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper
        return deco

    def _settings(max_examples: int = _MAX_DRAWS, deadline=None, **_):
        def deco(fn):
            fn._max_examples = max_examples
            return fn
        return deco

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _st = types.ModuleType("hypothesis.strategies")
    _st.integers = _integers
    _st.sampled_from = _sampled_from
    _hyp.strategies = _st
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st


def pytest_configure(config):
    # tests that run only on a CUDA card; each decides inside a fixture
    # whether there is one, and skips without it
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (sm_90a); skips without one")
