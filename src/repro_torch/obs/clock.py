"""Injectable time sources for the observability layer.

Everything in ``src/repro_torch`` that needs a wall/monotonic clock goes
through this module — never ``time.*`` directly (enforced by
``scripts/check_no_stray_timers.py``, which scans all of ``src/``).
Centralizing the clock is what
makes timing *injectable*: the serve engine takes a `Clock` and the
deterministic simulation harness (`tests/simulation.py`) swaps in a
`ManualClock`, so request-lifecycle traces carry exact, reproducible
timestamps instead of host-noise wall times.

All timestamps are monotonic seconds with an arbitrary epoch — only
differences are meaningful.  Device work is timed on the host around
a ``torch.cuda.synchronize``.

Port of ``repro/obs/clock.py``: the one module of the port that reads
the stdlib clock, through the same ``import time as _time`` alias.
"""
from __future__ import annotations

import time as _time


class MonotonicClock:
    """Real monotonic clock (``time.perf_counter``)."""

    def now(self) -> float:
        return _time.perf_counter()


class ManualClock:
    """Deterministic clock the caller advances explicitly.

    ``now()`` returns the last set value — repeated reads between
    ``advance`` calls are identical, so traces driven by a `ManualClock`
    are exactly reproducible across runs and platforms."""

    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float = 1.0) -> float:
        if dt < 0:
            raise ValueError("ManualClock cannot run backwards")
        self._t += dt
        return self._t


_DEFAULT = MonotonicClock()


def perf_counter() -> float:
    """Module-level monotonic timestamp for call sites without an
    injected clock (``launch.train.TrainLoop``'s default step
    clock).  Same contract as ``time.perf_counter``."""
    return _DEFAULT.now()
