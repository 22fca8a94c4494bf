"""Deploy-loop clock.

In simulation (Webots/mock SDK) the controller must advance time with
received low-state messages rather than the wall clock, so runs replay
deterministically (reference semantics: deploy/utils/timer.py:15-19 — a
tick counter scaled by the control period).  This implementation keeps an
explicit message count plus the period and derives time on demand; it also
exposes ``advance``/``reset`` for test rigs that need to jump the clock.
"""

from dataclasses import dataclass
from typing import Optional


@dataclass
class TimerConfig:
    time_step: float = 0.002


class Timer:
    """Message-tick clock: ``get_time() == ticks * time_step``."""

    __slots__ = ("config", "_ticks")

    def __init__(self, config: Optional[TimerConfig] = None,
                 time_step: Optional[float] = None):
        if config is None:
            config = TimerConfig(time_step) if time_step is not None else TimerConfig()
        self.config = config
        self._ticks = 0

    @property
    def counter(self) -> int:
        return self._ticks

    def tick_timer_if_sim(self) -> None:
        """Advance one control period (called per received sim message)."""
        self._ticks += 1

    def advance(self, n: int) -> None:
        self._ticks += int(n)

    def reset(self) -> None:
        self._ticks = 0

    def get_time(self) -> float:
        return self._ticks * self.config.time_step
