"""``StepTimer``: EMA step-time tracker with straggler detection (a copy of
the reference's ``repro/ft/monitor.py::StepTimer``; the serving macro loop
times its launches with it)."""
from __future__ import annotations

import time
from typing import Callable, List, Optional

from repro_torch.obs import telemetry as _obs

__all__ = ["StepTimer"]


class StepTimer:
    """EMA step-time tracker with straggler detection.

    When ``name`` is given the timer reports into the flight recorder: a
    straggler emits an ``ft.straggler`` event and every stop observes the
    ``<name>.step_s`` histogram (the training loop and the serving macro
    loop share this path)."""

    def __init__(self, ema_alpha: float = 0.1, threshold: float = 3.0,
                 warmup: int = 3,
                 on_straggler: Optional[Callable[[int, float, float], None]]
                 = None, name: Optional[str] = None):
        self.ema_alpha = ema_alpha
        self.threshold = threshold
        self.warmup = warmup
        self.on_straggler = on_straggler
        self.name = name
        self.ema: Optional[float] = None
        self.count = 0
        self.stragglers: List[int] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.monotonic()

    def stop(self, step: int) -> float:
        dt = time.monotonic() - self._t0
        self.count += 1
        straggler = False
        ema_ref = self.ema
        if self.ema is None:
            self.ema = dt
        elif self.count <= self.warmup:
            self.ema = 0.5 * self.ema + 0.5 * dt
        else:
            if dt > self.threshold * self.ema:
                straggler = True
                self.stragglers.append(step)
                if self.on_straggler:
                    self.on_straggler(step, dt, self.ema)
            self.ema = (1 - self.ema_alpha) * self.ema + self.ema_alpha * dt
        if self.name is not None and (r := _obs.RECORDER).enabled:
            r.observe(f"{self.name}.step_s", dt)
            if straggler:
                r.emit("ft.straggler", timer=self.name, step=int(step),
                       dt_s=dt, ema_s=float(ema_ref))
                r.count("ft.stragglers")
        return dt
