"""Optional per-stage wall-clock accounting of one encode.

A ``StageClock`` built with an output dict synchronises the device at
each mark and adds the milliseconds since the previous mark under the
stage's name, and adds events it is told to count (such as rate
control's packet simulations) under theirs; built with ``None`` it does
nothing, so the pipeline runs without extra synchronisation when nobody
asks for stage times.
"""

from __future__ import annotations

import time

import torch


class StageClock:
    def __init__(self, device: torch.device, out: dict[str, float] | None):
        self.device = torch.device(device)
        self.out = out
        self._t = self._now() if out is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, stage: str) -> None:
        """Charge the time since the previous mark to ``stage``."""
        if self.out is None:
            return
        t = self._now()
        self.out[stage] = self.out.get(stage, 0.0) + (t - self._t) * 1e3
        self._t = t

    def count(self, key: str, n: int = 1) -> None:
        """Add ``n`` events under ``key`` (a count, not milliseconds)."""
        if self.out is not None:
            self.out[key] = self.out.get(key, 0) + n
