"""Wall-clock stage timing shared by the serving pipeline and the SAM-2
predictors."""
from __future__ import annotations

import time

import torch


class StageClock:
    """Wall seconds by stage, added into `timings` (the device synchronised
    at each mark); does nothing without a dict."""

    def __init__(self, timings, device):
        self.timings, self.device = timings, device
        self.t0 = self._now()

    def _now(self):
        if self.timings is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def __call__(self, stage: str):
        if self.timings is None:
            return
        t = self._now()
        self.timings[stage] = self.timings.get(stage, 0.0) + t - self.t0
        self.t0 = t
