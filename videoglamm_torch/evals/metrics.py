"""Host-side numpy metrics that the trainer reads (the port's copy of
`AverageMeter` and `intersection_and_union` from
videoglamm_tpu/evals/metrics.py; the rest of that module comes with the
evaluation slice)."""
from __future__ import annotations

import numpy as np


def intersection_and_union(pred: np.ndarray, target: np.ndarray, K: int = 2,
                           ignore_index: int = 255):
    """Per-class (intersection, union, target-area) histograms; pixels whose
    target is `ignore_index` count nowhere (metrics.py:162)."""
    pred = pred.reshape(-1).copy()
    target = target.reshape(-1)
    pred[target == ignore_index] = ignore_index
    inter = pred[pred == target]
    area_inter = np.histogram(inter, bins=K, range=(0, K - 1))[0]
    area_pred = np.histogram(pred, bins=K, range=(0, K - 1))[0]
    area_target = np.histogram(target, bins=K, range=(0, K - 1))[0]
    return area_inter, area_pred + area_target - area_inter, area_target


class AverageMeter:
    """Running mean accumulator (metrics.py:176)."""

    def __init__(self, name: str = ""):
        self.name = name
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += np.asarray(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1e-8)
