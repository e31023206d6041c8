"""What several metric readers share."""
from __future__ import annotations


def stage_mean(layer, stage: str):
    """Mean seconds of one stage of the program's stage clock over the
    window's calls; None where no call recorded it."""
    vals = [t[stage] for t in layer.get("stage_times") or [] if stage in t]
    return sum(vals) / len(vals) if vals else None
