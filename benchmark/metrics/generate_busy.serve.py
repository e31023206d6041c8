"""Share (%) of the generate stage's time with a kernel on the card: the
kernels of the traced batch's generate stage (the profiler's kernel
intervals between the two synchronisations of the program's stage clock
that bound it) over the mean generate stage of the window's batches, which
ran without the profiler (serve_stage_s.generate). The profiler's own host
cost, which stretches the traced stage, so stays out of the share."""
from metric_lib import stage_mean


def read(layer):
    iv = layer.get("stage_intervals")
    wall = stage_mean(layer, "generate")
    if not iv or "generate" not in iv or not wall:
        return None
    tr = layer["trace"]
    busy = sum(tr.busy_s(lo, hi) for lo, hi in iv["generate"])
    return 100.0 * busy / (wall * len(iv["generate"]))
