"""Mean seconds of the program's 'preprocess' stage (serve_raw's stage clock) over
the window's serve_raw calls, a batch of clips each."""
from metric_lib import stage_mean


def read(layer):
    return stage_mean(layer, "preprocess")
