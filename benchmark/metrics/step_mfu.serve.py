"""Model FLOPs (flops.py's convention) of the window's done requests over
the window's wall seconds times the card's bf16 peak, in %."""
import flops as F


def read(layer):
    c, tr = layer["config"], layer["traffic"]
    total = sum(F.gcg_request(c, n, tr["new_tokens"], tr["sam_frames"])
                for n in layer["lengths"])
    return 100.0 * total / (layer["window_s"] * F.PEAK_BF16)
