"""Model FLOPs (flops.py's convention) of the window's optimizer steps over
the window's wall seconds times the card's bf16 peak, in %."""
import flops as F


def read(layer):
    c, tr = layer["config"], layer["traffic"]
    seq = tr["text_tokens"] - 1 + F.visual_tokens(c)
    per = F.train_step(c, tr["videos"], tr["rows"], seq, tr["sam_frames"],
                       c["mode"]["train"]["grad_accum_steps"])
    return 100.0 * layer["steps"] * per / (layer["window_s"] * F.PEAK_BF16)
