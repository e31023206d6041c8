"""Mean seconds a step of the program's 'forward' phase (train_step's phase
clock, both micro-steps added) over the window's steps."""


def read(layer):
    vals = [t["forward"] for t in layer.get("phase_times") or [] if "forward" in t]
    return sum(vals) / len(vals) if vals else None
