"""Mean seconds a step of the program's 'backward' phase (train_step's phase
clock, both micro-steps added) over the window's steps."""


def read(layer):
    vals = [t["backward"] for t in layer.get("phase_times") or [] if "backward" in t]
    return sum(vals) / len(vals) if vals else None
