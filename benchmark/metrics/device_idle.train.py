"""Share (%) of a step's wall time with no operation on the card, from one
step run after the window under the profiler with the device's activity
alone (tracing.device_pass): kernels, copies and sets united, over the
host's wall time of that step, in which the host keeps nearly its untraced
pace."""


def read(layer):
    d = layer["device_pass"]
    return 100.0 * (1.0 - d.busy_s / d.window_s)
