"""100 minus the device's busy share of the traced window, in %."""


def read(w):
    if w.trace is None or not w.trace.busy_s:
        return None
    return 100.0 * (1.0 - w.trace.busy_s / w.trace.window_s)
