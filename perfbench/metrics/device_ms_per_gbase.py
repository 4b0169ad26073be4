"""Device busy milliseconds (the union of kernel and copy intervals in the
trace of the window) per 1e9 genome bases x guides searched."""


def read(w):
    if w.trace is None or not w.trace.busy_s:
        return None
    gbases = sum(r.gbases for r in w.done)
    return 1e3 * w.trace.busy_s / gbases if gbases else None
