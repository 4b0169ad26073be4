"""Screen kernel launches (the program's ``dp_cuda.launches``) over the
window per 1e9 genome bases x guides searched."""


def read(w):
    gbases = sum(r.gbases for r in w.done)
    launches = sum(w.launches.get(k, 0) for k in ("screen_dual", "screen_multi", "screen_rows"))
    return launches / gbases if gbases and launches else None
