"""Genome bases x guides of every search completed in the window, in 1e9,
over the window's seconds (host clock)."""


def read(w):
    return sum(r.gbases for r in w.done) / w.seconds if w.done else None
