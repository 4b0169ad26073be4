"""Seconds from the process's start to the first timed request (host clock)."""


def read(w):
    return w.setup_s
