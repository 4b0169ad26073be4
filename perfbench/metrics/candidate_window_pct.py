"""Candidate windows over windows, in %, summed over the program's "Screen
...: N of M windows are candidates" records of the window's searches: the
share of windows the screen sends to the host finish."""


def read(w):
    counts = [r.screened() for r in w.done]
    total = sum(m for _n, m in counts)
    return 100.0 * sum(n for n, _m in counts) / total if total else None
