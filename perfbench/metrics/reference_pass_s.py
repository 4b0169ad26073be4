"""Mean seconds per search from its call to the program's "Reference windows
processed." record: staging lookups, the screen and the host finish."""


def read(w):
    spans = [r.mark("reference_done") - r.t0 for r in w.done if r.mark("reference_done")]
    return sum(spans) / len(spans) if spans else None
