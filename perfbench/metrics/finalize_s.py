"""Mean seconds per search from the program's "Sorting and Outputting."
record to its "Done:" record: the global dedup, sort and serialization."""


def read(w):
    spans = [r.mark("done") - r.mark("finalize_start") for r in w.done
             if r.mark("done") and r.mark("finalize_start")]
    return sum(spans) / len(spans) if spans else None
