"""Finish chunks run on the searching thread over all finish chunks, in %,
over the window's searches: the program's ``finish_chunks_inline`` and
``finish_chunks_pooled`` counters, one count per chunk of
``parallel/host_pool.py::map_items_mp`` (a chunk runs inline where a
contig's candidates fill fewer than four chunks, or the pool broke)."""

from perfbench.harness.program_spans import window_counts


def read(w):
    c = window_counts(w)
    if c is None:
        return None
    inline, pooled = c.get("finish_chunks_inline", 0), c.get("finish_chunks_pooled", 0)
    return 100.0 * inline / (inline + pooled) if inline + pooled else None
