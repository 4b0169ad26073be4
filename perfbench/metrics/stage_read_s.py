"""Seconds set-up's ``stage`` step spent reading contigs from the FASTA:
the program's ``stage_read`` spans (one per contig in
``serve.py::ResidentSearcher``), summed by the program in its
``stage_read_ns`` counter whether its spans record or not.  The rest of the
step is the upload and encode (``stage_upload``)."""

from perfbench.harness.program_spans import program_spans


def read(w):
    spans = program_spans()
    ns = spans.counts().get("stage_read_ns") if spans is not None else None
    return ns / 1e9 if ns else None
