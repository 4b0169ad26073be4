"""Resident-genome serving: stage the genome and index the VCF once, then
answer many searches.

Port of ``calitas_tpu/serve.py``.  A batch ``SearchReference`` run reads
the genome, stages every contig on the device and parses the VCF each
time.  All three are the same for every guide of one genome, so a
long-lived process does them once and answers per-guide searches at the
speed of a warm run: a guide designer screening hundreds of candidate
guides against one genome.

:class:`ResidentSearcher` holds the staged contigs (on the gpu engine's
device, as :meth:`GenomeScreen.stage` makes them, without PAM bits), the
screen and the VCF index.  Each :meth:`~ResidentSearcher.search` is one
full ``SearchReference`` run (both passes, global dedup, dictionary sort,
the 34-column table) whose table equals a fresh run's with the same
arguments but for ``time_stamp``.  The PAM gate of each guide group is
stamped into a temporary copy, so a resident contig is never written.
A device fault while a contig is staged degrades, as the reference's
does: that contig is not resident, and every request aligns it on the
host (the same table), with a WARNING and one count in
``utils.DEGRADED["resident_staging"]``.  Programming errors propagate.

:func:`serve_stdio` wraps a searcher in a line-oriented JSON protocol for
use as a subprocess; the ``Serve`` sub-command runs it.
"""

from __future__ import annotations

import inspect
import json
import logging
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional, Sequence

from calitas_tpu_torch import spans
from calitas_tpu_torch.core.scoring import Defaults
from calitas_tpu_torch.device import resolve_engine
from calitas_tpu_torch.io.fasta import IndexedFasta, extract_dictionary

logger = logging.getLogger("calitas_tpu_torch.Serve")


class ResidentSearcher:
    """A SearchReference engine with the genome resident on the device.

    Scoring costs, window size, the reference and the VCF are fixed at
    construction (they shape the staged arrays, the screen and the index);
    guides, PAMs and per-search limits are free per request.  ``engine``
    is ``auto``, ``host`` or ``gpu`` with ``device`` (``device.py``),
    resolved once; ``contigs`` limits staging to those contigs (the others
    are staged per request, as a batch run stages them)."""

    def __init__(
        self,
        ref: str | Path,
        variants: Optional[str | Path] = None,
        *,
        window_size: int = 1000,
        threads: int = 8,
        engine: str = "auto",
        device: Optional[str] = None,
        guide_mismatch_net_cost: int = Defaults.MISMATCH_NET_COST,
        pam_mismatch_net_cost: int = Defaults.PAM_MISMATCH_NET_COST,
        genome_gap_net_cost: int = Defaults.GENOME_GAP_NET_COST,
        guide_gap_net_cost: int = Defaults.GUIDE_GAP_NET_COST,
        contigs: Optional[Sequence[str]] = None,
    ):
        self.ref = Path(ref)
        self.variants = Path(variants) if variants is not None else None
        self.window_size = window_size
        self.threads = threads
        self.costs = dict(
            guide_mismatch_net_cost=guide_mismatch_net_cost,
            pam_mismatch_net_cost=pam_mismatch_net_cost,
            genome_gap_net_cost=genome_gap_net_cost,
            guide_gap_net_cost=guide_gap_net_cost,
        )
        self.dictionary = extract_dictionary(self.ref)  # required, like the tool
        self.device = resolve_engine(engine, device)
        self.engine = "host" if self.device is None else "gpu"

        self._screen = None
        self._staged: dict = {}
        self._host_only: list = []  # contigs whose staging failed
        if self.device is not None:
            from calitas_tpu_torch.align.engine import SequentialAligner
            from calitas_tpu_torch.ops.genome_screen import GenomeScreen
            from calitas_tpu_torch.utils import degradable, note_degraded

            scorer = SequentialAligner(
                mismatch_net_cost=guide_mismatch_net_cost,
                pam_mismatch_net_cost=pam_mismatch_net_cost,
                genome_gap_net_cost=genome_gap_net_cost,
                guide_gap_net_cost=guide_gap_net_cost,
            ).scorer
            self._screen = GenomeScreen(scorer, self.device, window=window_size)
            t0 = time.perf_counter()
            fasta = IndexedFasta(self.ref)
            try:
                for name in contigs if contigs is not None else fasta.names:
                    if (fasta.sequence_length(name) or 0) < 2:
                        continue  # too short to search, as screened_search skips it
                    try:
                        with spans.span("stage_read", tally=True):
                            bases = fasta.get_bases(name)
                        self._staged[name] = self._screen.stage(bases)
                    except Exception as ex:
                        if not degradable(ex):
                            raise
                        note_degraded(
                            "resident_staging", logger,
                            "Staging failed for %s; searches will align this "
                            "contig on the host.", name,
                        )
                        self._host_only.append(name)
            finally:
                fasta.close()
            logger.info(
                "Staged %d contigs on %s in %.1fs.", len(self._staged),
                self.device, time.perf_counter() - t0,
            )

        self._vcf_index = None
        if self.variants is not None:
            from calitas_tpu_torch.io.vcf import VcfIndex

            t0 = time.perf_counter()
            self._vcf_index = VcfIndex(self.variants)
            logger.info(
                "Indexed VCF %s in %.1fs.", self.variants.name,
                time.perf_counter() - t0,
            )

    def warmup(self, guide_length: int = 23) -> None:
        """Take the first request's one-time costs now: build the CUDA
        kernels (on a CUDA device), then run a throwaway whole-genome
        search with a dummy ``nrg`` guide of ``guide_length`` characters,
        which starts the finish pool's workers.  Errors propagate: a
        server whose kernels do not build cannot answer."""
        t0 = time.perf_counter()
        if self.device is not None and self.device.type == "cuda":
            from calitas_tpu_torch.ops import dp_cuda

            dp_cuda.build_all(("screen_dual", "screen_multi"))
        dummy = ("ACGT" * 8)[: guide_length - 3] + "nrg"
        self.search(guide=dummy, guide_id="_warmup", output=os.devnull)
        logger.info("Warmup in %.1fs.", time.perf_counter() - t0)

    def search(
        self,
        guide: Optional[str] = None,
        guide_id: Optional[str] = None,
        *,
        auxiliary_pams: Sequence[str] = (),
        guide_specs=None,
        output: Optional[str | Path] = None,
        chrom: Optional[str] = None,
        max_variants: int = Defaults.MAX_VARIANTS_IN_CLUSTER,
        max_guide_diffs: int = Defaults.MAX_GUIDE_DIFFS,
        max_pam_mismatches: int = Defaults.MAX_PAM_MISMATCHES,
        max_gaps_between_guide_and_pam: int = Defaults.MAX_GAPS_BETWEEN_GUIDE_AND_PAM,
        max_total_diffs: Optional[int] = None,
        max_overlap: int = Defaults.MAX_OVERLAP,
    ) -> Optional[str]:
        """One full SearchReference run against the resident genome.

        Writes the table to ``output`` when given (returns None);
        otherwise returns the table as a string."""
        from calitas_tpu_torch.parallel.screen_runner import HOST_ONLY
        from calitas_tpu_torch.tools import search_reference

        def _run(out_path):
            search_reference.run(
                guide=guide, guide_id=guide_id, ref=self.ref,
                auxiliary_pams=auxiliary_pams, guide_specs=guide_specs,
                variants=self.variants, max_variants=max_variants,
                output=out_path, threads=self.threads,
                window_size=self.window_size,
                max_guide_diffs=max_guide_diffs,
                max_pam_mismatches=max_pam_mismatches,
                max_gaps_between_guide_and_pam=max_gaps_between_guide_and_pam,
                max_total_diffs=max_total_diffs, max_overlap=max_overlap,
                chrom=chrom, engine=self.engine, device=self.device,
                **self.costs,
                _vcf_index=self._vcf_index, _screen=self._screen,
                _prestaged={**self._staged, **dict.fromkeys(self._host_only, HOST_ONLY)},
            )

        with spans.request():
            if output is not None:
                _run(output)
                return None
            with tempfile.NamedTemporaryFile(mode="r", suffix=".tsv", delete=False) as fh:
                tmp = Path(fh.name)
            try:
                _run(tmp)
                with spans.span("table_read"):
                    return tmp.read_text()
            finally:
                tmp.unlink(missing_ok=True)


def serve_stdio(searcher: ResidentSearcher, stdin=None, stdout=None) -> None:
    """Line-oriented JSON request loop.

    Request: ``{"guide": "...", "guide_id": "...", "output": "path",
    "auxiliary_pams": [...], "chrom": ..., "max_guide_diffs": ..., ...}``
    (any :meth:`ResidentSearcher.search` keyword).  Without ``output``
    the table text comes back inline as ``"table"``.

    Response: ``{"ok": true, "rows": N, "seconds": S, ...}`` or
    ``{"ok": false, "error": "..."}``.  ``{"cmd": "shutdown"}`` exits;
    ``{"cmd": "ping"}`` reports readiness.  The first line written is the
    ready line: the engine, the staged-contig count and the VCF's name.
    """
    stdin = stdin if stdin is not None else sys.stdin
    stdout = stdout if stdout is not None else sys.stdout

    def reply(obj: dict) -> None:
        stdout.write(json.dumps(obj) + "\n")
        stdout.flush()

    reply({
        "ok": True, "ready": True, "engine": searcher.engine,
        "staged_contigs": len(searcher._staged),
        "vcf": searcher.variants.name if searcher.variants else None,
    })
    signature = inspect.signature(searcher.search)
    for line in stdin:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as ex:
            reply({"ok": False, "error": f"bad JSON: {ex}"})
            continue
        if not isinstance(req, dict):
            reply({"ok": False, "error": "bad request: not a JSON object"})
            continue
        cmd = req.pop("cmd", None)
        if cmd == "shutdown":
            reply({"ok": True, "bye": True})
            return
        if cmd == "ping":
            reply({"ok": True, "ready": True})
            continue
        # Classify request-shape errors before the call: a TypeError raised
        # deep inside a search is not the client's fault.
        try:
            signature.bind(**req)
        except TypeError as ex:
            reply({"ok": False, "error": f"bad request: {ex}"})
            continue
        out = req.get("output")
        if out is not None and (not isinstance(out, str) or out == "-"
                                or out.startswith("/dev/")):
            # '-' would write the table into this protocol's stream
            reply({"ok": False, "error": "bad request: output must be a "
                                         "regular file path"})
            continue
        t0 = time.perf_counter()
        try:
            table = searcher.search(**req)
        except Exception as ex:  # noqa: BLE001 — a bad guide must not end the server
            logger.warning("Request failed: %r", ex, exc_info=True)
            reply({"ok": False, "error": repr(ex)})
            continue
        resp = {"ok": True, "seconds": round(time.perf_counter() - t0, 3)}
        if out is not None:
            with open(out) as fh:
                resp["rows"] = sum(1 for _ in fh) - 1
            resp["output"] = out
        else:
            resp["rows"] = table.count("\n") - 1
            resp["table"] = table
        reply(resp)
