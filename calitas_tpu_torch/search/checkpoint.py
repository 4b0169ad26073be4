"""Checkpoint/resume for long genome searches.

A copy of ``calitas_tpu/search/checkpoint.py`` (imports renamed; a
``close()``).  An extension over the reference tool (which is
single-shot, SURVEY.md §5): after each contig completes (both passes,
all guides), its raw hits are appended durably to a JSONL state file.  A
resumed run skips completed contigs, reuses the original run-start
timestamp, and produces a final table identical to an uninterrupted run
(the global dedup+sort happen at the end over loaded + new hits).

File format (JSON lines):
  {"meta": {"fingerprint": ..., "timestamp": ...}}
  {"chrom": "chr1", "hits": [{...ReferenceHit fields...}, ...]}
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional

from calitas_tpu_torch.search.hits import ReferenceHit


class CheckpointState:
    def __init__(self, path: Path, fingerprint: str):
        self.path = path
        self.fingerprint = fingerprint
        self.done: set[str] = set()
        self.hits: list[ReferenceHit] = []
        self.timestamp: Optional[str] = None
        self._fh = None

    @classmethod
    def open(cls, path: str | Path, fingerprint: str) -> "CheckpointState":
        from calitas_tpu_torch.io.tsv import parse_row

        state = cls(Path(path), fingerprint)
        torn_at: Optional[int] = None
        if state.path.exists():
            # Binary mode so the tracked offset is bytes by construction
            # (truncate() takes a byte offset; text-mode len(line) counts
            # characters after newline translation, which breaks for any
            # non-ASCII or CRLF-written record).
            with open(state.path, "rb") as fh:
                offset = 0
                for line in fh:
                    stripped = line.strip()
                    if not stripped:
                        offset += len(line)
                        continue
                    try:
                        rec = json.loads(stripped)
                    except (json.JSONDecodeError, UnicodeDecodeError):
                        # A crash mid-write (kill -9, ENOSPC) tears the
                        # final un-fsynced line; that contig was never
                        # marked done, so truncate the tail and resume.
                        torn_at = offset
                        break
                    offset += len(line)
                    if "meta" in rec:
                        meta = rec["meta"]
                        if meta.get("fingerprint") != fingerprint:
                            raise ValueError(
                                f"Checkpoint {path} was created with different "
                                "search parameters; refusing to resume."
                            )
                        state.timestamp = meta.get("timestamp")
                    else:
                        state.done.add(rec["chrom"])
                        for h in rec["hits"]:
                            if "l" in h:  # pre-rendered TSV line
                                state.hits.append(
                                    parse_row(h["l"], ReferenceHit)
                                )
                            else:
                                state.hits.append(
                                    ReferenceHit(**h.get("d", h))
                                )
            if torn_at is not None:
                with open(state.path, "r+b") as fh:
                    fh.truncate(torn_at)
        state._fh = open(state.path, "a")
        return state

    def set_timestamp(self, timestamp: str) -> None:
        self.timestamp = timestamp
        self._write({"meta": {"fingerprint": self.fingerprint, "timestamp": timestamp}})

    def is_done(self, chrom: str) -> bool:
        return chrom in self.done

    def record(self, chrom: str, hits: list) -> None:
        """Append a completed contig's hits.  Pre-rendered rows
        (search.hits.RenderedHit) persist as their TSV line; full
        dataclass rows as field dicts — in hit order, so a resumed run
        rebuilds the exact pre-dedup sequence."""
        from calitas_tpu_torch.search.hits import iter_rows

        recs = []
        for h in iter_rows(hits):  # expands columnar RenderedBlocks
            line = getattr(h, "_line", None)
            if line is not None:
                recs.append({"l": line})
            else:
                recs.append({"d": dataclasses.asdict(h)})
        self._write({"chrom": chrom, "hits": recs})
        self.done.add(chrom)

    def close(self) -> None:
        self._fh.close()

    def _write(self, rec: dict) -> None:
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        os.fsync(self._fh.fileno())
