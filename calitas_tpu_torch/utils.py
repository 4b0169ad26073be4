"""Small shared utilities."""

from __future__ import annotations

import re


def camel_to_gnu(name: str) -> str:
    """camelCase -> gnu-style-option-name (fgbio StringUtil.camelToGnu, used
    for the aligner_other_parameters column, SearchReference.scala:496-508)."""
    return re.sub(r"(?<!^)(?=[A-Z])", "-", name).lower()


def scala_option_repr(v) -> str:
    """Render an optional value the way Scala's Option.toString does —
    AlignToReference interpolates Option values directly into its
    parameter string (AlignToReference.scala:77-86)."""
    return "None" if v is None else f"Some({v})"


class ProgressLogger:
    """Throughput progress logging (reference: fgbio ProgressLogger —
    every `unit` records, SearchReference.scala:531,579)."""

    def __init__(self, logger, noun: str = "records", verb: str = "Processed",
                 unit: int = 25_000):
        import time as _time

        self._logger = logger
        self._noun = noun
        self._verb = verb
        self._unit = unit
        self._count = 0
        self._start = _time.monotonic()

    def record(self, chrom: str = "", pos: int = 0, n: int = 1) -> None:
        import time as _time

        self._count += n
        if self._count % self._unit < n:
            elapsed = _time.monotonic() - self._start
            rate = self._count / elapsed if elapsed > 0 else 0.0
            where = f" Last {self._noun[:-1]}: {chrom}:{pos}." if chrom else ""
            self._logger.info(
                "%s %s %s. Elapsed %.0fs (%.0f/s).%s",
                self._verb, f"{self._count:,}", self._noun, elapsed, rate, where,
            )
