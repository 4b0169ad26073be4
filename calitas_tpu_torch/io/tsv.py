"""Metric-style TSV serialization.

Mirrors the fgbio ``Metric`` contract the reference relies on
(SURVEY.md §2.9.6): header row of field names in declaration order,
tab-separated values, ``Option`` ``None`` rendered as the empty string.
"""

from __future__ import annotations

import dataclasses
import decimal
import math
import struct
import sys
from pathlib import Path
from typing import IO, Iterable, Iterator, Type, TypeVar

T = TypeVar("T")

_INF = float("inf")


def format_value(v) -> str:
    # Ordered by frequency in real tables (str >> int >> None >> rest);
    # exact type checks dodge isinstance's mro walk on the hot path.
    t = type(v)
    if t is str:
        return v
    if t is int:
        return str(v)
    if v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        return _format_float(v)
    return str(v)


def _format_float(v: float) -> str:
    """Render a float exactly as Scala/Java ``Double.toString`` would.

    fgbio ``Metric`` writes doubles through ``Double.toString``
    (ReferenceHit.scala:230-233 feeds ``allele_frequency`` into it), whose
    formatting differs from Python ``str``: values below 1e-3 or at/above
    1e7 in magnitude use ``d.dddE±exp`` computerized scientific notation
    (``1.0E-4``, not ``0.0001``), the exponent carries no ``+`` sign or
    padding, and both mantissa and plain renderings keep at least one
    fractional digit (``100.0``, ``1.0E7``).  Digit selection is the
    shortest decimal that round-trips, which Python's ``repr`` shares.
    """
    if v != v:
        return "NaN"
    if v == _INF:
        return "Infinity"
    if v == -_INF:
        return "-Infinity"
    sign = "-" if math.copysign(1.0, v) < 0 else ""
    if v == 0.0:
        return sign + "0.0"
    a = abs(v)
    return _java_number(a, sign, repr(a), lambda s: float(s) == a)


def _java_number(v_abs: float, sign: str, shortest: str, roundtrips) -> str:
    """Java FloatingDecimal formatting shared by ``Double.toString``
    (:func:`_format_float`) and ``Float.toString``
    (:func:`format_java_float32`): given the shortest round-trip decimal
    string of ``v_abs``, render it in Java's plain/scientific style."""
    dec = decimal.Decimal(shortest).normalize()
    sig, digits, exp = dec.as_tuple()
    ds = "".join(str(d) for d in digits)
    adj = len(ds) - 1 + exp  # value = d.ddd * 10^adj
    if len(ds) == 1:
        # Java emits at least two significant digits and picks the
        # 2-digit decimal closest to the value (Double.MIN_VALUE renders
        # as 4.9E-324, not 5.0E-324).  %.1e rounds to the nearest
        # 2-significant-digit decimal; adopt it when it still round-trips.
        two = "%.1e" % v_abs
        if roundtrips(two):
            mant2, exp2 = two.split("e")
            ds2 = mant2.replace(".", "")  # "49", "10", ...
            adj = int(exp2)
            # A trailing zero is just padding (the formatter below re-adds
            # it); a nonzero second digit is Java's closer pick.
            ds = ds2.rstrip("0") or ds2[0]
    if -3 <= adj <= 6:  # plain notation for 1e-3 <= |v| < 1e7
        if adj < 0:
            return sign + "0." + "0" * (-adj - 1) + ds
        int_part = ds[: adj + 1].ljust(adj + 1, "0")
        frac_part = ds[adj + 1 :] or "0"
        return sign + int_part + "." + frac_part
    mantissa = ds[0] + "." + (ds[1:] or "0")
    return sign + mantissa + "E" + str(adj)


def float32_widen(x) -> float:
    """Round a value through IEEE float32 and widen back to double.

    The reference reads allele frequencies as ``Float``
    (SearchReference.scala:199 — ``v.get[ArrayAttr[Float]]("AF")``) and
    assigns them into ``Option[Double]`` fields (ReferenceHit.scala:54,233),
    so Scala widens Float→Double: an input ``AF=0.135`` becomes
    ``0.13500000536441803`` in every downstream comparison and rendering.
    """
    x = float(x)
    try:
        return struct.unpack("<f", struct.pack("<f", x))[0]
    except OverflowError:  # beyond float32 range: Float.parseFloat -> ±Inf
        return math.copysign(_INF, x)


def format_java_float32(v: float) -> str:
    """Render exactly as Java ``Float.toString((float) v)`` would.

    htsjdk's VCF encoder renders non-Double INFO values via
    ``String.valueOf`` (PrepareVcf.scala:72-78 writes the kept AF array as
    ``ArrayAttr[Float]``), i.e. ``Float.toString``: the shortest decimal
    that round-trips the float32, in the same plain/scientific style as
    ``Double.toString`` — ``0.1350`` re-renders as ``0.135``, ``1e-05`` as
    ``1.0E-5``.
    """
    v = float32_widen(v)
    if v != v:
        return "NaN"
    if v == _INF:
        return "Infinity"
    if v == -_INF:
        return "-Infinity"
    sign = "-" if math.copysign(1.0, v) < 0 else ""
    if v == 0.0:
        return sign + "0.0"
    a = abs(v)
    shortest = next(
        s for p in range(1, 10) for s in ("%.*g" % (p, a),) if float32_widen(s) == a
    )
    return _java_number(a, sign, shortest, lambda s: float32_widen(s) == a)


def fields_of(cls) -> list[str]:
    return [f.name for f in dataclasses.fields(cls)]


class MetricWriter:
    """Writes dataclass rows as a TSV with a header."""

    def __init__(self, out: IO[str] | str | Path, cls):
        self._own = not hasattr(out, "write")
        self._fh: IO[str] = open(out, "w") if self._own else out  # type: ignore[arg-type]
        self._fields = fields_of(cls)
        self._fh.write("\t".join(self._fields) + "\n")

    def write(self, row) -> None:
        # Workers pre-render rows (render_row below) so large tables
        # serialize in parallel; fall back to rendering here.
        line = getattr(row, "_line", None)
        if line is None:
            line = render_row(row, self._fields)
        self._fh.write(line)

    def write_all(self, rows: Iterable) -> None:
        for r in rows:
            self.write(r)

    def close(self) -> None:
        if self._own:
            self._fh.close()
        else:
            self._fh.flush()


def render_row(row, fields: list[str]) -> str:
    """One TSV line (newline included) for a metric row — the single
    rendering path shared by MetricWriter and the worker-side
    pre-rendering."""
    return "\t".join([format_value(getattr(row, f)) for f in fields]) + "\n"


def open_output(path: str | Path | None) -> IO[str]:
    """'-'/None -> stdout (reference default Io.StdOut)."""
    if path is None or str(path) in ("-", "/dev/stdout"):
        return sys.stdout
    return open(path, "w")


def read_metrics(path: str | Path, cls: Type[T]) -> list[T]:
    """Read a metric TSV back into dataclass instances (fgbio
    ``Metric.read`` equivalent, used by tests)."""
    hints = {f.name: f.type for f in dataclasses.fields(cls)}
    rows: list[T] = []
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        for line in fh:
            vals = line.rstrip("\n").split("\t")
            kw = {}
            for name, raw in zip(header, vals):
                kw[name] = _parse(raw, hints.get(name, "str"))
            rows.append(cls(**kw))
    return rows


def parse_row(line: str, cls: Type[T]) -> T:
    """One rendered TSV line (field order = dataclass order) back into a
    dataclass instance — the exact inverse of :func:`render_row`."""
    fs = dataclasses.fields(cls)
    vals = line.rstrip("\n").split("\t")
    return cls(**{f.name: _parse(raw, f.type) for f, raw in zip(fs, vals)})


def _parse(raw: str, hint) -> object:
    h = str(hint)
    optional = "Optional" in h or "None" in h
    if raw == "" and optional:
        return None
    if "int" in h:
        return int(raw)
    if "float" in h:
        return float(raw)
    return raw
