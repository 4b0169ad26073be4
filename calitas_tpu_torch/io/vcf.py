"""Minimal VCF reader/writer covering the reference's usage
(SURVEY.md §2.9.5): PASS filters, per-alt ``AF`` INFO arrays, the allele
model, contig-header rewriting, genotype stripping, and gzip support.
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field, replace
from pathlib import Path
from typing import IO, Iterator, Optional, Sequence

from calitas_tpu_torch.io.tsv import float32_widen, format_java_float32

PASSING_FILTERS = frozenset({"PASS"})
_SIMPLE_BASES = frozenset("ACGTNacgtn")


@dataclass(frozen=True)
class VcfVariant:
    chrom: str
    pos: int  # 1-based
    id: Optional[str]  # None when '.'
    ref: str
    alts: tuple[str, ...]
    qual: Optional[str]
    filters: frozenset[str]  # empty when '.'
    info: tuple[tuple[str, str], ...]  # ordered key=value pairs ('' for flags)
    format: Optional[str] = None
    genotypes: tuple[str, ...] = ()

    @property
    def end(self) -> int:
        """1-based closed end = pos + len(ref) - 1 (fgbio Variant.end)."""
        return self.pos + len(self.ref) - 1

    @property
    def n_alleles(self) -> int:
        return 1 + len(self.alts)

    def info_dict(self) -> dict[str, str]:
        return dict(self.info)

    def af(self) -> Optional[list[float]]:
        """The AF INFO array (one value per alt), or None.

        Values are parsed through float32 and widened back to double,
        exactly as the reference's ``ArrayAttr[Float]`` read + assignment
        into ``Option[Double]`` does (SearchReference.scala:199,
        ReferenceHit.scala:54,233): ``0.135`` yields
        ``0.13500000536441803`` downstream.
        """
        raw = self.info_dict().get("AF")
        if raw is None:
            return None
        return [float32_widen(x) for x in raw.split(",")]

    def alleles_are_simple(self) -> bool:
        """True iff ref and all alts are plain base strings (no symbolic or
        breakend alleles) — fgbio SimpleAllele check (PrepareVcf.scala:70)."""
        seqs = (self.ref,) + self.alts
        return all(s and all(c in _SIMPLE_BASES for c in s) for s in seqs)

    def copy(self, **kw) -> "VcfVariant":
        return replace(self, **kw)


@dataclass
class VcfHeader:
    lines: list[str] = field(default_factory=list)  # '##...' meta lines
    samples: list[str] = field(default_factory=list)

    def copy(self) -> "VcfHeader":
        return VcfHeader(lines=list(self.lines), samples=list(self.samples))

    def replace_contigs(self, contigs: Sequence[tuple[str, int, Optional[str]]]) -> None:
        """Replace all ##contig lines with the given (name, length, assembly)
        entries, preserving position of the first contig block (or appending)."""
        non_contig = [l for l in self.lines if not l.startswith("##contig")]
        new_lines = [
            "##contig=<ID=%s,length=%d%s>" % (n, ln, f",assembly={a}" if a else "")
            for (n, ln, a) in contigs
        ]
        # insert before #CHROM (i.e., at end of meta lines)
        self.lines = non_contig + new_lines

    def set_general(self, key: str, value: str) -> None:
        self.lines = [l for l in self.lines if not l.startswith(f"##{key}=")]
        self.lines.append(f"##{key}={value}")


def _open_text(path: str | Path, mode: str = "rt") -> IO[str]:
    p = str(path)
    if p.endswith(".gz") or p.endswith(".bgz"):
        if "w" in mode:
            # The reference writes .vcf.gz as BGZF blocks through htsjdk
            # (PrepareVcf.scala:60 via fgbio VcfWriter) so tabix/bcftools
            # can index the output; plain gzip would be rejected there.
            from calitas_tpu_torch.io.bgzf import open_bgzf_text

            return open_bgzf_text(p)  # type: ignore[return-value]
        return gzip.open(p, mode)  # type: ignore[return-value]
    return open(p, mode)


class VcfReader:
    def __init__(self, path: str | Path):
        self.path = path
        self._fh = _open_text(path)
        self.header = VcfHeader()
        self._line: Optional[str] = None
        for line in self._fh:
            line = line.rstrip("\n")
            if line.startswith("##"):
                self.header.lines.append(line)
            elif line.startswith("#CHROM"):
                cols = line.split("\t")
                if len(cols) > 9:
                    self.header.samples = cols[9:]
                break
            else:
                # first record line without #CHROM header (malformed but tolerated)
                self._line = line
                break

    def __iter__(self) -> Iterator[VcfVariant]:
        for line in self.iter_lines():
            yield _parse_record(line)

    def iter_lines(self) -> Iterator[str]:
        """Raw record lines (header consumed).  Streaming filters
        (PrepareVcf) reject most lines on a partial split without paying
        for full record objects."""
        if self._line is not None:
            yield self._line
            self._line = None
        for line in self._fh:
            line = line.rstrip("\n")
            if line:
                yield line
        self._fh.close()

    def query(self, chrom: str, start: int, end: int) -> Iterator[VcfVariant]:
        """Stream-filter records on a chromosome range (the reference only
        queries whole chromosomes, SearchReference.scala:229)."""
        for v in self:
            if v.chrom == chrom and start <= v.pos <= end:
                yield v

    def close(self) -> None:
        self._fh.close()


class VcfIndex:
    """A once-per-run index of a (typically PrepareVcf'd) VCF: raw record
    lines held as one bytes blob with per-chromosome position/offset
    arrays; records parse lazily at query time.

    This is the TPU framework's stand-in for the reference's indexed
    per-chromosome query (SearchReference.scala:227-231): the reference
    opens a VariantSource backed by a tabix/contig index and pulls one
    chromosome at a time; here ``query(chrom)`` is a dict lookup plus a
    binary search over an int array instead of a linear re-scan of the
    file — and multi-guide / per-contig-checkpoint runs never re-read
    the file.  Holding lines rather than parsed objects keeps
    gnomAD-scale prepared VCFs (tens of millions of records) at
    file-size memory instead of object-graph memory.
    """

    def __init__(self, path: str | Path):
        import numpy as np

        self.path = path
        reader = VcfReader(path)
        self.header = reader.header
        build: dict[str, tuple[list, list, list]] = {}  # starts, ends, pos
        self._order: list[str] = []
        blob = bytearray()
        for line in reader.iter_lines():
            f = line.split("\t", 2)
            chrom = f[0]
            lists = build.get(chrom)
            if lists is None:
                lists = build[chrom] = ([], [], [])
                self._order.append(chrom)
            raw = line.encode()
            lists[0].append(len(blob))
            lists[1].append(len(blob) + len(raw))
            lists[2].append(int(f[1]))
            blob += raw
        self._blob = bytes(blob)
        # Per-chrom numpy (start, end, pos) int64 arrays: ~24 bytes per
        # record regardless of scale (vs hundreds for tuples/objects).
        # Sorted positions enable searchsorted queries; a VCF unsorted
        # within a chromosome (malformed but tolerated, like the
        # streaming reader) falls back to a linear filter.
        self._starts: dict[str, "np.ndarray"] = {}
        self._ends: dict[str, "np.ndarray"] = {}
        self._pos: dict[str, "np.ndarray"] = {}
        self._sorted: dict[str, bool] = {}
        for c in self._order:
            s, e, p = (np.asarray(v, dtype=np.int64) for v in build[c])
            self._starts[c], self._ends[c], self._pos[c] = s, e, p
            self._sorted[c] = bool(np.all(p[:-1] <= p[1:]))

    def _record(self, s: int, e: int) -> VcfVariant:
        return _parse_record(self._blob[s:e].decode())

    @property
    def chroms(self) -> list[str]:
        return list(self._order)

    def __iter__(self) -> Iterator[VcfVariant]:
        for c in self._order:
            for s, e in zip(self._starts[c], self._ends[c]):
                yield self._record(int(s), int(e))

    def query(self, chrom: str, start: int = 1, end: int = 2**31 - 1) -> Iterator[VcfVariant]:
        """Variants with start <= pos <= end on ``chrom`` (same contract
        as :meth:`VcfReader.query`), via binary search when sorted."""
        import numpy as np

        pos = self._pos.get(chrom)
        if pos is None or not len(pos):
            return iter(())
        ss, ee = self._starts[chrom], self._ends[chrom]
        if not self._sorted[chrom]:
            return (
                self._record(int(s), int(e))
                for s, e, p in zip(ss, ee, pos)
                if start <= p <= end
            )
        lo = int(np.searchsorted(pos, start, side="left"))
        hi = int(np.searchsorted(pos, end, side="right"))
        return (
            self._record(int(s), int(e)) for s, e in zip(ss[lo:hi], ee[lo:hi])
        )


def _parse_record(line: str) -> VcfVariant:
    f = line.split("\t")
    chrom, pos, vid, ref, alt, qual, filt, info = f[:8]
    fmt = f[8] if len(f) > 8 else None
    gts = tuple(f[9:]) if len(f) > 9 else ()
    info_pairs: list[tuple[str, str]] = []
    if info != ".":
        for item in info.split(";"):
            if "=" in item:
                k, v = item.split("=", 1)
                info_pairs.append((k, v))
            elif item:
                info_pairs.append((item, ""))
    return VcfVariant(
        chrom=chrom,
        pos=int(pos),
        id=None if vid == "." else vid,
        ref=ref,
        # '.' and empty tokens (malformed trailing commas) carry no
        # allele; htsjdk rejects them outright, we drop them tolerantly
        alts=tuple(a for a in alt.split(",") if a not in (".", "")),
        qual=None if qual == "." else qual,
        filters=frozenset() if filt == "." else frozenset(filt.split(";")),
        info=tuple(info_pairs),
        format=fmt,
        genotypes=gts,
    )


class VcfWriter:
    def __init__(self, path: str | Path, header: VcfHeader):
        self._fh = _open_text(path, "wt")
        self.header = header
        for line in header.lines:
            self._fh.write(line + "\n")
        cols = ["#CHROM", "POS", "ID", "REF", "ALT", "QUAL", "FILTER", "INFO"]
        if header.samples:
            cols += ["FORMAT"] + header.samples
        self._fh.write("\t".join(cols) + "\n")

    def write(self, v: VcfVariant) -> None:
        info = (
            ";".join(k if val == "" else f"{k}={val}" for k, val in v.info)
            if v.info
            else "."
        )
        fields = [
            v.chrom,
            str(v.pos),
            v.id if v.id is not None else ".",
            v.ref,
            ",".join(v.alts) if v.alts else ".",
            v.qual if v.qual is not None else ".",
            ";".join(sorted(v.filters)) if v.filters else ".",
            info,
        ]
        if self.header.samples:
            fields.append(v.format or ".")
            fields.extend(v.genotypes)
        self._fh.write("\t".join(fields) + "\n")

    def write_line(self, line: str) -> None:
        """Write one pre-rendered record line (newline included)."""
        self._fh.write(line)

    def close(self) -> None:
        self._fh.close()


def format_af(values: Sequence[float]) -> str:
    """Render an AF array as htsjdk's VCF encoder does for the reference's
    ``ArrayAttr[Float]`` (PrepareVcf.scala:72-78): ``Float.toString`` per
    value — shortest float32 round-trip, Java spelling."""
    return ",".join(format_java_float32(v) for v in values)
