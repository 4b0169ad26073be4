"""FASTA I/O: .fai-indexed random access, streaming contig iteration, and
.dict sequence dictionaries.

Replaces the htsjdk pieces the reference leans on (SURVEY.md §2.9.4):
``getSubsequenceAt`` (1-based closed), ``ReferenceSequenceIterator``, and
the ``.fai`` + ``.dict`` requirement (reference README.md:63-68).

Also provides :class:`ReferenceSetBuilder`, the synthetic-FASTA test
fixture builder equivalent to fgbio's (SURVEY.md §4).
"""

from __future__ import annotations

import hashlib
import mmap
import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np


@dataclass(frozen=True)
class FaiEntry:
    name: str
    length: int
    offset: int  # byte offset of the first base
    line_bases: int  # bases per line
    line_width: int  # bytes per line including newline(s)


@dataclass(frozen=True)
class DictEntry:
    name: str
    length: int
    assembly: Optional[str] = None
    species: Optional[str] = None
    md5: Optional[str] = None


class SequenceDictionary:
    """A SAM-style sequence dictionary (.dict file)."""

    def __init__(self, entries: Sequence[DictEntry]):
        self.entries = list(entries)
        self._index = {e.name: i for i, e in enumerate(self.entries)}

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self) -> Iterator[DictEntry]:
        return iter(self.entries)

    def index(self, name: str) -> int:
        """Sequence index of a contig; -1 if unknown (matches htsjdk
        ``getSequenceIndex`` used by the hit sort, ReferenceHit.scala:284)."""
        return self._index.get(name, -1)

    def get(self, name: str) -> Optional[DictEntry]:
        i = self._index.get(name)
        return self.entries[i] if i is not None else None

    @property
    def assembly(self) -> Optional[str]:
        """First non-null assembly among the sequences
        (ReferenceHit.scala:208)."""
        for e in self.entries:
            if e.assembly is not None:
                return e.assembly
        return None

    @staticmethod
    def read(path: str | Path) -> "SequenceDictionary":
        entries = []
        with open(path) as fh:
            for line in fh:
                if not line.startswith("@SQ"):
                    continue
                fields = dict(
                    f.split(":", 1) for f in line.rstrip("\n").split("\t")[1:] if ":" in f
                )
                entries.append(
                    DictEntry(
                        name=fields["SN"],
                        length=int(fields["LN"]),
                        assembly=fields.get("AS"),
                        species=fields.get("SP"),
                        md5=fields.get("M5"),
                    )
                )
        return SequenceDictionary(entries)

    def write(self, path: str | Path) -> None:
        with open(path, "w") as fh:
            fh.write("@HD\tVN:1.6\n")
            for e in self.entries:
                parts = [f"@SQ\tSN:{e.name}\tLN:{e.length}"]
                if e.md5:
                    parts.append(f"M5:{e.md5}")
                if e.assembly:
                    parts.append(f"AS:{e.assembly}")
                if e.species:
                    parts.append(f"SP:{e.species}")
                fh.write("\t".join(parts) + "\n")


def dict_path_for(fasta: str | Path) -> Path:
    """Path of the companion .dict (hts convention: replace the final
    .fa/.fasta(.gz) suffix)."""
    p = Path(fasta)
    name = p.name
    for suffix in (
        ".fasta.gz", ".fa.gz", ".fasta.bgz", ".fa.bgz", ".fasta", ".fa",
    ):
        if name.endswith(suffix):
            return p.with_name(name[: -len(suffix)] + ".dict")
    return p.with_name(name + ".dict")


def extract_dictionary(path: str | Path) -> SequenceDictionary:
    """Extract a sequence dictionary from a .dict file or a FASTA's
    companion .dict (htsjdk SAMSequenceDictionaryExtractor equivalent,
    SearchReference.scala:478-484)."""
    p = Path(path)
    if p.suffix == ".dict":
        return SequenceDictionary.read(p)
    dp = dict_path_for(p)
    if dp.exists():
        return SequenceDictionary.read(dp)
    raise FileNotFoundError(
        f"No sequence dictionary found for {path}; expected {dp}. "
        "Create one with 'samtools dict' or calitas_tpu_torch's ReferenceSetBuilder."
    )


def _is_compressed(path: Path) -> bool:
    return str(path).endswith((".gz", ".bgz"))


def _uncompressed_cache_for(path: Path) -> Path:
    """Decompress a gzip/BGZF FASTA once into a mtime-keyed cache file
    (the reference reads block-compressed FASTA transparently through
    htsjdk + .gzi; we decompress instead so every downstream fast path —
    raw mmap context slices for the native renderer included — keeps
    operating on plain bytes).  The cache is shared across processes:
    worker processes opening the same ``ref_path`` reuse it, and the
    write is atomic (temp + rename) so concurrent openers race safely."""
    import gzip
    import shutil
    import tempfile
    import zlib

    st = path.stat()
    uid = os.getuid() if hasattr(os, "getuid") else 0
    # Two-part key: the PATH part scopes eviction (only stale caches of
    # this same source file + uid may be deleted — a shared fallback dir
    # can hold same-named FASTAs from different directories or users),
    # the STAT part keys freshness.
    pathkey = hashlib.md5(
        f"{path.resolve()}:{uid}".encode()
    ).hexdigest()[:12]
    statkey = hashlib.md5(
        f"{st.st_size}:{st.st_mtime_ns}".encode()
    ).hexdigest()[:12]
    # Prefer a sidecar next to the FASTA (conventional, survives /tmp
    # limits — a 3 Gb genome won't fit a RAM-backed tmpfs); fall back to
    # CALITAS_TPU_CACHE_DIR or the system tempdir when the directory is
    # read-only.  The uid in the key keeps multi-user /tmp caches apart.
    for base in (
        path.parent,
        Path(os.environ.get("CALITAS_TPU_CACHE_DIR")
             or tempfile.gettempdir()),
    ):
        cache = base / f".{path.name}.calitas_cache_{pathkey}_{statkey}.fa"
        if cache.exists():
            return cache
        tmp = cache.with_name(cache.name + f".tmp{os.getpid()}")
        try:
            with gzip.open(path, "rb") as src, open(tmp, "wb") as dst:
                shutil.copyfileobj(src, dst, 16 << 20)
            os.replace(tmp, cache)
            # Evict stale caches for the same FASTA (older stat keys):
            # without this each touch of a multi-GB .fa.gz leaks a new
            # full-size sidecar.  The glob is scoped by the path key so
            # a same-named FASTA from another directory (or user) in a
            # shared fallback dir is never touched; per-file errors
            # (e.g. sticky-bit /tmp) skip that file, not the loop.
            # Best-effort; a racing reader that has the old file open
            # keeps it alive via its fd.
            stale = list(base.glob(
                f".{path.name}.calitas_cache_{pathkey}_*.fa"
            ))
            if base == path.parent:
                # Sidecars of the older single-hash naming,
                # .{name}.calitas_cache_{32 hex}.fa, carry no path key:
                # only the FASTA's own directory is known to hold them
                # for this file, so a shared fallback dir keeps its own.
                legacy = re.compile(
                    rf"\.{re.escape(path.name)}\.calitas_cache_[0-9a-f]{{32}}\.fa"
                )
                stale += [
                    old for old in base.glob(f".{path.name}.calitas_cache_*.fa")
                    if legacy.fullmatch(old.name)
                ]
            for old in stale:
                if old.name == cache.name:
                    continue
                try:
                    old.unlink(missing_ok=True)
                except OSError:
                    continue
            return cache
        except (gzip.BadGzipFile, EOFError, zlib.error) as e:
            # Corrupt/truncated input, not a cache-dir problem: falling
            # through to the next cache dir would mask it behind a
            # misleading "no writable cache directory" error.
            try:
                tmp.unlink(missing_ok=True)
            except OSError:
                pass
            raise OSError(
                f"corrupt compressed FASTA {path}: {e}"
            ) from e
        except OSError:
            try:
                tmp.unlink(missing_ok=True)
            except OSError:
                pass
            continue
    raise OSError(
        f"cannot decompress {path}: no writable cache directory "
        "(set CALITAS_TPU_CACHE_DIR)"
    )


class IndexedFasta:
    """Random access over a .fai-indexed FASTA file.

    Compressed input (``.fa.gz``/``.bgz`` — gzip or BGZF) is supported
    the way htsjdk exposes it (reference README.md:63-68 requires only
    ``.fai`` + ``.dict``): the ``.fai`` carries uncompressed-stream
    offsets, which we serve from a decompressed cache file."""

    def __init__(self, path: str | Path):
        self.path = Path(path)
        data_path = (
            _uncompressed_cache_for(self.path)
            if _is_compressed(self.path)
            else self.path
        )
        fai = Path(str(path) + ".fai")
        if not fai.exists():
            if _is_compressed(self.path):
                # No sidecar index: build one from the decompressed cache
                # (offsets are uncompressed-stream offsets either way).
                fai = Path(str(data_path) + ".fai")
                if not fai.exists():
                    build_fai(data_path)
            else:
                raise FileNotFoundError(
                    f"FASTA index not found: {fai}. Index with 'samtools "
                    "faidx' (or calitas_tpu_torch.io.fasta.build_fai)."
                )
        self.entries: list[FaiEntry] = []
        with open(fai) as fh:
            for line in fh:
                name, length, offset, line_bases, line_width = line.split("\t")[:5]
                self.entries.append(
                    FaiEntry(name, int(length), int(offset), int(line_bases), int(line_width))
                )
        self._by_name = {e.name: e for e in self.entries}
        self._fh = open(data_path, "rb")
        self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        self._raw_view: Optional[np.ndarray] = None  # lazy mmap uint8 view
        dp = dict_path_for(self.path)
        self.dictionary: Optional[SequenceDictionary] = (
            SequenceDictionary.read(dp) if dp.exists() else None
        )

    def close(self) -> None:
        self._raw_view = None  # drop the mmap buffer export first
        self._mm.close()
        self._fh.close()

    @property
    def names(self) -> list[str]:
        return [e.name for e in self.entries]

    def has_chrom(self, chrom: str) -> bool:
        return chrom in self._by_name

    def sequence_length(self, chrom: str) -> Optional[int]:
        e = self._by_name.get(chrom)
        return e.length if e else None

    def _slice_raw(self, e: FaiEntry, start0: int, end0: int) -> bytes:
        """Bases [start0, end0) of a contig, newlines stripped."""
        first_line = start0 // e.line_bases
        last_line = (end0 - 1) // e.line_bases if end0 > start0 else first_line
        byte_start = e.offset + first_line * e.line_width + (start0 % e.line_bases)
        byte_end = e.offset + last_line * e.line_width + ((end0 - 1) % e.line_bases) + 1
        raw = self._mm[byte_start:byte_end]
        return raw.replace(b"\n", b"").replace(b"\r", b"")

    def get_subsequence(self, chrom: str, start: int, end: int) -> bytes:
        """Bases for 1-based closed [start, end] (htsjdk getSubsequenceAt)."""
        e = self._by_name.get(chrom)
        if e is None:
            raise KeyError(f"Unknown chromosome: {chrom}")
        if start < 1 or end > e.length or end < start:
            raise ValueError(f"Bad range {chrom}:{start}-{end} (len {e.length})")
        return self._slice_raw(e, start - 1, end)

    def get_bases(self, chrom: str) -> np.ndarray:
        """The full contig as a uint8 array (case as on disk)."""
        e = self._by_name[chrom]
        return np.frombuffer(self._slice_raw(e, 0, e.length), dtype=np.uint8).copy()

    def raw_spans(
        self, chrom: str, start1, end1
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Vectorized raw-file addressing for 1-based closed ranges
        ``[start1[i], end1[i]]``: returns ``(buffer, byte_off, byte_len)``
        where ``buffer`` is a zero-copy uint8 view of the mmap'd FASTA and
        ``buffer[byte_off[i] : byte_off[i]+byte_len[i]]`` contains exactly
        the ranges' bases WITH the file's newlines still embedded (the
        native finisher strips them — no per-range Python slicing/copy).
        Requires uniform line geometry, which the .fai format guarantees.
        """
        e = self._by_name[chrom]
        p0 = np.asarray(start1, dtype=np.int64) - 1  # 0-based first base
        pl = np.asarray(end1, dtype=np.int64) - 1  # 0-based last base
        if len(p0) and (p0.min() < 0 or pl.max() >= e.length):
            raise ValueError(f"raw_spans out of range for {chrom}")
        lb, lw = e.line_bases, e.line_width
        b0 = e.offset + (p0 // lb) * lw + p0 % lb
        b1 = e.offset + (pl // lb) * lw + pl % lb + 1
        buf = self._raw_view
        if buf is None:
            buf = np.frombuffer(self._mm, dtype=np.uint8)
            self._raw_view = buf
        return buf, b0, (b1 - b0).astype(np.int32)

    def iter_contigs(self) -> Iterator[tuple[str, np.ndarray]]:
        for e in self.entries:
            yield e.name, self.get_bases(e.name)


def build_fai(fasta: str | Path) -> None:
    """Create a .fai index for an uncompressed FASTA (samtools faidx
    equivalent).  Requires uniform line lengths per contig."""
    entries = []
    with open(fasta, "rb") as fh:
        offset = 0
        name = None
        seq_offset = 0
        length = 0
        line_bases = 0
        line_width = 0
        for line in fh:
            if line.startswith(b">"):
                if name is not None:
                    entries.append((name, length, seq_offset, line_bases, line_width))
                name = line[1:].split()[0].decode()
                offset += len(line)
                seq_offset = offset
                length = 0
                line_bases = 0
                line_width = 0
            else:
                stripped = line.rstrip(b"\r\n")
                if line_bases == 0 and stripped:
                    line_bases = len(stripped)
                    line_width = len(line)
                length += len(stripped)
                offset += len(line)
        if name is not None:
            entries.append((name, length, seq_offset, line_bases, line_width))
    # Atomic publish (temp + rename): a crash or a concurrent builder
    # must never leave a truncated .fai that later runs trust.
    tmp = f"{fasta}.fai.tmp{os.getpid()}"
    with open(tmp, "w") as out:
        for name, length, seq_offset, line_bases, line_width in entries:
            out.write(f"{name}\t{length}\t{seq_offset}\t{line_bases}\t{line_width}\n")
    os.replace(tmp, str(fasta) + ".fai")


class ReferenceSetBuilder:
    """Synthesizes an indexed FASTA (+.fai +.dict) from literal strings —
    the test-fixture builder equivalent to fgbio's ``ReferenceSetBuilder``."""

    def __init__(self, assembly: Optional[str] = None, line_length: int = 100):
        self.assembly = assembly
        self.line_length = line_length
        self._contigs: list[tuple[str, list[str]]] = []

    def add(self, name: str) -> "ReferenceSetBuilder._Contig":
        parts: list[str] = []
        self._contigs.append((name, parts))
        return ReferenceSetBuilder._Contig(parts)

    class _Contig:
        def __init__(self, parts: list[str]):
            self._parts = parts

        def add(self, seq: str, times: int = 1) -> "ReferenceSetBuilder._Contig":
            self._parts.append(seq * times)
            return self

    def to_file(self, path: str | Path) -> Path:
        path = Path(path)
        with open(path, "w") as fh:
            for name, parts in self._contigs:
                fh.write(f">{name}\n")
                seq = "".join(parts)
                for i in range(0, len(seq), self.line_length):
                    fh.write(seq[i : i + self.line_length] + "\n")
        build_fai(path)
        entries = []
        for name, parts in self._contigs:
            seq = "".join(parts)
            md5 = hashlib.md5(seq.upper().encode()).hexdigest()
            entries.append(
                DictEntry(name=name, length=len(seq), assembly=self.assembly, md5=md5)
            )
        SequenceDictionary(entries).write(dict_path_for(path))
        return path

    def to_temp_file(self, dir: Optional[str] = None) -> Path:
        import tempfile

        fd, name = tempfile.mkstemp(suffix=".fa", dir=dir)
        os.close(fd)
        return self.to_file(name)
