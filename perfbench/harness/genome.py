"""A configuration's genome: its bases, the FASTA, ``.fai`` and ``.dict``
the program reads, and the planted sites each run writes into it.

The bases are a frozen copy of the port's 1 Gb bench stream
(``calitas_tpu_torch/bench.py::genome_codes`` / ``genome_mask_block``):
base code ``fmix32(x * 0x9E3779B9) & 3`` of a 32-bit counter ``x``, murmur3's
finalizer in wrapping uint32 arithmetic.  Each contig takes the counters that
follow the previous contig's, from an offset drawn from the assembly's name,
so no two contigs share a stretch (a genome up to 2**32 bases).  The device
copy runs in int64 torch arithmetic, each 32-bit multiply split at bit 16;
the host copy (for the bases the traffic reads and writes back) in NumPy
uint32.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

_M1, _M2, _M3 = 0x9E3779B9, 0x85EBCA6B, 0xC2B2AE35
_MASK32 = 0xFFFFFFFF
LETTERS = b"ACGT"
#: bases per FASTA line
LINE = 100
#: positions per device generator step (int64 temporaries of 128 MiB)
CHUNK = 1 << 24


def seed_offset(seed: int, salt: str) -> int:
    """A 32-bit counter offset drawn from ``seed`` (any integer)."""
    h = hashlib.blake2b(f"{salt}:{seed}".encode(), digest_size=8).digest()
    return int.from_bytes(h, "little") & _MASK32


def host_codes(start: int, count: int) -> np.ndarray:
    """Base codes 0-3 of counters [start, start + count) mod 2**32, uint8."""
    x = np.arange(count, dtype=np.uint32)
    x += np.uint32(start & _MASK32)
    x *= np.uint32(_M1)
    x ^= x >> 16
    x *= np.uint32(_M2)
    x ^= x >> 13
    x *= np.uint32(_M3)
    x ^= x >> 16
    return (x & 3).astype(np.uint8)


def _mul32(x, m: int):
    return (x * (m & 0xFFFF) + (((x * (m >> 16)) & 0xFFFF) << 16)) & _MASK32


def device_codes(start: int, count: int, device):
    """:func:`host_codes` on ``device`` in int64 torch arithmetic, uint8."""
    import torch

    x = torch.arange(count, dtype=torch.int64, device=device)
    x += start & _MASK32
    x &= _MASK32
    x = _mul32(x, _M1)
    x ^= x >> 16
    x = _mul32(x, _M2)
    x ^= x >> 13
    x = _mul32(x, _M3)
    x ^= x >> 16
    return (x & 3).to(torch.uint8)


@dataclass(frozen=True)
class Contig:
    name: str
    length: int
    counter: int  # the counter of base 0


def layout(contigs, seed) -> list:
    """Each ``(name, length)`` with the counter of its first base, from an
    offset drawn from ``seed`` (any value)."""
    out, c = [], seed_offset(seed, "genome")
    for name, length in contigs:
        out.append(Contig(name, length, c))
        c = (c + length) & _MASK32
    if sum(length for _n, length in contigs) > 1 << 32:
        raise ValueError("the stream holds 2**32 distinct bases")
    return out


def bases(contig: Contig, start: int, count: int) -> bytes:
    """The generated bases (no planted sites) of [start, start + count)."""
    return np.frombuffer(LETTERS, np.uint8)[host_codes(contig.counter + start, count)].tobytes()


class Genome:
    """A configuration's genome as FASTA + ``.fai`` + ``.dict`` in a cache
    directory of its own, made once (:meth:`ensure`) and kept for every
    later run: the bases do not move with the seed, as a deployment's
    reference does not.  Each run writes its traffic's planted sites into
    the file in place (:meth:`plant`) after writing back the bases that the
    last run's sites covered, which a journal beside the file lists.
    :meth:`fetch` reads bases back for the reference."""

    def __init__(self, contigs: list, assembly: str, directory):
        self.contigs = contigs
        self.assembly = assembly
        self.order = {c.name: i for i, c in enumerate(contigs)}
        self.lengths = {c.name: c.length for c in contigs}
        key = json.dumps([assembly, LINE, [(c.name, c.length, c.counter) for c in contigs]])
        tag = hashlib.blake2b(key.encode(), digest_size=6).hexdigest()
        self.dir = Path(directory) / f"{assembly}-{tag}"
        self.path = self.dir / "genome.fa"
        self.key = key
        self.offsets: dict = {}
        offset = 0
        for c in contigs:
            offset += len(f">{c.name}\n")
            self.offsets[c.name] = offset
            rows, tail = divmod(c.length, LINE)
            offset += rows * (LINE + 1) + (tail + 1 if tail else 0)
        self._fd = None

    def ensure(self, device) -> bool:
        """Makes the files unless a complete set is there; True if it made
        them.  Each contig is generated on ``device``, laid out as FASTA
        lines there and written out; the marker is written last."""
        marker = self.dir / "genome.json"
        if marker.exists() and marker.read_text() == self.key:
            return False
        import torch

        self.dir.mkdir(parents=True, exist_ok=True)
        for stale in (marker, self.dir / "plants.json"):
            stale.unlink(missing_ok=True)
        lut = torch.tensor(list(LETTERS), dtype=torch.uint8, device=device)
        part = self.path.with_suffix(".fa.part")
        with open(part, "wb") as fh:
            for c in self.contigs:
                fh.write(f">{c.name}\n".encode())
                rows, tail = divmod(c.length, LINE)
                buf = torch.empty(rows * (LINE + 1) + (tail + 1 if tail else 0),
                                  dtype=torch.uint8, device=device)
                body = buf[: rows * (LINE + 1)].view(rows, LINE + 1)
                body[:, LINE] = ord("\n")
                for r0 in range(0, rows, CHUNK // LINE):
                    r1 = min(rows, r0 + CHUNK // LINE)
                    codes = device_codes(c.counter + r0 * LINE, (r1 - r0) * LINE, device)
                    body[r0:r1, :LINE] = lut[codes.long()].view(r1 - r0, LINE)
                if tail:
                    codes = device_codes(c.counter + rows * LINE, tail, device)
                    buf[rows * (LINE + 1) : -1] = lut[codes.long()]
                    buf[-1] = ord("\n")
                fh.write(buf.cpu().numpy().tobytes())
                del buf, body
        os.replace(part, self.path)
        with open(str(self.path) + ".fai", "w") as fh:
            fh.writelines(f"{c.name}\t{c.length}\t{self.offsets[c.name]}\t{LINE}\t{LINE + 1}\n"
                          for c in self.contigs)
        with open(self.dir / "genome.dict", "w") as fh:
            fh.write("@HD\tVN:1.6\tSO:unsorted\n")
            fh.writelines(f"@SQ\tSN:{c.name}\tLN:{c.length}\tAS:{self.assembly}\n"
                          for c in self.contigs)
        marker.write_text(self.key)
        return True

    def _offset(self, name: str, pos: int) -> int:
        return self.offsets[name] + pos + pos // LINE

    def _put(self, fd: int, name: str, start: int, data: bytes) -> None:
        """Writes ``data`` over the bases from ``start`` on, line by line."""
        i = 0
        while i < len(data):
            pos = start + i
            n = min(LINE - pos % LINE, len(data) - i)
            os.pwrite(fd, data[i : i + n], self._offset(name, pos))
            i += n

    def plant(self, writes: dict) -> None:
        """Writes ``writes`` ({contig: [(start, bytes)]}, the planted sites)
        into the FASTA, after the generated bases back over the sites the
        journal lists.  The journal first lists both, then the new ones, so a
        run cut at any point leaves it covering every site in the file."""
        journal = self.dir / "plants.json"
        old = json.loads(journal.read_text()) if journal.exists() else []
        new = [[name, s, len(b)] for name, sites in writes.items() for s, b in sites]
        journal.write_text(json.dumps(old + new))
        by_name = {c.name: c for c in self.contigs}
        fd = os.open(self.path, os.O_WRONLY)
        try:
            for name, s, n in old:
                self._put(fd, name, s, bases(by_name[name], s, n))
            for name, sites in writes.items():
                for s, b in sites:
                    self._put(fd, name, s, b)
        finally:
            os.close(fd)
        journal.write_text(json.dumps(new))

    def fetch(self, name: str, a: int, b: int):
        """Bases of [a, b) on contig ``name`` as a str, ``#`` outside the
        contig; None for an unknown contig."""
        if name not in self.offsets:
            return None
        n = self.lengths[name]
        lo, hi = max(a, 0), min(b, n)
        if hi <= lo:
            return "#" * max(b - a, 0)
        if self._fd is None:
            self._fd = os.open(self.path, os.O_RDONLY)
        first = self._offset(name, lo)
        raw = os.pread(self._fd, self._offset(name, hi - 1) + 1 - first, first)
        return "#" * (lo - a) + raw.replace(b"\n", b"").decode() + "#" * (b - hi)

    def close(self) -> None:
        if self._fd is not None:
            os.close(self._fd)
            self._fd = None
