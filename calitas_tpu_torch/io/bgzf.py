"""BGZF (blocked gzip) writer: the compressed-VCF container htsjdk and
tabix require.

The reference writes ``.vcf.gz`` through htsjdk's ``BlockCompressedOutputStream``
(PrepareVcf.scala:60 via fgbio ``VcfWriter``): a sequence of independent
gzip members, each carrying a BC extra subfield with the compressed block
size, terminated by a fixed 28-byte empty block (the BGZF EOF marker).
Plain ``gzip`` output is readable by ``gzip``/htsjdk but rejected by
tabix/bcftools indexers; this writer produces spec-conformant BGZF
(SAMv1 spec §4.1) so downstream indexing round-trips.

A BGZF stream is also a valid multi-member gzip stream, so Python's
``gzip.open`` (and our :func:`calitas_tpu_torch.io.vcf._open_text`) reads it
back unchanged.
"""

from __future__ import annotations

import io
import struct
import zlib
from pathlib import Path

#: maximum uncompressed payload per block (htsjdk's default: 64 KiB
#: minus worst-case deflate overhead so BSIZE always fits in uint16)
MAX_BLOCK_DATA = 65280

#: the fixed empty final block every BGZF file must end with
EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

_HEADER = struct.Struct("<4BI2BH2BHH")  # gzip header + FEXTRA BC subfield


def compress_block(data: bytes, level: int = 6) -> bytes:
    """One complete BGZF block (gzip member with the BC size subfield)
    for <= MAX_BLOCK_DATA bytes of payload."""
    assert len(data) <= MAX_BLOCK_DATA
    co = zlib.compressobj(level, zlib.DEFLATED, -15)  # raw deflate
    cdata = co.compress(data) + co.flush()
    bsize = len(cdata) + 18 + 8  # header(18) + cdata + crc/isize(8)
    assert bsize <= 0xFFFF, "BGZF block overflow (incompressible payload)"
    header = _HEADER.pack(
        0x1F, 0x8B, 8, 4,  # magic, CM=deflate, FLG=FEXTRA
        0,  # MTIME
        0, 0xFF,  # XFL, OS=unknown
        6,  # XLEN
        66, 67, 2,  # 'B','C', SLEN=2
        bsize - 1,
    )
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + cdata + footer


class BgzfWriter(io.RawIOBase):
    """Binary file-like object writing BGZF blocks (``.close()`` writes
    the EOF marker).  Wrap in ``io.TextIOWrapper`` for text."""

    def __init__(self, path: str | Path, level: int = 6):
        super().__init__()
        self._fh = open(path, "wb")
        self._buf = bytearray()
        self._level = level

    def writable(self) -> bool:
        return True

    def write(self, data) -> int:
        self._buf += data
        while len(self._buf) >= MAX_BLOCK_DATA:
            chunk = bytes(self._buf[:MAX_BLOCK_DATA])
            del self._buf[:MAX_BLOCK_DATA]
            self._fh.write(compress_block(chunk, self._level))
        return len(data)

    def flush(self) -> None:
        if self._fh.closed:
            return
        if self._buf:
            self._fh.write(compress_block(bytes(self._buf), self._level))
            self._buf.clear()
        self._fh.flush()

    def close(self) -> None:
        if self.closed:
            return
        self.flush()
        self._fh.write(EOF_BLOCK)
        self._fh.close()
        super().close()


def open_bgzf_text(path: str | Path, level: int = 6):
    """BGZF-compressed text stream (the ``.vcf.gz`` write path)."""
    import io as _io

    # utf-8 like the plain-text and gzip write paths (VCF 4.3 allows
    # UTF-8 in header Description/source fields)
    return _io.TextIOWrapper(BgzfWriter(path, level), encoding="utf-8",
                             write_through=False)


def is_bgzf(path: str | Path) -> bool:
    """True if the file starts with a BGZF block (gzip + BC subfield)."""
    with open(path, "rb") as fh:
        head = fh.read(18)
    return (
        len(head) >= 18
        and head[:4] == b"\x1f\x8b\x08\x04"
        and head[12:14] == b"BC"
    )
