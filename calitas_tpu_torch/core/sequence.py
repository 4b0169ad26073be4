"""IUPAC sequence utilities: 4-bit base masks, compatibility, reverse complement.

Reimplements the observable contract of fgbio's ``Sequences.compatible`` /
``Sequences.revcomp`` as used by the reference aligner
(reference: SequentialGuideAligner.scala:139-147, 40-42, 253).

Design: every base is a 4-bit mask over {A=1, C=2, G=4, T=8}; ambiguity
codes are ORs of those bits; two bases are *compatible* iff their masks
intersect.  ``U`` behaves exactly as ``T`` (reference test
SequentialGuideAlignerTest.scala:287-296).  For DP *target* encoding, the
letter ``N`` maps to mask 0 so that it always scores as a mismatch — the
"target N always mismatches" rule of the reference scorer
(SequentialGuideAligner.scala:144) — while a *query* ``N`` keeps mask 15
and matches anything except a target N.  This makes the device kernel's
match test a single ``(q & t) != 0``.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# IUPAC masks
# ---------------------------------------------------------------------------

_A, _C, _G, _T = 1, 2, 4, 8

IUPAC_MASK: dict[str, int] = {
    "A": _A, "C": _C, "G": _G, "T": _T,
    "U": _T,
    "R": _A | _G, "Y": _C | _T, "S": _C | _G, "W": _A | _T,
    "K": _G | _T, "M": _A | _C,
    "B": _C | _G | _T, "D": _A | _G | _T, "H": _A | _C | _T, "V": _A | _C | _G,
    "N": _A | _C | _G | _T,
}

# Complement pairs over IUPAC codes (case preserved by helpers below).
_COMPLEMENT = {
    "A": "T", "T": "A", "C": "G", "G": "C", "U": "A",
    "R": "Y", "Y": "R", "S": "S", "W": "W", "K": "M", "M": "K",
    "B": "V", "V": "B", "D": "H", "H": "D", "N": "N",
    "-": "-", ".": ".",
}

# uint8 lookup tables indexed by raw byte value ---------------------------------

#: byte -> 4-bit mask, case-insensitive; unknown bytes -> 0 (always mismatch)
MASK_TABLE = np.zeros(256, dtype=np.uint8)
#: like MASK_TABLE but 'N'/'n' -> 0 (the DP target encoding)
TARGET_MASK_TABLE = np.zeros(256, dtype=np.uint8)
#: byte -> complement byte (case preserved); unknown bytes pass through
COMPLEMENT_TABLE = np.arange(256, dtype=np.uint8)

for ch, mask in IUPAC_MASK.items():
    for c in (ch, ch.lower()):
        MASK_TABLE[ord(c)] = mask
        TARGET_MASK_TABLE[ord(c)] = 0 if ch == "N" else mask
for ch, comp in _COMPLEMENT.items():
    COMPLEMENT_TABLE[ord(ch)] = ord(comp)
    if ch.isalpha():
        COMPLEMENT_TABLE[ord(ch.lower())] = ord(comp.lower())


def compatible(a: str, b: str) -> bool:
    """True if the two IUPAC bases could represent the same underlying base
    (case-insensitive).  Mirrors fgbio ``Sequences.compatible``."""
    return bool(MASK_TABLE[ord(a)] & MASK_TABLE[ord(b)])


def complement_char(c: str) -> str:
    return chr(COMPLEMENT_TABLE[ord(c)])


def revcomp(s: str) -> str:
    """Reverse complement of an IUPAC string, preserving case."""
    b = np.frombuffer(s.encode("ascii"), dtype=np.uint8)
    return COMPLEMENT_TABLE[b][::-1].tobytes().decode("ascii")


def revcomp_bytes(b: np.ndarray) -> np.ndarray:
    """Reverse complement of a uint8 base array, preserving case."""
    return COMPLEMENT_TABLE[b][::-1]


def revcomp_padded(s: str) -> str:
    """Reverse complement a padded alignment sequence: the string is reversed
    and every character except ``-`` is complemented (case preserved).
    Mirrors SequentialGuideAligner.rc (SequentialGuideAligner.scala:527-536)."""
    return "".join("-" if c == "-" else complement_char(c) for c in reversed(s))


# ---------------------------------------------------------------------------
# Encoders for the DP engine
# ---------------------------------------------------------------------------

def to_bytes(seq: str | bytes | np.ndarray) -> np.ndarray:
    if isinstance(seq, np.ndarray):
        return seq.astype(np.uint8, copy=False)
    if isinstance(seq, bytes):
        return np.frombuffer(seq, dtype=np.uint8)
    return np.frombuffer(seq.encode("ascii"), dtype=np.uint8)


def encode_query(seq: str | bytes | np.ndarray) -> np.ndarray:
    """Encode a query (guide / PAM) sequence as 4-bit masks.  Query ``N``
    keeps mask 15 (matches any non-N target base)."""
    return MASK_TABLE[to_bytes(seq)]


def encode_target(seq: str | bytes | np.ndarray) -> np.ndarray:
    """Encode a target sequence as 4-bit masks with ``N`` -> 0 so a target N
    always scores as a mismatch (SequentialGuideAligner.scala:144)."""
    return TARGET_MASK_TABLE[to_bytes(seq)]


def is_lower_bytes(b: np.ndarray) -> np.ndarray:
    """Boolean mask of lowercase ASCII letters (PAM bases in query encoding)."""
    return (b >= ord("a")) & (b <= ord("z"))
