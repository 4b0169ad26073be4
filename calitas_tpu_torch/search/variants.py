"""The variant (VCF) haplotype engine: clusters variants, expands allele
combinations into modified reference windows, and lifts hit coordinates
back to the reference frame.

Parity contract: SearchReference.scala:101-400 and the variant pass of
execute() (:570-630); SURVEY.md §2.6.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

from calitas_tpu_torch.core.cigar import Cigar, CigarElem
from calitas_tpu_torch.core.sequence import revcomp
from calitas_tpu_torch.align.guide_alignment import GuideAlignment
from calitas_tpu_torch.io.fasta import IndexedFasta
from calitas_tpu_torch.io.vcf import VcfReader, VcfVariant
from calitas_tpu_torch.search.windows import upper_bytes

logger = logging.getLogger("calitas_tpu_torch.variants")


@dataclass(frozen=True)
class VariantAllele:
    """A variant allele inserted into the reference (1-based pos) —
    SearchReference.scala:105-110."""

    id: str
    pos: int
    ref: str
    alt: str
    af: float

    @property
    def display_string(self) -> str:
        # 0-based pos for display; AF with 3 decimals.
        return f"{self.id if self.id else '.'}:{self.pos - 1}:{self.ref}>{self.alt}:{self.af:.3f}"


@dataclass
class VariantWindow:
    """A reference window modified by variant alleles; ``cigar`` maps
    window bases (query) onto the reference (target)
    (SearchReference.scala:112-157)."""

    chrom: str
    start: int  # 1-based
    variants: tuple[VariantAllele, ...]
    cigar: Cigar
    bases: np.ndarray  # uint8

    @property
    def length(self) -> int:
        return len(self.bases)

    def ref_offset_at_base_offset(self, offset: int, preceding: bool) -> int:
        """Map a window offset to a 0-based genome offset by walking the
        CIGAR; bases inside insertions map to the preceding or succeeding
        reference base (SearchReference.scala:133-156; pinned by test
        SearchReferenceTest.scala:198-215)."""
        if offset == len(self.bases):
            return self.start - 1 + self.cigar.length_on_target
        ref_offset = self.start - 1
        base_offset = 0
        elems = iter(self.cigar)
        cur = next(elems)
        while offset >= base_offset + cur.length_on_query:
            ref_offset += cur.length_on_target
            base_offset += cur.length_on_query
            cur = next(elems)
        if cur.op == "I":
            return ref_offset - 1 if preceding else ref_offset
        if cur.op == "M":
            return ref_offset + (offset - base_offset)
        raise AssertionError(f"Query bases can't be present at operator {cur.op}.")


@dataclass(frozen=True)
class VariantSet:
    """A set of variants plus a chosen ALT allele index (>0) per variant
    (SearchReference.scala:166-202)."""

    variants: tuple[VcfVariant, ...]
    alleles: tuple[int, ...]

    def __post_init__(self) -> None:
        assert len(self.variants) == len(self.alleles)
        assert all(a > 0 for a in self.alleles)

    @property
    def start(self) -> int:
        return self.variants[0].pos

    @property
    def end(self) -> int:
        return self.variants[-1].end

    def is_valid(self) -> bool:
        """No two chosen alleles modify the same reference base
        (SearchReference.scala:182-193)."""
        if len(self.variants) == 1:
            return True
        spans = [
            (v.pos, v.pos + len(v.ref) - 1) for v in self.variants
        ]
        for (s1, e1), (s2, e2) in zip(spans, spans[1:]):
            if s2 <= e1 and s1 <= e2:  # interval overlap (1-based closed)
                return False
        return True

    def variant_allele(self, i: int) -> VariantAllele:
        v = self.variants[i]
        a = self.alleles[i]
        afs = v.af()
        af = afs[a - 1] if afs is not None and len(afs) >= a else 0.0
        return VariantAllele(
            id=v.id or "", pos=v.pos, ref=v.ref, alt=v.alts[a - 1], af=float(af)
        )


def allele_combo_indices(allele_counts: Sequence[int]) -> list[list[int]]:
    """All combinations of allele indices, e.g. [2, 2] ->
    [[0,0],[0,1],[1,0],[1,1]] (SearchReference.scala:377-399)."""
    total = 1
    for n in allele_counts:
        total *= n
    results = [[0] * len(allele_counts) for _ in range(total)]
    denom = 1
    for i, n in enumerate(allele_counts):
        denom *= n
        group_size = total // denom
        j = 0
        allele = 0
        while j < total:
            for _ in range(group_size):
                results[j][i] = allele
                j += 1
            allele = (allele + 1) % n
    return results


def allele_combos(vs: Sequence[VcfVariant], max_variants: int) -> list[VariantSet]:
    """VariantSets for a chunk of variants; falls back to per-alt sets of
    the *first* variant only when the cluster exceeds max_variants
    (SearchReference.scala:351-369)."""
    vs = list(vs)
    if len(vs) > max_variants:
        logger.warning(
            "Not checking combos for %d variants at %s:%d-%d",
            len(vs), vs[0].chrom, vs[0].pos, vs[-1].end,
        )
        v = vs[0]
        return [
            VariantSet((v,), (a + 1,)) for a in range(len(v.alts))
        ]
    out: list[VariantSet] = []
    for alleles in allele_combo_indices([v.n_alleles for v in vs]):
        chosen = [(v, a) for v, a in zip(vs, alleles) if a != 0]
        if not chosen:
            continue
        vset = VariantSet(tuple(v for v, _ in chosen), tuple(a for _, a in chosen))
        if vset.is_valid():
            out.append(vset)
    return out


def build_variant_window(
    vset: VariantSet, ref_name: str, ref_bases: np.ndarray, padding: int
) -> VariantWindow:
    """Substitute the chosen alt alleles into a padded reference slice and
    build the window->reference CIGAR (SearchReference.scala:263-323)."""
    ref_len = len(ref_bases)
    if vset.start < 1 or vset.end > ref_len:
        # Mirrors the native builder's -3xx error: a variant beyond the
        # contig means mismatched VCF/reference builds — fail loudly.
        raise ValueError(
            f"Variant at {ref_name}:{vset.start}-{vset.end} lies beyond "
            f"the contig end (contig length {ref_len}) — do the VCF and "
            "reference use the same genome build?"
        )
    window_start = max(1, vset.start - padding)
    window_end = min(ref_len, vset.end + padding)
    alleles = [vset.variant_allele(i) for i in range(len(vset.variants))]

    # Fast path for the dominant shape (a single same-length
    # substitution, e.g. one SNP): copy, overwrite, all-M cigar —
    # identical output to the general machinery below.
    if len(alleles) == 1:
        a = alleles[0]
        if len(a.ref) == len(a.alt):
            arr = ref_bases[window_start - 1 : window_end].copy()
            i0 = a.pos - window_start
            arr[i0 : i0 + len(a.alt)] = np.frombuffer(
                a.alt.encode("ascii"), dtype=np.uint8
            )
            return VariantWindow(
                chrom=ref_name,
                start=window_start,
                variants=(a,),
                cigar=Cigar((CigarElem("M", len(arr)),)),
                bases=arr,
            )

    bases = bytearray(ref_bases[window_start - 1 : window_end].tobytes())

    # Substitute right-to-left to keep the math simple.
    for allele in reversed(alleles):
        start_index = allele.pos - window_start
        alt_b = allele.alt.encode("ascii")
        if len(allele.ref) == len(allele.alt):
            bases[start_index : start_index + len(alt_b)] = alt_b
        else:
            bases[start_index : start_index + len(allele.ref)] = alt_b

    # Build the window->reference CIGAR (I consumes window bases).
    elems: list[CigarElem] = []
    ref_pos = window_start
    base_offset = 0
    for allele in alleles:
        preceding_match = allele.pos - ref_pos
        if preceding_match > 0:
            elems.append(CigarElem("M", preceding_match))
            ref_pos += preceding_match
            base_offset += preceding_match
        rlen, alen = len(allele.ref), len(allele.alt)
        if rlen == alen:  # substitution
            elems.append(CigarElem("M", rlen))
        elif rlen == 1 and alen > 1:  # simple insertion
            elems.append(CigarElem("M", 1))
            elems.append(CigarElem("I", alen - 1))
        elif rlen > 1 and alen == 1:  # simple deletion
            elems.append(CigarElem("M", 1))
            elems.append(CigarElem("D", rlen - 1))
        else:  # complicated substitution with length difference
            elems.append(CigarElem("D", rlen))
            elems.append(CigarElem("I", alen))
        ref_pos += rlen
        base_offset += alen
    if len(bases) - base_offset > 0:
        elems.append(CigarElem("M", len(bases) - base_offset))
    cigar = Cigar(elems).coalesce()
    assert cigar.length_on_query == len(bases), (
        f"Cigar: {cigar}, LoQ: {cigar.length_on_query}, len(bases): {len(bases)}"
    )
    return VariantWindow(
        chrom=ref_name,
        start=window_start,
        variants=tuple(alleles),
        cigar=cigar,
        bases=np.frombuffer(bytes(bases), dtype=np.uint8),
    )


def next_chunk(variants: "_Peekable", max_distance: int) -> list[VcfVariant]:
    """The next chunk of variants that are close together
    (SearchReference.scala:326-337)."""
    last = variants.next()
    out = [last]
    while (
        variants.has_next()
        and variants.peek().chrom == last.chrom
        and variants.peek().pos <= last.end + max_distance
    ):
        last = variants.next()
        out.append(last)
    return out


def re_chunk(vs: list[VcfVariant], max_distance: int) -> list[list[VcfVariant]]:
    """Re-chunk by tails so each sub-chunk's variants all start within
    max_distance of the first's end (SearchReference.scala:343-347).
    Every non-empty tail yields a chunk."""
    out = []
    for i in range(len(vs)):
        sub = vs[i:]
        head_end = sub[0].end
        chunk = []
        for v in sub:
            if v.pos - head_end <= max_distance:
                chunk.append(v)
            else:
                break
        out.append(chunk)
    return out


class _Peekable:
    def __init__(self, it: Iterator[VcfVariant]):
        self._it = iter(it)
        self._head: Optional[VcfVariant] = None
        self._done = False
        self._advance()

    def _advance(self) -> None:
        try:
            self._head = next(self._it)
        except StopIteration:
            self._head = None
            self._done = True

    def has_next(self) -> bool:
        return not self._done

    def peek(self) -> VcfVariant:
        assert self._head is not None
        return self._head

    def next(self) -> VcfVariant:
        v = self._head
        assert v is not None
        self._advance()
        return v


#: records per native builder call (patchable in tests to pin the
#: block-boundary chunk-continuation logic)
_NATIVE_BLOCK = 65536


class _LazyVariantWindow(VariantWindow):
    """A VariantWindow whose cigar and variant alleles materialize on
    first access.  The native builder emits window bases, cigar strings
    and (record index, alt index) descriptors; most windows produce no
    hits, so their cigars are never parsed and their VCF records never
    decoded."""

    def __init__(self, chrom, start, bases, cigar_str, vpairs, resolver):
        self.chrom = chrom
        self.start = start
        self.bases = bases
        self._cigar_str = cigar_str
        self._vpairs = vpairs
        self._resolver = resolver

    @property
    def cigar(self) -> Cigar:
        c = self.__dict__.get("_cigar_obj")
        if c is None:
            from calitas_tpu_torch.core.cigar import LazyCigar

            c = LazyCigar(self._cigar_str)
            self.__dict__["_cigar_obj"] = c
        return c

    @property
    def variants(self) -> tuple[VariantAllele, ...]:
        v = self.__dict__.get("_variants")
        if v is None:
            v = tuple(self._resolver(r, a) for r, a in self._vpairs)
            self.__dict__["_variants"] = v
        return v


class _WindowBlock:
    """A block of native-builder windows in raw buffer form.

    The device screen packs its mask rows straight from the shared
    block buffers (one vectorized IUPAC encode per block), and only
    FLAGGED windows ever materialize Python objects — at gnomAD scale
    ~0.3% of windows are flagged, so per-window object churn dominates
    the variant pass without this."""

    __slots__ = (
        "chrom", "n", "masks", "_wbases", "_woff", "_wlen", "_wstart",
        "_cig_bytes", "_cigoff", "_ciglen", "_voff", "_vcnt", "_vrec",
        "_valt", "_resolver",
    )

    def __init__(self, chrom, n, wbases, woff, wlen, wstart, cig_bytes,
                 cigoff, ciglen, voff, vcnt, vrec, valt, resolver):
        from calitas_tpu_torch.core.sequence import TARGET_MASK_TABLE

        self.chrom = chrom
        self.n = n
        self._wbases = wbases
        self._woff = woff
        self._wlen = wlen
        self._wstart = wstart
        self._cig_bytes = cig_bytes
        self._cigoff = cigoff
        self._ciglen = ciglen
        self._voff = voff
        self._vcnt = vcnt
        self._vrec = vrec
        self._valt = valt
        self._resolver = resolver
        total = int(woff[n - 1] + wlen[n - 1]) if n else 0
        self.masks = TARGET_MASK_TABLE[wbases[:total]]

    def length(self, i: int) -> int:
        return int(self._wlen[i])

    def mask_row(self, i: int) -> np.ndarray:
        o = int(self._woff[i])
        return self.masks[o : o + int(self._wlen[i])]

    def window(self, i: int) -> "_LazyVariantWindow":
        o = int(self._woff[i])
        vo = int(self._voff[i])
        vc = int(self._vcnt[i])
        co = int(self._cigoff[i])
        return _LazyVariantWindow(
            chrom=self.chrom,
            start=int(self._wstart[i]),
            bases=self._wbases[o : o + int(self._wlen[i])],
            cigar_str=self._cig_bytes[co : co + int(self._ciglen[i])].decode(
                "ascii"
            ),
            vpairs=tuple(
                (int(self._vrec[vo + t]), int(self._valt[vo + t]))
                for t in range(vc)
            ),
            resolver=self._resolver,
        )

    def windows(self) -> Iterator["_LazyVariantWindow"]:
        for i in range(self.n):
            yield self.window(i)


def _native_chrom_windows(
    lib, index, vchrom: str, ref_bases: np.ndarray, padding: int,
    max_variants: int,
) -> Iterator[VariantWindow]:
    """Stream this chromosome's variant windows from the native builder
    (native/variants.cpp), block by block."""
    for blk in _native_chrom_blocks(
        lib, index, vchrom, ref_bases, padding, max_variants
    ):
        yield from blk.windows()


def _native_chrom_blocks(
    lib, index, vchrom: str, ref_bases: np.ndarray, padding: int,
    max_variants: int,
) -> Iterator[_WindowBlock]:
    """Raw-buffer form of :func:`_native_chrom_windows`: yields
    :class:`_WindowBlock`s for the screened fast path."""
    import ctypes

    from calitas_tpu_torch.io.vcf import _parse_record

    spans_s = index._starts[vchrom]
    spans_e = index._ends[vchrom]
    blob_arr = np.frombuffer(index._blob, dtype=np.uint8)
    blob = index._blob
    n = len(spans_s)
    cache: dict[int, object] = {}

    def resolver(rec_idx: int, alt_idx: int) -> VariantAllele:
        v = cache.get(rec_idx)
        if v is None:
            s, e = int(spans_s[rec_idx]), int(spans_e[rec_idx])
            v = _parse_record(blob[s:e].decode())
            cache[rec_idx] = v
        afs = v.af()
        af = afs[alt_idx - 1] if afs is not None and len(afs) >= alt_idx else 0.0
        return VariantAllele(
            id=v.id or "", pos=v.pos, ref=v.ref, alt=v.alts[alt_idx - 1],
            af=float(af),
        )

    i0 = 0
    block = _NATIVE_BLOCK
    win_cap = 0
    while i0 < n:
        nb = min(block, n - i0)
        final = 1 if i0 + nb == n else 0
        rec_s = np.ascontiguousarray(spans_s[i0 : i0 + nb])
        rec_e = np.ascontiguousarray(spans_e[i0 : i0 + nb])
        win_cap = max(win_cap, 4 * nb + 256)
        while True:
            vpair_cap = 2 * win_cap
            bases_cap = win_cap * (2 * padding + 80)
            cig_cap = win_cap * 32
            wbases = np.empty(bases_cap, dtype=np.uint8)
            woff = np.empty(win_cap, dtype=np.int64)
            wlen = np.empty(win_cap, dtype=np.int32)
            wstart = np.empty(win_cap, dtype=np.int64)
            cig = np.empty(cig_cap, dtype=np.uint8)
            cigoff = np.empty(win_cap, dtype=np.int64)
            ciglen = np.empty(win_cap, dtype=np.int32)
            voff = np.empty(win_cap, dtype=np.int32)
            vcnt = np.empty(win_cap, dtype=np.int32)
            vrec = np.empty(vpair_cap, dtype=np.int32)
            valt = np.empty(vpair_cap, dtype=np.int32)
            warn = np.empty(3 * nb + 3, dtype=np.int64)
            n_windows = ctypes.c_int32(0)
            n_vpairs = ctypes.c_int32(0)
            n_warn = ctypes.c_int32(0)
            rc = lib.build_variant_windows(
                blob_arr.ctypes.data, rec_s.ctypes.data, rec_e.ctypes.data,
                nb, final, i0,
                ref_bases.ctypes.data, len(ref_bases), padding, max_variants,
                wbases.ctypes.data, bases_cap, woff.ctypes.data,
                wlen.ctypes.data, wstart.ctypes.data,
                cig.ctypes.data, cig_cap, cigoff.ctypes.data,
                ciglen.ctypes.data, voff.ctypes.data, vcnt.ctypes.data,
                vrec.ctypes.data, valt.ctypes.data,
                win_cap, vpair_cap, warn.ctypes.data, nb + 1,
                ctypes.byref(n_windows), ctypes.byref(n_vpairs),
                ctypes.byref(n_warn),
            )
            if rc == -1:
                win_cap *= 4
                continue
            if rc <= -300:
                k = -(rc + 300)
                raise ValueError(
                    f"Variant {vchrom} record {i0 + k} lies beyond the "
                    f"contig end (contig length {len(ref_bases)}) — do "
                    "the VCF and reference use the same genome build?"
                )
            if rc < 0:
                raise ValueError(
                    f"Malformed VCF record near {vchrom} record {i0} "
                    f"(native parser error {rc})"
                )
            break
        if rc == 0 and not final:
            block *= 2  # one chunk spans the whole block; widen and retry
            continue
        for k in range(int(n_warn.value)):
            logger.warning(
                "Not checking combos for %d variants at %s:%d-%d",
                int(warn[3 * k]), vchrom, int(warn[3 * k + 1]),
                int(warn[3 * k + 2]),
            )
        nw = int(n_windows.value)
        if nw:
            yield _WindowBlock(
                vchrom, nw, wbases, woff, wlen, wstart, cig.tobytes(),
                cigoff, ciglen, voff, vcnt, vrec, valt, resolver,
            )
        i0 += rc
        block = _NATIVE_BLOCK


def _native_variant_window_iter(
    lib, fasta: IndexedFasta, index, chrom: Optional[str], padding: int,
    max_variants: int, blocks: bool = False,
) -> Iterator:
    """The native-builder equivalent of the Python iterator below: same
    contig advancement, same error on a VCF chromosome missing from the
    reference (in contig order).  With ``blocks`` yields
    :class:`_WindowBlock`s instead of windows."""
    contig_names = [chrom] if chrom is not None else fasta.names
    contig_iter = iter(contig_names)
    cur_name = next(contig_iter)
    cur_bases = upper_bytes(fasta.get_bases(cur_name))

    if chrom is not None:
        vchroms = [chrom] if chrom in index._starts else []
    else:
        vchroms = index.chroms
    for vchrom in vchroms:
        if not len(index._starts.get(vchrom, ())):
            continue
        while vchrom != cur_name:
            try:
                cur_name = next(contig_iter)
            except StopIteration:
                raise ValueError(
                    f"VCF chromosome {vchrom!r} not found in the "
                    "reference (in contig order) — do the VCF and FASTA "
                    "use the same naming (e.g. both 'chr1')?  PrepareVcf "
                    "--add-chr-prefix normalizes gnomAD-style names."
                ) from None
            cur_bases = upper_bytes(fasta.get_bases(cur_name))
        gen = _native_chrom_blocks if blocks else _native_chrom_windows
        yield from gen(
            lib, index, vchrom, cur_bases, padding, max_variants
        )


def variant_window_iterator(
    fasta: IndexedFasta,
    vcf,  # str | Path | VcfIndex
    chrom: Optional[str],
    padding: int,
    max_variants: int,
    blocks: bool = False,
) -> Iterator:
    """Stream VariantWindows from a VCF (SearchReference.scala:217-256).

    ``vcf`` may be a path (streamed/parsed on the fly) or a prebuilt
    :class:`~calitas_tpu_torch.io.vcf.VcfIndex` — the tool builds the index once
    per run so multi-guide and per-contig-checkpoint passes never re-parse
    the file (the reference's per-chromosome indexed query,
    SearchReference.scala:227-231).

    Given a VcfIndex whose records are position-sorted per chromosome
    (every PrepareVcf'd file), construction runs in the native builder
    (native/variants.cpp — bit-identical windows, fuzz-pinned by
    tests/test_native_variants.py); otherwise the pure-Python machinery
    below is used.

    With ``blocks=True`` the native path yields :class:`_WindowBlock`s
    (raw buffers; windows materialize lazily — the screened fast path);
    consumers of a blocks stream must also accept plain windows, which
    the pure-Python fallback still yields."""
    from calitas_tpu_torch.io.vcf import VcfIndex

    reader = vcf if isinstance(vcf, VcfIndex) else VcfReader(vcf)
    if isinstance(reader, VcfIndex):
        from calitas_tpu_torch import native

        lib = native.get_lib()
        relevant = [chrom] if chrom is not None else reader.chroms
        if lib is not None and all(
            reader._sorted.get(c, True) for c in relevant
        ):
            yield from _native_variant_window_iter(
                lib, fasta, reader, chrom, padding, max_variants,
                blocks=blocks,
            )
            return
    # The chunking below (next_chunk proximity grouping, window CIGAR
    # construction) requires position order within each chromosome — the
    # reference gets this from its htsjdk-indexed source.  Our tolerant
    # VcfIndex preserves file order for malformed (unsorted) chroms, so
    # sort those streams here rather than feeding order-dependent code.
    # Stable sort keyed on pos only: a sorted stream passes through in
    # exactly file order (same-pos ties keep their original order, which
    # the allele-combination output order depends on).
    def _chrom_sorted(it, sorted_flags, c):
        if sorted_flags.get(c, True):
            return it
        return iter(sorted(it, key=lambda v: v.pos))

    if chrom is not None:
        contig_names = [chrom]
        it = reader.query(chrom, 1, 2**31 - 1)
        if isinstance(reader, VcfIndex):
            it = _chrom_sorted(it, reader._sorted, chrom)
        vcf_iter = _Peekable(it)
    else:
        contig_names = fasta.names
        if isinstance(reader, VcfIndex):
            def _all_chroms(idx=reader):
                for c in idx.chroms:
                    yield from _chrom_sorted(
                        idx.query(c, 1, 2**31 - 1), idx._sorted, c
                    )

            vcf_iter = _Peekable(_all_chroms())
        else:
            # Streaming reader of unknown sortedness: buffer one
            # chromosome at a time and stable-sort by position (a no-op
            # pass-through for well-formed sorted VCFs).
            def _stream_sorted(r=reader):
                buf: list = []
                for v in r:
                    if buf and v.chrom != buf[-1].chrom:
                        yield from sorted(buf, key=lambda x: x.pos)
                        buf = []
                    buf.append(v)
                yield from sorted(buf, key=lambda x: x.pos)

            vcf_iter = _Peekable(_stream_sorted())

    contig_iter = iter(contig_names)
    cur_name = next(contig_iter)
    cur_bases = upper_bytes(fasta.get_bases(cur_name))

    while vcf_iter.has_next():
        vs = next_chunk(vcf_iter, padding)
        chunks = re_chunk(vs, padding)
        allele_sets = [s for c in chunks for s in allele_combos(c, max_variants)]
        while vs[0].chrom != cur_name:  # advance the reference if needed
            try:
                cur_name = next(contig_iter)
            except StopIteration:
                raise ValueError(
                    f"VCF chromosome {vs[0].chrom!r} not found in the "
                    "reference (in contig order) — do the VCF and FASTA "
                    "use the same naming (e.g. both 'chr1')?  PrepareVcf "
                    "--add-chr-prefix normalizes gnomAD-style names."
                ) from None
            cur_bases = upper_bytes(fasta.get_bases(cur_name))
        for vset in allele_sets:
            yield build_variant_window(vset, cur_name, cur_bases, padding)


def flank_and_absolutize(
    alns: Sequence[GuideAlignment], window: VariantWindow
) -> list[GuideAlignment]:
    """Attach window-derived flanks (insertion-aware) and lift coordinates
    back to the reference frame (SearchReference.scala:596-620)."""
    out = []
    for a in alns:
        b = window.bases
        gso, geo = a.guide_start_offset, a.guide_end_offset
        so, eo = a.start_offset, a.end_offset
        left10 = None if gso < 10 else b[gso - 10 : gso].tobytes().decode("ascii")
        right10 = (
            None
            if window.length - geo < 10
            else b[geo : geo + 10].tobytes().decode("ascii")
        )
        left8 = None if so < 8 else b[so - 8 : so].tobytes().decode("ascii")
        right8 = (
            None
            if window.length - eo < 8
            else b[eo : eo + 8].tobytes().decode("ascii")
        )

        if a.is_positive_strand:
            flanked = a.copy(
                left_of_guide_10bp=left10,
                right_of_guide_10bp=right10,
                left_of_full_aln_8bp=left8,
                right_of_full_aln_8bp=right8,
            )
        else:
            flanked = a.copy(
                left_of_guide_10bp=revcomp(right10) if right10 is not None else None,
                right_of_guide_10bp=revcomp(left10) if left10 is not None else None,
                left_of_full_aln_8bp=revcomp(right8) if right8 is not None else None,
                right_of_full_aln_8bp=revcomp(left8) if left8 is not None else None,
            )

        out.append(
            flanked.copy(
                start_offset=window.ref_offset_at_base_offset(so, preceding=True),
                end_offset=window.ref_offset_at_base_offset(eo, preceding=False),
                guide_start_offset=window.ref_offset_at_base_offset(gso, preceding=True),
                guide_end_offset=window.ref_offset_at_base_offset(geo, preceding=False),
            )
        )
    return out


# ---------------------------------------------------------------------------
# Device screening of variant windows.  The port's own device half: slot
# batches go to ops/genome_screen.py::screen_slots_multi, the multi-guide
# kernel on CUDA or its plain version on the CPU (and on CUDA for guides
# whose DP query is longer than the kernel takes: the route is chosen and
# logged once per guide group).  A device fault degrades: the batch's
# windows are aligned unscreened for every guide (utils.degradable,
# counted in utils.DEGRADED).  torch is imported inside these
# functions: the finish pool's spawned workers import this module to
# unpickle variant windows and must not pay for torch.
# ---------------------------------------------------------------------------

def screened_variant_windows_multi(
    window_iter,
    aligner,
    guide_specs,  # sequence of (key, Guide, min_score)
    *,
    device,
    slot: int = 512,
    batch_slots: int = 8192,
    pipeline_depth: int = 3,
    mesh=None,
):
    """Yield ``(window, flagged_keys)`` pairs: for every variant window,
    the set of guides whose exact device screen says the window can
    contain a hit.

    All guides share one window stream and one mask upload per batch;
    each same-length guide group then costs one multi-guide launch
    (flags thresholded and bit-packed on the device) and one small
    readback.  Up to ``pipeline_depth`` batches stay in flight before the
    oldest is resolved.  Windows longer than ``slot`` pass through
    unscreened, flagged for every guide.  Flags are a superset (zero
    padding only adds candidate end columns), so aligning the flagged
    windows gives the exact output.  Guides longer than
    :data:`~calitas_tpu_torch.ops.dp_cuda.Q_MAX` bases run the plain
    screen on CUDA.  With a ``mesh`` (``parallel/mesh.py``) each batch's
    rows split into one span per mesh entry (``screen_slots_multi``);
    the flags are the one-device screen's.

    A device fault while a batch is screened or read back degrades, as
    the reference's does: every window of that batch is flagged for every
    guide (a superset, so the table does not change), with a WARNING and
    one count in ``utils.DEGRADED["variant_screen"]``.  A kernel that does
    not build, launch or run, and programming errors, propagate."""
    import torch

    from calitas_tpu_torch.core.sequence import TARGET_MASK_TABLE, encode_query
    from calitas_tpu_torch.ops import dp_cuda
    from calitas_tpu_torch.ops import genome_screen
    from calitas_tpu_torch.utils import degradable, note_degraded

    device = torch.device(device)
    # Same-length guide groups: one launch per group per batch.  On CUDA
    # every group with Q <= Q_MAX runs the kernel (the reference's
    # use_pallas flag of the key).
    by_len: dict = {}  # (kernel, Q) -> [keys], [qv2 [2,Q]], [min_score]
    for key, guide, min_score in guide_specs:
        dp_query = guide.guide_rc if guide.pam_is_5prime else guide.guide_fw
        q_len = len(dp_query)
        kernel = device.type == "cuda" and q_len <= dp_cuda.Q_MAX
        ks, qs, ms = by_len.setdefault((kernel, q_len), ([], [], []))
        ks.append(key)
        qs.append(
            np.stack([encode_query(dp_query), encode_query(revcomp(dp_query))])
        )
        ms.append(min_score)
    group_keys = [ks for ks, _, _ in by_len.values()]
    for (_kernel, q_len), (ks, _qs, _ms) in by_len.items():
        dp_cuda.log_route(
            "Variant screen of guides " + ",".join(map(str, ks)), q_len, device
        )
    groups = [
        (np.stack(qs).astype(np.int32), np.asarray(ms, np.int32))
        for ks, qs, ms in by_len.values()
    ]
    unit = genome_screen.slot_batch_unit(any(kernel for kernel, _q in by_len), mesh)

    all_keys = frozenset(k for k, *_ in guide_specs)
    # The batch is a list of segments: (block, row-indices) spans from raw
    # builder blocks, or (window, None) singletons, so filling and flag
    # fan-out run as vectorized NumPy over whole spans.
    batch: list = []  # [(item, bis ndarray | None)]
    batch_count = 0
    pending: list = []  # [(segments, [([keys], resolver), ...] | None)]

    def _degrade(ex):
        if not degradable(ex):
            raise ex
        note_degraded(
            "variant_screen", logging.getLogger("calitas_tpu_torch.SearchReference"),
            "Device variant screen unavailable; aligning this batch's "
            "windows unscreened.",
        )

    def _seg_lengths(item, bis):
        if bis is None:
            return np.asarray([item.length], dtype=np.int64)
        return item._wlen[bis].astype(np.int64)

    def dispatch():
        """Pack the current batch and launch every guide group's screen;
        the device works while the host packs the next batches.  The slot
        width is the smallest power of two (at least 64) covering this
        batch's longest window."""
        nonlocal batch, batch_count
        longest = max(int(_seg_lengths(item, bis).max()) for item, bis in batch)
        slot_b = max(64, 1 << (longest - 1).bit_length())
        # Padding rows are zero and are never read back into the stream.
        B = -(-max(batch_count, batch_slots) // unit) * unit
        tmasks = np.zeros((B, slot_b), dtype=np.uint8)
        flat = tmasks.reshape(-1)
        row = 0
        for item, bis in batch:
            if bis is None:
                m = TARGET_MASK_TABLE[item.bases]
                tmasks[row, : len(m)] = m
                row += 1
                continue
            # Vectorized ragged copy: the block's mask rows are consecutive
            # slices of one buffer; scatter them into the slot grid.
            wl = item._wlen[bis].astype(np.int64)
            off = item._woff[bis].astype(np.int64)
            tot = int(wl.sum())
            ends = np.cumsum(wl)
            within = np.arange(tot, dtype=np.int64) - np.repeat(ends - wl, wl)
            src = np.repeat(off, wl) + within
            dst = np.repeat(
                (row + np.arange(len(bis), dtype=np.int64)) * slot_b, wl
            ) + within
            flat[dst] = item.masks[src]
            row += len(bis)
        try:
            resolvers = genome_screen.screen_slots_multi(
                aligner.scorer, tmasks, groups, device, mesh=mesh
            )
            launched = list(zip(group_keys, resolvers))
        except Exception as ex:
            _degrade(ex)
            launched = None  # every window flagged for every guide
        out = (batch, launched)
        batch = []
        batch_count = 0
        return out

    def _materialize_all(segments):
        for item, bis in segments:
            if bis is None:
                yield item, all_keys
            else:
                for bi in bis.tolist():
                    yield item.window(bi), all_keys

    def resolve(p):
        segments, launched = p
        if launched is None:
            yield from _materialize_all(segments)
            return
        try:
            fls = [(keys, resolver()) for keys, resolver in launched]
        except Exception as ex:
            _degrade(ex)
            yield from _materialize_all(segments)
            return
        # [G_total, B] bool stacked over groups, keys flattened to match
        keys_flat = [k for keys, _fl in fls for k in keys]
        fl = np.concatenate([f for _k, f in fls], axis=0)
        any_fl = fl.any(axis=0)
        row = 0
        for item, bis in segments:
            nrows = 1 if bis is None else len(bis)
            hit_rows = np.nonzero(any_fl[row : row + nrows])[0]
            for r in hit_rows.tolist():
                keys = {k for g, k in enumerate(keys_flat) if fl[g, row + r]}
                w = item if bis is None else item.window(int(bis[r]))
                yield w, keys
            row += nrows

    def flush_full():
        pending.append(dispatch())
        if len(pending) > pipeline_depth:
            return resolve(pending.pop(0))
        return ()

    for it in window_iter:
        if isinstance(it, _WindowBlock):
            wl = it._wlen[: it.n]
            long_idx = np.nonzero(wl > slot)[0]
            for bi in long_idx.tolist():  # rare: align unscreened
                yield it.window(bi), all_keys
            ok = (
                np.arange(it.n, dtype=np.int64)
                if not len(long_idx)
                else np.nonzero(wl <= slot)[0]
            )
            pos = 0
            while pos < len(ok):
                take = min(batch_slots - batch_count, len(ok) - pos)
                batch.append((it, ok[pos : pos + take]))
                batch_count += take
                pos += take
                if batch_count == batch_slots:
                    yield from flush_full()
        else:
            if it.length > slot:
                yield it, all_keys  # too long; align unscreened
                continue
            batch.append((it, None))
            batch_count += 1
            if batch_count == batch_slots:
                yield from flush_full()
    if batch:
        pending.append(dispatch())
    for p in pending:
        yield from resolve(p)


def screened_variant_windows(
    window_iter,
    aligner,
    guide,
    min_score: int,
    *,
    device,
    slot: int = 512,
    batch_slots: int = 8192,
):
    """Single-guide wrapper over :func:`screened_variant_windows_multi`:
    yield only variant windows that can contain a hit for ``guide``."""
    for w, _keys in screened_variant_windows_multi(
        window_iter, aligner, [("g", guide, min_score)],
        device=device, slot=slot, batch_slots=batch_slots,
    ):
        yield w
