// Native variant-window builder: the haplotype-enumeration hot path.
//
// Mirrors calitas_tpu_torch.search.variants exactly (which in turn mirrors
// SearchReference.scala:217-399): next_chunk / re_chunk clustering,
// allele-combination expansion with the max_variants first-variant
// fallback, and window construction with the window->reference CIGAR.
// Bit-identical output is enforced by the differential fuzz in
// tests/test_native_variants.py.
//
// One call processes a block of raw VCF record lines from one
// chromosome (spans into the VcfIndex blob) and emits packed window
// buffers; a chunk that may extend past the block is left for the next
// call (see consumed_records).
//
// Build: compiled into libcalitas.so together with aligner.cpp.
// ABI: plain C, driven from Python via ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Rec {
  int64_t pos = 0;   // 1-based POS
  int64_t end = 0;   // pos + len(ref) - 1
  const char* ref = nullptr;
  int32_t ref_len = 0;
  // alt allele spans (token "." excluded, like the Python reader)
  std::vector<std::pair<const char*, int32_t>> alts;
  bool ok = false;
};

// Parse POS/REF/ALT out of one raw record line (tab-separated).
bool parse_rec(const char* p, const char* e, Rec* out) {
  // field 0: CHROM
  const char* t = static_cast<const char*>(memchr(p, '\t', e - p));
  if (!t) return false;
  p = t + 1;
  // field 1: POS
  int64_t pos = 0;
  const char* q = p;
  while (q < e && *q != '\t') {
    if (*q < '0' || *q > '9') return false;
    pos = pos * 10 + (*q - '0');
    ++q;
  }
  if (q >= e) return false;
  p = q + 1;
  // field 2: ID (skip)
  t = static_cast<const char*>(memchr(p, '\t', e - p));
  if (!t) return false;
  p = t + 1;
  // field 3: REF
  t = static_cast<const char*>(memchr(p, '\t', e - p));
  if (!t) return false;
  out->ref = p;
  out->ref_len = static_cast<int32_t>(t - p);
  p = t + 1;
  // field 4: ALT (comma-separated; "." tokens dropped)
  t = static_cast<const char*>(memchr(p, '\t', e - p));
  const char* alt_end = t ? t : e;
  const char* a = p;
  // '.' and EMPTY tokens (malformed trailing/leading commas) carry no
  // allele and are dropped, exactly like the tolerant Python reader
  // (io/vcf.py::_parse_record) — the two tiers must emit identical
  // window sets.
  for (;;) {
    const char* c =
        static_cast<const char*>(memchr(a, ',', alt_end - a));
    const char* tok_end = c ? c : alt_end;
    const int64_t tok_len = tok_end - a;
    if (tok_len > 0 && !(tok_len == 1 && *a == '.')) {
      out->alts.emplace_back(a, static_cast<int32_t>(tok_len));
    }
    if (!c) break;
    a = tok_end + 1;
  }
  out->pos = pos;
  out->end = pos + out->ref_len - 1;
  out->ok = true;
  return true;
}

struct Outputs {
  uint8_t* bases;
  int64_t bases_cap;
  int64_t bases_used = 0;
  int64_t* woff;
  int32_t* wlen;
  int64_t* wstart;
  char* cig;
  int64_t cig_cap;
  int64_t cig_used = 0;
  int64_t* cigoff;
  int32_t* ciglen;
  int32_t* voff;
  int32_t* vcnt;
  int32_t* vrec;
  int32_t* valt;
  int32_t win_cap;
  int32_t vpair_cap;
  int32_t n_windows = 0;
  int32_t n_vpairs = 0;
  bool overflow = false;
};

struct CigElem {
  char op;
  int64_t len;
};

// Append with coalescing (core/cigar.py::Cigar.coalesce semantics:
// adjacent same-op elements merge; zero-length elements never emitted
// by this builder).
inline void cig_push(std::vector<CigElem>* c, char op, int64_t len) {
  if (len <= 0) return;
  if (!c->empty() && c->back().op == op) {
    c->back().len += len;
  } else {
    c->push_back({op, len});
  }
}

// One chosen (variant record, alt index>0) pair.
struct Chosen {
  int32_t rec;   // block-relative record index
  int32_t alt;   // 1-based alt index
};

// Build one window for a valid variant set and emit it
// (search/variants.py::build_variant_window).
void emit_window(const std::vector<Rec>& recs,
                 const std::vector<Chosen>& chosen, int32_t rec_base,
                 const uint8_t* ref_bases, int64_t ref_len,
                 int64_t padding, Outputs* o) {
  const Rec& first = recs[chosen.front().rec];
  const Rec& last = recs[chosen.back().rec];
  const int64_t wstart = std::max<int64_t>(1, first.pos - padding);
  const int64_t wend = std::min<int64_t>(ref_len, last.end + padding);
  if (wend < wstart) return;  // degenerate (empty reference slice)

  // Window bases: reference slice, then right-to-left splices
  // (matches the Python bytearray splice order; alleles are
  // position-sorted so indices stay valid).
  std::string bases(reinterpret_cast<const char*>(ref_bases) + (wstart - 1),
                    static_cast<size_t>(wend - wstart + 1));
  for (auto it = chosen.rbegin(); it != chosen.rend(); ++it) {
    const Rec& r = recs[it->rec];
    const auto& alt = r.alts[it->alt - 1];
    int64_t idx = r.pos - wstart;
    if (idx < 0) idx = 0;  // unreachable for sorted input; defensive
    size_t start = std::min<size_t>(static_cast<size_t>(idx), bases.size());
    size_t count = (r.ref_len == alt.second)
                       ? static_cast<size_t>(alt.second)
                       : static_cast<size_t>(r.ref_len);
    count = std::min(count, bases.size() - start);
    bases.replace(start, count, alt.first, alt.second);
  }

  // Window->reference CIGAR (I consumes window bases).
  std::vector<CigElem> cig;
  int64_t ref_pos = wstart;
  int64_t base_off = 0;
  for (const Chosen& ch : chosen) {
    const Rec& r = recs[ch.rec];
    const auto& alt = r.alts[ch.alt - 1];
    const int64_t preceding = r.pos - ref_pos;
    if (preceding > 0) {
      cig_push(&cig, 'M', preceding);
      ref_pos += preceding;
      base_off += preceding;
    }
    const int64_t rlen = r.ref_len, alen = alt.second;
    if (rlen == alen) {
      cig_push(&cig, 'M', rlen);
    } else if (rlen == 1 && alen > 1) {
      cig_push(&cig, 'M', 1);
      cig_push(&cig, 'I', alen - 1);
    } else if (rlen > 1 && alen == 1) {
      cig_push(&cig, 'M', 1);
      cig_push(&cig, 'D', rlen - 1);
    } else {
      cig_push(&cig, 'D', rlen);
      cig_push(&cig, 'I', alen);
    }
    ref_pos += rlen;
    base_off += alen;
  }
  const int64_t tail = static_cast<int64_t>(bases.size()) - base_off;
  if (tail > 0) cig_push(&cig, 'M', tail);

  // Emit.
  if (o->n_windows >= o->win_cap ||
      o->n_vpairs + static_cast<int32_t>(chosen.size()) > o->vpair_cap ||
      o->bases_used + static_cast<int64_t>(bases.size()) > o->bases_cap) {
    o->overflow = true;
    return;
  }
  char cbuf[32];
  int64_t clen = 0;
  std::string cstr;
  cstr.reserve(cig.size() * 8);
  for (const CigElem& ce : cig) {
    clen = snprintf(cbuf, sizeof cbuf, "%lld%c",
                    static_cast<long long>(ce.len), ce.op);
    cstr.append(cbuf, static_cast<size_t>(clen));
  }
  if (o->cig_used + static_cast<int64_t>(cstr.size()) > o->cig_cap) {
    o->overflow = true;
    return;
  }
  const int32_t w = o->n_windows;
  o->woff[w] = o->bases_used;
  o->wlen[w] = static_cast<int32_t>(bases.size());
  o->wstart[w] = wstart;
  memcpy(o->bases + o->bases_used, bases.data(), bases.size());
  o->bases_used += static_cast<int64_t>(bases.size());
  o->cigoff[w] = o->cig_used;
  o->ciglen[w] = static_cast<int32_t>(cstr.size());
  memcpy(o->cig + o->cig_used, cstr.data(), cstr.size());
  o->cig_used += static_cast<int64_t>(cstr.size());
  o->voff[w] = o->n_vpairs;
  o->vcnt[w] = static_cast<int32_t>(chosen.size());
  for (const Chosen& ch : chosen) {
    o->vrec[o->n_vpairs] = rec_base + ch.rec;
    o->valt[o->n_vpairs] = ch.alt;
    ++o->n_vpairs;
  }
  ++o->n_windows;
}

// Expand one re-chunked sub-chunk [lo, hi) into allele combinations and
// emit each valid set's window (search/variants.py::allele_combos).
void expand_subchunk(const std::vector<Rec>& recs, int32_t lo, int32_t hi,
                     int32_t rec_base, const uint8_t* ref_bases,
                     int64_t ref_len, int64_t padding, int32_t max_variants,
                     Outputs* o, int64_t* warn, int32_t warn_cap,
                     int32_t* n_warn) {
  const int32_t n = hi - lo;
  std::vector<Chosen> chosen;
  if (n > max_variants) {
    // Fallback: per-alt sets for the FIRST variant only
    // (SearchReference.scala:352-356), plus a logged warning.
    if (*n_warn < warn_cap) {
      warn[*n_warn * 3 + 0] = n;
      warn[*n_warn * 3 + 1] = recs[lo].pos;
      warn[*n_warn * 3 + 2] = recs[hi - 1].end;
      ++*n_warn;
    }
    const Rec& v = recs[lo];
    for (int32_t a = 1; a <= static_cast<int32_t>(v.alts.size()); ++a) {
      chosen.assign(1, {lo, a});
      emit_window(recs, chosen, rec_base, ref_bases, ref_len, padding, o);
      if (o->overflow) return;
    }
    return;
  }
  // Cartesian product over allele indices, variant 0 most significant
  // (allele_combo_indices ordering); drop ref-only sets; drop sets whose
  // adjacent chosen alleles' reference spans overlap (VariantSet.is_valid).
  int64_t total = 1;
  for (int32_t i = lo; i < hi; ++i) {
    total *= static_cast<int64_t>(recs[i].alts.size()) + 1;
  }
  std::vector<int64_t> group(n);  // index stride of variant i
  {
    int64_t g = total;
    for (int32_t i = 0; i < n; ++i) {
      g /= static_cast<int64_t>(recs[lo + i].alts.size()) + 1;
      group[i] = g;
    }
  }
  for (int64_t idx = 0; idx < total; ++idx) {
    chosen.clear();
    bool valid = true;
    int64_t prev_s = 0, prev_e = 0;
    bool have_prev = false;
    for (int32_t i = 0; i < n; ++i) {
      const int32_t n_all =
          static_cast<int32_t>(recs[lo + i].alts.size()) + 1;
      const int32_t a = static_cast<int32_t>((idx / group[i]) % n_all);
      if (a == 0) continue;
      const Rec& r = recs[lo + i];
      const int64_t s = r.pos, e = r.pos + r.ref_len - 1;
      if (have_prev && s <= prev_e && prev_s <= e) {
        valid = false;
        break;
      }
      prev_s = s;
      prev_e = e;
      have_prev = true;
      chosen.push_back({lo + i, a});
    }
    if (!valid || chosen.empty()) continue;
    emit_window(recs, chosen, rec_base, ref_bases, ref_len, padding, o);
    if (o->overflow) return;
  }
}

}  // namespace

extern "C" {

// Build variant windows for a block of same-chromosome VCF records.
//
// Inputs: raw record lines (spans into blob), the uppercased contig
// bases, padding and max_variants.  is_final_block=1 means no further
// records follow on this chromosome, so the trailing chunk is complete.
//
// Outputs (caller-allocated): packed window bases / cigar strings with
// per-window offsets, 1-based window starts, and per-window
// (record index, alt index) pairs resolving lazily to VariantAllele on
// the Python side.  Warnings: one (n_variants, pos_first, end_last)
// int64 triple per oversized cluster (max_variants fallback).
//
// Returns the number of records consumed (complete chunks only; the
// caller re-presents unconsumed records in the next block), or
//   -1  output capacity exhausted (grow buffers, retry the same block)
//   -2  malformed record line
// On success *n_windows_out / *n_vpairs_out / *n_warn_out are set.
int32_t build_variant_windows(
    const uint8_t* blob, const int64_t* rec_start, const int64_t* rec_end,
    int32_t n_records, int32_t is_final_block, int32_t rec_base,
    const uint8_t* ref_bases, int64_t ref_len, int64_t padding,
    int32_t max_variants,
    uint8_t* out_bases, int64_t bases_cap, int64_t* out_woff,
    int32_t* out_wlen, int64_t* out_wstart, char* out_cig, int64_t cig_cap,
    int64_t* out_cigoff, int32_t* out_ciglen, int32_t* out_voff,
    int32_t* out_vcnt, int32_t* out_vrec, int32_t* out_valt,
    int32_t win_cap, int32_t vpair_cap, int64_t* out_warn, int32_t warn_cap,
    int32_t* n_windows_out, int32_t* n_vpairs_out, int32_t* n_warn_out) {
  std::vector<Rec> recs(n_records);
  for (int32_t i = 0; i < n_records; ++i) {
    const char* p = reinterpret_cast<const char*>(blob) + rec_start[i];
    const char* e = reinterpret_cast<const char*>(blob) + rec_end[i];
    if (!parse_rec(p, e, &recs[i])) return -2;
    // A variant beyond the contig end means the VCF and reference are
    // mismatched builds; fail LOUDLY like the Python oracle instead of
    // silently dropping windows (-3 -> ValueError upstream).
    if (recs[i].pos < 1 || recs[i].end > ref_len) return -(300 + i);
  }

  Outputs o;
  o.bases = out_bases;
  o.bases_cap = bases_cap;
  o.woff = out_woff;
  o.wlen = out_wlen;
  o.wstart = out_wstart;
  o.cig = out_cig;
  o.cig_cap = cig_cap;
  o.cigoff = out_cigoff;
  o.ciglen = out_ciglen;
  o.voff = out_voff;
  o.vcnt = out_vcnt;
  o.vrec = out_vrec;
  o.valt = out_valt;
  o.win_cap = win_cap;
  o.vpair_cap = vpair_cap;

  int32_t n_warn = 0;
  int32_t i = 0;
  int32_t consumed = 0;
  while (i < n_records) {
    // next_chunk: chain records while the next starts within padding of
    // the previous record's end (search/variants.py::next_chunk).
    int32_t j = i + 1;
    while (j < n_records && recs[j].pos <= recs[j - 1].end + padding) ++j;
    if (j == n_records && !is_final_block) {
      // The chunk may extend into the next block; leave it unconsumed.
      break;
    }
    // re_chunk: every tail t yields the sub-chunk of records starting
    // within padding of recs[t].end (search/variants.py::re_chunk).
    for (int32_t t = i; t < j; ++t) {
      int32_t u = t;
      while (u < j && recs[u].pos - recs[t].end <= padding) ++u;
      expand_subchunk(recs, t, u, rec_base, ref_bases, ref_len, padding,
                      max_variants, &o, out_warn, warn_cap, &n_warn);
      if (o.overflow) return -1;
    }
    i = j;
    consumed = j;
  }

  *n_windows_out = o.n_windows;
  *n_vpairs_out = o.n_vpairs;
  *n_warn_out = n_warn;
  return consumed;
}

}  // extern "C"
