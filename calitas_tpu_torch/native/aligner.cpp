// Native glocal-DP aligner: the host-side exact engine.
//
// Implements the same contract as calitas_tpu_torch.align.oracle (glocal DP with
// per-end-column multi-hit traceback, linear gap costs, diag > left > up
// traceback preference) at ~100x NumPy speed.  Used to finish the sparse
// candidate windows flagged by the device screen, and as an independent
// oracle for kernel tests.
//
// Build: g++ -O3 -march=native -shared -fPIC aligner.cpp -o libcalitas.so
// ABI: plain C, driven from Python via ctypes.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <string>
#include <vector>

// Bump on ANY change to an exported function's signature or buffer
// layout (e.g. the round-4 out_meta8 int32->int64 widening).  The
// Python loader checks this at load time so a stale prebuilt .so with a
// newer mtime (copied artifact, rsync -t) cannot silently write
// wrong-strided buffers.
extern "C" int32_t calitas_abi_version() { return 5; }


namespace {

// Two-pass row fill: pass 1 (auto-vectorizable) computes
// max(diag + pair, up + tgap); pass 2 closes over the left-gap chain.
// Identical results to the fused 3-way max.
inline void fill_row(const int32_t* prev, int32_t* row, int32_t* tmp,
                     const uint8_t* tmask, int32_t T, uint8_t q,
                     int32_t match, int32_t mismatch,
                     int32_t qgap, int32_t tgap) {
  for (int32_t j = 1; j <= T; ++j) {
    const int32_t pair = (q & tmask[j - 1]) ? match : mismatch;
    const int32_t a = prev[j - 1] + pair;
    const int32_t b = prev[j] + tgap;
    tmp[j] = a > b ? a : b;
  }
  row[0] = prev[0] + tgap;
  for (int32_t j = 1; j <= T; ++j) {
    const int32_t c = row[j - 1] + qgap;
    row[j] = tmp[j] > c ? tmp[j] : c;
  }
}

}  // namespace

extern "C" {

// Fill the final DP row: out_final[j] = S[Q][j] for j in 0..T.
// Returns the max over j in 1..T.
int32_t dp_final_row(const uint8_t* qmask, int32_t Q,
                     const uint8_t* tmask, int32_t T,
                     int32_t match, int32_t mismatch,
                     int32_t qgap, int32_t tgap,
                     int32_t* out_final) {
  std::vector<int32_t> prev(T + 1), cur(T + 1), tmp(T + 1);
  for (int32_t j = 0; j <= T; ++j) prev[j] = 0;
  for (int32_t i = 1; i <= Q; ++i) {
    fill_row(prev.data(), cur.data(), tmp.data(), tmask, T, qmask[i - 1],
             match, mismatch, qgap, tgap);
    std::swap(prev, cur);
  }
  int32_t best = INT32_MIN;
  for (int32_t j = 0; j <= T; ++j) {
    out_final[j] = prev[j];
    if (j >= 1 && prev[j] > best) best = prev[j];
  }
  return best;
}

// Multi-end alignment: one alignment per end column j (1..T) with
// S[Q][j] >= min_score, ascending j.  For each hit, writes:
//   out_scores[k], out_ends[k] (1-based inclusive), out_starts[k]
//   (1-based), and the cigar as ops into out_ops (one char per aligned
//   column: '=', 'X', 'I', 'D'), with out_ops_len[k] giving its length and
//   ops packed back-to-back starting at out_ops_off[k].
// Returns the number of hits (capped at max_hits; negative = error).
int32_t dp_align_multi(const uint8_t* qmask, int32_t Q,
                       const uint8_t* tmask, int32_t T,
                       int32_t match, int32_t mismatch,
                       int32_t qgap, int32_t tgap,
                       int32_t min_score, int32_t max_hits,
                       int32_t* out_scores, int32_t* out_ends,
                       int32_t* out_starts,
                       char* out_ops, int32_t out_ops_cap,
                       int32_t* out_ops_off, int32_t* out_ops_len) {
  if (Q <= 0 || T <= 0) return 0;
  // Full matrix, row-major (Q+1) x (T+1).
  std::vector<int32_t> S((size_t)(Q + 1) * (T + 1));
  std::vector<int32_t> tmp(T + 1);
  for (int32_t j = 0; j <= T; ++j) S[j] = 0;
  for (int32_t i = 1; i <= Q; ++i) {
    fill_row(&S[(size_t)(i - 1) * (T + 1)], &S[(size_t)i * (T + 1)],
             tmp.data(), tmask, T, qmask[i - 1], match, mismatch, qgap, tgap);
  }

  const int32_t* frow = &S[(size_t)Q * (T + 1)];
  int32_t n = 0;
  int32_t ops_pos = 0;
  std::vector<char> rev_ops;
  rev_ops.reserve(Q + 64);
  for (int32_t end = 1; end <= T; ++end) {
    if (frow[end] < min_score) continue;
    if (n >= max_hits) return -1;  // caller should retry with more space
    // Traceback from (Q, end); preference diag > left(D) > up(I).
    rev_ops.clear();
    int32_t i = Q, j = end;
    while (i > 0) {
      const int32_t s = S[(size_t)i * (T + 1) + j];
      bool moved = false;
      if (j > 0) {
        const bool compat = (qmask[i - 1] & tmask[j - 1]) != 0;
        const int32_t pair = compat ? match : mismatch;
        if (s == S[(size_t)(i - 1) * (T + 1) + (j - 1)] + pair) {
          rev_ops.push_back(compat ? '=' : 'X');
          --i; --j; moved = true;
        } else if (s == S[(size_t)i * (T + 1) + (j - 1)] + qgap) {
          rev_ops.push_back('D');
          --j; moved = true;
        }
      }
      if (!moved) {
        if (s == S[(size_t)(i - 1) * (T + 1) + j] + tgap) {
          rev_ops.push_back('I');
          --i;
        } else {
          return -2;  // traceback inconsistency (should be impossible)
        }
      }
    }
    const int32_t len = (int32_t)rev_ops.size();
    if (ops_pos + len > out_ops_cap) return -1;
    out_scores[n] = frow[end];
    out_ends[n] = end;
    out_starts[n] = j + 1;
    out_ops_off[n] = ops_pos;
    out_ops_len[n] = len;
    for (int32_t k = 0; k < len; ++k) out_ops[ops_pos + k] = rev_ops[len - 1 - k];
    ops_pos += len;
    ++n;
  }
  return n;
}

}  // extern "C"

// ===========================================================================
// Full window finisher: DP + PAM extension + intra-window dedup in native
// code.  Mirrors SequentialGuideAligner.align's phases exactly
// (SequentialGuideAligner.scala:228-322); the Python engine is the oracle
// (differential-fuzzed in tests/test_native.py).
//
// The caller passes the DP query (guide in search orientation) and target
// masks for ONE pass (one strand arrangement); orientation flips and
// GuideAlignment construction stay in Python, applied only to the few
// returned alignments.
// ===========================================================================

namespace {

struct RawAln {
  int32_t tstart;   // 1-based
  int32_t tend;     // 1-based closed, incl. PAM extension
  int32_t score;
  int32_t pam_idx;  // -1 when PAM-less
  std::vector<char> ops;  // per-column ops incl. PAM ('=','X','I','D')
  int32_t gap_bases;      // count of I/D columns (for dedup tie-break)
  int32_t edits;          // mismatches + gaps (post-filter limit)
};

}  // namespace

extern "C" {

// Run one DP pass + extension + per-pass collection.
// pams: concatenated PAM masks; pam_off[k], pam_len[k] for k < n_pams.
// pam_is_lower ignored: PAM scoring always uses pam_* scores (the query
// bases of a PAM are lowercase by construction in the reference).
// Returns number of alignments kept (before cross-pass dedup), or <0 on
// buffer overflow.  Output arrays are per-alignment; ops are packed into
// out_ops with offsets/lengths.
int32_t search_pass(const uint8_t* qmask, int32_t Q,
                    const uint8_t* tmask, int32_t T,
                    const uint8_t* pams, const int32_t* pam_off,
                    const int32_t* pam_len, int32_t n_pams,
                    int32_t match, int32_t mismatch,
                    int32_t qgap, int32_t tgap,
                    int32_t pam_match, int32_t pam_mismatch,
                    int32_t min_score,
                    int32_t max_guide_diffs, int32_t max_pam_mismatches,
                    int32_t max_gap_before_extending, int32_t max_total_diffs,
                    int32_t max_out,
                    int32_t* out_tstart, int32_t* out_tend,
                    int32_t* out_score, int32_t* out_pam_idx,
                    int32_t* out_gap_bases, int32_t* out_edits,
                    char* out_ops, int32_t out_ops_cap,
                    int32_t* out_ops_off, int32_t* out_ops_len) {
  if (Q <= 0 || T <= 0) return 0;
  std::vector<int32_t> S((size_t)(Q + 1) * (T + 1));
  std::vector<int32_t> tmp(T + 1);
  for (int32_t j = 0; j <= T; ++j) S[j] = 0;
  for (int32_t i = 1; i <= Q; ++i) {
    fill_row(&S[(size_t)(i - 1) * (T + 1)], &S[(size_t)i * (T + 1)],
             tmp.data(), tmask, T, qmask[i - 1], match, mismatch, qgap, tgap);
  }

  const int32_t* frow = &S[(size_t)Q * (T + 1)];
  const bool pamless = (n_pams == 0) || (n_pams == 1 && pam_len[0] == 0);

  int32_t n_out = 0;
  int32_t ops_pos = 0;
  std::vector<char> rev_ops;
  rev_ops.reserve(Q + 64);

  for (int32_t end = 1; end <= T; ++end) {
    if (frow[end] < min_score) continue;
    // Traceback (diag > left(D) > up(I)).
    rev_ops.clear();
    int32_t i = Q, j = end;
    while (i > 0) {
      const int32_t s = S[(size_t)i * (T + 1) + j];
      bool moved = false;
      if (j > 0) {
        const bool compat = (qmask[i - 1] & tmask[j - 1]) != 0;
        const int32_t pair = compat ? match : mismatch;
        if (s == S[(size_t)(i - 1) * (T + 1) + (j - 1)] + pair) {
          rev_ops.push_back(compat ? '=' : 'X');
          --i; --j; moved = true;
        } else if (s == S[(size_t)i * (T + 1) + (j - 1)] + qgap) {
          rev_ops.push_back('D');
          --j; moved = true;
        }
      }
      if (!moved) {
        if (s == S[(size_t)(i - 1) * (T + 1) + j] + tgap) {
          rev_ops.push_back('I');
          --i;
        } else {
          return -2;
        }
      }
    }
    const int32_t tstart = j + 1;
    const int32_t glen = (int32_t)rev_ops.size();

    // guide diffs = non-'=' ops (SequentialGuideAligner.scala:441-443)
    int32_t guide_diffs = 0;
    for (char c : rev_ops) if (c != '=') ++guide_diffs;
    if (guide_diffs > max_guide_diffs) continue;

    // guide ops in forward order
    std::vector<char> fw_ops(rev_ops.rbegin(), rev_ops.rend());

    if (pamless) {
      if (n_out >= max_out || ops_pos + glen > out_ops_cap) return -1;
      int32_t gaps = 0, edits = 0;
      for (char c : fw_ops) {
        if (c == 'I' || c == 'D') { ++gaps; ++edits; }
        else if (c == 'X') ++edits;
      }
      out_tstart[n_out] = tstart;
      out_tend[n_out] = end;
      out_score[n_out] = frow[end];
      out_pam_idx[n_out] = -1;
      out_gap_bases[n_out] = gaps;
      out_edits[n_out] = edits;
      out_ops_off[n_out] = ops_pos;
      out_ops_len[n_out] = glen;
      std::memcpy(out_ops + ops_pos, fw_ops.data(), glen);
      ops_pos += glen;
      ++n_out;
      continue;
    }

    // terminal indel reduces the allowed extra gap
    // (SequentialGuideAligner.scala:452-453); count the trailing run.
    int32_t terminal_gap = 0;
    if (!fw_ops.empty() && (fw_ops.back() == 'I' || fw_ops.back() == 'D')) {
      const char t = fw_ops.back();
      for (auto it = fw_ops.rbegin(); it != fw_ops.rend() && *it == t; ++it)
        ++terminal_gap;
    }
    int32_t max_extra_gap = max_gap_before_extending - terminal_gap;
    const int32_t budget = max_total_diffs - guide_diffs;
    if (budget < max_extra_gap) max_extra_gap = budget;

    for (int32_t p = 0; p < n_pams; ++p) {
      const uint8_t* pam = pams + pam_off[p];
      const int32_t plen = pam_len[p];
      int32_t best_offset = -1;
      int32_t best_total = INT32_MIN;
      uint64_t best_mm_mask = 0;  // bit per PAM base (plen <= 63; longer
      // PAMs are gated off the native path in align/batch.py)
      for (int32_t offset = 0; offset <= max_extra_gap; ++offset) {
        const int32_t t_off = end + offset;  // 0-based offset after aln
        int32_t limit = max_total_diffs - guide_diffs - offset;
        if (limit > max_pam_mismatches) limit = max_pam_mismatches;
        if (t_off + plen > T || limit < 0) continue;
        int32_t score = 0, n_mm = 0;
        uint64_t mm_mask = 0;
        for (int32_t k = 0; k < plen; ++k) {
          // PAM scoring: target N (mask 0) always mismatches; otherwise
          // IUPAC-compatible -> pam_match.  A base is '=' iff its addend
          // is positive (SequentialGuideAligner.scala:468), which differs
          // from compatibility only for degenerate scoring configs.
          const bool ok = (pam[k] & tmask[t_off + k]) != 0;
          const int32_t addend = ok ? pam_match : pam_mismatch;
          score += addend;
          if (addend <= 0) { ++n_mm; mm_mask |= (1ull << k); }
        }
        if (n_mm > limit) continue;
        const int32_t total = score + offset * qgap;
        if (total > best_total) {  // earliest offset wins ties
          best_total = total;
          best_offset = offset;
          best_mm_mask = mm_mask;
        }
      }
      if (best_offset < 0) continue;
      const int32_t full_len = glen + best_offset + plen;
      if (n_out >= max_out || ops_pos + full_len > out_ops_cap) return -1;
      char* dst = out_ops + ops_pos;
      std::memcpy(dst, fw_ops.data(), glen);
      for (int32_t k = 0; k < best_offset; ++k) dst[glen + k] = 'D';
      for (int32_t k = 0; k < plen; ++k)
        dst[glen + best_offset + k] = (best_mm_mask & (1ull << k)) ? 'X' : '=';
      int32_t gaps = 0, edits = 0;
      for (int32_t k = 0; k < full_len; ++k) {
        const char c = dst[k];
        if (c == 'I' || c == 'D') { ++gaps; ++edits; }
        else if (c == 'X') ++edits;
      }
      out_tstart[n_out] = tstart;
      out_tend[n_out] = end + best_offset + plen;
      out_score[n_out] = frow[end] + best_total;
      out_pam_idx[n_out] = p;
      out_gap_bases[n_out] = gaps;
      out_edits[n_out] = edits;
      out_ops_off[n_out] = ops_pos;
      out_ops_len[n_out] = full_len;
      ops_pos += full_len;
      ++n_out;
    }
  }
  return n_out;
}

}  // extern "C"

// ===========================================================================
// Batched window finisher: DP + PAM extension + intra-window dedup + full
// GuideAlignment rendering (padded strings, counters, coordinates) for a
// whole batch of candidate windows in ONE native call.
//
// Semantics are the engine's, phase for phase
// (SequentialGuideAligner.scala:228-322 via calitas_tpu_torch.align.engine, which
// is the differential oracle in tests/test_batch_finish.py):
//   - cpp pass 0 aligns the DP query against the window in forward order,
//     pass 1 against its reverse complement;
//   - engine pass order (fwd strand pass first) maps to cpp passes via
//     is5prime: engine-fwd == cpp pass (is5prime ? 1 : 0);
//   - per-pass stable sort (score desc, fewer gap bases) + greedy overlap
//     dedup (> max_overlap excluded) + edits <= max_total_diffs post-filter
//     (dedup never crosses strands: each pass is one strand);
//   - rendering mirrors Alignment.padded_strings + GuideAlignment.create +
//     the engine's 5'-PAM / reverse-pass flips, with the counter
//     attribution quirks of GuideAlignment._count.
// ===========================================================================

namespace {

struct IupacTables {
  uint8_t mask[256];         // case-insensitive IUPAC mask; unknown -> 0
  uint8_t target_mask[256];  // like mask but N/n -> 0 (target-N rule)
  uint8_t comp[256];         // complement, case preserved; unknown -> self
  IupacTables() {
    std::memset(mask, 0, sizeof(mask));
    std::memset(target_mask, 0, sizeof(target_mask));
    for (int i = 0; i < 256; ++i) comp[i] = (uint8_t)i;
    struct Code { char c; uint8_t m; };
    const Code codes[] = {
        {'A', 1},  {'C', 2},  {'G', 4},  {'T', 8},  {'U', 8},
        {'R', 5},  {'Y', 10}, {'S', 6},  {'W', 9},  {'K', 12},
        {'M', 3},  {'B', 14}, {'D', 13}, {'H', 11}, {'V', 7},
        {'N', 15}};
    for (const Code& cd : codes) {
      mask[(int)cd.c] = cd.m;
      mask[(int)std::tolower(cd.c)] = cd.m;
      const uint8_t tm = (cd.c == 'N') ? 0 : cd.m;
      target_mask[(int)cd.c] = tm;
      target_mask[(int)std::tolower(cd.c)] = tm;
    }
    const char* fr = "ATCGURYSWKMBVDHN";
    const char* to = "TAGCAYRSWMKVBHDN";
    for (int i = 0; fr[i]; ++i) {
      comp[(int)fr[i]] = (uint8_t)to[i];
      comp[(int)std::tolower(fr[i])] = (uint8_t)std::tolower(to[i]);
    }
  }
};

const IupacTables TBL;

struct FinAln {
  int32_t s0, e0;  // pass-local 0-based open target span (incl. PAM)
  int32_t score;
  int32_t pam_idx;     // -1 when PAM-less
  int32_t gap_bases;   // I/D columns (dedup tie-break)
  int32_t edits;       // X + I/D columns (max_total_diffs post-filter)
  std::string ops;     // per-column ops incl. PAM: '=','X','I','D'
};

// One DP pass + traceback + PAM extension over end columns
// [end_lo, end_hi] (1-based inclusive; pass end_lo <= 0 for the full
// range).  The DP itself runs on the column slice
// [max(1, end_lo - span_max), end_hi]; containment of every
// above-min_score path in that slice makes the sliced DP values, the
// qualifying-end set, and the tracebacks identical to the full DP (see
// docs/ARCHITECTURE.md "slice DP exactness").
int run_pass_collect(const uint8_t* qmask, int32_t Q, const uint8_t* tmask,
                     int32_t T, const uint8_t* pam_masks,
                     const int32_t* pam_off, const int32_t* pam_len,
                     int32_t n_pams, int32_t match, int32_t mismatch,
                     int32_t qgap, int32_t tgap, int32_t pam_match,
                     int32_t pam_mismatch, int32_t min_score,
                     int32_t max_guide_diffs, int32_t max_pam_mismatches,
                     int32_t max_gap_before_extending,
                     int32_t extension_total_diffs, int32_t end_lo,
                     int32_t end_hi, std::vector<int32_t>& S,
                     std::vector<int32_t>& tmp, std::vector<FinAln>& out) {
  if (Q <= 0 || T <= 0) return 0;
  if (end_lo <= 0) { end_lo = 1; end_hi = T; }
  if (end_hi > T) end_hi = T;
  if (end_lo > end_hi) return 0;
  // span_max: an above-threshold path consumes at most Q + D_max target
  // columns, D_max = floor((match*Q - min_score) / |qgap|).
  int64_t surplus = (int64_t)match * Q - min_score;
  int32_t d_max = surplus > 0 && qgap < 0 ? (int32_t)(surplus / -(int64_t)qgap)
                                          : (surplus > 0 ? T : 0);
  int32_t dp_from = end_lo - (Q + d_max);
  if (dp_from < 1) dp_from = 1;
  const uint8_t* tsub = tmask + (dp_from - 1);
  const int32_t Tsub = end_hi - dp_from + 1;

  S.assign((size_t)(Q + 1) * (Tsub + 1), 0);
  tmp.resize(Tsub + 1);
  for (int32_t i = 1; i <= Q; ++i) {
    fill_row(&S[(size_t)(i - 1) * (Tsub + 1)], &S[(size_t)i * (Tsub + 1)],
             tmp.data(), tsub, Tsub, qmask[i - 1], match, mismatch, qgap,
             tgap);
  }
  const int32_t* frow = &S[(size_t)Q * (Tsub + 1)];
  const bool pamless = (n_pams == 0) || (n_pams == 1 && pam_len[0] == 0);

  std::vector<char> rev_ops;
  rev_ops.reserve(Q + 64);
  for (int32_t le = end_lo - dp_from + 1; le <= Tsub; ++le) {
    if (frow[le] < min_score) continue;
    rev_ops.clear();
    int32_t i = Q, j = le;
    while (i > 0) {
      const int32_t s = S[(size_t)i * (Tsub + 1) + j];
      bool moved = false;
      if (j > 0) {
        const bool compat = (qmask[i - 1] & tsub[j - 1]) != 0;
        const int32_t pair = compat ? match : mismatch;
        if (s == S[(size_t)(i - 1) * (Tsub + 1) + (j - 1)] + pair) {
          rev_ops.push_back(compat ? '=' : 'X');
          --i; --j; moved = true;
        } else if (s == S[(size_t)i * (Tsub + 1) + (j - 1)] + qgap) {
          rev_ops.push_back('D');
          --j; moved = true;
        }
      }
      if (!moved) {
        if (s == S[(size_t)(i - 1) * (Tsub + 1) + j] + tgap) {
          rev_ops.push_back('I');
          --i;
        } else {
          return -2;
        }
      }
    }
    const int32_t end = le + dp_from - 1;       // absolute 1-based end
    const int32_t tstart = (j + dp_from - 1) + 1;  // absolute 1-based
    int32_t guide_diffs = 0;
    for (char c : rev_ops) if (c != '=') ++guide_diffs;
    if (guide_diffs > max_guide_diffs) continue;
    std::string fw_ops(rev_ops.rbegin(), rev_ops.rend());

    if (pamless) {
      FinAln a;
      a.s0 = tstart - 1; a.e0 = end;
      a.score = frow[le];
      a.pam_idx = -1;
      a.gap_bases = 0; a.edits = 0;
      for (char c : fw_ops) {
        if (c == 'I' || c == 'D') { ++a.gap_bases; ++a.edits; }
        else if (c == 'X') ++a.edits;
      }
      a.ops = std::move(fw_ops);
      out.push_back(std::move(a));
      continue;
    }

    int32_t terminal_gap = 0;
    if (!fw_ops.empty() && (fw_ops.back() == 'I' || fw_ops.back() == 'D')) {
      const char t = fw_ops.back();
      for (auto it = fw_ops.rbegin(); it != fw_ops.rend() && *it == t; ++it)
        ++terminal_gap;
    }
    int32_t max_extra_gap = max_gap_before_extending - terminal_gap;
    const int32_t budget = extension_total_diffs - guide_diffs;
    if (budget < max_extra_gap) max_extra_gap = budget;

    for (int32_t p = 0; p < n_pams; ++p) {
      const uint8_t* pam = pam_masks + pam_off[p];
      const int32_t plen = pam_len[p];
      int32_t best_offset = -1;
      int32_t best_total = INT32_MIN;
      uint64_t best_mm_mask = 0;
      for (int32_t offset = 0; offset <= max_extra_gap; ++offset) {
        const int32_t t_off = end + offset;
        int32_t limit = extension_total_diffs - guide_diffs - offset;
        if (limit > max_pam_mismatches) limit = max_pam_mismatches;
        if (t_off + plen > T || limit < 0) continue;
        int32_t score = 0, n_mm = 0;
        uint64_t mm_mask = 0;
        for (int32_t k = 0; k < plen; ++k) {
          const bool ok = (pam[k] & tmask[t_off + k]) != 0;
          const int32_t addend = ok ? pam_match : pam_mismatch;
          score += addend;
          if (addend <= 0) { ++n_mm; mm_mask |= (1ull << k); }
        }
        if (n_mm > limit) continue;
        const int32_t total = score + offset * qgap;
        if (total > best_total) {  // earliest offset wins ties
          best_total = total;
          best_offset = offset;
          best_mm_mask = mm_mask;
        }
      }
      if (best_offset < 0) continue;
      FinAln a;
      a.s0 = tstart - 1;
      a.e0 = end + best_offset + plen;
      a.score = frow[le] + best_total;
      a.pam_idx = p;
      a.ops = fw_ops;
      a.ops.append(best_offset, 'D');
      for (int32_t k = 0; k < plen; ++k)
        a.ops.push_back((best_mm_mask & (1ull << k)) ? 'X' : '=');
      a.gap_bases = 0; a.edits = 0;
      for (char c : a.ops) {
        if (c == 'I' || c == 'D') { ++a.gap_bases; ++a.edits; }
        else if (c == 'X') ++a.edits;
      }
      out.push_back(std::move(a));
    }
  }
  return 0;
}

inline char prev_non_dash(const std::string& s, int i) {
  while (i > 0 && s[i] == '-') --i;
  return s[i];
}
inline char next_non_dash(const std::string& s, int i) {
  const int n = (int)s.size();
  while (i < n - 1 && s[i] == '-') ++i;
  return s[i];
}
inline bool is_lower(char c) { return c >= 'a' && c <= 'z'; }
inline bool is_alpha_c(char c) {
  return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
}

// GuideAlignment._count (GuideAlignment.scala:139-163): attribute '.' and
// '~' columns to guide vs PAM by the case of the (neighboring) guide chars.
int count_attr(const std::string& pg, const std::string& pa, bool lower,
               bool both_sides, bool mms, bool gaps) {
  int n = 0;
  const int len = (int)pa.size();
  for (int i = 0; i < len; ++i) {
    const char ac = pa[i];
    const char gc = pg[i];
    if (mms && ac == '.' && is_lower(gc) == lower) {
      ++n;
    } else if (gaps && ac == '~') {
      if (gc != '-' && is_lower(gc) == lower) {
        ++n;
      } else {
        const char prev = prev_non_dash(pg, i);
        const char nxt = next_non_dash(pg, i);
        bool ok;
        if (both_sides) {
          ok = (prev == '-' || is_lower(prev) == lower) &&
               (nxt == '-' || is_lower(nxt) == lower);
        } else {
          ok = (is_alpha_c(prev) && is_lower(prev) == lower) ||
               (is_alpha_c(nxt) && is_lower(nxt) == lower);
        }
        if (ok) ++n;
      }
    }
  }
  return n;
}

// One fully-rendered alignment: strings + coordinates + counters, shared
// by the buffer-emitting and line-emitting finishers.
struct RenderOut {
  std::string pg, pa, pt, ut, cig;
  int32_t s0, e0, gs, ge;
  int32_t mism, gapb, gmm, ggap, pmm, pgap;
};

// Render one kept alignment into ``r`` (mirrors Alignment.padded_strings +
// GuideAlignment.create + the engine's 5'-PAM / reverse-pass flips with
// the counter attribution quirks of GuideAlignment._count).
// Returns 0, or -2 on internal inconsistency.
int render_core(const FinAln& a, bool coord_flip, bool string_flip,
                const uint8_t* qletters, int32_t Q,
                const uint8_t* pam_letters, const int32_t* pam_off,
                const int32_t* pam_len, const uint8_t* tb, int32_t T,
                RenderOut& r) {
  std::string& pg = r.pg;
  std::string& pa = r.pa;
  std::string& pt = r.pt;
  std::string& ut = r.ut;
  // ---- render padded strings in the pass-local frame -------------
  pg.clear(); pa.clear(); pt.clear();
  int32_t qi = 0, ti = a.s0;
  const uint8_t* pamL =
      a.pam_idx >= 0 ? pam_letters + pam_off[a.pam_idx] : nullptr;
  const int32_t qfull_len = Q + (a.pam_idx >= 0 ? pam_len[a.pam_idx] : 0);
  for (char op : a.ops) {
    if (op == '=' || op == 'X') {
      if (qi >= qfull_len) return -2;
      pg.push_back(qi < Q ? (char)qletters[qi] : (char)pamL[qi - Q]);
      pa.push_back(op == '=' ? '|' : '.');
      pt.push_back((char)tb[ti]);
      ++qi; ++ti;
    } else if (op == 'I') {
      if (qi >= qfull_len) return -2;
      pg.push_back(qi < Q ? (char)qletters[qi] : (char)pamL[qi - Q]);
      pa.push_back('~');
      pt.push_back('-');
      ++qi;
    } else {  // 'D'
      pg.push_back('-');
      pa.push_back('~');
      pt.push_back((char)tb[ti]);
      ++ti;
    }
  }
  // ---- guide-only coordinates (GuideAlignment.create, pre-flip) --
  int first_up = -1, last_up = -1;
  for (int i2 = 0; i2 < (int)pg.size(); ++i2) {
    const char c = pg[i2];
    if (c >= 'A' && c <= 'Z') {
      if (first_up < 0) first_up = i2;
      last_up = i2;
    }
  }
  if (first_up < 0) return -2;
  int left_delta = 0, right_delta = 0;
  for (int i2 = 0; i2 < first_up; ++i2)
    if (is_alpha_c(pt[i2])) ++left_delta;
  for (int i2 = last_up + 1; i2 < (int)pt.size(); ++i2)
    if (is_alpha_c(pt[i2])) ++right_delta;
  int32_t s0 = a.s0, e0 = a.e0;
  int32_t gs = s0 + left_delta, ge = e0 - right_delta;
  if (coord_flip) {
    const int32_t ns = T - e0, ne = T - s0;
    const int32_t ngs = T - ge, nge = T - gs;
    s0 = ns; e0 = ne; gs = ngs; ge = nge;
  }
  r.s0 = s0; r.e0 = e0; r.gs = gs; r.ge = ge;
  // ---- string flips (5'-PAM kinds) -------------------------------
  std::string cig_ops = a.ops;
  if (string_flip) {
    std::reverse(pg.begin(), pg.end());
    std::reverse(pa.begin(), pa.end());
    std::reverse(pt.begin(), pt.end());
    for (char& c : pg) if (c != '-') c = (char)TBL.comp[(uint8_t)c];
    for (char& c : pt) if (c != '-') c = (char)TBL.comp[(uint8_t)c];
    std::reverse(cig_ops.begin(), cig_ops.end());
  }
  // ---- unpadded target under the uppercase guide span ------------
  int fu = -1, lu = -1;
  for (int i2 = 0; i2 < (int)pg.size(); ++i2) {
    const char c = pg[i2];
    if (c >= 'A' && c <= 'Z') {
      if (fu < 0) fu = i2;
      lu = i2;
    }
  }
  ut.clear();
  for (int i2 = fu; i2 <= lu; ++i2)
    if (is_alpha_c(pt[i2])) ut.push_back(pt[i2]);
  // ---- counters on the final strings -----------------------------
  r.mism = 0; r.gapb = 0;
  for (char c : pa) {
    if (c == '.') ++r.mism;
    else if (c == '~') ++r.gapb;
  }
  r.gmm = count_attr(pg, pa, false, false, true, false);
  r.ggap = count_attr(pg, pa, false, false, false, true);
  r.pmm = count_attr(pg, pa, true, true, true, false);
  r.pgap = count_attr(pg, pa, true, true, false, true);
  // ---- cigar string (run-length encode; coalesced by nature) -----
  char cigbuf[64];
  r.cig.clear();
  for (size_t i2 = 0; i2 < cig_ops.size();) {
    size_t j2 = i2;
    while (j2 < cig_ops.size() && cig_ops[j2] == cig_ops[i2]) ++j2;
    const int nn = std::snprintf(cigbuf, sizeof(cigbuf), "%d%c",
                                 (int)(j2 - i2), cig_ops[i2]);
    r.cig.append(cigbuf, nn);
    i2 = j2;
  }
  return 0;
}

// The shared batched-finish skeleton: per window, per engine pass, run
// the (range-sliced) DP pass + PAM extension, intra-pass dedup, render,
// and hand each kept alignment to ``emit(w, ep_strand, kind_code, a, r)``
// (emit returns 0 ok / -1 output full).  Returns kept count or <0.
template <typename Emit>
int32_t finish_windows_core(
    const uint8_t* qletters, int32_t Q, const uint8_t* pam_letters,
    const int32_t* pam_off, const int32_t* pam_len, int32_t n_pams,
    int32_t is5prime, int32_t match, int32_t mismatch, int32_t qgap,
    int32_t tgap, int32_t pam_match, int32_t pam_mismatch, int32_t min_score,
    int32_t max_guide_diffs, int32_t max_pam_mismatches,
    int32_t max_gap_before_extending, int32_t extension_total_diffs,
    int32_t max_total_diffs, int32_t max_overlap, const uint8_t* wbytes,
    const int64_t* woff, const int32_t* wlen, const uint8_t* pass_mask,
    const int32_t* ranges, int32_t n_windows, Emit&& emit) {
  // Guide-constant masks.
  std::vector<uint8_t> qmask(Q);
  for (int32_t i = 0; i < Q; ++i) qmask[i] = TBL.mask[qletters[i]];
  int32_t pam_total = 0;
  for (int32_t p = 0; p < n_pams; ++p) pam_total += pam_len[p];
  std::vector<uint8_t> pmask(std::max(pam_total, 1));
  for (int32_t p = 0; p < n_pams; ++p)
    for (int32_t k = 0; k < pam_len[p]; ++k)
      pmask[pam_off[p] + k] = TBL.mask[pam_letters[pam_off[p] + k]];

  std::vector<int32_t> S;
  std::vector<int32_t> dptmp;
  std::vector<uint8_t> tmask_fwd, tbytes_rc, tmask_rc;
  std::vector<FinAln> alns;
  std::vector<int> order, kept;
  RenderOut r;

  int32_t n_out = 0;

  for (int32_t w = 0; w < n_windows; ++w) {
    const uint8_t* wb = wbytes + woff[w];
    const int32_t T = wlen[w];
    if (T <= 0) continue;
    const uint8_t pm = pass_mask[w];
    if (!pm) continue;
    tmask_fwd.resize(T);
    for (int32_t j = 0; j < T; ++j) tmask_fwd[j] = TBL.target_mask[wb[j]];
    bool have_rc = false;

    // Engine pass order: fwd strand pass first; engine-fwd is cpp pass
    // (is5prime ? 1 : 0).
    for (int ep = 0; ep < 2; ++ep) {
      const int cpp_pass = is5prime ? 1 - ep : ep;
      if (!(pm & (1u << cpp_pass))) continue;
      const uint8_t* tm;
      const uint8_t* tb;
      if (cpp_pass == 0) {
        tm = tmask_fwd.data();
        tb = wb;
      } else {
        if (!have_rc) {
          tbytes_rc.resize(T);
          tmask_rc.resize(T);
          for (int32_t j = 0; j < T; ++j) {
            const uint8_t c = TBL.comp[wb[T - 1 - j]];
            tbytes_rc[j] = c;
            tmask_rc[j] = TBL.target_mask[c];
          }
          have_rc = true;
        }
        tm = tmask_rc.data();
        tb = tbytes_rc.data();
      }
      int32_t end_lo = ranges ? ranges[(int64_t)w * 4 + 2 * cpp_pass] : 0;
      int32_t end_hi = ranges ? ranges[(int64_t)w * 4 + 2 * cpp_pass + 1] : 0;
      alns.clear();
      const int rc = run_pass_collect(
          qmask.data(), Q, tm, T, pmask.data(), pam_off, pam_len, n_pams,
          match, mismatch, qgap, tgap, pam_match, pam_mismatch, min_score,
          max_guide_diffs, max_pam_mismatches, max_gap_before_extending,
          extension_total_diffs, end_lo, end_hi, S, dptmp, alns);
      if (rc < 0) return rc;
      if (alns.empty()) continue;

      // Intra-pass dedup: stable (score desc, fewer gaps); greedy keep with
      // edits <= max_total_diffs and overlap(kept) <= max_overlap.
      order.resize(alns.size());
      std::iota(order.begin(), order.end(), 0);
      std::stable_sort(order.begin(), order.end(), [&](int a, int b) {
        if (alns[a].score != alns[b].score) return alns[a].score > alns[b].score;
        return alns[a].gap_bases < alns[b].gap_bases;
      });
      kept.clear();
      for (int idx : order) {
        const FinAln& ra = alns[idx];
        if (ra.edits > max_total_diffs) continue;
        bool clash = false;
        for (int kidx : kept) {
          const FinAln& k = alns[kidx];
          const int32_t o = std::min(k.e0, ra.e0) - std::max(k.s0, ra.s0);
          if (o > max_overlap) { clash = true; break; }
        }
        if (!clash) kept.push_back(idx);
      }

      const bool coord_flip = (cpp_pass == 1);
      const bool string_flip = (is5prime != 0);
      // kind encoding: 0=3fwd(pass0) 1=3rev(pass1) 2=5fwd(pass1) 3=5rev(pass0)
      const int32_t kind_code =
          is5prime ? (cpp_pass == 1 ? 2 : 3) : (cpp_pass == 1 ? 1 : 0);

      for (int idx : kept) {
        const FinAln& a = alns[idx];
        const int rr = render_core(a, coord_flip, string_flip, qletters, Q,
                                   pam_letters, pam_off, pam_len, tb, T, r);
        if (rr < 0) return rr;
        const int ee = emit(w, ep == 0 ? 0 : 1, kind_code, a, r);
        if (ee < 0) return ee;
        ++n_out;
      }
    }
  }
  return n_out;
}

}  // namespace

extern "C" {

// Batched finisher.  Inputs: the DP-orientation query LETTERS (uppercase
// guide; masks derived internally), PAM letters (lowercase), window BYTES
// (uppercased by the caller's window materialization), per-window pass
// mask (bit0: cpp pass 0 / forward target order, bit1: cpp pass 1 /
// revcomp), and optional per-window per-pass end-column ranges
// (ranges[w*4 + 2*pass + {0,1}] = lo,hi 1-based inclusive; lo <= 0 means
// full).  Output: per kept alignment,
//   out_meta[k*16 ...] = {widx, strand(0='+'), pam_idx, score, s0, e0,
//     gs, ge, mismatches, gap_bases, guide_mm, guide_gaps, pam_mm,
//     pam_gaps, kind(0=3fwd,1=3rev,2=5fwd,3=5rev), 0}
//   (coords are window-local 0-based open; caller adds the genomic
//    offset), the three padded strings + unpadded target packed into
// out_str at out_str_off[k] as [pg|pa|pt] (each out_plen[k] chars) then
// [unpadded target] (out_ulen[k] chars), and the cigar string in out_cig.
// Returns kept count; -1 = an output buffer is full (retry with bigger
// buffers); -2 = internal error.
int32_t finish_batch(
    const uint8_t* qletters, int32_t Q, const uint8_t* pam_letters,
    const int32_t* pam_off, const int32_t* pam_len, int32_t n_pams,
    int32_t is5prime, int32_t match, int32_t mismatch, int32_t qgap,
    int32_t tgap, int32_t pam_match, int32_t pam_mismatch, int32_t min_score,
    int32_t max_guide_diffs, int32_t max_pam_mismatches,
    int32_t max_gap_before_extending, int32_t extension_total_diffs,
    int32_t max_total_diffs, int32_t max_overlap, const uint8_t* wbytes,
    const int64_t* woff, const int32_t* wlen, const uint8_t* pass_mask,
    const int32_t* ranges, int32_t n_windows, int32_t max_out,
    int32_t* out_meta, char* out_str, int64_t out_str_cap,
    int64_t* out_str_off, int32_t* out_plen, int32_t* out_ulen,
    char* out_cig, int64_t out_cig_cap, int64_t* out_cig_off,
    int32_t* out_cig_len) {
  int32_t n_out = 0;
  int64_t str_pos = 0, cig_pos = 0;
  auto emit = [&](int32_t w, int32_t strandc, int32_t kind_code,
                  const FinAln& a, const RenderOut& r) -> int {
    const int32_t plen2 = (int32_t)r.pg.size();
    const int64_t need_str = 3 * (int64_t)plen2 + (int64_t)r.ut.size();
    if (n_out >= max_out || str_pos + need_str > out_str_cap ||
        cig_pos + (int64_t)r.cig.size() > out_cig_cap)
      return -1;
    int32_t* m = out_meta + (int64_t)n_out * 16;
    m[0] = w;
    m[1] = strandc;  // 0='+', 1='-'
    m[2] = a.pam_idx;
    m[3] = a.score;
    m[4] = r.s0; m[5] = r.e0; m[6] = r.gs; m[7] = r.ge;
    m[8] = r.mism; m[9] = r.gapb; m[10] = r.gmm; m[11] = r.ggap;
    m[12] = r.pmm; m[13] = r.pgap;
    m[14] = kind_code;
    m[15] = 0;
    out_str_off[n_out] = str_pos;
    out_plen[n_out] = plen2;
    out_ulen[n_out] = (int32_t)r.ut.size();
    std::memcpy(out_str + str_pos, r.pg.data(), plen2);
    std::memcpy(out_str + str_pos + plen2, r.pa.data(), plen2);
    std::memcpy(out_str + str_pos + 2 * (int64_t)plen2, r.pt.data(), plen2);
    std::memcpy(out_str + str_pos + 3 * (int64_t)plen2, r.ut.data(),
                r.ut.size());
    str_pos += need_str;
    out_cig_off[n_out] = cig_pos;
    out_cig_len[n_out] = (int32_t)r.cig.size();
    std::memcpy(out_cig + cig_pos, r.cig.data(), r.cig.size());
    cig_pos += (int64_t)r.cig.size();
    ++n_out;
    return 0;
  };
  return finish_windows_core(
      qletters, Q, pam_letters, pam_off, pam_len, n_pams, is5prime, match,
      mismatch, qgap, tgap, pam_match, pam_mismatch, min_score,
      max_guide_diffs, max_pam_mismatches, max_gap_before_extending,
      extension_total_diffs, max_total_diffs, max_overlap, wbytes, woff,
      wlen, pass_mask, ranges, n_windows, emit);
}

// Fully-rendered batched finisher: same search semantics as finish_batch,
// but each kept alignment is composed into its COMPLETE 34-column
// reference-pass TSV line in native code (the production path previously
// assembled lines in Python at ~50 us/row; see align/batch.py).
//
// Per-window extras beyond finish_batch's inputs:
//   fbytes/foff/flen  - UPPERCASE flank-source bases covering at least
//                       [window_start - 10, window_end + 10] clamped to
//                       the contig (positions outside the source render
//                       as 'N', matching HitBuilder._fetch's contig-edge
//                       N-padding - ReferenceHit.scala:261-266);
//   fstart1           - 1-based genomic position of fbytes[foff[w]];
//   wstart1           - 1-based genomic start of the (trimmed) window.
// Call-constant strings (length-prefixed, no NUL): chrom, guide_id,
// unpadded guide, genome build, guide-length digits, and the pre-joined
// tail (aligner..time_stamp).
//
// Output (int64 per element — genomic coords exceed int32 on >2 Gb
// contigs): out_meta8[k*8] = {widx, strand(0='+'), cs, score, rh_end, 0,0,0}
// (cs = genomic guide-only start; rh_end = cs + length_on_target - 1, the
// ReferenceHit.end dedup key), and the line bytes (newline included)
// packed into out_lines at out_line_off[k] (out_line_len[k] chars).
// Returns kept count; -1 = buffer full (retry bigger); -2 = internal.
int32_t finish_batch_render(
    const uint8_t* qletters, int32_t Q, const uint8_t* pam_letters,
    const int32_t* pam_off, const int32_t* pam_len, int32_t n_pams,
    int32_t is5prime, int32_t match, int32_t mismatch, int32_t qgap,
    int32_t tgap, int32_t pam_match, int32_t pam_mismatch, int32_t min_score,
    int32_t max_guide_diffs, int32_t max_pam_mismatches,
    int32_t max_gap_before_extending, int32_t extension_total_diffs,
    int32_t max_total_diffs, int32_t max_overlap, const uint8_t* wbytes,
    const int64_t* woff, const int32_t* wlen, const uint8_t* pass_mask,
    const int32_t* ranges, int32_t n_windows,
    const uint8_t* fbytes, const int64_t* foff, const int32_t* flen,
    const int64_t* fstart1, const int64_t* wstart1,
    const char* chrom, int32_t chrom_len,
    const char* c_guide_id, int32_t c_guide_id_len,
    const char* c_guide, int32_t c_guide_len,
    const char* c_build, int32_t c_build_len,
    const char* c_glen, int32_t c_glen_len,
    const char* c_tail, int32_t c_tail_len,
    int32_t max_out, int64_t* out_meta8,
    char* out_lines, int64_t out_lines_cap,
    int64_t* out_line_off, int32_t* out_line_len) {
  // pam_used per pam index: the lowercase chars of the final guide string
  // = the PAM as written for 3' guides, its (case-preserving) revcomp for
  // 5' guides (ReferenceHit.scala:229; PAM letters are lowercase by
  // construction).
  std::vector<std::string> pam_used(std::max(n_pams, 0));
  for (int32_t p = 0; p < n_pams; ++p) {
    std::string s(reinterpret_cast<const char*>(pam_letters + pam_off[p]),
                  (size_t)pam_len[p]);
    if (is5prime) {
      std::reverse(s.begin(), s.end());
      for (char& c : s) c = (char)TBL.comp[(uint8_t)c];
    }
    pam_used[p] = std::move(s);
  }

  int32_t n_out = 0;
  int64_t line_pos = 0;
  std::string line;
  line.reserve(512);
  char num[16];

  auto emit = [&](int32_t w, int32_t strandc, int32_t kind_code,
                  const FinAln& a, const RenderOut& r) -> int {
    (void)kind_code;
    const int64_t toff = wstart1[w] - 1;
    const int64_t cs = toff + r.gs;
    const int64_t ce = toff + r.ge;
    const int64_t sf = toff + r.s0;
    const int64_t ef = toff + r.e0;
    const bool pos = strandc == 0;
    const uint8_t* fsrc = fbytes + foff[w];
    const int64_t fs1 = fstart1[w];
    const int32_t fn = flen[w];

    line.clear();
    auto tab = [&]() { line.push_back('\t'); };
    auto put = [&](const char* s, int32_t n) { line.append(s, (size_t)n); };
    auto put_i = [&](int64_t v) {
      const int nn = std::snprintf(num, sizeof(num), "%lld", (long long)v);
      line.append(num, nn);
    };
    // Flank span [a1, b1] 1-based closed genomic; uppercase source;
    // positions outside the source render 'N'; minus-strand flanks
    // revcomp (case is already upper so comp stays upper).
    auto put_flank = [&](int64_t a1, int64_t b1) {
      if (pos) {
        for (int64_t g = a1; g <= b1; ++g) {
          const int64_t i = g - fs1;
          line.push_back(i >= 0 && i < fn ? (char)fsrc[i] : 'N');
        }
      } else {
        for (int64_t g = b1; g >= a1; --g) {
          const int64_t i = g - fs1;
          line.push_back(
              i >= 0 && i < fn ? (char)TBL.comp[fsrc[i]] : 'N');
        }
      }
    };

    put(c_guide_id, c_guide_id_len); tab();
    put(c_guide, c_guide_len); tab();
    put(c_build, c_build_len); tab();
    put(chrom, chrom_len); tab();
    put_i(cs); tab();
    put_i(ce); tab();
    line.push_back(pos ? '+' : '-'); tab();
    line.append(r.ut); tab();
    // ten_bases_5'/3': flank the protospacer; labels strand-swap.
    if (pos) {
      put_flank(cs - 9, cs); tab();
      put_flank(ce + 1, ce + 10); tab();
    } else {
      put_flank(ce + 1, ce + 10); tab();
      put_flank(cs - 9, cs); tab();
    }
    if (a.pam_idx >= 0) line.append(pam_used[a.pam_idx]);
    tab();
    tab(); tab(); tab(); tab();  // variant_id/description/vcf/allele_freq
    put_i(a.score); tab();
    put_i(r.gmm); tab();
    put_i(r.ggap); tab();
    put_i(r.gmm + r.ggap); tab();
    put_i(r.pmm); tab();
    put_i(r.mism + r.gapb); tab();
    line.append(r.pg); tab();
    line.append(r.pa); tab();
    line.append(r.pt); tab();
    // padded_extra_8: flank the whole alignment; labels strand-swap.
    if (pos) {
      put_flank(sf - 7, sf); tab();
      put_flank(ef + 1, ef + 8); tab();
    } else {
      put_flank(ef + 1, ef + 8); tab();
      put_flank(sf - 7, sf); tab();
    }
    line.append(r.cig); tab();
    put(c_glen, c_glen_len); tab();
    put_i((int64_t)r.ut.size()); tab();
    put(c_tail, c_tail_len);
    line.push_back('\n');

    if (n_out >= max_out ||
        line_pos + (int64_t)line.size() > out_lines_cap)
      return -1;
    int64_t* m = out_meta8 + (int64_t)n_out * 8;
    m[0] = w;
    m[1] = strandc;
    m[2] = cs;
    m[3] = a.score;
    // ReferenceHit.end quirk preserved: guide-only start + full-cigar
    // length-on-target (= e0 - s0) - 1 (ReferenceHit.scala:135-138).
    m[4] = cs + (r.e0 - r.s0) - 1;
    m[5] = 0; m[6] = 0; m[7] = 0;
    out_line_off[n_out] = line_pos;
    out_line_len[n_out] = (int32_t)line.size();
    std::memcpy(out_lines + line_pos, line.data(), line.size());
    line_pos += (int64_t)line.size();
    ++n_out;
    return 0;
  };
  return finish_windows_core(
      qletters, Q, pam_letters, pam_off, pam_len, n_pams, is5prime, match,
      mismatch, qgap, tgap, pam_match, pam_mismatch, min_score,
      max_guide_diffs, max_pam_mismatches, max_gap_before_extending,
      extension_total_diffs, max_total_diffs, max_overlap, wbytes, woff,
      wlen, pass_mask, ranges, n_windows, emit);
}

// Window materialization + finish_batch_render in ONE native call: the
// worker's only per-candidate Python is the mmap read of the raw
// context slice (window + flank margin, ORIGINAL case).  Per window this
// function applies the reference's exact window semantics
// (SearchReference.scala:52-68 — N-trim of UPPERCASE 'N' only at both
// ends, then uppercase) plus the screen-range -> pass-range mapping of
// align/batch.py::chain_ranges_to_pass, and then runs the line-rendering
// finisher.  Inputs per window:
//   cbytes/coff/clen - raw context rows; cstart1 - 1-based genomic pos of
//   each row's first byte; wstart0 - 0-based genomic start of the RAW
//   window inside the context; wraw_len - raw window length;
//   cranges[w*4+{0..3}] - (loA, hiA, loB, hiB) 1-based inclusive screen
//   end-column bounds, or loA <= -1 for "no ranges" (full DP).
// Windows whose trimmed length < min_window_len are skipped (too short
// to hold the guide string; also covers the all-N placeholder).
int32_t materialize_finish_render(
    const uint8_t* qletters, int32_t Q, const uint8_t* pam_letters,
    const int32_t* pam_off, const int32_t* pam_len, int32_t n_pams,
    int32_t is5prime, int32_t match, int32_t mismatch, int32_t qgap,
    int32_t tgap, int32_t pam_match, int32_t pam_mismatch, int32_t min_score,
    int32_t max_guide_diffs, int32_t max_pam_mismatches,
    int32_t max_gap_before_extending, int32_t extension_total_diffs,
    int32_t max_total_diffs, int32_t max_overlap,
    const uint8_t* cbytes, const int64_t* coff, const int32_t* clen,
    const int64_t* cstart1, const int64_t* wstart0, const int32_t* wraw_len,
    const uint8_t* pass_mask, const int32_t* cranges, int32_t n_windows,
    int32_t min_window_len,
    const char* chrom, int32_t chrom_len,
    const char* c_guide_id, int32_t c_guide_id_len,
    const char* c_guide, int32_t c_guide_len,
    const char* c_build, int32_t c_build_len,
    const char* c_glen, int32_t c_glen_len,
    const char* c_tail, int32_t c_tail_len,
    int32_t max_out, int64_t* out_meta8,
    char* out_lines, int64_t out_lines_cap,
    int64_t* out_line_off, int32_t* out_line_len) {
  // Uppercase table (flank sources and window bytes are uppercased;
  // masks are case-insensitive anyway, but rendered strings must match
  // the reference's uppercased windows/flanks).
  uint8_t upper[256];
  for (int i = 0; i < 256; ++i)
    upper[i] = (i >= 'a' && i <= 'z') ? (uint8_t)(i - 32) : (uint8_t)i;

  int64_t ctx_total = 0;
  for (int32_t w = 0; w < n_windows; ++w) ctx_total += clen[w];
  std::vector<uint8_t> fb((size_t)std::max<int64_t>(ctx_total, 1));
  std::vector<uint8_t> wb((size_t)std::max<int64_t>(ctx_total, 1));
  std::vector<int64_t> woff(n_windows), fstart1(n_windows),
      wstart1(n_windows);
  std::vector<int32_t> wlen(n_windows);
  std::vector<uint8_t> pm(n_windows);
  std::vector<int32_t> ranges((size_t)n_windows * 4, 0);

  const int64_t surplus = (int64_t)match * Q - min_score;

  int64_t pos = 0;
  for (int32_t w = 0; w < n_windows; ++w) {
    const uint8_t* row = cbytes + coff[w];
    const int32_t cl = clen[w];
    // uppercase flank source (whole context row)
    for (int32_t j = 0; j < cl; ++j) fb[coff[w] + j] = upper[row[j]];
    fstart1[w] = cstart1[w];
    // raw window inside the context
    int64_t a = wstart0[w] + 1 - cstart1[w];  // context offset of window
    int32_t s = 0, e = wraw_len[w];
    if (a < 0 || a + e > cl) {  // caller geometry error: skip window
      wlen[w] = 0; pm[w] = 0; woff[w] = pos; wstart1[w] = 1;
      continue;
    }
    const uint8_t* rw = row + a;
    while (s < e && rw[s] == 'N') ++s;
    while (s < e && rw[e - 1] == 'N') --e;
    const int32_t T = e - s;
    woff[w] = pos;
    wstart1[w] = wstart0[w] + s + 1;
    if (T < min_window_len || T <= 0) {
      wlen[w] = 0; pm[w] = 0;
      continue;
    }
    for (int32_t j = 0; j < T; ++j) wb[pos + j] = upper[rw[s + j]];
    wlen[w] = T;
    pos += T;
    pm[w] = pass_mask[w];
    const int32_t loA = cranges[(int64_t)w * 4 + 0];
    if (loA > -1) {
      const int32_t hiA = cranges[(int64_t)w * 4 + 1];
      const int32_t loB = cranges[(int64_t)w * 4 + 2];
      const int32_t hiB = cranges[(int64_t)w * 4 + 3];
      // span = Q + D_max guide-gap columns (max_target_span semantics:
      // d = surplus//-qgap when qgap < 0, else T; 0 when no surplus).
      int64_t d = 0;
      if (surplus > 0) d = qgap < 0 ? surplus / -(int64_t)qgap : (int64_t)T;
      const int64_t span = (int64_t)Q + d;
      // chain A maps by the trim shift; chain B mirrors with span
      // widening (chain_ranges_to_pass semantics, align/batch.py).
      int64_t lo0 = std::max<int64_t>(1, (int64_t)loA - s);
      int64_t hi0 = std::min<int64_t>(T, (int64_t)hiA - s);
      int64_t lo1 = std::max<int64_t>(1, (int64_t)T + 1 - ((int64_t)hiB - s));
      int64_t hi1 = std::min<int64_t>(T, (int64_t)T - ((int64_t)loB - s) + span);
      if (hi0 < lo0) { lo0 = 1; hi0 = 0; }
      if (hi1 < lo1) { lo1 = 1; hi1 = 0; }
      ranges[(int64_t)w * 4 + 0] = (int32_t)lo0;
      ranges[(int64_t)w * 4 + 1] = (int32_t)hi0;
      ranges[(int64_t)w * 4 + 2] = (int32_t)lo1;
      ranges[(int64_t)w * 4 + 3] = (int32_t)hi1;
    }
  }
  return finish_batch_render(
      qletters, Q, pam_letters, pam_off, pam_len, n_pams, is5prime, match,
      mismatch, qgap, tgap, pam_match, pam_mismatch, min_score,
      max_guide_diffs, max_pam_mismatches, max_gap_before_extending,
      extension_total_diffs, max_total_diffs, max_overlap, wb.data(),
      woff.data(), wlen.data(), pm.data(), ranges.data(), n_windows,
      fb.data(), coff, clen, fstart1.data(), wstart1.data(),
      chrom, chrom_len, c_guide_id, c_guide_id_len, c_guide, c_guide_len,
      c_build, c_build_len, c_glen, c_glen_len, c_tail, c_tail_len,
      max_out, out_meta8, out_lines, out_lines_cap, out_line_off,
      out_line_len);
}

// materialize_finish_render over RAW FASTA-file bytes: each window's
// context is addressed directly in the caller's mmap'd FASTA (byte
// offset + raw byte length INCLUDING newlines + expected base count).
// This removes the worker's last per-candidate Python work (the per-
// window mmap slice + newline strip): one linear pass here packs the
// newline-stripped contexts, then the packed finisher above runs
// unchanged.  Returns -3 if any row's stripped base count does not
// match cbase_len (caller geometry error -> caller falls back).
int32_t materialize_finish_render_raw(
    const uint8_t* qletters, int32_t Q, const uint8_t* pam_letters,
    const int32_t* pam_off, const int32_t* pam_len, int32_t n_pams,
    int32_t is5prime, int32_t match, int32_t mismatch, int32_t qgap,
    int32_t tgap, int32_t pam_match, int32_t pam_mismatch, int32_t min_score,
    int32_t max_guide_diffs, int32_t max_pam_mismatches,
    int32_t max_gap_before_extending, int32_t extension_total_diffs,
    int32_t max_total_diffs, int32_t max_overlap,
    const uint8_t* fasta_bytes, const int64_t* raw_off,
    const int32_t* raw_len, const int32_t* cbase_len,
    const int64_t* cstart1, const int64_t* wstart0, const int32_t* wraw_len,
    const uint8_t* pass_mask, const int32_t* cranges, int32_t n_windows,
    int32_t min_window_len,
    const char* chrom, int32_t chrom_len,
    const char* c_guide_id, int32_t c_guide_id_len,
    const char* c_guide, int32_t c_guide_len,
    const char* c_build, int32_t c_build_len,
    const char* c_glen, int32_t c_glen_len,
    const char* c_tail, int32_t c_tail_len,
    int32_t max_out, int64_t* out_meta8,
    char* out_lines, int64_t out_lines_cap,
    int64_t* out_line_off, int32_t* out_line_len) {
  int64_t total = 0;
  for (int32_t w = 0; w < n_windows; ++w) total += cbase_len[w];
  std::vector<uint8_t> packed((size_t)std::max<int64_t>(total, 1));
  std::vector<int64_t> poff(std::max(n_windows, 1));
  int64_t pos = 0;
  for (int32_t w = 0; w < n_windows; ++w) {
    poff[w] = pos;
    const uint8_t* src = fasta_bytes + raw_off[w];
    const int32_t rl = raw_len[w];
    const int64_t lim = pos + (int64_t)cbase_len[w];  // never overflow packed
    int64_t k = pos;
    for (int32_t j = 0; j < rl; ++j) {
      const uint8_t b = src[j];
      if (b != '\n' && b != '\r') {
        if (k >= lim) return -3;
        packed[(size_t)k++] = b;
      }
    }
    if (k != lim) return -3;
    pos = k;
  }
  return materialize_finish_render(
      qletters, Q, pam_letters, pam_off, pam_len, n_pams, is5prime, match,
      mismatch, qgap, tgap, pam_match, pam_mismatch, min_score,
      max_guide_diffs, max_pam_mismatches, max_gap_before_extending,
      extension_total_diffs, max_total_diffs, max_overlap,
      packed.data(), poff.data(), cbase_len, cstart1, wstart0, wraw_len,
      pass_mask, cranges, n_windows, min_window_len,
      chrom, chrom_len, c_guide_id, c_guide_id_len, c_guide, c_guide_len,
      c_build, c_build_len, c_glen, c_glen_len, c_tail, c_tail_len,
      max_out, out_meta8, out_lines, out_lines_cap, out_line_off,
      out_line_len);
}

}  // extern "C"
