// The glocal-DP screen's device core for NVIDIA Hopper (sm_90a), shared
// by screen_dual.cu (one guide), screen_multi.cu (G guides and the
// variant pass's slot batches) and screen_rows.cu (length-masked rows,
// one chain per lane group: Lane's kRows and kStride).
//
// One window's two chains (chain A = the DP query, chain B = its reverse
// complement) over the same staged genome bytes.  Per byte: bits 0-3 =
// IUPAC target mask, bit 4 = a chain-A alignment may END here, bit 5 = a
// chain-B alignment may START after it; bytes at or past genome_len read
// as 0.  Exact int32 recurrence
//     S[0,j] = 0 (chain B with the gate: 0 if bit 5 else NEG_GATE, j >= 1)
//     S[i,0] = i*tgap
//     S[i,j] = max(S[i-1,j-1] + pair, S[i,j-1] + qgap, S[i-1,j] + tgap)
// with pair = match if (query_mask & target_mask) != 0 else mismatch.
//
// The design (measured on screen_dual in PERF.md section 6):
// - L lanes of one warp share a window as a wavefront (L divides 32;
//   L = 1 is one thread per window).  Lane k owns rows
//   [k*R + 1, min((k+1)*R, Q)] of both chains, R = ceil(Q/L); at step s it
//   works on column j = s - k and takes its top boundary (row k*R of
//   column j) from lane k-1's bottom row of the step before by
//   __shfl_up_sync with width L.  All lanes run all T + L - 1 steps, so
//   every shuffle has the full warp; a lane off its columns, or a window
//   past n_windows, only skips its work and its stores.  L multiplies the
//   warps in flight by L; each step costs every lane the shuffles, the
//   byte, the table read and the end-column bookkeeping.  The lane that
//   holds row Q keeps best/min/max and writes the outputs.
// - Per cell, per chain: one bit test, one predicated add and two DPX
//   add+max.  Each block holds, per lane and target code t, the bit set
//   {r : q[k*R + r] & t} of both chains (one shared load per column).
//   The state is kept as S'[i,j] = S[i,j] - i*mismatch, so a diagonal
//   step adds 0 or match - mismatch and needs no select.  Two register
//   sets alternate by column, so no cell moves its result, and the column
//   bytes are loaded one round of four steps ahead.  The steps outside the
//   steady rounds of four (the first and last L-1, and what the rounds
//   leave) copy their result back into the first set: letting them
//   alternate too (both sets initialised, a guarded tail) cost L 1 30
//   registers and 0.2 SASS instructions per cell and chain in the steady
//   loop, and made no slot batch faster (PERF.md section 6).
// - Rows (kRows: one chain per lane group): a row's bytes are its own,
//   n_cols of them, and every lane of a warp runs the steps of the warp's
//   longest row.  The byte of a column inside the row is read with bit 4
//   set (an alignment may end there) and one past it as 0, and the
//   chain's ends are gated on bit 4, so the columns a lane runs past its
//   row's end score NEG_INF in the end-column state, as the row contract
//   has it, at the cost of one OR per byte.  A table entry holds the one
//   chain's bits (Bits, not Compat), half the shared memory and stores.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace dp_lane {

constexpr int kNegInf = -(1 << 30);
constexpr int kNegGate = -(1 << 26);
constexpr int kQMax = 48;
constexpr int kThreads = 64;  // small blocks: a grid fills 132 SMs evenly at every L
constexpr unsigned kFullMask = 0xffffffffu;

// The window grid and scores of one launch: window w covers genome bytes
// [base0 + w*step, base0 + w*step + window).
struct Grid {
  const uint8_t* genome;
  long long genome_len;
  long long base0;
  long long step;
  int window;
  int n_windows;
  int match;
  int mismatch;
  int qgap;
  int tgap;
  int pam_gate;
};

// The split of Q rows over L lanes.
template <int Q, int L>
struct Split {
  static constexpr int R = (Q + L - 1) / L;  // rows per lane
  static constexpr int kLast = (Q - 1) / R;  // the lane that holds row Q
  static constexpr int rLast = Q - kLast * R;  // row Q's index in that lane
  static constexpr int kWindows = kThreads / L;  // windows per block
  using Bits = typename std::conditional<(R > 32), unsigned long long, unsigned>::type;
  static_assert(32 % L == 0 && L <= Q, "L must divide a warp");
};

// Both chains' match bits of one lane for one target code: bit r set when
// row k*R + r + 1 matches.  One aligned entry, one shared load per column.
template <typename Bits>
struct alignas(2 * sizeof(Bits)) Compat {
  Bits f;
  Bits r;
};

// Lane k's entry for target code t from the chains' masks qf, qr [Q].
template <int Q, int L, typename Mask>
__host__ __device__ inline Compat<typename Split<Q, L>::Bits> compat_entry(const Mask* qf,
                                                                           const Mask* qr,
                                                                           int k, int t) {
  using S = Split<Q, L>;
  using Bits = typename S::Bits;
  Bits f = 0, r = 0;
  for (int i = 0; i < S::R; ++i) {
    const int row = k * S::R + i;
    if (row >= Q) break;
    if (qf[row] & t) f |= Bits(1) << i;
    if (qr[row] & t) r |= Bits(1) << i;
  }
  return Compat<Bits>{f, r};
}

// S'[Q,j] = S[Q,j] - end_shift: the shift of a launch's end-column scores,
// its gated end (NEG_INF in S' units) and a threshold in S' units, or
// false when the gated end leaves int32.
struct Shift {
  int end_shift;  // Q*mismatch
  int neg_end;    // NEG_INF - Q*mismatch
};

inline bool make_shift(int q_len, int mismatch, Shift& out) {
  const long long shift = static_cast<long long>(q_len) * mismatch;
  const long long neg_end = kNegInf - shift;
  if (neg_end < INT32_MIN || neg_end > INT32_MAX || shift < INT32_MIN || shift > INT32_MAX) {
    return false;
  }
  out = Shift{static_cast<int>(shift), static_cast<int>(neg_end)};
  return true;
}

// min_score - end_shift, clamped to int32: e' >= it exactly when the
// unshifted score e' + end_shift >= min_score, for every e' the DP reaches.
__host__ __device__ inline int shifted_threshold(int min_score, int end_shift) {
  const long long ms = static_cast<long long>(min_score) - end_shift;
  return static_cast<int>(ms < INT32_MIN ? INT32_MIN : ms > INT32_MAX ? INT32_MAX : ms);
}

__device__ __forceinline__ int add_max(int a, int b, int c) {
  return __viaddmax_s32(a, b, c);  // max(a + b, c)
}

// d + delta where `word & mask` is non-zero, else d: one predicate test and
// one predicated add (the compiler, left to itself, builds a 0/delta mask
// with a shift pair and an AND first).
__device__ __forceinline__ int add_if(int d, unsigned word, unsigned mask, int delta) {
  asm("{\n\t.reg .pred p;\n\t.reg .b32 t;\n\t"
      "and.b32 t, %1, %2;\n\tsetp.ne.u32 p, t, 0;\n\t@p add.s32 %0, %0, %3;\n\t}"
      : "+r"(d)
      : "r"(word), "r"(mask), "r"(delta));
  return d;
}

// The end-column state of one chain after column j: best = max(best, e);
// where e >= min_score, mn = min(mn, j) and mx = j.  One compare, two
// predicated updates and a max (the compiler repeats the compare).
__device__ __forceinline__ void keep_end(int e, int j, int min_score, int& best, int& mn,
                                         int& mx) {
  asm("{\n\t.reg .pred p;\n\tsetp.ge.s32 p, %3, %4;\n\t@p min.s32 %1, %1, %5;\n\t"
      "@p mov.b32 %2, %5;\n\tmax.s32 %0, %0, %3;\n\t}"
      : "+r"(best), "+r"(mn), "+r"(mx)
      : "r"(e), "r"(min_score), "r"(j));
}

// One column of one chain over a lane's R rows: nxt from cur (the column
// before) and the row above, in S' units.  Per cell: a bit test, a
// predicated add for the diagonal and two DPX add+max.
template <int R, typename Bits>
__device__ __forceinline__ void column(const int (&cur)[R + 1], int (&nxt)[R + 1], int top,
                                       Bits bits, int delta, int qgap, int tgap) {
  nxt[0] = top;
#pragma unroll
  for (int i = 1; i <= R; ++i) {
    const unsigned word = static_cast<unsigned>(bits >> (32 * ((i - 1) / 32)));
    const int d = add_if(cur[i - 1], word, 1u << ((i - 1) % 32), delta);
    nxt[i] = add_max(nxt[i - 1], tgap, add_max(cur[i], qgap, d));
  }
}

// One thread's share of a window or row: its lane's rows of C chains (A
// and B of a window; one chain of a row: kRows, see above), in two
// register sets that alternate by column (no copies between columns), and
// the end-column state its window keeps if it holds row Q.  kStride: the
// distance between the lane's table entries of two target codes (1, or
// the block's threads when every thread has a table of its own).
template <int Q, int L, bool kRows = false, int kStride = 1>
struct Lane {
  using S = Split<Q, L>;
  using Bits = typename S::Bits;
  static constexpr int R = S::R;
  static constexpr int C = kRows ? 1 : 2;
  // One table entry: both chains' bits, or a row's one chain's.
  using Entry = typename std::conditional<kRows, Bits, Compat<Bits>>::type;

  int f[2][R + 1];
  int r[2][R + 1];
  int best_f, best_r, mn_f, mx_f, mn_r, mx_r;
  int k, T, t_in, delta, qgap, tgap, open, neg_end, min_score;
  const uint8_t* src;
  const Entry* tbl;

  // Lane k of window w (live: w < n_windows) with its block's table and
  // its guide's gated end and threshold, both in S' units.
  __device__ __forceinline__ void start(const Grid& g, int w, bool live, int lane,
                                        const Entry* table, int gated_end,
                                        int threshold) {
    const long long first = g.base0 + static_cast<long long>(w) * g.step;
    const long long avail = g.genome_len - first;
    const int n_in =
        !live || avail <= 0 ? 0 : (avail < g.window ? static_cast<int>(avail) : g.window);
    begin(g.genome + (n_in > 0 ? first : 0), n_in, g.window, lane, table, g.match,
          g.mismatch, g.qgap, g.tgap, g.pam_gate ? 0 : 48, gated_end, threshold);
  }

  // Lane k over the n_in bytes at `bytes`, for `steps` columns (warp
  // uniform), with the gate bits `gate_open` read as set on every byte.
  __device__ __forceinline__ void begin(const uint8_t* bytes, int n_in, int steps, int lane,
                                        const Entry* table, int match, int mismatch,
                                        int q_gap, int t_gap, int gate_open, int gated_end,
                                        int threshold) {
    k = lane;
    T = steps;
    t_in = n_in;
    src = bytes;
    tbl = table;
    delta = match - mismatch;
    qgap = q_gap;
    tgap = t_gap - mismatch;
    open = gate_open;
    neg_end = gated_end;
    min_score = threshold;
#pragma unroll
    for (int i = 0; i <= R; ++i) {
      f[0][i] = (k * R + i) * tgap;  // S'[i,0]
      if constexpr (C == 2) r[0][i] = (k * R + i) * tgap;
    }
    best_f = best_r = gated_end;
    mn_f = mn_r = T + 1;
    mx_f = mx_r = 0;
  }

  // The byte of step s's column, 0 past the window's bytes or off its
  // columns (one unsigned compare covers both ends); a row's own bytes
  // carry bit 4.
  __device__ __forceinline__ int load(int s) const {
    const int j = s - k;
    return static_cast<unsigned>(j - 1) < static_cast<unsigned>(t_in)
               ? static_cast<int>(__ldg(src + (j - 1))) | (kRows ? 16 : 0)
               : 0;
  }

  // Step s: column j = s - k from set P into set 1-P, with that column's
  // byte (loaded ahead by the caller).  kGuard: the lane may be off its
  // columns (the first and last L-1 steps); kCopy: move the result back
  // into set P (a step that is not one of a pair).
  template <int P, bool kGuard, bool kCopy>
  __device__ __forceinline__ void step(int s, int raw) {
    const int j = s - k;
    const bool on = !kGuard || (j >= 1 && j <= T);
    int top_f = 0, top_r = 0;
    if constexpr (L > 1) {
      // Lane k-1's bottom row of the step before: column j, row k*R.
      top_f = __shfl_up_sync(kFullMask, f[P][R], 1, L);
      if constexpr (C == 2) top_r = __shfl_up_sync(kFullMask, r[P][R], 1, L);
    }
    const int gm = raw | open;  // gate bits read as open without the gate
    if (k == 0) {  // the glocal row 0
      top_f = 0;
      top_r = gm & 32 ? 0 : kNegGate;
    }
    if (kGuard && !on) return;
    const Entry cb = tbl[(raw & 15) * kStride];
    if constexpr (kRows) {
      column<R>(f[P], f[1 - P], top_f, cb, delta, qgap, tgap);
    } else {
      column<R>(f[P], f[1 - P], top_f, cb.f, delta, qgap, tgap);
      column<R>(r[P], r[1 - P], top_r, cb.r, delta, qgap, tgap);
    }
    // Row Q's lane keeps the window's end-column state; the others'
    // copies are never stored.
    keep_end(gm & 16 ? f[1 - P][S::rLast] : neg_end, j, min_score, best_f, mn_f, mx_f);
    if constexpr (C == 2) keep_end(r[1 - P][S::rLast], j, min_score, best_r, mn_r, mx_r);
    if constexpr (kCopy) {
#pragma unroll
      for (int i = 0; i <= R; ++i) {
        f[P][i] = f[1 - P][i];
        if constexpr (C == 2) r[P][i] = r[1 - P][i];
      }
    }
  }

  // Every step of the window: lane k works on column s - k, so every lane
  // is on for s in [L, T].  The steady steps go four at a time, their
  // bytes loaded one round ahead.
  __device__ __forceinline__ void sweep() {
    int s = 1;
    for (; s < L; ++s) step<0, true, true>(s, load(s));
    int next[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) next[u] = load(s + u);
#pragma unroll 1
    for (; s + 3 <= T; s += 4) {
      int raw[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        raw[u] = next[u];
        next[u] = load(s + 4 + u);
      }
      step<0, false, false>(s, raw[0]);
      step<1, false, false>(s + 1, raw[1]);
      step<0, false, false>(s + 2, raw[2]);
      step<1, false, false>(s + 3, raw[3]);
    }
    for (; s <= T; ++s) step<0, false, true>(s, load(s));
    for (; s < T + L; ++s) step<0, true, true>(s, load(s));
  }
};

}  // namespace dp_lane
