// Length-masked row screen for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel calitas_tpu/ops/dp_pallas2.py::_kernel
// (wrapper _pallas_screen2, class PallasScreenKernelV2), and carries the
// pair screen of the list-driven tools (calitas_tpu/ops/pair_screen.py::
// _pair_scores_dual[_ranges], XLA scans on the TPU) in a second mode:
//   - shared query (_kernel's contract, one chain): every row is screened
//     against one query, which travels in the parameter struct;
//   - per-row query (the pair screen, two chains): row b has its own
//     chain-A and chain-B queries, [2, B, Q] uint8 in device memory.
// It reads the row-major [B, T] uint8 target batch as it is staged; the
// Pallas kernel's [T, nb*8, 128] column relayout is the TPU's and is gone.
//
// Contract (bit-identical to calitas_tpu_torch/ops/dp_screen.py::
// screen_rows_reference).  Exact int32 recurrence per row b and chain c
//     S[0,j] = 0,  S[i,0] = i*tgap
//     S[i,j] = max(S[i-1,j-1] + pair, S[i,j-1] + qgap, S[i-1,j] + tgap)
// with pair = match if (query_mask & target_mask) != 0 else mismatch; no
// PAM gate.  best[c*B + b] = max over 1 <= j <= min(T, lengths[b]) of
// S[Q,j], NEG_INF when there is none.  With min_scores, ranges[(2c+k)*B
// + b] = (k=0) min / (k=1) max 1-based end column j whose score reaches
// min_scores[b], T+1 / 0 when none, where end columns past the row's
// length score NEG_INF (so they qualify only when min_scores[b] <=
// NEG_INF; the epilogue settles the tail past the warp's last column in
// closed form).  A score set whose end shift Q*mismatch, or NEG_INF
// shifted by it, leaves int32 is refused (cudaErrorInvalidValue), as
// screen_dual.cu refuses it.
//
// What bounds it on the H100: integer issue, as for the window screens:
// two int32 operations (one add, one max) per DP cell, Q cells per chain
// and column of each row's own length.  The design is dp_lane.cuh's
// (PERF.md section 6: screen_dual from about 12.8 to 3.96 SASS
// instructions per cell and chain): L lanes per row as a wavefront, per
// cell a bit test, a predicated add and two DPX add+max on state kept as
// S - i*mismatch, alternating register sets, bytes loaded a round ahead,
// 64-thread blocks.  The first design, one thread per row with four
// per-base position sets ORed per column and a select per cell, left a
// list tool's chunk of 2,870-7,130 rows on less than one warp per SM.
// What rows need that windows do not:
// - A list tool's chunk has too few rows to fill the card: 2,870 rows at
//   L 4 are 359 warps for 528 schedulers.  So each group of L lanes runs
//   one chain of one row (Lane's kRows), in both modes: per-row mode is
//   2B one-chain rows, the chains A and B of row b side by side (group v
//   = 2b + c), twice the warps of two chains per lane at half the work
//   per step; measured faster at every shape and Q than two chains per
//   lane, though a cell costs more instructions (PERF.md section 6).
// - Each row ends at its own length; every lane of a warp runs the steps
//   of the warp's longest row (a __reduce_max_sync), and the columns past
//   a row's end are gated to NEG_INF in the end-column state
//   (dp_lane.cuh, kRows).
// - Per-row mode: every row has its own queries, so every thread builds
//   its own lane's 16 match-bit entries of its chain in shared memory
//   from the device masks (four per-base position sets, then one OR per
//   entry), laid out [code][thread] so that a warp's reads of one code
//   hit consecutive words; no barrier, since a thread reads only its own.
//   Shared mode: the block builds the one L x 16 table from the query in
//   the parameters, as screen_multi.cu builds a guide's.
// - Thresholds are per row, clamped to int32 in S' units.
// The launcher picks L from the mode, Q and the row count (kLaneRows);
// calitas_screen_rows_lanes launches a given L, for measurement.  Each
// lane reads its column's byte through L1 (the 2L lanes of a row hit one
// line; neighbouring rows are T bytes apart).

#include <cuda_runtime.h>

#include <array>
#include <climits>
#include <cstdint>
#include <utility>

#include "dp_lane.cuh"

namespace {

using namespace dp_lane;

// The (Q, L) the library is built for, in each mode: every L of
// kLaneCounts up to Q, except shared-query L 4, which lost by more than
// 3 % at every Q of chip_smoke.py phase 9's sweep (PERF.md section 6).
constexpr bool built(int q_len, int lanes, bool per_row) {
  return lanes <= q_len && (per_row || lanes < 4);
}

// The launcher's lanes per row.  A launch's row is the first of its mode
// whose bound its row count is below, and L = lanes[Q - 1].  Each row
// holds, at each Q, the L whose time came nearest the fastest, in the
// worst run, at every shape named (chip_smoke.py phase 9's sweep, PERF.md
// section 6); each bound is the row count of the next row's first shape,
// so both sides of it are measured.  Adjacent rows that one L list could
// serve within 2 % at every Q are merged.
constexpr int kAnyRows = INT_MAX;
struct LaneRow {
  bool per_row;       // per-row queries, else one shared query
  int below;          // fewer rows than this, or kAnyRows
  const char* lanes;  // one digit per Q from 1 to 48
};
constexpr LaneRow kLaneRows[] = {
    // pairs20k's chunks of slot 128 (2,870 rows); 4,000 x 128.
    {true, 5000, "111111111214122422422224224444442244444444444444"},
    // a2r20k's chunks (5,000 rows of 201 bases, slot 256); 5,500 x 128;
    // 6,000 x 512.
    {true, 7130, "111111111111111111121224224444441244444444441244"},
    // pairs20k's chunks of slot 256: 7,130 rows.
    {true, 12000, "111111111111111111121222222222221222222221221222"},
    // 12,000 x 256 and 12,000 x 1024.
    {true, 20000, "111111111111111111111212122222222222222222222222"},
    // 20,000 x 256, lengths 0..256 (phase 9's (a)).
    {true, 32768, "111111111111111111111211111222222222222222222222"},
    // 32,768 x 128 (a full chunk of PairScreen) and every larger launch.
    {true, kAnyRows, "111111111111111111111111111111111222221211212222"},
    // A shared query over 41,238 rows of 1000 columns (phase 9's (d)).
    {false, kAnyRows, "111111111111111111111221112222212222222222222222"},
};

constexpr bool lanes_are_built() {
  for (const LaneRow& r : kLaneRows) {
    for (int q = 1; q <= kQMax; ++q) {
      if (!built(q, r.lanes[q - 1] - '0', r.per_row)) return false;
    }
  }
  return true;
}
static_assert(lanes_are_built(), "the launcher picks an L the library is not built for");

int default_lanes(int q_len, bool per_row, int n_rows) {
  for (const LaneRow& r : kLaneRows) {
    if (r.per_row == per_row && (n_rows < r.below || r.below == kAnyRows)) {
      return r.lanes[q_len - 1] - '0';
    }
  }
  return 0;
}

struct Args {
  const uint8_t* tmasks;  // [B, ld] row-major, T columns used
  long long ld;
  int T;
  int n_rows;
  const int* lengths;     // [B]
  const uint8_t* qrows;   // per-row mode: [2, B, Q]; else null
  uint8_t query[kQMax];   // shared mode: the query's masks
  const int* min_scores;  // [B] or null (no ranges)
  int match;
  int mismatch;
  int qgap;
  int tgap;
  // S'[Q,j] = S[Q,j] - Q*mismatch (dp_lane.cuh), and NEG_INF in S'.
  Shift shift;
  int* best;    // [C, B]
  int* ranges;  // [C, 2, B] or null
};

// Thread `tid`'s 16 entries of its chain, at table[t * kThreads + tid],
// from the query rows of lane k at q (Q masks; none when not live).
template <int Q, int L>
__device__ __forceinline__ void build_row_table(typename Split<Q, L>::Bits* table, int tid,
                                                const uint8_t* q, int k, bool live) {
  using S = Split<Q, L>;
  using Bits = typename S::Bits;
  Bits p[4] = {};  // bit i of p[x]: row k*R + i + 1 fits base x
#pragma unroll
  for (int i = 0; i < S::R; ++i) {
    const int row = k * S::R + i;
    if (!live || row >= Q) break;
    const int m = __ldg(q + row);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      if (m >> x & 1) p[x] |= Bits(1) << i;
    }
  }
  Bits e[16];
  e[0] = 0;  // entry t: entry t & (t - 1) (t's other bases) and base x
#pragma unroll
  for (int t = 1; t < 16; ++t) {
    const int x = t & 1 ? 0 : t & 2 ? 1 : t & 4 ? 2 : 3;  // t's lowest base
    e[t] = e[t & (t - 1)] | p[x];
  }
#pragma unroll
  for (int t = 0; t < 16; ++t) table[t * kThreads + tid] = e[t];
}

template <int Q, int L, bool kRowQuery>
__global__ void __launch_bounds__(kThreads, 1) screen_rows_kernel(const Args a) {
  using S = Split<Q, L>;
  using Bits = typename S::Bits;
  const int tid = static_cast<int>(threadIdx.x);
  const int k = L == 1 ? 0 : tid % L;
  // Per-row mode: each group of L lanes runs one chain of one row, the
  // chains A and B of row b side by side (v = 2b + c).
  const int v = blockIdx.x * S::kWindows + tid / L;
  const int b = kRowQuery ? v >> 1 : v;
  const int c = kRowQuery ? v & 1 : 0;
  const bool live = b < a.n_rows;
  const long long n = a.n_rows;

  const Bits* table;  // one chain's bits per target code
  if constexpr (kRowQuery) {
    __shared__ Bits compat[16 * kThreads];
    build_row_table<Q, L>(compat, tid, a.qrows + (live ? c * n + b : 0) * Q, k, live);
    table = compat + tid;
  } else {
    __shared__ Bits compat[L][16];
    for (int i = tid; i < L * 16; i += kThreads) {
      compat[i / 16][i % 16] = compat_entry<Q, L>(a.query, a.query, i / 16, i % 16).f;
    }
    __syncthreads();
    table = compat[k];
  }

  const int len = live ? __ldg(a.lengths + b) : 0;
  const int n_cols = len <= 0 ? 0 : (len < a.T ? len : a.T);
  const int steps = __reduce_max_sync(kFullMask, n_cols);
  const bool want_ranges = a.ranges != nullptr;
  const int ms = live && want_ranges ? __ldg(a.min_scores + b) : INT_MAX;

  Lane<Q, L, true, kRowQuery ? kThreads : 1> x;
  x.begin(a.tmasks + (live ? b * a.ld : 0), n_cols, steps, k, table, a.match, a.mismatch,
          a.qgap, a.tgap, 32, a.shift.neg_end, shifted_threshold(ms, a.shift.end_shift));
  x.mn_f = a.T + 1;
  x.sweep();

  if (!live || k != S::kLast) return;
  // End columns past the row's length score NEG_INF: when that reaches
  // the threshold, all of n_cols+1..T qualify.
  const bool tail = want_ranges && n_cols < a.T && kNegInf >= ms;
  a.best[c * n + b] = x.best_f + a.shift.end_shift;
  if (want_ranges) {
    a.ranges[(2 * c) * n + b] = tail ? min(x.mn_f, n_cols + 1) : x.mn_f;
    a.ranges[(2 * c + 1) * n + b] = tail ? a.T : x.mx_f;
  }
}

using LaunchFn = cudaError_t (*)(const Args&, cudaStream_t);

template <int Q, int L, bool kRowQuery>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using S = Split<Q, L>;
  const long long groups = (kRowQuery ? 2LL : 1LL) * a.n_rows;  // one per row and chain
  const int blocks = static_cast<int>((groups + S::kWindows - 1) / S::kWindows);
  screen_rows_kernel<Q, L, kRowQuery><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int Q, int L, bool kRowQuery>
constexpr LaunchFn launch_if_fits() {
  if constexpr (built(Q, L, kRowQuery)) {
    return &launch<Q, L, kRowQuery>;
  } else {
    return nullptr;
  }
}

template <int L, bool kRowQuery, int... I>
constexpr std::array<LaunchFn, kQMax> lane_row(std::integer_sequence<int, I...>) {
  return {launch_if_fits<I + 1, L, kRowQuery>()...};
}

// The launches of every built (Q, L): kShared[i][Q - 1] (shared query)
// and kPerRow[i][Q - 1] for L = kLaneCounts[i].
constexpr std::array<int, 3> kLaneCounts = {1, 2, 4};
constexpr std::array<std::array<LaunchFn, kQMax>, 3> kShared = {
    lane_row<1, false>(std::make_integer_sequence<int, kQMax>{}),
    lane_row<2, false>(std::make_integer_sequence<int, kQMax>{}),
    lane_row<4, false>(std::make_integer_sequence<int, kQMax>{}),
};
constexpr std::array<std::array<LaunchFn, kQMax>, 3> kPerRow = {
    lane_row<1, true>(std::make_integer_sequence<int, kQMax>{}),
    lane_row<2, true>(std::make_integer_sequence<int, kQMax>{}),
    lane_row<4, true>(std::make_integer_sequence<int, kQMax>{}),
};

LaunchFn launch_fn(bool per_row, int q_len, int lanes) {
  for (size_t i = 0; i < kLaneCounts.size(); ++i) {
    if (kLaneCounts[i] == lanes) return (per_row ? kPerRow : kShared)[i][q_len - 1];
  }
  return nullptr;
}

}  // namespace

// Launches the row screen on `stream` with `lanes` lanes per row and chain
// (1, 2, or 4 in per-row mode; at most q_len); returns the cudaError_t of the launch (0 =
// cudaSuccess).  Exactly one of `query` (host array of q_len masks:
// shared-query mode, one chain) and `qrows` (device [2, n_rows, q_len]
// uint8: per-row mode, two chains) is given.  `tmasks` ([n_rows, ld]
// uint8, T <= ld columns used), `lengths` ([n_rows] int32), `best` ([C,
// n_rows] int32) and, when given together, `min_scores` ([n_rows] int32)
// and `ranges` ([C, 2, n_rows] int32) are device memory.
extern "C" int calitas_screen_rows_lanes(const void* tmasks, long long ld, int T, int n_rows,
                                         const void* lengths, const int* query,
                                         const void* qrows, int q_len,
                                         const void* min_scores, int match, int mismatch,
                                         int qgap, int tgap, void* best, void* ranges,
                                         void* stream, int lanes) {
  if (q_len < 1 || q_len > kQMax || n_rows < 1 || T < 0 || ld < T ||
      (query == nullptr) == (qrows == nullptr) ||
      (min_scores == nullptr) != (ranges == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LaunchFn fn = launch_fn(qrows != nullptr, q_len, lanes);
  Shift shift;
  if (fn == nullptr || !make_shift(q_len, mismatch, shift)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const uint8_t*>(tmasks), ld, T, n_rows,
         static_cast<const int*>(lengths), static_cast<const uint8_t*>(qrows), {},
         static_cast<const int*>(min_scores), match, mismatch, qgap, tgap, shift,
         static_cast<int*>(best), static_cast<int*>(ranges)};
  if (query != nullptr) {
    for (int i = 0; i < q_len; ++i) a.query[i] = static_cast<uint8_t>(query[i]);
  }
  return static_cast<int>(fn(a, static_cast<cudaStream_t>(stream)));
}

// The lanes per row calitas_screen_rows uses for `n_rows` rows of a
// `q_len`-base query, per row (per_row != 0) or shared; 0 if none.
extern "C" int calitas_screen_rows_default_lanes(int q_len, int n_rows, int per_row) {
  if (q_len < 1 || q_len > kQMax || n_rows < 0) return 0;
  return default_lanes(q_len, per_row != 0, n_rows);
}

// calitas_screen_rows_lanes with calitas_screen_rows_default_lanes' L.
extern "C" int calitas_screen_rows(const void* tmasks, long long ld, int T, int n_rows,
                                   const void* lengths, const int* query, const void* qrows,
                                   int q_len, const void* min_scores, int match,
                                   int mismatch, int qgap, int tgap, void* best,
                                   void* ranges, void* stream) {
  const int lanes = calitas_screen_rows_default_lanes(q_len, n_rows, qrows != nullptr);
  if (lanes == 0) return static_cast<int>(cudaErrorInvalidValue);
  return calitas_screen_rows_lanes(tmasks, ld, T, n_rows, lengths, query, qrows, q_len,
                                   min_scores, match, mismatch, qgap, tgap, best, ranges,
                                   stream, lanes);
}

extern "C" const char* calitas_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
