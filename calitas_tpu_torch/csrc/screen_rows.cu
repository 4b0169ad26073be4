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
// NEG_INF; the epilogue settles that tail without scanning it).
//
// What bounds it on the H100: integer instruction throughput.  A thread
// owns one row and keeps its chains' DP columns (Q+1 int32 each) in
// registers: the kernel is instantiated per query length (Q <= 48), so
// no column index is dynamic.  Each cell costs a bit test, a select and two add-then-max
// (Hopper's DPX __viaddmax_s32).  The query masks never enter the column
// loop as masks: they become four per-base position sets per chain (bit
// i of pos[c][k] = base k fits query row i; on the host for the shared
// query, in each thread's prologue for per-row queries), so a target
// column's compat bits are the OR of the sets of its bases, a few
// operations per column shared by Q cells, and a per-row query costs 4
// words of registers per chain instead of Q masks.  Each thread
// streams its own row bytes, one per column; neighbouring threads read
// addresses T bytes apart, so the loads are uncoalesced and lean on L1
// (one 128-byte line serves 128 columns).  A transposed or shared-memory
// tiled read is later work.  Rows end at their own lengths, so a ragged
// batch costs what its warps' longest rows cost.

#include <cuda_runtime.h>

#include <array>
#include <cstdint>
#include <type_traits>
#include <utility>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kQMax = 48;
constexpr int kThreads = 64;

struct Args {
  const uint8_t* tmasks;  // [B, ld] row-major, T columns used
  long long ld;
  int T;
  int n_rows;
  const int* lengths;      // [B]
  const uint8_t* qrows;    // per-row mode: [2, B, Q]; else null
  const int* min_scores;   // [B] or null (no ranges)
  int match;
  int mismatch;
  int qgap;
  int tgap;
  int* best;    // [C, B]
  int* ranges;  // [C, 2, B] or null
};

// The shared query rides in the kernel's parameter space as its four
// per-base position sets (bit i of pos[k] = base k fits query row i),
// built once on the host.
struct Query {
  unsigned long long pos[4];
};

__device__ __forceinline__ int add_max(int a, int b, int c) {
  return __viaddmax_s32(a, b, c);  // max(a + b, c)
}

template <int Q, bool kRowQuery>
__global__ void __launch_bounds__(kThreads)
    screen_rows_kernel(const Args a, const Query q) {
  constexpr int C = kRowQuery ? 2 : 1;
  using Bits = std::conditional_t<(Q <= 32), unsigned, unsigned long long>;
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= a.n_rows) return;

  Bits pos[C][4];
  if constexpr (kRowQuery) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint8_t* qrow = a.qrows + (static_cast<long long>(c) * a.n_rows + b) * Q;
#pragma unroll
      for (int k = 0; k < 4; ++k) pos[c][k] = 0;
#pragma unroll
      for (int i = 0; i < Q; ++i) {
        const int m = qrow[i];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if ((m >> k) & 1) pos[c][k] |= Bits(1) << i;
        }
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) pos[0][k] = static_cast<Bits>(q.pos[k]);
  }

  const int len = a.lengths[b];
  const int n_cols = len <= 0 ? 0 : (len < a.T ? len : a.T);
  const bool want_ranges = a.ranges != nullptr;
  const int ms = want_ranges ? a.min_scores[b] : 0;
  const uint8_t* row = a.tmasks + static_cast<long long>(b) * a.ld;

  int s[C][Q + 1];
  int best[C], mn[C], mx[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int i = 0; i <= Q; ++i) s[c][i] = i * a.tgap;
    best[c] = kNegInf;
    mn[c] = a.T + 1;
    mx[c] = 0;
  }

  for (int j = 1; j <= n_cols; ++j) {
    const int t = __ldg(row + (j - 1));
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const Bits bits = ((t & 1) ? pos[c][0] : Bits(0)) | ((t & 2) ? pos[c][1] : Bits(0)) |
                        ((t & 4) ? pos[c][2] : Bits(0)) | ((t & 8) ? pos[c][3] : Bits(0));
      int diag = s[c][0];
      s[c][0] = 0;
#pragma unroll
      for (int i = 1; i <= Q; ++i) {
        const int p = ((bits >> (i - 1)) & Bits(1)) ? a.match : a.mismatch;
        const int cur = add_max(s[c][i - 1], a.tgap, add_max(diag, p, s[c][i] + a.qgap));
        diag = s[c][i];
        s[c][i] = cur;
      }
      const int end = s[c][Q];
      best[c] = max(best[c], end);
      if (want_ranges && end >= ms) {
        mn[c] = min(mn[c], j);
        mx[c] = j;
      }
    }
  }

  const long long n = a.n_rows;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    // End columns n_cols+1..T are masked to NEG_INF.
    if (want_ranges && n_cols < a.T && kNegInf >= ms) {
      mn[c] = min(mn[c], n_cols + 1);
      mx[c] = a.T;
    }
    a.best[c * n + b] = best[c];
    if (want_ranges) {
      a.ranges[(2 * c) * n + b] = mn[c];
      a.ranges[(2 * c + 1) * n + b] = mx[c];
    }
  }
}

using LaunchFn = cudaError_t (*)(const Args&, const Query&, cudaStream_t);

template <int Q, bool kRowQuery>
cudaError_t launch(const Args& a, const Query& q, cudaStream_t stream) {
  const int blocks = (a.n_rows + kThreads - 1) / kThreads;
  screen_rows_kernel<Q, kRowQuery><<<blocks, kThreads, 0, stream>>>(a, q);
  return cudaGetLastError();
}

template <bool kRowQuery, int... I>
constexpr std::array<LaunchFn, sizeof...(I)> make_launch_table(
    std::integer_sequence<int, I...>) {
  return {&launch<I + 1, kRowQuery>...};
}

constexpr auto kLaunchShared =
    make_launch_table<false>(std::make_integer_sequence<int, kQMax>{});
constexpr auto kLaunchRows =
    make_launch_table<true>(std::make_integer_sequence<int, kQMax>{});

}  // namespace

// Launches the row screen on `stream`; returns the cudaError_t of the
// launch (0 = cudaSuccess).  Exactly one of `query` (host array of q_len
// masks: shared-query mode, one chain) and `qrows` (device [2, n_rows,
// q_len] uint8: per-row mode, two chains) is given.  `tmasks` ([n_rows,
// ld] uint8, T <= ld columns used), `lengths` ([n_rows] int32), `best`
// ([C, n_rows] int32) and, when given together, `min_scores` ([n_rows]
// int32) and `ranges` ([C, 2, n_rows] int32) are device memory.
extern "C" int calitas_screen_rows(const void* tmasks, long long ld, int T,
                                   int n_rows, const void* lengths,
                                   const int* query, const void* qrows,
                                   int q_len, const void* min_scores,
                                   int match, int mismatch, int qgap, int tgap,
                                   void* best, void* ranges, void* stream) {
  if (q_len < 1 || q_len > kQMax || n_rows < 1 || T < 0 || ld < T ||
      (query == nullptr) == (qrows == nullptr) ||
      (min_scores == nullptr) != (ranges == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const uint8_t*>(tmasks), ld, T, n_rows,
         static_cast<const int*>(lengths), static_cast<const uint8_t*>(qrows),
         static_cast<const int*>(min_scores), match, mismatch, qgap, tgap,
         static_cast<int*>(best), static_cast<int*>(ranges)};
  Query q{};
  if (query != nullptr) {
    for (int i = 0; i < q_len; ++i) {
      for (int k = 0; k < 4; ++k) {
        if ((query[i] >> k) & 1) q.pos[k] |= 1ull << i;
      }
    }
  }
  const auto& table = query != nullptr ? kLaunchShared : kLaunchRows;
  return static_cast<int>(table[q_len - 1](a, q, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* calitas_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
