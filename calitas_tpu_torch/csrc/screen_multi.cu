// Multi-guide dual-chain glocal-DP genome screen for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel calitas_tpu/ops/dp_pallas2.py::_kernel_multi
// (wrapper _pallas_screen_multi).  It computes screen_dual.cu's contract for
// G guides of one query length over one window grid, each guide against its
// own min score.  The same kernel serves the variant pass's slot batches: a
// [B, T] batch, flattened, is the grid base0 = 0, step = T, window = T with
// the gate off.
//
// Contract (bit-identical to calitas_tpu_torch/ops/dp_screen.py::
// screen_multi_reference).  Window w covers genome bytes
// [base0 + w*step, base0 + w*step + window); bytes at or past genome_len
// read as 0.  Per byte: bits 0-3 = IUPAC target mask, bit 4 = a chain-A
// alignment may END here, bit 5 = a chain-B alignment may START after it.
// Guide g has two chains over the same bytes: chain A = its DP query,
// chain B = the query's reverse complement.  Exact int32 recurrence
//     S[0,j] = 0 (chain B with the gate: 0 if bit 5 else NEG_GATE, j >= 1)
//     S[i,0] = i*tgap
//     S[i,j] = max(S[i-1,j-1] + pair, S[i,j-1] + qgap, S[i-1,j] + tgap)
// with pair = match if (query_mask & target_mask) != 0 else mismatch.
// Outputs, for c in {A, B}: best[(2g+c)*n + w] = max over end columns j of
// S[Q,j] (chain-A end columns with bit 4 clear are NEG_INF under the gate);
// when `ranges` is given, ranges[((2g+c)*2+k)*n + w] = (k=0) min / (k=1)
// max 1-based end column whose score >= min_scores[g], T+1 / 0 when none.
//
// What bounds it on the H100: integer issue.  Each DP cell costs about six
// int32 operations per chain (pair select from a bit mask, add, and two
// add-then-max issued as Hopper's DPX __viaddmax_s32), so a window costs
// G x 2 chains x ~6*Q ops per genome byte it reads.  The launch has one
// thread per (window, guide): windows on blockIdx.x, the guide on
// blockIdx.y.  The Q+1 column state lives in registers (the kernel is
// instantiated per query length, Q <= 48, so it is never indexed
// dynamically).  Query masks arrive in device memory as [G, 2, Q] int32,
// so no guide count is capped by the parameter space; each block turns
// its guide's masks into a table in shared memory, compat[c][t] = bit i
// set when (q[c][i] & t) != 0, and a thread reads one 64-bit word per
// chain per column, never per cell.  The window bytes are read G times,
// once by each guide's thread, through L1/L2 rather than once from shared
// memory: on the TPU the window block stayed resident in VMEM across the
// guide grid axis.  Staging a block's genome span in shared memory for
// every guide, and folding threshold, bit-pack and range coarsening into
// the epilogue, are left to later work.

#include <cuda_runtime.h>

#include <array>
#include <cstdint>
#include <utility>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kNegGate = -(1 << 26);
constexpr int kQMax = 48;
constexpr int kThreads = 128;
constexpr int kMaxGuides = 65535;  // gridDim.y

struct Args {
  const uint8_t* genome;
  long long genome_len;
  long long base0;
  long long step;
  int window;
  int n_windows;
  const int* qvals;       // [G, 2, Q]
  const int* min_scores;  // [G]
  int match;
  int mismatch;
  int qgap;
  int tgap;
  int pam_gate;
  int* best;    // [G, 2, n]
  int* ranges;  // [G, 2, 2, n] or null
};

__device__ __forceinline__ int add_max(int a, int b, int c) {
  return __viaddmax_s32(a, b, c);  // max(a + b, c)
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
    screen_multi_kernel(const Args a) {
  __shared__ unsigned long long compat[2][16];
  const int g = blockIdx.y;
  if (threadIdx.x < 32) {
    const int c = threadIdx.x >> 4;
    const int t = threadIdx.x & 15;
    const int* q = a.qvals + (2 * g + c) * Q;
    unsigned long long bits = 0;
    for (int i = 0; i < Q; ++i) {
      if (q[i] & t) bits |= 1ull << i;
    }
    compat[c][t] = bits;
  }
  __syncthreads();

  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= a.n_windows) return;
  const int T = a.window;
  const int ms = a.min_scores[g];
  const long long start = a.base0 + static_cast<long long>(w) * a.step;
  const long long avail = a.genome_len - start;
  const int t_in = avail <= 0 ? 0 : (avail < T ? static_cast<int>(avail) : T);
  const uint8_t* src = a.genome + (t_in > 0 ? start : 0);

  int sf[Q + 1];
  int sr[Q + 1];
#pragma unroll
  for (int i = 0; i <= Q; ++i) {
    sf[i] = i * a.tgap;
    sr[i] = i * a.tgap;
  }
  int best_f = kNegInf, best_r = kNegInf;
  int mn_f = T + 1, mx_f = 0, mn_r = T + 1, mx_r = 0;

  for (int j = 1; j <= T; ++j) {
    const int raw = j <= t_in ? static_cast<int>(__ldg(src + (j - 1))) : 0;
    const int t = raw & 15;
    bool end_ok = true;
    int row0_r = 0;
    if (a.pam_gate) {
      end_ok = (raw & 16) != 0;
      row0_r = (raw & 32) ? 0 : kNegGate;
    }
    const unsigned long long bf = compat[0][t];
    const unsigned long long br = compat[1][t];
    int diag_f = sf[0];
    int diag_r = sr[0];
    sf[0] = 0;
    sr[0] = row0_r;
#pragma unroll
    for (int i = 1; i <= Q; ++i) {
      const int pf = ((bf >> (i - 1)) & 1ull) ? a.match : a.mismatch;
      const int pr = ((br >> (i - 1)) & 1ull) ? a.match : a.mismatch;
      const int cf = add_max(sf[i - 1], a.tgap, add_max(diag_f, pf, sf[i] + a.qgap));
      const int cr = add_max(sr[i - 1], a.tgap, add_max(diag_r, pr, sr[i] + a.qgap));
      diag_f = sf[i];
      diag_r = sr[i];
      sf[i] = cf;
      sr[i] = cr;
    }
    const int end_f = end_ok ? sf[Q] : kNegInf;
    const int end_r = sr[Q];
    best_f = max(best_f, end_f);
    best_r = max(best_r, end_r);
    if (end_f >= ms) {
      mn_f = min(mn_f, j);
      mx_f = j;
    }
    if (end_r >= ms) {
      mn_r = min(mn_r, j);
      mx_r = j;
    }
  }
  const long long n = a.n_windows;
  const long long row = 2LL * g;  // chain A's row; chain B's is row + 1
  a.best[row * n + w] = best_f;
  a.best[(row + 1) * n + w] = best_r;
  if (a.ranges != nullptr) {
    a.ranges[(2 * row) * n + w] = mn_f;
    a.ranges[(2 * row + 1) * n + w] = mx_f;
    a.ranges[(2 * row + 2) * n + w] = mn_r;
    a.ranges[(2 * row + 3) * n + w] = mx_r;
  }
}

using LaunchFn = cudaError_t (*)(const Args&, int, cudaStream_t);

template <int Q>
cudaError_t launch(const Args& a, int n_guides, cudaStream_t stream) {
  const dim3 grid((a.n_windows + kThreads - 1) / kThreads, n_guides);
  screen_multi_kernel<Q><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int... I>
constexpr std::array<LaunchFn, sizeof...(I)> make_launch_table(
    std::integer_sequence<int, I...>) {
  return {&launch<I + 1>...};
}

constexpr auto kLaunch = make_launch_table(std::make_integer_sequence<int, kQMax>{});

}  // namespace

// Launches the screen on `stream`; returns the cudaError_t of the launch
// (0 = cudaSuccess).  `qvals` ([n_guides, 2, q_len] int32), `min_scores`
// ([n_guides] int32), `best` ([n_guides, 2, n_windows] int32) and `ranges`
// ([n_guides, 2, 2, n_windows] int32, or null for none) are device memory.
extern "C" int calitas_screen_multi(const void* genome, long long genome_len,
                                    long long base0, long long step, int window,
                                    int n_windows, const void* qvals, int q_len,
                                    int n_guides, const void* min_scores,
                                    int match, int mismatch, int qgap, int tgap,
                                    int pam_gate, void* best, void* ranges,
                                    void* stream) {
  if (q_len < 1 || q_len > kQMax || window < 1 || n_windows < 1 || step < 1 ||
      base0 < 0 || genome_len < 0 || n_guides < 1 || n_guides > kMaxGuides) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const uint8_t*>(genome), genome_len, base0, step, window,
         n_windows, static_cast<const int*>(qvals),
         static_cast<const int*>(min_scores), match, mismatch, qgap, tgap,
         pam_gate, static_cast<int*>(best), static_cast<int*>(ranges)};
  return static_cast<int>(
      kLaunch[q_len - 1](a, n_guides, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* calitas_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
