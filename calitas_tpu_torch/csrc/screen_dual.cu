// Dual-chain glocal-DP genome screen for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel calitas_tpu/ops/dp_pallas2.py::_kernel2
// (wrapper _pallas_screen_dual), together with the window extraction and
// column packing that fed it on the TPU (genome_screen.py::
// extract_window_grid, dp_pallas2.py::pack_tcols_jax): each thread reads
// its own window straight out of the staged, PAM-annotated genome.
//
// Contract (bit-identical to calitas_tpu_torch/ops/dp_screen.py::
// screen_dual_reference).  Window w covers genome bytes
// [base0 + w*step, base0 + w*step + window); bytes at or past genome_len
// read as 0 (mask 0, both PAM gates closed), as the reference's zero
// padding does.  Per byte: bits 0-3 = IUPAC target mask, bit 4 = a chain-A
// alignment may END here, bit 5 = a chain-B alignment may START after it.
// Two chains per window over the same bytes: chain A = the DP query,
// chain B = its reverse complement (the strand trick: the genome is never
// reverse-complemented).  Exact int32 recurrence
//     S[0,j] = 0 (chain B with the gate: 0 if bit 5 else NEG_GATE, j >= 1)
//     S[i,0] = i*tgap
//     S[i,j] = max(S[i-1,j-1] + pair, S[i,j-1] + qgap, S[i-1,j] + tgap)
// with pair = match if (query_mask & target_mask) != 0 else mismatch.
// Outputs: best[c*n + w] = max over end columns j of S[Q,j] (chain A end
// columns with bit 4 clear count as NEG_INF when the gate is on);
// ranges[(2c+k)*n + w] = (k=0) min / (k=1) max 1-based end column whose
// score >= min_score, T+1 / 0 when none.
//
// What bounds it on the H100: integer issue, not memory.  Every DP cell
// costs about six int32 operations (mask AND, select, add, and two
// add-then-max, issued as Hopper's DPX __viaddmax_s32), so a column costs
// ~6*Q ops per chain, 12*Q for both, against one genome byte read.  The
// per-window state (2*(Q+1) int32, Q <= 48) lives in registers: the kernel
// is instantiated per query length so the column is never indexed
// dynamically and never spills.  Each thread streams its own window bytes,
// one byte per column; neighbouring threads read addresses `step` bytes
// apart, so loads are uncoalesced across the warp.  This simple version
// leaves that to the L1 cache (each thread's 128-byte line serves 128
// columns, and the bytes are ~1/(12*Q) of the instruction stream).
// Tensor cores (wgmma) do not apply: the recurrence is max-plus, not a
// multiply-accumulate.  Staging a block's contiguous genome span in shared
// memory, and folding the threshold, flag bit-pack and range coarsening
// into the epilogue, are left to later work.

#include <cuda_runtime.h>

#include <array>
#include <cstdint>
#include <utility>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kNegGate = -(1 << 26);
constexpr int kQMax = 48;
constexpr int kThreads = 128;

struct Args {
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
  int min_score;
  int pam_gate;
  int* best;
  int* ranges;
};

// Query masks travel in the kernel's parameter space: every thread reads
// the same element at a compile-time index, served by the constant bank.
struct Query {
  int fw[kQMax];
  int rc[kQMax];
};

__device__ __forceinline__ int add_max(int a, int b, int c) {
  return __viaddmax_s32(a, b, c);  // max(a + b, c)
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
    screen_dual_kernel(const Args a, const Query q) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= a.n_windows) return;
  const int T = a.window;
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
    int diag_f = sf[0];
    int diag_r = sr[0];
    sf[0] = 0;
    sr[0] = row0_r;
#pragma unroll
    for (int i = 1; i <= Q; ++i) {
      const int pf = (t & q.fw[i - 1]) ? a.match : a.mismatch;
      const int pr = (t & q.rc[i - 1]) ? a.match : a.mismatch;
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
    if (end_f >= a.min_score) {
      mn_f = min(mn_f, j);
      mx_f = j;
    }
    if (end_r >= a.min_score) {
      mn_r = min(mn_r, j);
      mx_r = j;
    }
  }
  const int n = a.n_windows;
  a.best[w] = best_f;
  a.best[n + w] = best_r;
  a.ranges[w] = mn_f;
  a.ranges[n + w] = mx_f;
  a.ranges[2 * n + w] = mn_r;
  a.ranges[3 * n + w] = mx_r;
}

using LaunchFn = cudaError_t (*)(const Args&, const Query&, cudaStream_t);

template <int Q>
cudaError_t launch(const Args& a, const Query& q, cudaStream_t stream) {
  const int blocks = (a.n_windows + kThreads - 1) / kThreads;
  screen_dual_kernel<Q><<<blocks, kThreads, 0, stream>>>(a, q);
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
// (0 = cudaSuccess).  `qvals` is a host array of 2*q_len masks: chain A's
// query then chain B's.  `best` is [2, n_windows] int32 and `ranges`
// [2, 2, n_windows] int32, both device memory.
extern "C" int calitas_screen_dual(const void* genome, long long genome_len,
                                   long long base0, long long step, int window,
                                   int n_windows, const int* qvals, int q_len,
                                   int match, int mismatch, int qgap, int tgap,
                                   int min_score, int pam_gate, void* best,
                                   void* ranges, void* stream) {
  if (q_len < 1 || q_len > kQMax || window < 1 || n_windows < 1 || step < 1 ||
      base0 < 0 || genome_len < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const uint8_t*>(genome), genome_len, base0, step, window,
         n_windows, match, mismatch, qgap, tgap, min_score, pam_gate,
         static_cast<int*>(best), static_cast<int*>(ranges)};
  Query q{};
  for (int i = 0; i < q_len; ++i) {
    q.fw[i] = qvals[i];
    q.rc[i] = qvals[q_len + i];
  }
  return static_cast<int>(kLaunch[q_len - 1](a, q, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* calitas_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
