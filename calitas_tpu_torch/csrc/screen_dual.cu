// Dual-chain glocal-DP genome screen for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel calitas_tpu/ops/dp_pallas2.py::_kernel2
// (wrapper _pallas_screen_dual), together with the window extraction and
// column packing that fed it on the TPU (genome_screen.py::
// extract_window_grid, dp_pallas2.py::pack_tcols_jax): each window's lanes
// read its bytes straight out of the staged, PAM-annotated genome.
//
// Contract (bit-identical to calitas_tpu_torch/ops/dp_screen.py::
// screen_dual_reference): dp_lane.cuh's recurrence over the window grid
// of Grid.  Outputs: best[c*n + w] = max over end columns j of S[Q,j]
// (chain A end columns with bit 4 clear count as NEG_INF when the gate is
// on); ranges[(2c+k)*n + w] = (k=0) min / (k=1) max 1-based end column
// whose score >= min_score, T+1 / 0 when none.
//
// What bounds it on the H100: integer instructions, not memory.  The
// bound counts two int32 operations (one add, one max) per DP cell; a
// genome byte read once serves 2*Q cells of each window that covers it.
// The first design (one thread per window, 128-thread blocks) put
// config3's 41,238 windows, and a 1 Gb segment's ~64,500, on 10-16
// resident warps per SM out of 64,
// with only a window's two chains to hide each dependent add+max (inside
// a column S[i,j] needs the new S[i-1,j]), and it spent about six
// instructions per cell beside that: a mask AND, compare and select for
// the pair, an add, two DPX __viaddmax_s32, and register moves.
//
// The design, against both, is dp_lane.cuh's: L lanes per window as a
// wavefront, and per cell a bit test, a predicated add and two DPX
// add+max on state kept as S - i*mismatch.  Each block's per-lane
// match-bit table is built on the host and passed as a grid constant.
// The launcher picks L per query length from kLanes: the faster of L 1
// and 2 that chip_smoke.py phase 3 measures at each Q;
// calitas_screen_dual_lanes launches either for that measurement.  The
// library is built for those two only: at L 4 and 8 the per-step
// overhead outweighed the extra warps at every query length measured,
// and they more than doubled the build time.
//
// No shared-memory staging of the window bytes: on the main path the step
// is window - (guide + diffs + gaps - 1) = 970 of 1000 columns, so
// neighbouring windows share 3 % of their bytes and a block's span buys
// no reuse; the ~40 MB read once per contig costs ~0.012 ms against the
// ~0.1 ms operation bound.  Each lane reads its column's byte through L1
// (the L lanes of a window hit one line).  Tensor cores (wgmma) do not
// apply: the recurrence is max-plus, not a multiply-accumulate.  Folding
// threshold, flag bit-pack and range coarsening into the epilogue is left
// to later work.

#include <cuda_runtime.h>

#include <array>
#include <cstdint>
#include <utility>

#include "dp_lane.cuh"

namespace {

using namespace dp_lane;

// Lanes per window the launcher uses for each query length (index Q - 1):
// the faster L of chip_smoke.py phase 3's timings at that Q.
constexpr int kLanes[kQMax] = {
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  // Q 1-16
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  // Q 17-32
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,  // Q 33-48
};

struct Args {
  Grid g;
  // The kernel keeps S'[i,j] = S[i,j] - i*mismatch (dp_lane.cuh): a
  // diagonal step adds 0 or match - mismatch, a vertical one tgap -
  // mismatch, and S[Q,j] = S'[Q,j] + Q*mismatch.
  Shift shift;
  int min_score;  // min_score - Q*mismatch, clamped to int32
  int* best;
  int* ranges;
};

template <typename Bits, int L>
struct Table {
  Compat<Bits> c[L][16];
};

template <int Q, int L>
__global__ void __launch_bounds__(kThreads, 1)
    screen_dual_kernel(const Args a,
                       const __grid_constant__ Table<typename Split<Q, L>::Bits, L> tbl) {
  using S = Split<Q, L>;
  using Bits = typename S::Bits;
  __shared__ Compat<Bits> compat[L][16];
  for (int i = threadIdx.x; i < L * 16; i += kThreads) {
    compat[i / 16][i % 16] = tbl.c[i / 16][i % 16];
  }
  __syncthreads();

  Lane<Q, L> x;
  const int k = L == 1 ? 0 : static_cast<int>(threadIdx.x % L);
  const int w = blockIdx.x * S::kWindows + static_cast<int>(threadIdx.x / L);
  const bool live = w < a.g.n_windows;
  x.start(a.g, w, live, k, compat[k], a.shift.neg_end, a.min_score);
  x.sweep();

  if (!live || k != S::kLast) return;
  const int n = a.g.n_windows;
  a.best[w] = x.best_f + a.shift.end_shift;
  a.best[n + w] = x.best_r + a.shift.end_shift;
  a.ranges[w] = x.mn_f;
  a.ranges[n + w] = x.mx_f;
  a.ranges[2 * n + w] = x.mn_r;
  a.ranges[3 * n + w] = x.mx_r;
}

using LaunchFn = cudaError_t (*)(const Args&, const int*, cudaStream_t);

// Builds the lanes' match-bit table from the host masks (chain A's Q, then
// chain B's) and launches one block per kWindows windows.
template <int Q, int L>
cudaError_t launch(const Args& a, const int* qvals, cudaStream_t stream) {
  using S = Split<Q, L>;
  Table<typename S::Bits, L> tbl{};
  for (int k = 0; k < L; ++k) {
    for (int t = 0; t < 16; ++t) tbl.c[k][t] = compat_entry<Q, L>(qvals, qvals + Q, k, t);
  }
  const int blocks = (a.g.n_windows + S::kWindows - 1) / S::kWindows;
  screen_dual_kernel<Q, L><<<blocks, kThreads, 0, stream>>>(a, tbl);
  return cudaGetLastError();
}

template <int Q, int L>
constexpr LaunchFn launch_if_fits() {
  if constexpr (L <= Q) {
    return &launch<Q, L>;
  } else {
    return nullptr;
  }
}

template <int L, int... I>
constexpr std::array<LaunchFn, kQMax> lane_row(std::integer_sequence<int, I...>) {
  return {launch_if_fits<I + 1, L>()...};
}

// The lane counts the library is built for: kByLanes[L - 1][Q - 1].
constexpr std::array<std::array<LaunchFn, kQMax>, 2> kByLanes = {
    lane_row<1>(std::make_integer_sequence<int, kQMax>{}),
    lane_row<2>(std::make_integer_sequence<int, kQMax>{}),
};

int run(const void* genome, long long genome_len, long long base0, long long step,
        int window, int n_windows, const int* qvals, int q_len, int match,
        int mismatch, int qgap, int tgap, int min_score, int pam_gate, void* best,
        void* ranges, void* stream, int lanes) {
  if (q_len < 1 || q_len > kQMax || window < 1 || n_windows < 1 || step < 1 ||
      base0 < 0 || genome_len < 0 || lanes < 1 || lanes > static_cast<int>(kByLanes.size())) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LaunchFn fn = kByLanes[lanes - 1][q_len - 1];
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  Shift shift;
  if (!make_shift(q_len, mismatch, shift)) return static_cast<int>(cudaErrorInvalidValue);
  Args a{Grid{static_cast<const uint8_t*>(genome), genome_len, base0, step, window, n_windows,
              match, mismatch, qgap, tgap, pam_gate},
         shift, shifted_threshold(min_score, shift.end_shift), static_cast<int*>(best),
         static_cast<int*>(ranges)};
  return static_cast<int>(fn(a, qvals, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// Launches the screen on `stream` with kLanes[q_len - 1] lanes per window;
// returns the cudaError_t of the launch (0 = cudaSuccess).  `qvals` is a
// host array of 2*q_len masks: chain A's query then chain B's.  `best` is
// [2, n_windows] int32 and `ranges` [2, 2, n_windows] int32, both device
// memory.
extern "C" int calitas_screen_dual(const void* genome, long long genome_len,
                                   long long base0, long long step, int window,
                                   int n_windows, const int* qvals, int q_len,
                                   int match, int mismatch, int qgap, int tgap,
                                   int min_score, int pam_gate, void* best,
                                   void* ranges, void* stream) {
  const int lanes = q_len >= 1 && q_len <= kQMax ? kLanes[q_len - 1] : 1;
  return run(genome, genome_len, base0, step, window, n_windows, qvals, q_len, match,
             mismatch, qgap, tgap, min_score, pam_gate, best, ranges, stream, lanes);
}

// calitas_screen_dual with an explicit lane count (1 or 2, at most q_len),
// for timing and checking each.
extern "C" int calitas_screen_dual_lanes(const void* genome, long long genome_len,
                                         long long base0, long long step, int window,
                                         int n_windows, const int* qvals, int q_len,
                                         int match, int mismatch, int qgap, int tgap,
                                         int min_score, int pam_gate, void* best,
                                         void* ranges, void* stream, int lanes) {
  return run(genome, genome_len, base0, step, window, n_windows, qvals, q_len, match,
             mismatch, qgap, tgap, min_score, pam_gate, best, ranges, stream, lanes);
}

// The lanes per window calitas_screen_dual uses for `q_len` (0 if none).
extern "C" int calitas_screen_dual_default_lanes(int q_len) {
  return q_len >= 1 && q_len <= kQMax ? kLanes[q_len - 1] : 0;
}

extern "C" const char* calitas_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
