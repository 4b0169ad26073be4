// Multi-guide dual-chain glocal-DP genome screen for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel calitas_tpu/ops/dp_pallas2.py::_kernel_multi
// (wrapper _pallas_screen_multi).  It computes screen_dual.cu's contract for
// G guides of one query length over one window grid, each guide against its
// own min score.  The same kernel serves the variant pass's slot batches: a
// [B, T] batch, flattened, is the grid base0 = 0, step = T, window = T with
// the gate off and no ranges.
//
// Contract (bit-identical to calitas_tpu_torch/ops/dp_screen.py::
// screen_multi_reference): dp_lane.cuh's recurrence over the window grid
// of Grid, guide g's chains A and B from qvals[g].  Outputs, for c in
// {A, B}: best[(2g+c)*n + w] = max over end columns j of S[Q,j] (chain-A
// end columns with bit 4 clear are NEG_INF under the gate); when `ranges`
// is given, ranges[((2g+c)*2+k)*n + w] = (k=0) min / (k=1) max 1-based end
// column whose score >= min_scores[g], T+1 / 0 when none.
//
// What bounds it on the H100: integer issue, as for screen_dual: two int32
// operations (one add, one max) per DP cell, G x 2 chains x Q cells per
// window column; the genome bytes, read once per guide through L1/L2, are
// far below that.  The design is dp_lane.cuh's, which took screen_dual
// from about 12.8 to 3.99 SASS instructions per cell and chain: L lanes
// per window as a wavefront, per cell a bit test, a predicated add and two
// DPX add+max on state kept as S - i*mismatch, alternating register sets,
// bytes loaded a round ahead, 64-thread blocks.  What differs from
// screen_dual:
// - The guide is on blockIdx.y and each block builds its guide's per-lane
//   match-bit table (L x 16 entries) in shared memory from the device
//   masks [G, 2, Q]: G goes up to 65,535, past what a grid-constant table
//   could carry.
// - Each guide's threshold is its own min score in S' units, clamped to
//   int32 in the kernel.
// - `ranges` may be null (slot mode): the loop keeps the end columns
//   either way and only the epilogue tests the pointer.
// - The launcher picks L from the query length, the number of (window,
//   guide) pairs and whether the launch is a slot batch (kLaneRows):
//   config3's grid at G 4 has 164,952 pairs, a variant slot batch 8,192
//   per guide, where one thread per window leaves most SMs with one or
//   two warps and L 2 or 4 wins from Q 7 on.
//
// calitas_screen_multi_lanes launches a given L, for measurement.

#include <cuda_runtime.h>

#include <array>
#include <climits>
#include <cstdint>
#include <utility>

#include "dp_lane.cuh"

namespace {

using namespace dp_lane;

constexpr int kMaxGuides = 65535;  // gridDim.y

// The launcher's lanes per window.  A launch is a slot batch (no ranges:
// the variant pass) or a genome grid (ranges: the reference pass); its row
// is the first of its kind whose bound its (window, guide) pair count is
// below, else kManyPairs, and L = lanes[Q - 1].  Each row holds, at each
// Q, the L whose time at the shapes named came nearest the fastest in the
// worst of several runs of chip_smoke.py phase 5's sweep.  At equal pairs
// a slot batch takes fewer lanes than a genome grid: 32,768 slot pairs
// keep L 1 up to Q 32 at every slot width from 64 to 512, where
// config5s's 41,240 take L 2 from Q 22.
struct LaneRow {
  bool slots;         // a slot batch, else a genome grid
  long long below;    // fewer (window, guide) pairs than this
  const char* lanes;  // one digit per Q from 1 to 48
};
constexpr LaneRow kLaneRows[] = {
    // Slot batches of one guide, 8,192 rows of 64 to 512 columns.
    {true, 16384, "111111222222224444424244424442444444444444444444"},
    // Slot batches of two guides, 8,192 rows of 64 columns; at Q 14 the
    // even L 2 split beats L 1.
    {true, 32768, "111111111111121111222222222222222222222222222222"},
    // A 2 Mb contig's 2,000 windows of 1000 columns at G 4.
    {false, 16384, "111122422244444444444244444442444444444444444444"},
    // config5s's grid at G 2 (20,620 pairs); at Q 11-19 an L 2 split of
    // an odd Q loses to L 1.
    {false, 32768, "111111111212121212142222222222222222224444444444"},
    // config5s's grid at G 4 (41,240 pairs); at Q 23 and 25, as at Q 21,
    // L 1 beats the uneven L 2 split.
    {false, 65536, "111111111111111111111212122222222222222222222222"},
};
// config3's grid at G 4 (164,952 pairs), config5s's at G 8 (82,480), slot
// batches of four guides (32,768), and every larger launch.
constexpr const char* kManyPairs = "111111111111111111111111111111112222222222222222";

int default_lanes(int q_len, bool slots, long long pairs) {
  for (const LaneRow& r : kLaneRows) {
    if (r.slots == slots && pairs < r.below) return r.lanes[q_len - 1] - '0';
  }
  return kManyPairs[q_len - 1] - '0';
}

struct Args {
  Grid g;
  const int* qvals;       // [G, 2, Q]
  const int* min_scores;  // [G]
  // S'[Q,j] = S[Q,j] - Q*mismatch (dp_lane.cuh), and the gated end in S'.
  Shift shift;
  int* best;    // [G, 2, n]
  int* ranges;  // [G, 2, 2, n] or null
};

// Guide g's outputs for window w from its row-Q lane.
__device__ __forceinline__ void store(const Args& a, int g, int w, int best_f, int best_r,
                                      int mn_f, int mx_f, int mn_r, int mx_r) {
  const long long n = a.g.n_windows;
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

template <int Q, int L>
__global__ void __launch_bounds__(kThreads, 1) screen_multi_kernel(const Args a) {
  using S = Split<Q, L>;
  using Bits = typename S::Bits;
  __shared__ Compat<Bits> compat[L][16];
  const int g = blockIdx.y;
  const int* q = a.qvals + 2 * Q * g;
  for (int i = threadIdx.x; i < L * 16; i += kThreads) {
    compat[i / 16][i % 16] = compat_entry<Q, L>(q, q + Q, i / 16, i % 16);
  }
  __syncthreads();

  Lane<Q, L> x;
  const int k = L == 1 ? 0 : static_cast<int>(threadIdx.x % L);
  const int w = blockIdx.x * S::kWindows + static_cast<int>(threadIdx.x / L);
  const bool live = w < a.g.n_windows;
  x.start(a.g, w, live, k, compat[k], a.shift.neg_end,
          shifted_threshold(__ldg(a.min_scores + g), a.shift.end_shift));
  x.sweep();

  if (!live || k != S::kLast) return;
  const int shift = a.shift.end_shift;
  store(a, g, w, x.best_f + shift, x.best_r + shift, x.mn_f, x.mx_f, x.mn_r, x.mx_r);
}

using LaunchFn = cudaError_t (*)(const Args&, int, cudaStream_t);

template <int Q, int L>
cudaError_t launch(const Args& a, int n_guides, cudaStream_t stream) {
  using S = Split<Q, L>;
  const dim3 grid((a.g.n_windows + S::kWindows - 1) / S::kWindows, n_guides);
  screen_multi_kernel<Q, L><<<grid, kThreads, 0, stream>>>(a);
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

// The lane counts the library is built for: kLaneCounts[i], kByLanes[i][Q - 1].
constexpr std::array<int, 3> kLaneCounts = {1, 2, 4};
constexpr std::array<std::array<LaunchFn, kQMax>, 3> kByLanes = {
    lane_row<1>(std::make_integer_sequence<int, kQMax>{}),
    lane_row<2>(std::make_integer_sequence<int, kQMax>{}),
    lane_row<4>(std::make_integer_sequence<int, kQMax>{}),
};

LaunchFn launch_fn(int q_len, int lanes) {
  for (size_t i = 0; i < kLaneCounts.size(); ++i) {
    if (kLaneCounts[i] == lanes) return kByLanes[i][q_len - 1];
  }
  return nullptr;
}

}  // namespace

// Launches the screen on `stream` with `lanes` lanes per window (1, 2 or 4,
// at most q_len); returns the cudaError_t of the launch (0 = cudaSuccess).
// `qvals` ([n_guides, 2, q_len] int32), `min_scores` ([n_guides] int32),
// `best` ([n_guides, 2, n_windows] int32) and `ranges` ([n_guides, 2, 2,
// n_windows] int32, or null for none) are device memory.
extern "C" int calitas_screen_multi_lanes(const void* genome, long long genome_len,
                                          long long base0, long long step, int window,
                                          int n_windows, const void* qvals, int q_len,
                                          int n_guides, const void* min_scores,
                                          int match, int mismatch, int qgap, int tgap,
                                          int pam_gate, void* best, void* ranges,
                                          void* stream, int lanes) {
  if (q_len < 1 || q_len > kQMax || window < 1 || n_windows < 1 || step < 1 ||
      base0 < 0 || genome_len < 0 || n_guides < 1 || n_guides > kMaxGuides) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LaunchFn fn = launch_fn(q_len, lanes);
  Shift shift;
  if (fn == nullptr || !make_shift(q_len, mismatch, shift)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{Grid{static_cast<const uint8_t*>(genome), genome_len, base0, step, window, n_windows,
              match, mismatch, qgap, tgap, pam_gate},
         static_cast<const int*>(qvals), static_cast<const int*>(min_scores), shift,
         static_cast<int*>(best), static_cast<int*>(ranges)};
  return static_cast<int>(fn(a, n_guides, static_cast<cudaStream_t>(stream)));
}

// The lanes per window calitas_screen_multi uses for `n_guides` guides of
// `q_len` bases over `n_windows` windows, with ranges (a genome grid) or
// without (a slot batch); 0 if none.
extern "C" int calitas_screen_multi_default_lanes(int q_len, int n_windows, int n_guides,
                                                  int ranges) {
  if (q_len < 1 || q_len > kQMax || n_windows < 0 || n_guides < 0) return 0;
  return default_lanes(q_len, ranges == 0, static_cast<long long>(n_windows) * n_guides);
}

// calitas_screen_multi_lanes with calitas_screen_multi_default_lanes' L.
extern "C" int calitas_screen_multi(const void* genome, long long genome_len,
                                    long long base0, long long step, int window,
                                    int n_windows, const void* qvals, int q_len,
                                    int n_guides, const void* min_scores,
                                    int match, int mismatch, int qgap, int tgap,
                                    int pam_gate, void* best, void* ranges,
                                    void* stream) {
  const int lanes =
      calitas_screen_multi_default_lanes(q_len, n_windows, n_guides, ranges != nullptr);
  if (lanes == 0) return static_cast<int>(cudaErrorInvalidValue);
  return calitas_screen_multi_lanes(genome, genome_len, base0, step, window, n_windows,
                                    qvals, q_len, n_guides, min_scores, match, mismatch,
                                    qgap, tgap, pam_gate, best, ranges, stream, lanes);
}

extern "C" const char* calitas_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
