// Dual-chain glocal-DP genome screen for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel calitas_tpu/ops/dp_pallas2.py::_kernel2
// (wrapper _pallas_screen_dual), together with the window extraction and
// column packing that fed it on the TPU (genome_screen.py::
// extract_window_grid, dp_pallas2.py::pack_tcols_jax): each window's lanes
// read its bytes straight out of the staged, PAM-annotated genome.
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
// The design, against both:
// - L lanes of one warp share a window as a wavefront (L divides 32;
//   L = 1 is the first design's shape).  Lane k owns rows
//   [k*R + 1, min((k+1)*R, Q)] of both chains, R = ceil(Q/L); at step s it
//   works on column j = s - k and takes its top boundary (row k*R of
//   column j) from lane k-1's bottom row of the step before by
//   __shfl_up_sync with width L.  All lanes run all T + L - 1 steps, so
//   every shuffle has the full warp; a lane off its columns, or a window
//   past n_windows, only skips its work and its stores.  L multiplies the
//   warps in flight by L; each step costs every lane the shuffles, the
//   byte, the table read and the end-column bookkeeping, so a larger L
//   spends more instructions per cell.  The lane that holds row Q keeps
//   best/min/max and writes the outputs.
// - Per cell, per chain: one bit test, one predicated add and two DPX
//   add+max.  Each block holds, per lane and target code t, the bit set
//   {r : q[k*R + r] & t} of both chains (built on the host, one shared
//   load per column).  The state is kept as S'[i,j] = S[i,j] -
//   i*mismatch, so a diagonal step adds 0 or match - mismatch and needs
//   no select.  Two register sets alternate by column, so no cell moves
//   its result, and the column bytes are loaded one round of four steps
//   ahead.
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
#include <type_traits>
#include <utility>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kNegGate = -(1 << 26);
constexpr int kQMax = 48;
constexpr int kThreads = 64;  // small blocks: config3 fills 132 SMs evenly at every L
constexpr unsigned kFullMask = 0xffffffffu;

// Lanes per window the launcher uses for each query length (index Q - 1):
// the faster L of chip_smoke.py phase 3's timings at that Q.
constexpr int kLanes[kQMax] = {
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  // Q 1-16
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,  // Q 17-32
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,  // Q 33-48
};

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
  int pam_gate;
  // The kernel keeps S'[i,j] = S[i,j] - i*mismatch (launch() fills these):
  // a diagonal step then adds 0 or match - mismatch, a vertical one
  // tgap - mismatch, and S[Q,j] = S'[Q,j] + Q*mismatch.
  int end_shift;  // Q*mismatch
  int min_score;  // min_score - Q*mismatch, clamped to int32
  int neg_end;    // NEG_INF - Q*mismatch: a gated end column
  int* best;
  int* ranges;
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

template <typename Bits, int L>
struct Table {
  Compat<Bits> c[L][16];
};

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

// One thread's share of a window: its lane's rows of both chains, in two
// register sets that alternate by column (no copies between columns), and
// the end-column state its window keeps if it holds row Q.
template <int Q, int L>
struct Lane {
  using S = Split<Q, L>;
  using Bits = typename S::Bits;
  static constexpr int R = S::R;

  int f[2][R + 1];
  int r[2][R + 1];
  int best_f, best_r, mn_f, mx_f, mn_r, mx_r;
  int k, T, t_in, delta, qgap, tgap, open, neg_end, min_score;
  const uint8_t* src;
  const Compat<Bits>* tbl;

  // The byte of step s's column, 0 past the window's bytes or off its
  // columns (one unsigned compare covers both ends).
  __device__ __forceinline__ int load(int s) const {
    const int j = s - k;
    return static_cast<unsigned>(j - 1) < static_cast<unsigned>(t_in)
               ? static_cast<int>(__ldg(src + (j - 1)))
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
      top_r = __shfl_up_sync(kFullMask, r[P][R], 1, L);
    }
    const int gm = raw | open;  // gate bits read as open without the gate
    if (k == 0) {  // the glocal row 0
      top_f = 0;
      top_r = gm & 32 ? 0 : kNegGate;
    }
    if (kGuard && !on) return;
    const Compat<Bits> cb = tbl[raw & 15];
    column<R>(f[P], f[1 - P], top_f, cb.f, delta, qgap, tgap);
    column<R>(r[P], r[1 - P], top_r, cb.r, delta, qgap, tgap);
    // Row Q's lane keeps the window's end-column state; the others'
    // copies are never stored.
    keep_end(gm & 16 ? f[1 - P][S::rLast] : neg_end, j, min_score, best_f, mn_f, mx_f);
    keep_end(r[1 - P][S::rLast], j, min_score, best_r, mn_r, mx_r);
    if constexpr (kCopy) {
#pragma unroll
      for (int i = 0; i <= R; ++i) {
        f[P][i] = f[1 - P][i];
        r[P][i] = r[1 - P][i];
      }
    }
  }
};

template <int Q, int L>
__global__ void __launch_bounds__(kThreads, 1)
    screen_dual_kernel(const Args a,
                       const __grid_constant__ Table<typename Split<Q, L>::Bits, L> tbl) {
  using S = Split<Q, L>;
  using Bits = typename S::Bits;
  constexpr int R = S::R;
  __shared__ Compat<Bits> compat[L][16];
  for (int i = threadIdx.x; i < L * 16; i += kThreads) {
    compat[i / 16][i % 16] = tbl.c[i / 16][i % 16];
  }
  __syncthreads();

  Lane<Q, L> x;
  x.k = L == 1 ? 0 : static_cast<int>(threadIdx.x % L);
  const int w = blockIdx.x * S::kWindows + static_cast<int>(threadIdx.x / L);
  const bool live = w < a.n_windows;
  const int T = a.window;
  const long long start = a.base0 + static_cast<long long>(w) * a.step;
  const long long avail = a.genome_len - start;
  x.T = T;
  x.t_in = !live || avail <= 0 ? 0 : (avail < T ? static_cast<int>(avail) : T);
  x.src = a.genome + (x.t_in > 0 ? start : 0);
  x.tbl = compat[x.k];
  x.delta = a.match - a.mismatch;
  x.qgap = a.qgap;
  x.tgap = a.tgap - a.mismatch;
  x.open = a.pam_gate ? 0 : 48;
  x.neg_end = a.neg_end;
  x.min_score = a.min_score;
#pragma unroll
  for (int i = 0; i <= R; ++i) {
    x.f[0][i] = (x.k * R + i) * x.tgap;  // S'[i,0]
    x.r[0][i] = (x.k * R + i) * x.tgap;
  }
  x.best_f = x.best_r = a.neg_end;
  x.mn_f = x.mn_r = T + 1;
  x.mx_f = x.mx_r = 0;

  // Lane k works on column s - k: every lane is on for s in [L, T].  The
  // steady steps go four at a time, their bytes loaded one round ahead.
  int s = 1;
  for (; s < L; ++s) x.template step<0, true, true>(s, x.load(s));
  int next[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) next[u] = x.load(s + u);
#pragma unroll 1
  for (; s + 3 <= T; s += 4) {
    int raw[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      raw[u] = next[u];
      next[u] = x.load(s + 4 + u);
    }
    x.template step<0, false, false>(s, raw[0]);
    x.template step<1, false, false>(s + 1, raw[1]);
    x.template step<0, false, false>(s + 2, raw[2]);
    x.template step<1, false, false>(s + 3, raw[3]);
  }
  for (; s <= T; ++s) x.template step<0, false, true>(s, x.load(s));
  for (; s < T + L; ++s) x.template step<0, true, true>(s, x.load(s));

  if (!live || x.k != S::kLast) return;
  const int n = a.n_windows;
  a.best[w] = x.best_f + a.end_shift;
  a.best[n + w] = x.best_r + a.end_shift;
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
  using Bits = typename S::Bits;
  Table<Bits, L> tbl{};
  for (int k = 0; k < L; ++k) {
    for (int t = 0; t < 16; ++t) {
      Bits f = 0, r = 0;
      for (int i = 0; i < S::R; ++i) {
        const int row = k * S::R + i;
        if (row >= Q) break;
        if (qvals[row] & t) f |= Bits(1) << i;
        if (qvals[Q + row] & t) r |= Bits(1) << i;
      }
      tbl.c[k][t] = Compat<Bits>{f, r};
    }
  }
  const int blocks = (a.n_windows + S::kWindows - 1) / S::kWindows;
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
  const long long shift = static_cast<long long>(q_len) * mismatch;
  const long long neg_end = kNegInf - shift;
  const long long ms = static_cast<long long>(min_score) - shift;
  if (neg_end < INT32_MIN || neg_end > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{static_cast<const uint8_t*>(genome), genome_len, base0, step, window,
         n_windows, match, mismatch, qgap, tgap, pam_gate,
         static_cast<int>(shift),
         static_cast<int>(ms < INT32_MIN ? INT32_MIN : ms > INT32_MAX ? INT32_MAX : ms),
         static_cast<int>(neg_end), static_cast<int*>(best), static_cast<int*>(ranges)};
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
