// Roofline probes for NVIDIA Hopper (sm_90a): the integer work of the DP
// screens with nothing else around it.
//
// Replaces the Pallas TPU kernels benchmarks/screen_ab.py::_ceiling_kernel
// and ::_peak_kernel (both launched through _probe_call).  They are the
// denominators the screen kernels (screen_dual.cu, screen_multi.cu,
// screen_rows.cu) are held against: the same column loop at the minimum
// of one add and one max per DP cell.
//
// Contract (bit-identical to calitas_tpu_torch/ops/probes.py::
// ceiling_probe_reference / peak_probe_reference).  `tcols` is [T, N]
// int32 row-major: column j of lane n is tcols[j*N + n]; out is [N].
//   ceiling: state[0..Q] = 0, best = -2^30; per column
//            new[0] = tcol + bias, new[i] = max(state[i] + 1, new[i-1]),
//            state = new, best = max(best, new[Q]); out = best.
//   peak:    acc[c] = c for c < 8; per column, for each c, Q times
//            acc[c] = max(acc[c] + (c+1), tcol + bias); out = max_c acc[c].
// The TPU layout [T, nb*8, 128] is this one with N = nb*8*128.
//
// What bounds them on the H100: integer issue.  Each add+max pair is one
// DPX instruction (__viaddmax_s32: max(a + b, c)), against one 4-byte
// column read per lane per Q (ceiling) or 8*Q (peak) pairs.  At the
// ceiling's shape (T 1024, N 32,768, Q 20) the bytes bound (each column
// read once) is nearly as long as the operations bound, so the column
// stream has to keep up too.
//
// Ceiling probe: the DP's dependency shape, cell (i, j) needs (i-1, j)
// and (i, j-1), so every cell of an anti-diagonal is free of the others.
// One thread per lane walks the lane's Q x T cells as a skewed wavefront:
// one register per row, s[0..Q]; at step k row i works on column k - i,
// and the rows update in descending order, s[i] = max(s[i] + 1, s[i-1])
// for i = Q..1, then s[0] = tcol[k] + bias, so each row reads its own
// previous column and row i-1's value from the step before.  The Q
// add+max of a step are independent: instruction-level parallelism Q
// per thread, where the column-by-column chain had 1.  T + Q steps:
// - the first Q: row i must hold the initial 0 until step i.  It starts
//   at -i instead, and the update it runs meanwhile raises it by one a
//   step (its upper neighbour is one ahead), so it reaches 0 exactly at
//   step i with no guard in the update;
// - the last Q: rows past column T - 1 go on updating, which nothing
//   reads (a row's last valid column is read by the row below in the
//   next step, before that row's value moves again); s[0] keeps its last
//   column once the loads stop;
// - best takes row Q at steps Q..T+Q-1, its columns 0..T-1.
// The column values stream through a ring of kAhead shared-memory slots
// per thread, filled by cp.async (4 bytes each, straight from device
// memory to shared memory, no register held while in flight): step k
// reads slot k % kAhead and refills it with column k + kAhead.  The loop
// runs in rounds of kRound steps (unrolled, so a slot's offset is a
// constant from the round's base); each round is one cp.async group, and
// a round first waits for the group that holds its own columns, so each
// load has kAhead - kRound to kAhead steps to land.  A thread reads only
// the slots its own copies fill, so no block barrier is needed.  Rounds
// that touch the first Q steps, or whose loads would pass column T - 1,
// run guarded; the rest unguarded.  Why a shared ring: at N 32,768 the
// card holds about 250 threads per SM, so a column read has to be in
// flight about 30 steps ahead to keep the stream up, and a register ring
// that deep needs the loop unrolled as far.  At T 1024, N 32,768, Q 20 on
// an H100 80GB HBM3 at 700 W (ops/probe_ab.py, PERF.md section 6): a
// register ring of 16 columns 0.0691 ms, of 32 columns 0.0636 ms (121
// registers); this ring, 32 slots in rounds of 8, 0.0577 ms (56
// registers, 8 KB of shared memory per block).  64-thread blocks (the
// screens' dp_lane.cuh size) spread N 32,768 over all 132 SMs.  The
// first design ran one thread per lane column by column, each add+max
// waiting on the one before (instruction-level parallelism 1), in
// 256-thread blocks (128 blocks at N 32,768, 4 SMs idle): 0.3001 ms
// there, 14.1 % of its bound, and 0.5127 ms at N 270,336.
//
// Peak probe: 8 independent accumulators, enough instruction-level
// parallelism to keep the integer pipes busy: it measures the reachable
// add+max rate.  The increments c+1 arrive as a run-time value (`unit`,
// always 1) so the compiler cannot fold Q repeated max(acc + k, t) into
// fewer operations (max(max(x + k, t) + k, t) = max(x + 2k, t + k) for a
// known k >= 0).  One thread per lane in 256-thread blocks.
//
// Both: neighbouring threads read neighbouring addresses, so the column
// reads coalesce.  Occupancy is the launch's concern: the caller sizes N
// to fill the card (132 SMs x 2048 threads).

#include <cuda_runtime.h>

#include <array>
#include <cstdint>
#include <utility>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kQMax = 48;
constexpr int kPeakC = 8;
constexpr int kThreads = 256;  // the peak probe's blocks
constexpr int kCeilThreads = 64;  // the ceiling probe's blocks
constexpr int kAhead = 32;  // a ceiling thread's ring slots: columns its loads run ahead
constexpr int kRound = 8;  // ceiling steps per unrolled round and cp.async group
static_assert((kAhead & (kAhead - 1)) == 0 && kAhead % kRound == 0, "ring of whole rounds");

// cp.async of one int from device memory into shared memory, and its
// group commit and wait (all 4-byte copies of this thread).
__device__ __forceinline__ void copy_async(int* dst, const int* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int kPending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// kRound steps of the ceiling's wavefront from step k (a multiple of
// kRound).  `p` points at column k + kAhead of the thread's lane; `ring`
// is the block's [kAhead][kCeilThreads] slots.  kGuarded: some step of
// the round is among the first Q, past T + Q - 1, or would load past
// column T - 1.
template <int Q, bool kGuarded>
__device__ __forceinline__ void ceiling_round(int (&s)[Q + 1], int (*ring)[kCeilThreads],
                                              int& best, const int*& p, long long N, int k,
                                              int T, int bias) {
  const int t = threadIdx.x;
  const int base = k & (kAhead - 1);
  copy_wait<kAhead / kRound - 1>();  // this round's columns have landed
#pragma unroll
  for (int u = 0; u < kRound; ++u) {
#pragma unroll
    for (int i = Q; i >= 1; --i) {
      s[i] = __viaddmax_s32(s[i], 1, s[i - 1]);  // row i, column k + u - i
    }
    if (!kGuarded || (k + u >= Q && k + u < T + Q)) best = max(best, s[Q]);
    s[0] = ring[base + u][t] + bias;
    if (!kGuarded || k + u + kAhead < T) copy_async(&ring[base + u][t], p);
    p += N;
  }
  copy_commit();
}

template <int Q>
__global__ void __launch_bounds__(kCeilThreads)
    ceiling_kernel(const int* __restrict__ tcols, int T, long long N, int bias,
                   int* __restrict__ out) {
  __shared__ int ring[kAhead][kCeilThreads];
  const long long n = static_cast<long long>(blockIdx.x) * kCeilThreads + threadIdx.x;
  if (n >= N) return;
  int s[Q + 1];
  s[0] = 0;
#pragma unroll
  for (int i = 1; i <= Q; ++i) s[i] = -i;  // reaches 0 at step i, its first column
#pragma unroll
  for (int u = 0; u < kAhead; ++u) {
    if (u < T) copy_async(&ring[u][threadIdx.x], tcols + static_cast<long long>(u) * N + n);
    if (u % kRound == kRound - 1) copy_commit();
  }
  const int* p = tcols + static_cast<long long>(kAhead) * N + n;
  int best = kNegInf;
  int k = 0;
  for (; k < Q; k += kRound) ceiling_round<Q, true>(s, ring, best, p, N, k, T, bias);
  for (; k + kRound + kAhead <= T; k += kRound) {
    ceiling_round<Q, false>(s, ring, best, p, N, k, T, bias);
  }
  for (; k < T + Q; k += kRound) ceiling_round<Q, true>(s, ring, best, p, N, k, T, bias);
  out[n] = best;
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
    peak_kernel(const int* __restrict__ tcols, int T, long long N, int bias,
                int unit, int* __restrict__ out) {
  const long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  int acc[kPeakC];
  int inc[kPeakC];
#pragma unroll
  for (int c = 0; c < kPeakC; ++c) {
    acc[c] = c;
    inc[c] = (c + 1) * unit;
  }
  for (int j = 0; j < T; ++j) {
    const int t = __ldg(tcols + static_cast<long long>(j) * N + n) + bias;
#pragma unroll
    for (int i = 0; i < Q; ++i) {
#pragma unroll
      for (int c = 0; c < kPeakC; ++c) {
        acc[c] = __viaddmax_s32(acc[c], inc[c], t);  // max(acc + (c+1), t)
      }
    }
  }
  int best = acc[0];
#pragma unroll
  for (int c = 1; c < kPeakC; ++c) best = max(best, acc[c]);
  out[n] = best;
}

using LaunchFn = cudaError_t (*)(const int*, int, long long, int, int*, cudaStream_t);

inline unsigned blocks_for(long long N, int threads = kThreads) {
  return static_cast<unsigned>((N + threads - 1) / threads);
}

template <int Q>
cudaError_t launch_ceiling(const int* tcols, int T, long long N, int bias, int* out,
                           cudaStream_t stream) {
  ceiling_kernel<Q><<<blocks_for(N, kCeilThreads), kCeilThreads, 0, stream>>>(
      tcols, T, N, bias, out);
  return cudaGetLastError();
}

template <int Q>
cudaError_t launch_peak(const int* tcols, int T, long long N, int bias, int* out,
                        cudaStream_t stream) {
  peak_kernel<Q><<<blocks_for(N), kThreads, 0, stream>>>(tcols, T, N, bias, 1, out);
  return cudaGetLastError();
}

template <int... I>
constexpr std::array<LaunchFn, sizeof...(I)> ceiling_table(std::integer_sequence<int, I...>) {
  return {&launch_ceiling<I + 1>...};
}

template <int... I>
constexpr std::array<LaunchFn, sizeof...(I)> peak_table(std::integer_sequence<int, I...>) {
  return {&launch_peak<I + 1>...};
}

constexpr auto kCeiling = ceiling_table(std::make_integer_sequence<int, kQMax>{});
constexpr auto kPeak = peak_table(std::make_integer_sequence<int, kQMax>{});

int check(int T, long long N, int q_len, int threads = kThreads) {
  if (q_len < 1 || q_len > kQMax || T < 1 || N < 1 ||
      (N + threads - 1) / threads > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// Each launches its probe on `stream` and returns the cudaError_t of the
// launch (0 = cudaSuccess).  `tcols` is [T, N] int32 and `out` [N] int32,
// both device memory.
extern "C" int calitas_ceiling_probe(const void* tcols, int T, long long N, int q_len,
                                     int bias, void* out, void* stream) {
  if (int err = check(T, N, q_len, kCeilThreads)) return err;
  return static_cast<int>(kCeiling[q_len - 1](static_cast<const int*>(tcols), T, N, bias,
                                              static_cast<int*>(out),
                                              static_cast<cudaStream_t>(stream)));
}

extern "C" int calitas_peak_probe(const void* tcols, int T, long long N, int q_len,
                                  int bias, void* out, void* stream) {
  if (int err = check(T, N, q_len)) return err;
  return static_cast<int>(kPeak[q_len - 1](static_cast<const int*>(tcols), T, N, bias,
                                           static_cast<int*>(out),
                                           static_cast<cudaStream_t>(stream)));
}

extern "C" const char* calitas_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
