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
// column read per lane per Q (ceiling) or 8*Q (peak) pairs.  The ceiling
// probe is a dependent chain (new[i] needs new[i-1]): one thread's pairs
// issue back to back at the instruction latency, so it measures the
// latency floor of the DP's dependency shape; the kernel is instantiated
// per Q so the Q+1 state lives in registers.  The peak probe's 8
// accumulators are independent, enough instruction-level parallelism to
// keep the integer pipes busy: it measures the reachable add+max rate.
// The increments c+1 arrive as a run-time value (`unit`, always 1) so the
// compiler cannot fold Q repeated max(acc + k, t) into fewer operations
// (max(max(x + k, t) + k, t) = max(x + 2k, t + k) for a known k >= 0).
// One thread per lane: neighbouring threads read neighbouring addresses,
// so the column reads coalesce.  Occupancy is the launch's concern: the
// caller sizes N to fill the card (132 SMs x 2048 threads).

#include <cuda_runtime.h>

#include <array>
#include <cstdint>
#include <utility>

namespace {

constexpr int kNegInf = -(1 << 30);
constexpr int kQMax = 48;
constexpr int kPeakC = 8;
constexpr int kThreads = 256;

template <int Q>
__global__ void __launch_bounds__(kThreads)
    ceiling_kernel(const int* __restrict__ tcols, int T, long long N, int bias,
                   int* __restrict__ out) {
  const long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (n >= N) return;
  int state[Q + 1];
#pragma unroll
  for (int i = 0; i <= Q; ++i) state[i] = 0;
  int best = kNegInf;
  for (int j = 0; j < T; ++j) {
    int prev = __ldg(tcols + static_cast<long long>(j) * N + n) + bias;
    state[0] = prev;
#pragma unroll
    for (int i = 1; i <= Q; ++i) {
      prev = __viaddmax_s32(state[i], 1, prev);  // max(state[i] + 1, new[i-1])
      state[i] = prev;
    }
    best = max(best, prev);
  }
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

inline unsigned blocks_for(long long N) {
  return static_cast<unsigned>((N + kThreads - 1) / kThreads);
}

template <int Q>
cudaError_t launch_ceiling(const int* tcols, int T, long long N, int bias, int* out,
                           cudaStream_t stream) {
  ceiling_kernel<Q><<<blocks_for(N), kThreads, 0, stream>>>(tcols, T, N, bias, out);
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

int check(int T, long long N, int q_len) {
  if (q_len < 1 || q_len > kQMax || T < 1 || N < 1 ||
      (N + kThreads - 1) / kThreads > 0x7fffffffLL) {
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
  if (int err = check(T, N, q_len)) return err;
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
