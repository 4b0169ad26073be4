// PAM-gate annotation of a staged genome for NVIDIA Hopper (sm_90a).
//
// Replaces, on a CUDA tensor, the whole-array PyTorch ops of
// calitas_tpu_torch/ops/genome_screen.py::annotate_genome_pam_reference.
// It ports no Pallas kernel: the JAX package's annotate_genome_pam
// (calitas_tpu/ops/genome_screen.py) is jnp ops over chunks, left to XLA.
// It was added because those ops, some 37 whole-array passes per
// annotation, took most of the card's time on a whole-genome request.
//
// Contract (bit-identical to annotate_genome_pam_reference): out[i] =
// in[i] | end[i] << 4 | start[i] << 5, where, with positions outside
// [0, len) reading as mask 0 and a PAM "fitting" at positions
// s..s+plen-1 when at most max_mm of its bases b_k see in[s+k] & b_k == 0,
//   end[i]   = some PAM fits starting at s in [i+1, i+1+max_gap];
//   start[i] = some reverse-complemented PAM fits ending at e in
//              [i-max_gap, i].
//
// What bounds it on the H100: bytes.  The least work is the staged array
// read once and the annotated one written once, 2 bytes per position over
// 3.35 TB/s (0.160 ms at 2^28 positions).  A plain byte-per-position
// stencil (a shared-memory tile with a halo, one thread per position, a
// runtime mismatch count per PAM base, a loop over the gap offsets) took
// 1.69-1.83 ms there on an H100 for the benchmark's two specs, nine times
// this design's 0.19-0.20 ms: its integer work per position, not its
// bytes, set its pace.  So the design keeps the arithmetic on bit planes,
// 32 positions to a 32-bit word:
//
// - A grid-stride loop walks tiles of 8,000 positions; each block stages
//   its next tile (with a 96-byte halo on each side, zeros outside the
//   array) into shared memory with 16-byte cp.async copies while it
//   computes the current one.  The grid is 8 blocks per resident slot,
//   at 6 resident blocks of 256 threads per SM (at most 42 registers a
//   thread).  Timed on an H100 at 2^28 positions: 8 blocks per slot ran
//   as fast as 16 and 3 % faster than 4; 4, 7 or 8 resident blocks per
//   SM ran 5-6 % slower, a third staging buffer 1 % slower, and one
//   block per slot (the first design) 12-16 % slower; one block per tile
//   ran 20 % slower than 8 per slot.
// - Each thread turns 32 staged bytes into four bit planes (bit b of
//   each position's mask): two delta swaps transpose the mask bits inside
//   each word and four byte permutes gather the words, about 1.5
//   instructions per position.  It then ORs the planes into one match
//   plane per distinct PAM base mask of the spec.
// - A PAM base at offset k is a funnel shift of a match plane across
//   neighbouring words; mismatch counts are saturating bit-sliced
//   counters (max_mm + 1 levels, a template parameter), one LOP3 per
//   level, 32 positions at a time.  Each level costs: four builds of 2, 4,
//   8 and 17 levels, the fit read at level max_mm, ran 1.5 % slower at
//   max_mm 1 and 4-55 % slower at max_mm 2-9 on an H100.  The gap offsets
//   are funnel shifts and ORs of the fit planes.
// - The end and start planes go back to bits 4 and 5 of each byte by the
//   same transposes in reverse, ORed into the staged words the thread
//   kept in registers, and leave with 16-byte stores; neighbouring
//   threads swap halves first, so each store instruction of a warp
//   covers 512 contiguous bytes (2-10 % faster, in the designs timed,
//   than each thread storing its own 32).
//
// The spec (PAM masks, lengths, gap) travels by value as a grid constant;
// nothing is built per spec.  Limits: kMaxPams PAMs of 1..kMaxPlen bases,
// max_gap 0..kMaxGap, max_mm 0..255 (the plain version compares uint8
// counts, so larger or negative values wrap there); callers route specs
// beyond them to the plain version (dp_cuda.annotates_on_kernel).

#include <cuda_runtime.h>

#include <array>
#include <cstdint>
#include <utility>

namespace {

constexpr int kMaxPams = 8;
constexpr int kMaxPlen = 16;
constexpr int kMaxGap = 32;
constexpr int kMaxMasks = 16;            // distinct 4-bit base masks
constexpr int kLevels = kMaxPlen + 1;     // counter levels beyond which every PAM fits
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 6;           // the register cap: 65,536 / (6 * 256) = 42
constexpr int kBlocksPerSlot = 8;         // grid blocks per resident block
constexpr int kHaloWords = 3;             // plane words of halo on each side
constexpr int kWords = kThreads;          // staged plane words per tile, halo included
constexpr int kTileWords = kWords - 2 * kHaloWords;
constexpr int kTile = 32 * kTileWords;    // 8,000 positions written per tile
constexpr int kHalo = 32 * kHaloWords;    // 96 bytes
constexpr int kRaw = 32 * kWords;         // 8,192 bytes staged per tile
constexpr int kChunks = kRaw / 16;

// FE words reach two words right of an output word (max_gap + 1 <= 33
// positions), each reading one more plane word (plen - 1 <= 15); FS words
// one word left, reading one more.
static_assert(kMaxGap + 1 <= 64 && kMaxPlen <= 32, "halo of three plane words");
static_assert(kTile % 16 == 0 && kHalo % 16 == 0, "16-byte staging chunks");

struct Spec {
  uint32_t select[kMaxMasks][4];  // ~0u where distinct mask u has base bit b
  int n_masks;
  int n_pams;
  int max_gap;
  uint8_t plen[kMaxPams];
  uint8_t fwd[kMaxPams][kMaxPlen];  // distinct-mask index of PAM base k
  uint8_t rev[kMaxPams][kMaxPlen];  // ... of the reverse-complemented PAM's base k
};
static_assert(sizeof(Spec) % 4 == 0, "copied to shared memory as words");

// In-word 4x4 bit transpose, on both nibbles of each byte at once: bit
// (8i + b + 4h) <-> bit (8b + i + 4h), i, b in 0..3, h in 0..1.
__device__ __forceinline__ uint32_t transpose4(uint32_t x) {
  uint32_t t = (x ^ (x >> 14)) & 0x0000CCCCu;
  x ^= t ^ (t << 14);
  t = (x ^ (x >> 7)) & 0x00AA00AAu;
  return x ^ t ^ (t << 7);
}

// 32 positions' bytes (w[k] holds positions 4k..4k+3) -> four bit planes:
// bit r of p[b] = bit b of position r's byte.
__device__ __forceinline__ void to_planes(const uint32_t (&w)[8], uint32_t (&p)[4]) {
  uint32_t u[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // byte i: position 8k+i's mask in the low nibble, 8k+4+i's in the high
    u[k] = transpose4((w[2 * k] & 0x0F0F0F0Fu) | ((w[2 * k + 1] << 4) & 0xF0F0F0F0u));
  }
  const uint32_t a = __byte_perm(u[0], u[1], 0x5140), b = __byte_perm(u[0], u[1], 0x7362);
  const uint32_t c = __byte_perm(u[2], u[3], 0x5140), d = __byte_perm(u[2], u[3], 0x7362);
  p[0] = __byte_perm(a, c, 0x5410);
  p[1] = __byte_perm(a, c, 0x7632);
  p[2] = __byte_perm(b, d, 0x5410);
  p[3] = __byte_perm(b, d, 0x7632);
}

// ORs bit r of `end` into bit 4, and of `start` into bit 5, of position
// r's byte in w.
__device__ __forceinline__ void merge_gate(uint32_t (&w)[8], uint32_t end, uint32_t start) {
#pragma unroll
  for (int k = 0; k < 4; k += 2) {
    // rows: end and start of positions 8k.., then of 8(k+1)..
    const uint32_t x = transpose4(
        __byte_perm(end, start, k | (4 + k) << 4 | (k + 1) << 8 | (5 + k) << 12));
    w[2 * k] |= (x << 4) & 0x30303030u;
    w[2 * k + 1] |= x & 0x30303030u;
    w[2 * k + 2] |= (x << 2) & 0x30303030u;
    w[2 * k + 3] |= (x >> 2) & 0x30303030u;
  }
}

// Fit plane of one PAM over the 32 positions of staged word t: forward,
// bit r = the PAM fits starting at position r; reverse, bit r = the
// reverse-complemented PAM fits ending there.  `idx` holds each base's
// distinct-mask index; a count reaching kLevels mismatches misses.
template <int kLev, bool kForward>
__device__ __forceinline__ uint32_t fit_plane(const uint32_t* match, int t,
                                              const uint8_t* idx, int plen) {
  uint32_t c[kLev];  // c[l]: at least l + 1 mismatches
#pragma unroll
  for (int l = 0; l < kLev; ++l) c[l] = 0;
  for (int k = 0; k < plen; ++k) {
    const uint32_t* m = match + idx[k] * kWords + t;
    const uint32_t miss = ~(kForward ? __funnelshift_r(m[0], m[1], k)
                                     : __funnelshift_l(m[-1], m[0], plen - 1 - k));
#pragma unroll
    for (int l = kLev - 1; l > 0; --l) c[l] |= c[l - 1] & miss;
    c[0] |= miss;
  }
  return ~c[kLev - 1];
}

// Stages tile `tile`'s kRaw bytes (positions from tile * kTile - kHalo)
// into `buf` with 16-byte cp.async copies, zero-filled past the array.
__device__ __forceinline__ void stage_tile(const uint8_t* in, long long len, long long tile,
                                           uint8_t* buf) {
  const long long base = tile * kTile - kHalo;
  for (int c = threadIdx.x; c < kChunks; c += kThreads) {
    const long long pos = base + 16LL * c;
    const long long left = len - pos;
    const int n = pos < 0 ? 0 : static_cast<int>(left < 0 ? 0 : (left > 16 ? 16 : left));
    const uint8_t* src = n > 0 ? in + pos : in;
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(buf + 16 * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
                 "r"(n));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kLev>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
    pam_annotate_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                        long long len, long long n_tiles, const __grid_constant__ Spec spec) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ Spec s;
  uint8_t* raw = smem;                                           // [2][kRaw]
  uint32_t* fe = reinterpret_cast<uint32_t*>(smem + 2 * kRaw);  // [kWords]
  uint32_t* fs = fe + kWords;                                    // [kWords]
  uint32_t* match = fs + kWords;                                 // [n_masks][kWords]
  const int t = threadIdx.x;
  for (int i = t; i < static_cast<int>(sizeof(Spec) / 4); i += kThreads) {
    reinterpret_cast<uint32_t*>(&s)[i] = reinterpret_cast<const uint32_t*>(&spec)[i];
  }
  long long tile = blockIdx.x;
  stage_tile(in, len, tile, raw);
  for (int it = 0; tile < n_tiles; tile += gridDim.x, ++it) {
    const uint8_t* cur = raw + (it & 1) * kRaw;
    if (tile + gridDim.x < n_tiles) {
      stage_tile(in, len, tile + gridDim.x, raw + ((it + 1) & 1) * kRaw);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    // Staged word t: tile positions 32 (t - kHaloWords) .. +31.
    uint32_t w[8];
    {
      const uint4 a = *reinterpret_cast<const uint4*>(cur + 32 * t);
      const uint4 b = *reinterpret_cast<const uint4*>(cur + 32 * t + 16);
      w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
      w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
    }
    {
      uint32_t p[4];
      to_planes(w, p);
      for (int u = 0; u < s.n_masks; ++u) {
        uint32_t m = p[0] & s.select[u][0];
#pragma unroll
        for (int b = 1; b < 4; ++b) m |= p[b] & s.select[u][b];
        match[u * kWords + t] = m;
      }
    }
    __syncthreads();

    // Fit planes: FE for staged words 3..kWords-2 and FS for 2..kWords-4
    // are read below; each thread in between computes both.
    if (t >= 2 && t <= kWords - 2) {
      uint32_t e = 0, r = 0;
      for (int p = 0; p < s.n_pams; ++p) {
        e |= fit_plane<kLev, true>(match, t, s.fwd[p], s.plen[p]);
        r |= fit_plane<kLev, false>(match, t, s.rev[p], s.plen[p]);
      }
      fe[t] = e;
      fs[t] = r;
    }
    __syncthreads();

    const bool live = t >= kHaloWords && t < kHaloWords + kTileWords;
    const long long pos = tile * kTile + 32LL * (t - kHaloWords);
    if (live) {
      const int gap = s.max_gap;
      const uint32_t a = fe[t], b = fe[t + 1], c = fe[t + 2];
      uint32_t end = 0;
      for (int o = 1; o <= gap + 1; ++o) {
        end |= o < 32 ? __funnelshift_r(a, b, o) : __funnelshift_r(b, c, o - 32);
      }
      const uint32_t lo = fs[t - 1], hi = fs[t];
      uint32_t start = hi;
      for (int o = 1; o <= gap; ++o) start |= __funnelshift_lc(lo, hi, o);
      merge_gate(w, end, start);
    }
    // Threads 2m and 2m + 1 hold positions pos_e..pos_e + 63: the even
    // one stores bytes 0-15 then 32-47, the odd one 16-31 then 48-63, each
    // half whose 32 bytes lie whole inside the array.  Word-wise selects:
    // selecting whole uint4s ran 16 % slower on an H100.
    {
      const bool whole = live && pos + 32 <= len;
      const bool odd = t & 1;
      uint32_t g0 = odd ? w[0] : w[4], g1 = odd ? w[1] : w[5], g2 = odd ? w[2] : w[6],
               g3 = odd ? w[3] : w[7];
      g0 = __shfl_xor_sync(~0u, g0, 1);
      g1 = __shfl_xor_sync(~0u, g1, 1);
      g2 = __shfl_xor_sync(~0u, g2, 1);
      g3 = __shfl_xor_sync(~0u, g3, 1);
      const bool other = __shfl_xor_sync(~0u, static_cast<int>(whole), 1);
      const long long a0 = odd ? pos - 16 : pos, a1 = odd ? pos + 16 : pos + 32;
      const uint4 d0 = odd ? make_uint4(g0, g1, g2, g3) : make_uint4(w[0], w[1], w[2], w[3]);
      const uint4 d1 = odd ? make_uint4(w[4], w[5], w[6], w[7]) : make_uint4(g0, g1, g2, g3);
      if (odd ? other : whole) *reinterpret_cast<uint4*>(out + a0) = d0;
      if (odd ? whole : other) *reinterpret_cast<uint4*>(out + a1) = d1;
    }
    if (live && pos + 32 > len) {
#pragma unroll
      for (int k = 0; k < 32; ++k) {  // unrolled: w stays in registers
        if (pos + k < len) out[pos + k] = static_cast<uint8_t>(w[k >> 2] >> (8 * (k & 3)));
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
}

using LaunchFn = cudaError_t (*)(const uint8_t*, uint8_t*, long long, const Spec&,
                                 cudaStream_t);

// kBlocksPerSlot blocks per SM-resident slot, at most one per tile.
template <int kLev>
cudaError_t launch(const uint8_t* in, uint8_t* out, long long len, const Spec& spec,
                   cudaStream_t stream) {
  const long long n_tiles = (len + kTile - 1) / kTile;
  const size_t smem = 2 * kRaw + (2 + static_cast<size_t>(spec.n_masks)) * kWords * 4;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pam_annotate_kernel<kLev>,
                                                        kThreads, smem);
  }
  if (err != cudaSuccess) return err;
  long long blocks = static_cast<long long>(kBlocksPerSlot) * (per_sm > 0 ? per_sm : 1) * sms;
  if (blocks > n_tiles) blocks = n_tiles;
  pam_annotate_kernel<kLev><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      in, out, len, n_tiles, spec);
  return cudaGetLastError();
}

template <int kLev>
constexpr LaunchFn launch_at() {
  return &launch<kLev>;
}

template <int... I>
constexpr std::array<LaunchFn, kLevels> level_row(std::integer_sequence<int, I...>) {
  return {launch_at<I + 1>()...};
}

// kByLevels[l - 1]: the kernel with l counter levels (max_mm = l - 1).
constexpr std::array<LaunchFn, kLevels> kByLevels =
    level_row(std::make_integer_sequence<int, kLevels>{});

int rc_mask(int m) { return ((m & 1) << 3) | ((m & 2) << 1) | ((m & 4) >> 1) | ((m & 8) >> 3); }

}  // namespace

// Annotates the `len` staged mask bytes at `genome` into `out` (device
// memory, both 16-byte aligned) on `stream`; returns the cudaError_t of
// the launch (0 = cudaSuccess).  `masks` is a host array of n_pams rows of
// 16 ints, row p holding PAM p's plens[p] base masks (4-bit IUPAC) in
// genome order; the kernel reverse-complements them for the start gate.
extern "C" int calitas_pam_annotate(const void* genome, void* out, long long len,
                                    const int* masks, const int* plens, int n_pams,
                                    int max_mm, int max_gap, void* stream) {
  if (len < 0 || n_pams < 1 || n_pams > kMaxPams || max_gap < 0 || max_gap > kMaxGap ||
      max_mm < 0 || max_mm > 255 || reinterpret_cast<uintptr_t>(genome) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Spec spec{};
  int index[kMaxMasks];
  for (int& i : index) i = -1;
  auto distinct = [&](int m) {
    if (index[m] < 0) {
      index[m] = spec.n_masks;
      for (int b = 0; b < 4; ++b) spec.select[spec.n_masks][b] = (m >> b & 1) ? ~0u : 0u;
      ++spec.n_masks;
    }
    return static_cast<uint8_t>(index[m]);
  };
  for (int p = 0; p < n_pams; ++p) {
    const int plen = plens[p];
    if (plen < 1 || plen > kMaxPlen) return static_cast<int>(cudaErrorInvalidValue);
    const int* row = masks + p * kMaxPlen;
    for (int k = 0; k < plen; ++k) {
      if (row[k] < 0 || row[k] > 15) return static_cast<int>(cudaErrorInvalidValue);
    }
    spec.plen[p] = static_cast<uint8_t>(plen);
    for (int k = 0; k < plen; ++k) {
      spec.fwd[p][k] = distinct(row[k]);
      spec.rev[p][k] = distinct(rc_mask(row[plen - 1 - k]));
    }
  }
  spec.n_pams = n_pams;
  spec.max_gap = max_gap;
  if (len == 0) return 0;
  const int levels = max_mm < kLevels ? max_mm + 1 : kLevels;
  return static_cast<int>(kByLevels[levels - 1](static_cast<const uint8_t*>(genome),
                                                static_cast<uint8_t*>(out), len, spec,
                                                static_cast<cudaStream_t>(stream)));
}

extern "C" const char* calitas_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
