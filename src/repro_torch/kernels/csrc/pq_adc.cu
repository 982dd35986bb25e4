// Batched PQ asymmetric-distance (ADC) kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pq_adc (_adc_kernel) of
// repro/kernels/pq_adc.py:
//
//   out[b, n] = sum_m luts[b, m, codes[n, m]]
//
// codes [N, M] u8, luts [B, M, K] f32 -> out [B, N] f32 (the layout of
// repro.kernels.ops.pq_adc_batch). Each output adds its M terms in
// numpy's pairwise order (the order of np.sum along a row, which the JAX
// host search's adc_distance uses): in order m = 0, 1, ... below 8 terms;
// else 8 partial sums r[m % 8], reduced as ((r0+r1)+(r2+r3))+((r4+r5)+
// (r6+r7)) — Sum below. Codes at or above K clamp to K - 1. This is the
// plain version's f32 order, so the bits equal it.
//
// The TPU kernel expands each code tile into a one-hot [BN, M*K] matrix
// and multiplies it into the LUTs on the MXU, because the TPU's vector
// unit gathers poorly. A GPU gathers from shared memory well, so this
// kernel does the table lookups directly.
//
// What bounds it on an H100 is bytes: the [B, N] f32 output (4 bytes per
// M adds) dwarfs the codes and the LUTs. Next come the shared-memory
// lookups, whose addresses follow the random code bytes. Design:
//  * a CTA stages the LUTs of BQ queries (16 where they fit and the
//    batch fills them, else 8 or 4) in shared memory query-interleaved,
//    [M][K][BQ]: one 16-byte load fetches one (m, code) entry for 4
//    queries, and BQ/4 lanes read a row's entry;
//  * at BQ = 16 an entry is 64 bytes, half the banks, and a quarter-warp
//    (the lanes that share one pass of a 16-byte load) holds two rows. The
//    entries of even m sit in the lower half of the banks and those of odd
//    m in the upper half, and the second row of each pair loads its terms
//    in the order 1, 0, 3, 2, ..., so the two rows of a pass always read
//    different halves: no bank conflict whatever the codes. The terms are
//    swapped back in registers before they are added, so each term
//    reaches its own partial sum;
//  * a lane takes 4 consecutive rows: it loads their 4·M code bytes in
//    one to eight 16-byte loads (clamped to K - 1 four bytes at a time,
//    and only where K < 256), turns each into a shared-memory offset
//    once, and writes its 4 queries' outputs as 16-byte streaming stores
//    (__stcs), so a warp writes whole 128-byte lines of out along n;
//  * the CTAs are persistent: a CTA owns a range of rows and walks its
//    share of the query tiles, staging each tile's LUTs (a transpose:
//    32-byte global reads, conflict-free shared stores). At M = 8,
//    K = 256 a tile is 128 KB, so two do not fit one SM's 227 KB and the
//    staging is not double-buffered; the CTAs run out of step, so while
//    one SM stages the others keep the memory busy.
// The entry point launches on the given stream and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NT = 512;                 // threads a CTA
constexpr int NW = NT / 32;

template <int BQ>
struct Tile {
  static constexpr int L = BQ / 4;      // lanes a row (4 queries a lane)
  static constexpr int RS = 32 / L;     // rows a warp a step
  static constexpr int U = RS * 4;      // rows a warp unit (4 a lane)
  static constexpr int J = 32 / BQ;     // staging: m values a warp a step
  // the float offset of entry (m, c): pairs of m interleave at BQ = 16
  __device__ __forceinline__ static int at(int m, int c, int k) {
    if constexpr (BQ == 16)
      return (((m >> 1) * k + c) * 2 + (m & 1)) * 16;
    else
      return (m * k + c) * BQ;
  }
};

// Stage the LUTs of queries q0 .. q0 + nq - 1 into lut_s ([M][K][BQ],
// Tile::at). At BQ = 16 a lane takes query q = lane % BQ and m = mg·J +
// lane / BQ, reads 8 consecutive codes' entries (one 32-byte sector) and
// writes them at stride BQ: the 32 lanes hit 32 different banks. The
// small tiles (a batch of 8 or fewer) are copied a query at a time by
// every thread, coalesced along the table: fewer instructions where the
// copy is most of the call.
template <int M, int BQ>
__device__ __forceinline__ void stage(float* lut_s,
                                      const float* __restrict__ luts, int k,
                                      int q0, int nq, bool vec) {
  using T = Tile<BQ>;
  if constexpr (BQ < 16) {
    for (int qq = 0; qq < nq; ++qq) {
      const float* src = luts + static_cast<long>(q0 + qq) * M * k;
      for (int i = threadIdx.x; i < M * k; i += NT)
        lut_s[i * BQ + qq] = __ldg(src + i);   // Tile::at(m, c) = i·BQ
    }
    return;
  }
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int q = lane % BQ, j = lane / BQ;
  const int c8n = (k + 7) / 8;
  const int items = ((M + T::J - 1) / T::J) * c8n;
  if (q >= nq) return;                   // padded queries stay unwritten
  const float* src = luts + static_cast<long>(q0 + q) * M * k;
#pragma unroll 4
  for (int it = w; it < items; it += NW) {
    const int m = (it / c8n) * T::J + j, c = (it % c8n) * 8;
    if (m >= M) continue;
    const float* s = src + m * k + c;
    float v[8];
    if (vec) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(s));
      const float4 b = __ldg(reinterpret_cast<const float4*>(s) + 1);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = c + i < k ? __ldg(s + i) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c + i < k) lut_s[T::at(m, c + i, k) + q] = v[i];
  }
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// one row's M terms (4 queries a float4) summed in numpy's pairwise
// order; add(m, v) is called for m = 0, 1, ..., M - 1 with m a constant
// once unrolled, so r stays in registers
template <int M>
struct Sum {
  static_assert(M < 8 || M % 8 == 0, "pairwise order: M < 8 or 8 | M");
  float4 r[8];
  __device__ __forceinline__ void add(int m, float4 v) {
    if constexpr (M < 8) r[0] = m == 0 ? v : add4(r[0], v);
    else if (m < 8) r[m] = v;
    else r[m & 7] = add4(r[m & 7], v);
  }
  __device__ __forceinline__ float4 total() const {
    if constexpr (M < 8) return r[0];
    else return add4(add4(add4(r[0], r[1]), add4(r[2], r[3])),
                     add4(add4(r[4], r[5]), add4(r[6], r[7])));
  }
};

// each byte of w clamped to kmax (codes at or above K read entry K - 1)
__device__ __forceinline__ uint32_t clamp_bytes(uint32_t w, uint32_t kmax) {
  uint32_t r = 0;
#pragma unroll
  for (int by = 0; by < 4; ++by)
    r |= min((w >> (8 * by)) & 0xffu, kmax) << (8 * by);
  return r;
}

// component i (a constant once unrolled) of v
__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int M, int BQ>
__global__ void __launch_bounds__(NT, 1)
pq_adc_kernel(const uint8_t* __restrict__ codes,
              const float* __restrict__ luts, int n, int k, int b,
              float* __restrict__ out) {
  static_assert(M % 2 == 0 && M <= 32, "M: even, up to 32");
  using T = Tile<BQ>;
  extern __shared__ float4 smem4[];
  float* lut_s = reinterpret_cast<float*>(smem4);
  const float4* lut4 = smem4;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int rs = lane / T::L, h = lane % T::L;
  const bool odd = BQ == 16 && (rs & 1);     // the second row of a pass
  const bool stage_vec = (k & 7) == 0 &&
                         (reinterpret_cast<uintptr_t>(luts) & 15) == 0;
  const bool codes_vec = (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const bool out_vec = (n & 3) == 0;
  const long nu = (static_cast<long>(n) + T::U - 1) / T::U;
  const long u0 = nu * blockIdx.x / gridDim.x;
  const long u1 = nu * (blockIdx.x + 1) / gridDim.x;
  const int nt = (b + BQ - 1) / BQ;

  for (int t = blockIdx.y; t < nt; t += gridDim.y) {
    const int q0 = t * BQ, nq = min(BQ, b - q0);
    __syncthreads();                     // the last tile's readers are done
    stage<M, BQ>(lut_s, luts, k, q0, nq, stage_vec);
    __syncthreads();
    for (long u = u0 + w; u < u1; u += NW) {
      const long r0 = u * T::U + rs * 4;    // this lane's 4 rows
      if (r0 >= n) continue;
      // the 4 rows' 4·M code bytes, as M words (row s, byte j: byte
      // e = s·M + j of the run, bits 8·(e % 4) of word e / 4)
      uint32_t cw[M];
      const uint8_t* c = codes + r0 * M;
      if (codes_vec && r0 + 3 < n && M % 4 == 0) {
#pragma unroll
        for (int i = 0; i < M / 4; ++i) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(c) + i);
          cw[4 * i] = v.x; cw[4 * i + 1] = v.y;
          cw[4 * i + 2] = v.z; cw[4 * i + 3] = v.w;
        }
      } else if (codes_vec && r0 + 3 < n && M == 2) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(c));
        cw[0] = v.x;
        cw[1] = v.y;
      } else {
#pragma unroll
        for (int i = 0; i < M; ++i) {
          uint32_t word = 0;
#pragma unroll
          for (int by = 0; by < 4; ++by) {
            const int e = 4 * i + by;
            if (r0 + e / M < n) word |= uint32_t(__ldg(c + e)) << (8 * by);
          }
          cw[i] = word;
        }
      }
      if (k < 256) {                       // a u8 code may reach past K
#pragma unroll
        for (int i = 0; i < M; ++i) cw[i] = clamp_bytes(cw[i], k - 1);
      }
      float4 acc[4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        Sum<M> sum;
        if constexpr (BQ == 16) {
          // pair (2i, 2i+1): the second row of a pass loads 2i+1 first;
          // both bytes sit in one word (M is even)
#pragma unroll
          for (int i = 0; i < M / 2; ++i) {
            const int e = s * M + 2 * i;
            const uint32_t word = cw[e >> 2];
            const int sh = 8 * (e & 3);
            const int pa = odd ? 1 : 0;
            const int ca = (word >> (sh + 8 * pa)) & 0xff;
            const int cb = (word >> (sh + 8 - 8 * pa)) & 0xff;
            const float4 a = lut4[((i * k + ca) * 2 + pa) * 4 + h];
            const float4 bb = lut4[((i * k + cb) * 2 + 1 - pa) * 4 + h];
            const float4 x0 = odd ? bb : a, x1 = odd ? a : bb;
            sum.add(2 * i, x0);
            sum.add(2 * i + 1, x1);
          }
        } else {
#pragma unroll
          for (int m = 0; m < M; ++m) {
            const int e = s * M + m;
            const int cm = (cw[e >> 2] >> (8 * (e & 3))) & 0xff;
            sum.add(m, lut4[T::at(m, cm, k) / 4 + h]);
          }
        }
        acc[s] = sum.total();
      }
      // queries q0 + 4h .. q0 + 4h + 3, rows r0 .. r0 + 3
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qq = q0 + 4 * h + i;
        if (qq >= b) break;
        float* o = out + static_cast<long>(qq) * n + r0;
        const float v0 = lane4(acc[0], i), v1 = lane4(acc[1], i),
                    v2 = lane4(acc[2], i), v3 = lane4(acc[3], i);
        if (out_vec && r0 + 3 < n) {
          __stcs(reinterpret_cast<float4*>(o), make_float4(v0, v1, v2, v3));
        } else {
          __stcs(o, v0);
          if (r0 + 1 < n) __stcs(o + 1, v1);
          if (r0 + 2 < n) __stcs(o + 2, v2);
          if (r0 + 3 < n) __stcs(o + 3, v3);
        }
      }
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <int M, int BQ>
int launch(const uint8_t* codes, const float* luts, int n, int k, int b,
           float* out, cudaStream_t st) {
  using T = Tile<BQ>;
  const size_t smem = static_cast<size_t>(M) * k * BQ * sizeof(float);
  auto kern = pq_adc_kernel<M, BQ>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, NT, smem);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // CTAs to fill the card once: query tiles split over grid.y (up to 4,
  // fewer LUT stagings than more row ranges), rows over grid.x
  const long target = static_cast<long>(sm_count()) * per_sm;
  const long nu = (static_cast<long>(n) + T::U - 1) / T::U;
  const int nt = (b + BQ - 1) / BQ;
  const int gy = static_cast<int>(
      std::min<long>(nt, std::max<long>(4, target / std::max<long>(nu, 1))));
  const int gx = static_cast<int>(
      std::min<long>(nu, std::max<long>(1, target / gy)));
  if (gy > 65535) return (int)cudaErrorInvalidConfiguration;
  pq_adc_kernel<M, BQ><<<dim3(gx, gy), NT, smem, st>>>(codes, luts, n, k, b,
                                                       out);
  return (int)cudaGetLastError();
}

template <int M>
int dispatch(const uint8_t* codes, const float* luts, int n, int k, int b,
             int bq, float* out, cudaStream_t st) {
  switch (bq) {
    case 16: return launch<M, 16>(codes, luts, n, k, b, out, st);
    case 8: return launch<M, 8>(codes, luts, n, k, b, out, st);
    case 4: return launch<M, 4>(codes, luts, n, k, b, out, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// codes [n, m] u8, luts [b, m, k] f32 -> out [b, n] f32. m in {2, 4, 8,
// 16, 32}; bq (16, 8 or 4) queries a LUT tile, bq·m·k·4 bytes of
// shared memory.
int pq_adc(const void* codes, const void* luts, int n, int m, int k, int b,
           int bq, void* out, void* stream) {
  if (n <= 0 || b <= 0) return 0;
  const auto* c = static_cast<const uint8_t*>(codes);
  const auto* l = static_cast<const float*>(luts);
  auto* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (m) {
    case 2: return dispatch<2>(c, l, n, k, b, bq, o, st);
    case 4: return dispatch<4>(c, l, n, k, b, bq, o, st);
    case 8: return dispatch<8>(c, l, n, k, b, bq, o, st);
    case 16: return dispatch<16>(c, l, n, k, b, bq, o, st);
    case 32: return dispatch<32>(c, l, n, k, b, bq, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
