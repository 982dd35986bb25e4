// Tiled exact-distance kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel l2_tile (_l2_kernel) of
// repro/kernels/l2_tile.py:
//
//   out[i, j] = max(|q_i|^2 + |x_j|^2 - 2 q_i.x_j, 0)   (l2)
//   out[i, j] = -q_i.x_j                                  (ip)
//
// for q [Q, D] and x [N, D], f32 or bf16 (cast to f32 on load), out
// [Q, N] f32. It is the whole distance work of the segment build's brute
// force (ground truth, the NSG seed graph's exact kNN, range search).
//
// What bounds it on an H100 is operations: 2·Q·N·D multiply-adds against
// 4 bytes written per output (64 operations a byte at D = 128, above the
// card's 20 f32 operations per byte of HBM). The product runs on the CUDA
// cores in f32 FMA, never on the tensor cores: the kNN graph and the
// ground truth depend on f32 order, and TF32 keeps three decimal digits.
// Each output is one fmaf chain over k = 0 .. D-1 in order, each norm
// another, and the epilogue rounds step by step, so the result does not
// depend on the tiling.
//
// What keeps the FMA pipes from being fed, and what the design does:
//  * norms: a short pass of its own (norms_kernel) sums |q_i|^2 and
//    |x_j|^2 once per call, 128 rows a CTA staged through shared memory
//    so that its loads are coalesced; the product kernel reads them in
//    its epilogue and spends its FMAs on the dot products alone;
//  * register banks: a thread owns an 8 x 8 tile (rows ty*4 + {0..3}
//    and 64 + ty*4 + {0..3}, the same for columns with tx) and, for each
//    k, reads its 8 q and 8 x operands as four float4 from K-major tiles
//    in shared memory. Each operand then keeps one register for all k,
//    so the compiler can put every accumulator in the other register
//    bank from its x operand. (Row-major tiles read as float4 over four
//    k, fed by cp.async, give every operand of a k the same bank parity
//    and lose half the FMA issue to bank conflicts; that design was
//    measured slower, as was a TMA-store epilogue.)
//  * shared memory: the 32 lanes of a warp cover 4 x 8 of the 16 x 16
//    threads, so each float4 read has 4 or 8 distinct addresses (one
//    wavefront), and the transposed stores land in distinct banks;
//  * loads: a tile of BK = 8 columns of D goes through two buffers; each
//    thread loads its share of the next one with 16-byte loads into
//    registers while the FMAs of this one run, then stores it;
//  * two CTAs an SM (128 registers a thread), so one CTA's epilogue (the
//    4 bytes an output, coalesced 16-byte stores) overlaps the other's
//    FMAs; the CTAs take the q tiles fastest, so those in flight share
//    their x tiles in L2.
// The f32 path with D % 4 == 0 and 16-byte aligned operands loads 16
// bytes at a time; bf16, or any other D, loads one value at a time (cast
// on load, zero past the edge). Any Q, N and D: rows and columns past the
// edge are not written, so no padding copy is made.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BM = 128;       // q rows per tile
constexpr int BN = 128;       // x rows per tile
constexpr int BK = 8;         // D columns per stage
constexpr int LD = BM + 4;    // K-major row: the transposed stores spread
constexpr int NT = 256;       // threads per CTA (16 x 16)
constexpr int NORM_ROWS = 128;  // rows per norm CTA

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ------------------------------------------------------------------ norms

// out[row] = sum_k a[row, k]^2 by one sequential fmaf chain over k, for
// the q rows (CTAs [0, q_ctas)) and then the x rows.
template <typename T>
__global__ void __launch_bounds__(NORM_ROWS)
norms_kernel(const T* __restrict__ q, int qn, const T* __restrict__ x,
             int n, int d, int q_ctas, float* __restrict__ qq,
             float* __restrict__ xx) {
  __shared__ float s[NORM_ROWS][33];
  const bool is_q = blockIdx.x < q_ctas;
  const T* a = is_q ? q : x;
  const int rows = is_q ? qn : n;
  float* out = is_q ? qq : xx;
  const long row0 =
      static_cast<long>(is_q ? blockIdx.x : blockIdx.x - q_ctas) * NORM_ROWS;
  const int tid = threadIdx.x;
  float acc = 0.f;
  for (int k0 = 0; k0 < d; k0 += 32) {
    const int kw = min(32, d - k0);
    for (int e = tid; e < NORM_ROWS * 32; e += NORM_ROWS) {
      const int r = e >> 5, c = e & 31;
      const long gr = row0 + r;
      if (gr < rows && c < kw) s[r][c] = to_f32(a[gr * d + k0 + c]);
    }
    __syncthreads();
    for (int c = 0; c < kw; ++c) acc = fmaf(s[tid][c], s[tid][c], acc);
    __syncthreads();
  }
  if (row0 + tid < rows) out[row0 + tid] = acc;
}

// ---------------------------------------------------------------- product

// The thread's share of a 128 x BK stage of a row-major [rows, d] matrix:
// row tid / 2, columns k0 + (tid % 2) * 4 .. + 3, zero past the edges.
template <typename T, bool VEC>
__device__ __forceinline__ void load_stage(const T* __restrict__ a, int rows,
                                           int d, long row0, int k0,
                                           float (&v)[4]) {
  const long gr = row0 + (threadIdx.x >> 1);
  const int gk = k0 + (threadIdx.x & 1) * 4;
  if (VEC) {                       // f32, d % 4 == 0, 16-byte aligned
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (gr < rows && gk < d)
      t = *reinterpret_cast<const float4*>(
          reinterpret_cast<const float*>(a) + gr * d + gk);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      v[u] = (gr < rows && gk + u < d) ? to_f32(a[gr * d + gk + u]) : 0.f;
  }
}

// ... stored transposed, K-major: s[k][row].
__device__ __forceinline__ void store_stage(float* __restrict__ s,
                                            const float (&v)[4]) {
  const int r = threadIdx.x >> 1, k = (threadIdx.x & 1) * 4;
#pragma unroll
  for (int u = 0; u < 4; ++u) s[(k + u) * LD + r] = v[u];
}

// Column k of a stage into the thread's 8 x 8 accumulators.
__device__ __forceinline__ void fma_k(const float* __restrict__ qs,
                                      const float* __restrict__ xs, int k,
                                      int ty, int tx, float (&acc)[8][8]) {
  const float4 a0 = *reinterpret_cast<const float4*>(qs + k * LD + ty * 4);
  const float4 a1 =
      *reinterpret_cast<const float4*>(qs + k * LD + 64 + ty * 4);
  const float4 b0 = *reinterpret_cast<const float4*>(xs + k * LD + tx * 4);
  const float4 b1 =
      *reinterpret_cast<const float4*>(xs + k * LD + 64 + tx * 4);
  const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
}

__device__ __forceinline__ float dist(float qq, float xx, float dot,
                                      int ip) {
  return ip ? -dot
            : fmaxf(__fsub_rn(__fadd_rn(qq, xx), __fmul_rn(2.f, dot)), 0.f);
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT, 2)
l2_tile_kernel(const T* __restrict__ q, const T* __restrict__ x, int qn,
               int n, int d, int ip, const float* __restrict__ qqv,
               const float* __restrict__ xxv, float* __restrict__ out) {
  __shared__ __align__(16) float qs[2][BK * LD];
  __shared__ __align__(16) float xs[2][BK * LD];
  // a warp's lanes cover 4 x 8 of the 16 x 16 threads
  const int tid = threadIdx.x;
  const int tx = ((tid >> 5) & 1) * 8 + (tid & 7);
  const int ty = (tid >> 6) * 4 + ((tid & 31) >> 3);
  const int tiles_q = (qn + BM - 1) / BM;
  const long r0 = static_cast<long>(blockIdx.x % tiles_q) * BM;
  const long c0 = static_cast<long>(blockIdx.x / tiles_q) * BN;
  const int stages = (d + BK - 1) / BK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float vq[4], vx[4];
  load_stage<T, VEC>(q, qn, d, r0, 0, vq);
  load_stage<T, VEC>(x, n, d, c0, 0, vx);
  store_stage(qs[0], vq);
  store_stage(xs[0], vx);
  __syncthreads();

  for (int s = 0; s < stages; ++s) {
    const int cur = s & 1;
    if (s + 1 < stages) {          // the next stage's loads are in flight
      load_stage<T, VEC>(q, qn, d, r0, (s + 1) * BK, vq);
      load_stage<T, VEC>(x, n, d, c0, (s + 1) * BK, vx);
    }
    const int kw = min(BK, d - s * BK);
    if (kw == BK) {
#pragma unroll
      for (int k = 0; k < BK; ++k) fma_k(qs[cur], xs[cur], k, ty, tx, acc);
    } else {                       // the last stage of a ragged D
      for (int k = 0; k < kw; ++k) fma_k(qs[cur], xs[cur], k, ty, tx, acc);
    }
    if (s + 1 < stages) {          // the other buffer was read at s - 1
      store_stage(qs[cur ^ 1], vq);
      store_stage(xs[cur ^ 1], vx);
    }
    __syncthreads();
  }

  float xx[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const long c = c0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
    xx[j] = (!ip && c < n) ? xxv[c] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long r = r0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= qn) continue;
    const float qq = ip ? 0.f : qqv[r];
    float* row = out + r * n;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long c = c0 + h * 64 + tx * 4;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        v[j] = dist(qq, xx[h * 4 + j], acc[i][h * 4 + j], ip);
      if ((n & 3) == 0 && c + 3 < n) {
        *reinterpret_cast<float4*>(row + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < n) row[c + j] = v[j];
      }
    }
  }
}

template <typename T>
int launch(const void* qv, const void* xv, int qn, int n, int d, int ip,
           void* norms, void* outv, void* stream) {
  if (qn <= 0 || n <= 0) return 0;
  if (d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long tiles =
      static_cast<long>((qn + BM - 1) / BM) * ((n + BN - 1) / BN);
  if (tiles > 2147483647L)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const T* q = static_cast<const T*>(qv);
  const T* x = static_cast<const T*>(xv);
  float* out = static_cast<float*>(outv);
  float* qq = static_cast<float*>(norms);
  float* xx = ip ? nullptr : qq + qn;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!ip) {
    const int q_ctas = (qn + NORM_ROWS - 1) / NORM_ROWS;
    const int ctas = q_ctas + (n + NORM_ROWS - 1) / NORM_ROWS;
    norms_kernel<T><<<ctas, NORM_ROWS, 0, st>>>(q, qn, x, n, d, q_ctas, qq,
                                                xx);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const unsigned grid = static_cast<unsigned>(tiles);
  bool vec = false;
  if constexpr (std::is_same<T, float>::value)
    vec = d % 4 == 0 && ((reinterpret_cast<uintptr_t>(qv) |
                          reinterpret_cast<uintptr_t>(xv)) & 15) == 0;
  if (vec)
    l2_tile_kernel<T, true><<<grid, NT, 0, st>>>(q, x, qn, n, d, ip, qq, xx,
                                                 out);
  else
    l2_tile_kernel<T, false><<<grid, NT, 0, st>>>(q, x, qn, n, d, ip, qq,
                                                  xx, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q [qn, d], x [n, d] f32 -> out [qn, n] f32; ip != 0 gives -q.x.
// norms: scratch of qn + n floats (unused for ip).
int l2_tile_f32(const void* q, const void* x, int qn, int n, int d, int ip,
                void* norms, void* out, void* stream) {
  return launch<float>(q, x, qn, n, d, ip, norms, out, stream);
}

// The same for bf16 operands, each cast to f32 as it is loaded.
int l2_tile_bf16(const void* q, const void* x, int qn, int n, int d, int ip,
                 void* norms, void* out, void* stream) {
  return launch<__nv_bfloat16>(q, x, qn, n, d, ip, norms, out, stream);
}

}  // extern "C"
