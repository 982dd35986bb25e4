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
//
// Design (a classic register-blocked SGEMM, simple first):
//  * one CTA of 256 threads per 128 x 128 output tile; the q and x rows
//    are staged through shared memory BK = 8 columns of D at a time,
//    transposed so that each thread reads its operands with unit stride;
//  * each thread owns an 8 x 8 register tile: rows ty + 16 i, columns
//    tx + 16 j, so the 16 threads of a half-warp write 16 neighbouring
//    columns of a row (coalesced) and read neighbouring shared words
//    (no bank conflicts);
//  * both squared norms are summed in the kernel from the same staged
//    operands, in the same order over D as the dot product;
//  * any Q, N and D: rows and columns past the edge load as 0 and are
//    not written, so no padding copy is made.
// wgmma/TMA pipelines are later work; the f32 SIMT path is the rule here.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;       // q rows per CTA
constexpr int BN = 128;       // x rows per CTA
constexpr int BK = 8;         // D columns per stage
constexpr int TM = 8;         // rows per thread
constexpr int TN = 8;         // columns per thread
constexpr int NT = 256;       // threads per CTA (16 x 16)
constexpr int PAD = 4;        // shared-row padding (bank spread on store)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Load a BM x BK (or BN x BK) tile of rows [row0, row0 + 128) and columns
// [k0, k0 + BK) of a row-major [rows, d] matrix, transposed into s[BK][128+PAD].
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ a, int rows,
                                          int d, int row0, int k0,
                                          float (*s)[BM + PAD]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int e = tid; e < BM * BK; e += NT) {
    const int r = e / BK, c = e % BK;
    const int gr = row0 + r, gc = k0 + c;
    float v = 0.f;
    if (gr < rows && gc < d) v = to_f32(a[(size_t)gr * d + gc]);
    s[c][r] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT)
l2_tile_kernel(const T* __restrict__ q, const T* __restrict__ x, int qn,
               int n, int d, int ip, float* __restrict__ out) {
  __shared__ float qs[BK][BM + PAD];
  __shared__ float xs[BK][BN + PAD];

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.y * BM, x0 = blockIdx.x * BN;

  float acc[TM][TN];
  float qq[TM], xx[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    qq[i] = 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) xx[j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
    load_tile(q, qn, d, q0, k0, qs);
    load_tile(x, n, d, x0, k0, xs);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = qs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = xs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) qq[i] = fmaf(a[i], a[i], qq[i]);
#pragma unroll
      for (int j = 0; j < TN; ++j) xx[j] = fmaf(b[j], b[j], xx[j]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= qn) continue;
    float* row = out + (size_t)r * n;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = x0 + tx + 16 * j;
      if (c >= n) continue;
      const float dot = acc[i][j];
      row[c] = ip ? -dot
                  : fmaxf(__fsub_rn(__fadd_rn(qq[i], xx[j]),
                                    __fmul_rn(2.f, dot)), 0.f);
    }
  }
}

template <typename T>
int launch(const void* q, const void* x, int qn, int n, int d, int ip,
           void* out, void* stream) {
  if (qn <= 0 || n <= 0) return 0;
  dim3 grid((n + BN - 1) / BN, (qn + BM - 1) / BM);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  l2_tile_kernel<T><<<grid, NT, 0, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(x), qn, n, d, ip,
      static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [qn, d], x [n, d] f32 -> out [qn, n] f32; ip != 0 gives -q.x.
int l2_tile_f32(const void* q, const void* x, int qn, int n, int d, int ip,
                void* out, void* stream) {
  return launch<float>(q, x, qn, n, d, ip, out, stream);
}

// The same for bf16 operands, each cast to f32 as it is loaded.
int l2_tile_bf16(const void* q, const void* x, int qn, int n, int d, int ip,
                 void* out, void* stream) {
  return launch<__nv_bfloat16>(q, x, qn, n, d, ip, out, stream);
}

}  // extern "C"
