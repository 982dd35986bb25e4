// Batched PQ asymmetric-distance (ADC) kernel for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pq_adc (_adc_kernel) of
// repro/kernels/pq_adc.py:
//
//   out[b, n] = sum_m luts[b, m, codes[n, m]]
//
// codes [N, M] u8, luts [B, M, K] f32 -> out [B, N] f32 (the layout of
// repro.kernels.ops.pq_adc_batch).
//
// The TPU kernel expands each code tile into a one-hot [BN, M*K] matrix
// and multiplies it into the LUTs on the MXU, because the TPU's vector
// unit gathers poorly. A GPU gathers from shared memory well, so this
// kernel does the table lookups directly.
//
// What bounds it on an H100 is bytes: the [B, N] f32 output (4 bytes per
// M adds) dwarfs the codes and the LUTs. Design:
//  * grid (row tiles, query tiles); a CTA holds the LUTs of its BQ
//    queries in shared memory (BQ·M·K·4 bytes, 64 KB at BQ = 8, M = 8,
//    K = 256), read once from the L2-resident LUT array;
//  * each thread takes one code row at a time, with its neighbours on
//    the neighbouring rows, and sums its M lookups for each of the BQ
//    queries in order m = 0, 1, ..., so out[b, n0..n0+255] is written by
//    one CTA's threads in order (coalesced);
//  * a CTA walks ROWS_PER_CTA rows, so each LUT byte staged in shared
//    memory serves many rows.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;
constexpr int ROWS_PER_CTA = 4096;

__global__ void __launch_bounds__(NT)
pq_adc_kernel(const uint8_t* __restrict__ codes,
              const float* __restrict__ luts, int n, int m, int k, int b,
              int bq, float* __restrict__ out) {
  extern __shared__ float lut_s[];                 // [bq][m][k]
  const int q0 = blockIdx.y * bq;
  const int nq = min(bq, b - q0);
  const int table = m * k;
  const float* src = luts + (size_t)q0 * table;
  for (int i = threadIdx.x; i < nq * table; i += NT) lut_s[i] = src[i];
  __syncthreads();

  const int r0 = blockIdx.x * ROWS_PER_CTA;
  const int r1 = min(r0 + ROWS_PER_CTA, n);
  for (int r = r0 + threadIdx.x; r < r1; r += NT) {
    const uint8_t* c = codes + (size_t)r * m;
    for (int qi = 0; qi < nq; ++qi) {
      const float* lut = lut_s + qi * table;
      float acc = 0.f;
      for (int j = 0; j < m; ++j)
        acc += lut[j * k + min((int)__ldg(c + j), k - 1)];
      out[(size_t)(q0 + qi) * n + r] = acc;
    }
  }
}

}  // namespace

extern "C" {

// codes [n, m] u8, luts [b, m, k] f32 -> out [b, n] f32. bq queries per
// CTA; bq·m·k·4 bytes of shared memory must fit the card.
int pq_adc(const void* codes, const void* luts, int n, int m, int k, int b,
           int bq, void* out, void* stream) {
  if (n <= 0 || b <= 0) return 0;
  const size_t smem = (size_t)bq * m * k * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      pq_adc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n + ROWS_PER_CTA - 1) / ROWS_PER_CTA, (b + bq - 1) / bq);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  pq_adc_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const float*>(luts), n,
      m, k, b, bq, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

}  // extern "C"
