// Block-tile ranking for Hopper (sm_90a): the exact distances of a
// query to the ε residents of one gathered block, and the top-m slots.
//
// It replaces the Pallas TPU kernel repro/kernels/block_topk.py
// (block_topk, _rank_kernel), and computes what that kernel computes:
//
//   * the distance by the norm expansion, max(|t|^2 + |q|^2 - 2 q.t, 0)
//     (or -q.t for ip) — not the explicit difference of the round
//     kernels; the two differ by f32 rounding;
//   * the top-m slots by m rounds of masked argmin: the smallest value,
//     the lower slot on ties, then that slot is masked with 3e38. Past
//     the ε-th round every slot holds 3e38, so the lowest slot, 0, is
//     written, as the TPU kernel writes it.
//
// What bounds it on an H100 is bytes: it reads each tile once (ε·D
// floats a query) and does 2 multiply-adds per float read. One warp per
// query: the lanes split D, a warp reduction per slot gives every lane
// the slot's distance, lane 0 keeps the row's ε distances in shared
// memory, and each argmin round is a strided scan plus a warp reduction
// on (value, slot). No block-wide barrier: the warps of a CTA are
// independent queries.
//
// The entry point launches on the given stream and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;          // queries per CTA
constexpr float kMasked = 3.0e38f; // the TPU kernel's mask value

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool IP>
__global__ void block_topk_kernel(const float* __restrict__ q,
                                  const float* __restrict__ tiles, int qn,
                                  int eps, int d, int top_m,
                                  float* __restrict__ d_out,
                                  int* __restrict__ idx_out) {
  extern __shared__ float work[];                 // [kWarps][eps]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long qi = static_cast<long>(blockIdx.x) * kWarps + warp;
  if (qi >= qn) return;                           // the whole warp leaves
  float* w = work + warp * eps;
  const float* qrow = q + qi * d;

  float qq = 0.f;
  if (!IP) {
    for (int c = lane; c < d; c += 32) qq = fmaf(qrow[c], qrow[c], qq);
    qq = warp_sum(qq);
  }
  for (int e = 0; e < eps; ++e) {
    const float* t = tiles + (qi * eps + e) * d;
    float dot = 0.f, tt = 0.f;
    for (int c = lane; c < d; c += 32) {
      float x = t[c];
      dot = fmaf(x, qrow[c], dot);
      if (!IP) tt = fmaf(x, x, tt);
    }
    dot = warp_sum(dot);
    float dist;
    if (IP) {
      dist = -dot;
    } else {
      tt = warp_sum(tt);
      // (tt + qq) - 2 dot, rounded step by step (no contraction to fma)
      dist = fmaxf(__fsub_rn(__fadd_rn(tt, qq), __fmul_rn(2.f, dot)), 0.f);
    }
    if (lane == 0) {
      d_out[qi * eps + e] = dist;
      w[e] = dist;
    }
  }
  __syncwarp();

  for (int m = 0; m < top_m; ++m) {
    float best = INFINITY;
    int bi = 0x7fffffff;
    for (int e = lane; e < eps; e += 32) {
      float v = w[e];
      if (v < best || (v == best && e < bi)) {
        best = v;
        bi = e;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      float ov = __shfl_xor_sync(0xffffffffu, best, off);
      int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ov < best || (ov == best && oi < bi)) {
        best = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      idx_out[qi * top_m + m] = bi;
      w[bi] = kMasked;
    }
    __syncwarp();
  }
}

}  // namespace

extern "C" {

// queries [qn, d] f32 x tiles [qn, eps, d] f32 -> dists [qn, eps] f32,
// top_idx [qn, top_m] i32.
int block_topk(const float* q, const float* tiles, int qn, int eps, int d,
               int top_m, int ip, float* dists, int* top_idx,
               void* stream) {
  if (qn <= 0) return 0;
  const int ctas = (qn + kWarps - 1) / kWarps;
  const size_t smem = static_cast<size_t>(kWarps) * eps * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ip)
    block_topk_kernel<true><<<ctas, kWarps * 32, smem, st>>>(
        q, tiles, qn, eps, d, top_m, dists, top_idx);
  else
    block_topk_kernel<false><<<ctas, kWarps * 32, smem, st>>>(
        q, tiles, qn, eps, d, top_m, dists, top_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
