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
//     written, as the TPU kernel writes it. Inputs are finite (a NaN
//     distance has no place in that order).
//
// What bounds it on an H100 is bytes: it reads each tile once (ε·D
// floats a query) and does 2 multiply-adds per float read; at the served
// round's shape the ~5 µs of a launch is most of its time. One warp per
// query, four a CTA, no block barrier and no shared memory:
//  * every load of a pass is issued before any arithmetic: lane c reads
//    columns c, c+32, ... of all the pass's slots (SG slots, CU columns
//    a lane, SG·CU loads in flight);
//  * the slots are reduced together: the first log2(SG) steps of the xor
//    butterfly halve the slots a lane holds (a reduce-scatter), so SG
//    slots cost SG - 1 + 5 - log2(SG) shuffles a quantity, not 5·SG, and
//    one more shuffle brings slot e to lane e, which writes d_out[q, e]
//    in one coalesced store;
//  * the argmin rounds run on registers: the warp's minimum of the
//    (distance, slot) keys of the slots still unpicked is two
//    __reduce_min_sync, and the masked slots need no state but the last
//    pick and the lowest picked slot.
// The f32 order is the earlier kernel's: lane c sums its columns with
// fmaf in ascending order, then the partials meet in the xor pairs 16,
// 8, 4, 2, 1 (the reduce-scatter adds the same pairs: a + b is b + a in
// IEEE f32), then (tt + qq) - 2·dot rounded step by step. So the
// distances are bit-identical to it, and the slots equal too.
// ε > 32 slots (small D, or a larger η) take passes of 32 slots, one a
// lane each; the argmin rounds then read a lane's slots back from its own
// d_out stores.
//
// The entry point launches on the given stream and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int kWarps = 4;          // queries per CTA
constexpr float kMasked = 3.0e38f; // the TPU kernel's mask value

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// The xor butterfly from offset OFF down, CNT slots a lane: while a lane
// holds more than one slot, a step keeps half of them (the upper half
// where lane & OFF) and adds the partner's partial of each; then the
// plain steps. Slot k's total lands on the lanes with
// lane >> (5 - log2 CNT) == k. CNT and OFF are template constants, so
// every index into acc is one and acc stays in registers.
template <int CNT, int OFF>
__device__ __forceinline__ float reduce_scatter(float* acc, int lane) {
  if constexpr (OFF == 0) {
    return acc[0];
  } else if constexpr (CNT > 1) {
    const bool up = (lane & OFF) != 0;
#pragma unroll
    for (int k = 0; k < CNT / 2; ++k) {
      const float give = up ? acc[k] : acc[k + CNT / 2];
      const float keep = up ? acc[k + CNT / 2] : acc[k];
      acc[k] = keep + __shfl_xor_sync(FULL, give, OFF);
    }
    return reduce_scatter<CNT / 2, OFF / 2>(acc, lane);
  } else {
    acc[0] += __shfl_xor_sync(FULL, acc[0], OFF);
    return reduce_scatter<1, OFF / 2>(acc, lane);
  }
}

// An unsigned key in the order of the float (-0 counted as +0).
__device__ __forceinline__ unsigned fkey(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// SG: slots a pass (a power of two, 32 where MULTI: ε > 32).
template <bool IP, int SG, bool MULTI>
__global__ void __launch_bounds__(kWarps * 32)
block_topk_kernel(const float* __restrict__ q, const float* __restrict__ tiles,
                  int qn, int eps, int d, int top_m, float* d_out,
                  int* __restrict__ idx_out) {
  constexpr int CU = SG <= 8 ? 4 : (SG == 16 ? 2 : 1);  // columns a lane
  // slot k's total sits on lane k << SHIFT after the reduce-scatter
  constexpr int SHIFT = SG == 32 ? 0 : SG == 16 ? 1 : SG == 8 ? 2
                        : SG == 4 ? 3 : SG == 2 ? 4 : 5;
  const int lane = threadIdx.x & 31;
  const long qi = static_cast<long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (qi >= qn) return;                           // the whole warp leaves
  const float* qrow = q + qi * d;
  const float* trow = tiles + qi * eps * d;
  float* drow = d_out + qi * eps;

  float qq = 0.f, mine = 0.f;
  for (int g0 = 0; g0 < eps; g0 += 32) {          // one pass unless MULTI
    const int ns = min(SG, eps - g0);
    const float* t = trow + static_cast<long>(g0) * d;
    float dot[SG], tt[SG];
#pragma unroll
    for (int k = 0; k < SG; ++k) dot[k] = tt[k] = 0.f;
    for (int c0 = 0; c0 < d; c0 += 32 * CU) {
      float qv[CU], x[SG][CU];
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const int c = c0 + 32 * u + lane;
        qv[u] = c < d ? qrow[c] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < SG; ++k)
#pragma unroll
        for (int u = 0; u < CU; ++u) {
          const int c = c0 + 32 * u + lane;
          x[k][u] = (k < ns && c < d) ? t[static_cast<long>(k) * d + c] : 0.f;
        }
#pragma unroll
      for (int u = 0; u < CU; ++u)
        if (!IP && g0 == 0 && c0 + 32 * u + lane < d)
          qq = fmaf(qv[u], qv[u], qq);
#pragma unroll
      for (int k = 0; k < SG; ++k)
#pragma unroll
        for (int u = 0; u < CU; ++u)
          if (c0 + 32 * u + lane < d) {
            dot[k] = fmaf(x[k][u], qv[u], dot[k]);
            if (!IP) tt[k] = fmaf(x[k][u], x[k][u], tt[k]);
          }
    }
    if (!IP && g0 == 0) qq = warp_sum(qq);
    float dist;
    if (IP) {
      dist = -reduce_scatter<SG, 16>(dot, lane);
    } else {
      const float sd = reduce_scatter<SG, 16>(dot, lane);
      const float st = reduce_scatter<SG, 16>(tt, lane);
      // (tt + qq) - 2 dot, rounded step by step (no contraction to fma)
      dist = fmaxf(__fsub_rn(__fadd_rn(st, qq), __fmul_rn(2.f, sd)), 0.f);
    }
    const float v = __shfl_sync(FULL, dist, (lane << SHIFT) & 31);
    if (lane < ns) drow[g0 + lane] = v;            // slot g0 + lane
    if (!MULTI) mine = v;
  }

  // m rounds of masked argmin. Picks of real slots come in ascending
  // (distance, slot) order, so the slots still unpicked are those above
  // the last pick (lk, ls); every picked slot holds kMasked, and of those
  // the lowest, lm, is the masked candidate.
  const unsigned km = fkey(kMasked);
  unsigned lk = 0;
  int ls = -1, lm = INT_MAX, held = 0;
  for (int m = 0; m < top_m; ++m) {
    unsigned ck = FULL;
    int cs = INT_MAX;
    if (!MULTI) {
      if (lane < eps) {
        const unsigned k = fkey(mine);
        if (k > lk || (k == lk && lane > ls)) {
          ck = k;
          cs = lane;
        }
      }
    } else {
      for (int s = lane; s < eps; s += 32) {       // this lane's own stores
        const unsigned k = fkey(drow[s]);
        if ((k > lk || (k == lk && s > ls)) && k < ck) {
          ck = k;
          cs = s;
        }
      }
    }
    const unsigned mk = __reduce_min_sync(FULL, ck);
    const unsigned ms = __reduce_min_sync(
        FULL, ck == mk ? static_cast<unsigned>(cs) : FULL);
    int pick;
    if (lm != INT_MAX && (km < mk || (km == mk &&
                                      static_cast<unsigned>(lm) < ms))) {
      pick = lm;
    } else {
      pick = static_cast<int>(ms);
      lk = mk;
      ls = pick;
      lm = min(lm, pick);
    }
    if ((m & 31) == lane) held = pick;
    if ((m & 31) == 31 || m == top_m - 1)          // one store a 32 rounds
      if (lane <= (m & 31)) idx_out[qi * top_m + (m & ~31) + lane] = held;
  }
}

template <bool IP, int SG, bool MULTI>
void launch(const float* q, const float* tiles, int qn, int eps, int d,
            int top_m, float* dists, int* top_idx, cudaStream_t st) {
  const int ctas = (qn + kWarps - 1) / kWarps;
  block_topk_kernel<IP, SG, MULTI><<<ctas, kWarps * 32, 0, st>>>(
      q, tiles, qn, eps, d, top_m, dists, top_idx);
}

template <bool IP>
void dispatch(const float* q, const float* tiles, int qn, int eps, int d,
              int top_m, float* dists, int* top_idx, cudaStream_t st) {
  if (eps > 32)
    launch<IP, 32, true>(q, tiles, qn, eps, d, top_m, dists, top_idx, st);
  else if (eps > 16)
    launch<IP, 32, false>(q, tiles, qn, eps, d, top_m, dists, top_idx, st);
  else if (eps > 8)
    launch<IP, 16, false>(q, tiles, qn, eps, d, top_m, dists, top_idx, st);
  else if (eps > 4)
    launch<IP, 8, false>(q, tiles, qn, eps, d, top_m, dists, top_idx, st);
  else if (eps > 2)
    launch<IP, 4, false>(q, tiles, qn, eps, d, top_m, dists, top_idx, st);
  else if (eps > 1)
    launch<IP, 2, false>(q, tiles, qn, eps, d, top_m, dists, top_idx, st);
  else
    launch<IP, 1, false>(q, tiles, qn, eps, d, top_m, dists, top_idx, st);
}

}  // namespace

extern "C" {

// queries [qn, d] f32 x tiles [qn, eps, d] f32 -> dists [qn, eps] f32,
// top_idx [qn, top_m] i32.
int block_topk(const float* q, const float* tiles, int qn, int eps, int d,
               int top_m, int ip, float* dists, int* top_idx,
               void* stream) {
  if (qn <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ip)
    dispatch<true>(q, tiles, qn, eps, d, top_m, dists, top_idx, st);
  else
    dispatch<false>(q, tiles, qn, eps, d, top_m, dists, top_idx, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
