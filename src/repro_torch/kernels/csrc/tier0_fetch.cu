// Round kernels of the batched device search, written for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of repro/kernels/tier0_fetch.py:
//
//   t0_gather_union       <-  gather_union (_union_into_smem,
//                             _gather_union_kernel, _gather_union_dma_kernel,
//                             _double_buffered_gather)
//   t0_gather             <-  gather_unique (_gather_unique_kernel,
//                             _gather_unique_dma_kernel)
//   t0_rank               <-  fused_round pass 2b (_rank_kernel)
//   t0_fetch_rank         <-  tier0_fetch_rank (_probe_kernel)
//
// Their bound on an H100 is bytes, not arithmetic: a round moves a few MB
// of block payload (ε·D floats, ε ids, ε·Λ neighbour ids per block) and
// computes Q·F·ε·D multiply-adds, some 10^2 operations per KB. At a
// round's sizes that is ~2-4 µs of HBM time, so what they take beyond it
// is the launch and chains of dependent memory latencies, which the
// designs below keep short.
//
//  * Union and copy (t0_gather_union), one launch. The TPU kernel uses an
//    O(R^2) sort-free formulation because Mosaic has no sort. Here the keys
//    are block ids, so the union is a presence bitmap over the rho blocks
//    (rho / 8 bytes: 20.8 KB at rho = 166,667) with a popcount prefix per
//    group of 32 words: a slot's rank is the prefix of its word's group
//    plus the popcounts before it, and the j-th union row is the j-th set
//    bit. Every CTA builds the bitmap itself from the R keys (4 bytes each,
//    read from L2), so no CTA waits for another and there is no cap on R;
//    each then writes the ranks of its share of the slots, and uniq and
//    the copy of its share of the union rows, a warp per row with 16-byte
//    moves, eight in flight a lane. Rows past the distinct count hold
//    block 0, as the plain version's do. Where the bitmap does not fit a
//    CTA's shared memory (rho past ~1.8M blocks), a first launch marks it
//    in device memory that the wrapper zeroed, and the CTAs read it from
//    L2. Keys must lie in [0, rho), as the serving path's do; one outside
//    is clamped into range, so the kernel reads no memory outside the
//    store (its outputs then need not equal the plain version's).
//  * Gather (t0_gather, gather_unique). A warp per union row, four rows a
//    CTA, copies the row's block with the union kernel's row copy
//    (warp_copy): the vectors, ids and neighbour rows laid end to end,
//    eight moves a lane a pass, every load of a pass issued before its
//    first store. A served row (192 + 6 + 36 moves) is one pass, so one
//    memory round trip, where a CTA per row and one array after the other
//    took three.
//  * Rank. What bounds it on this card is latency, not bytes: a query's
//    work is ~10 KB, and each query waits on a chain of dependent loads
//    (u and rank2d -> uniq -> hot_slot_of -> the payload). One warp per
//    query, four queries a CTA, no block barrier: the warp reads its
//    row's u and rank2d together (the tile's u, with 16-byte loads and a
//    ballot, only where the row itself picked nothing: 0.3-0.45 µs less
//    than reading both), lanes 0..F-1 walk uniq -> hot_slot_of, and then
//    every payload load is issued before any arithmetic or store: the
//    first pass of the neighbour rows (F runs of ε·Λ words, 16-byte
//    moves where aligned), the ε·F ids (one slot a lane), and the ε·D
//    floats of 16 slots at a time (warp_dists). The 16 slots' partial
//    sums meet by a reduce-scatter that adds the same pairs as a plain
//    xor butterfly, so the distances are the probe's bits. The selection
//    key goes through shared memory (one row of F·ε words a warp) and the
//    stable rank is a count over it: fewer, plus equal with a lower
//    index, which is exactly argsort(stable)[:n_expand]. An idle tile
//    writes its sentinels with 16-byte stores.
//  * Probe (tier0_fetch_rank). The rank pass's probe and distance without
//    its broadcast and order. Its traffic is the tiles of the named
//    blocks, some 3 KB a (query, block) pair, so what bounds it is the
//    chain blocks -> hot_slot_of -> the tile. A warp per pair, P_WARPS
//    pairs a CTA, no shared memory and no barrier: every lane reads the
//    pair's block id and its hot slot (one word each, the same for the
//    warp), and then the loads of all of the block's ε rows (P_SG rows a
//    pass, warp_dists) are in flight before any arithmetic; a served
//    block (ε = 6) is one pass, so one chain of three dependent loads.
//    No row couples the pairs (there is no order to rank), so a wide
//    round gives more warps, not longer chains. The distances are the
//    rank pass's bits: warp_dists adds the same pairs for any slot count.
//
// Every index read from an input is clamped into range, as the JAX
// gathers clamp. Each entry point launches on the given stream and
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// n words at a and b move as 16-byte words: both 16-byte aligned and n a
// multiple of 4.
__device__ __forceinline__ bool wide_ok(const void* a, const void* b,
                                        long n) {
  return n % 4 == 0 && ((reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b)) & 15) == 0;
}

// Unit i of an array moved in 16-byte words (wide) or in single words
// (carried in .x).
__device__ __forceinline__ int4 load_unit(const int* __restrict__ src,
                                          long i, bool wide) {
  return wide ? reinterpret_cast<const int4*>(src)[i]
              : make_int4(src[i], 0, 0, 0);
}

__device__ __forceinline__ void store_unit(int* __restrict__ dst, long i,
                                           int4 v, bool wide) {
  if (wide)
    reinterpret_cast<int4*>(dst)[i] = v;
  else
    dst[i] = v.x;
}

// One block-store row by one warp: three int arrays (vectors, ids,
// neighbour rows), each in 16-byte words where wide_ok, else in single
// words. Their units are laid end to end and taken eight a lane a pass;
// every load of a pass is issued before its first store, so a row of up
// to 256 units costs one memory round trip.
__device__ __forceinline__ void warp_copy(
    int* __restrict__ d0, const int* __restrict__ s0, long n0,
    int* __restrict__ d1, const int* __restrict__ s1, long n1,
    int* __restrict__ d2, const int* __restrict__ s2, long n2, int lane) {
  const bool w0 = wide_ok(d0, s0, n0), w1 = wide_ok(d1, s1, n1),
             w2 = wide_ok(d2, s2, n2);
  const long e0 = w0 ? n0 / 4 : n0;
  const long e1 = e0 + (w1 ? n1 / 4 : n1);
  const long total = e1 + (w2 ? n2 / 4 : n2);
  for (long i0 = lane; i0 < total; i0 += 8 * 32) {
    int4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long i = i0 + 32 * k;
      if (i < e0)
        v[k] = load_unit(s0, i, w0);
      else if (i < e1)
        v[k] = load_unit(s1, i - e0, w1);
      else if (i < total)
        v[k] = load_unit(s2, i - e1, w2);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const long i = i0 + 32 * k;
      if (i < e0)
        store_unit(d0, i, v[k], w0);
      else if (i < e1)
        store_unit(d1, i - e0, v[k], w1);
      else if (i < total)
        store_unit(d2, i - e1, v[k], w2);
    }
  }
}

// n copies of v from dst on, by one warp: single words up to the first
// 16-byte boundary, 16-byte stores, single words after.
__device__ __forceinline__ void warp_fill(int* __restrict__ dst, long n,
                                          int v, int lane) {
  long head = static_cast<long>(
      (16 - (reinterpret_cast<uintptr_t>(dst) & 15)) & 15) >> 2;
  head = head < n ? head : n;
  if (lane < head) dst[lane] = v;
  int4* d4 = reinterpret_cast<int4*>(dst + head);
  const long n4 = (n - head) >> 2;
  const int4 v4 = make_int4(v, v, v, v);
  for (long i = lane; i < n4; i += 32) d4[i] = v4;
  for (long i = head + 4 * n4 + lane; i < n; i += 32) dst[i] = v;
}

// ------------------------------------------------------------------ union

constexpr int U_NT = 512;     // threads of a union CTA (16 warps)
constexpr int U_ROWS = 16;    // union rows a CTA takes at the least

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
  for (int off = 1; off < 32; off <<= 1) {
    int t = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += t;
  }
  return v;
}

// Sets bit k of the device bitmap for every key (the form for a rho whose
// bitmap does not fit a CTA's shared memory; the wrapper zeroes it).
__global__ void mark_kernel(const int* __restrict__ b, int r, int rho,
                            unsigned* __restrict__ bm) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < r) {
    const int k = clampi(b[i], 0, rho - 1);
    atomicOr(bm + (k >> 5), 1u << (k & 31));
  }
}

// Union and copy in one pass. Every CTA derives the union itself from the
// r keys (a few KB, read from L2): a presence bitmap over the rho blocks
// (in shared memory, or the device bitmap mark_kernel set), the popcount
// of each group of 32 words, and their exclusive prefix gpre. Then
//   rank(k)  = gpre[k >> 10] + popc of the words before k's in its group
//              + popc(word & bits below k),
//   uniq[j]  = the j-th set bit (a binary search of gpre, a warp scan of
//              the group's popcounts, then the bit within the word),
// so no CTA waits for another. A CTA takes a contiguous share of the
// slots (their ranks) and of the union rows (uniq and the row's copy, a
// warp per row, warp_copy); rows past the distinct count copy block 0,
// as uniq holds 0 there.
template <bool SMEM_BM>
__global__ void __launch_bounds__(U_NT)
union_gather_kernel(const int* __restrict__ b, int r, int rho,
                    const unsigned* __restrict__ dev_bm,
                    const float* __restrict__ vecs,
                    const int* __restrict__ vid,
                    const int* __restrict__ nbrs, int eps, int d, int lam,
                    int* __restrict__ uniq, int* __restrict__ rank,
                    float* __restrict__ tv, int* __restrict__ ti,
                    int* __restrict__ tn) {
  extern __shared__ unsigned usm[];
  const int words = (rho + 31) >> 5, groups = (words + 31) >> 5;
  unsigned* gpre = usm;                           // [groups + 1]
  const unsigned* bm = dev_bm;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = U_NT / 32;

  if (SMEM_BM) {
    unsigned* sbm = usm + groups + 1;             // [words]
    for (int w = tid; w < words; w += U_NT) sbm[w] = 0u;
    __syncthreads();
    for (int i = tid; i < r; i += U_NT) {
      const int k = clampi(b[i], 0, rho - 1);
      atomicOr(sbm + (k >> 5), 1u << (k & 31));
    }
    __syncthreads();
    bm = sbm;
  }

  for (int g = warp; g < groups; g += nwarps) {   // group popcounts
    const int w = (g << 5) + lane;
    int c = w < words ? __popc(bm[w]) : 0;
    for (int off = 16; off > 0; off >>= 1)
      c += __shfl_xor_sync(0xffffffffu, c, off);
    if (lane == 0) gpre[g + 1] = c;
  }
  __syncthreads();
  if (warp == 0) {                                // exclusive prefix
    int carry = 0;
    for (int g0 = 0; g0 < groups; g0 += 32) {
      const int g = g0 + lane;
      const int v = warp_incl_scan(g < groups ? gpre[g + 1] : 0, lane);
      if (g < groups) gpre[g + 1] = carry + v;
      carry += __shfl_sync(0xffffffffu, v, 31);
    }
    if (lane == 0) gpre[0] = 0;
  }
  __syncthreads();
  const int distinct = gpre[groups];

  const int per = max(U_ROWS, (r + gridDim.x - 1) / gridDim.x);
  const int lo = min(r, static_cast<int>(blockIdx.x) * per);
  const int hi = min(r, lo + per);

  for (int i = lo + tid; i < hi; i += U_NT) {     // slot ranks
    const int k = clampi(b[i], 0, rho - 1);
    const int w = k >> 5, base = w & ~31;
    int c = gpre[w >> 5] + __popc(bm[w] & ((1u << (k & 31)) - 1u));
#pragma unroll
    for (int t = 0; t < 32; ++t)
      if (base + t < w) c += __popc(bm[base + t]);
    rank[i] = c;
  }

  const long vd = static_cast<long>(eps) * d, vl = static_cast<long>(eps) * lam;
  for (int j = lo + warp; j < hi; j += nwarps) {  // union rows
    int blk = 0;
    if (j < distinct) {
      int g0 = 0, g1 = groups - 1;                // last g: gpre[g] <= j
      while (g0 < g1) {
        const int mid = (g0 + g1 + 1) >> 1;
        if (static_cast<int>(gpre[mid]) <= j) g0 = mid; else g1 = mid - 1;
      }
      const int w = (g0 << 5) + lane;
      const unsigned word = w < words ? bm[w] : 0u;
      const int pc = __popc(word);
      const int incl = static_cast<int>(gpre[g0]) + warp_incl_scan(pc, lane);
      const int at = __ffs(__ballot_sync(0xffffffffu, incl > j)) - 1;
      unsigned m = word;
      for (int t = lane == at ? j - (incl - pc) : 0; t > 0; --t) m &= m - 1u;
      blk = __shfl_sync(0xffffffffu, (w << 5) + __ffs(m) - 1, at);
    }
    if (lane == 0) uniq[j] = blk;
    warp_copy(reinterpret_cast<int*>(tv + j * vd),
              reinterpret_cast<const int*>(vecs + blk * vd), vd,
              ti + static_cast<long>(j) * eps,
              vid + static_cast<long>(blk) * eps, eps, tn + j * vl,
              nbrs + blk * vl, vl, lane);
  }
}

// ----------------------------------------------------------------- gather

constexpr int G_WARPS = 4;    // union rows (warps) a gather CTA

__global__ void __launch_bounds__(G_WARPS * 32)
gather_kernel(const int* __restrict__ uniq, int r, int rho,
              const float* __restrict__ vecs, const int* __restrict__ vid,
              const int* __restrict__ nbrs, int eps, int d, int lam,
              float* __restrict__ tv, int* __restrict__ ti,
              int* __restrict__ tn) {
  const long row = static_cast<long>(blockIdx.x) * G_WARPS + (threadIdx.x >> 5);
  if (row >= r) return;
  const long blk = clampi(uniq[row], 0, rho - 1);
  const long vd = static_cast<long>(eps) * d, vl = static_cast<long>(eps) * lam;
  warp_copy(reinterpret_cast<int*>(tv + row * vd),
            reinterpret_cast<const int*>(vecs + blk * vd), vd,
            ti + row * eps, vid + blk * eps, eps, tn + row * vl,
            nbrs + blk * vl, vl, threadIdx.x & 31);
}

// --------------------------------------------------------------- distance

// The xor butterfly from offset OFF down, CNT slots a lane: while a lane
// holds more than one slot, a step keeps half of them (the upper half
// where lane & OFF) and adds the partner's partial of each; then the
// plain steps. CNT and OFF are template constants, so every index into
// acc is one and acc stays in registers (a loop over a run-time count
// put it in local memory).
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

// Distances of ns <= SG slot rows t[0..ns) to the query q, d floats each,
// by one warp, in one f32 order: lane c sums columns c, c+32, ... of a
// slot with fmaf in ascending order (the loads of all SG slots and four
// columns a lane in flight at once), then the lanes' partial sums meet in
// the pairs of an xor butterfly with offsets 16, 8, 4, 2, 1. For SG > 1
// the first log2(SG) steps halve the slots a lane holds (a reduce-
// scatter: each sum is still a + b of the same two partials, and a + b is
// b + a in IEEE f32), so slot k's total lands on the lanes with
// lane >> (5 - log2 SG) == k; for SG = 1 every lane holds it. Returns the
// lane's total: sum((t - q)^2), or -sum(q * t) for ip. The rank and the
// probe kernels both use it, so both give the same bits.
template <bool IP, int SG>
__device__ __forceinline__ float warp_dists(const float* const* t, int ns,
                                            const float* __restrict__ q,
                                            int d, int lane) {
  static_assert(SG >= 1 && SG <= 32 && (SG & (SG - 1)) == 0,
                "SG: a power of two up to 32");
  constexpr int CU = 4;                          // columns a lane a pass
  float acc[SG];
#pragma unroll
  for (int k = 0; k < SG; ++k) acc[k] = 0.f;
  for (int c0 = 0; c0 < d; c0 += 32 * CU) {
    float qv[CU], x[SG][CU];
#pragma unroll
    for (int u = 0; u < CU; ++u) {
      const int c = c0 + 32 * u + lane;
      qv[u] = c < d ? q[c] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < SG; ++k)
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        const int c = c0 + 32 * u + lane;
        x[k][u] = (k < ns && c < d) ? t[k][c] : 0.f;
      }
#pragma unroll
    for (int k = 0; k < SG; ++k)
#pragma unroll
      for (int u = 0; u < CU; ++u) {
        if (c0 + 32 * u + lane < d) {
          if (IP) {
            acc[k] = fmaf(x[k][u], qv[u], acc[k]);
          } else {
            const float df = x[k][u] - qv[u];
            acc[k] = fmaf(df, df, acc[k]);
          }
        }
      }
  }
  const float sum = reduce_scatter<SG, 16>(acc, lane);
  return IP ? -sum : sum;
}

// ------------------------------------------------------------------- rank

constexpr int R_WARPS = 4;    // queries (warps) a rank CTA
constexpr int R_SG = 16;      // slots a distance pass takes
constexpr int R_NB = 4;       // neighbour units a lane a pass
static_assert(R_SG == 16, "rank_kernel reads slot k's total on lane 2k");

// A lane's place in a row of runs laid end to end, n units a run: run j,
// unit off. One division where it starts; a step moves 32 units on by
// subtraction (once where a run is at least a warp long).
struct RunPos {
  int j, off;
  __device__ __forceinline__ RunPos(int i, int n) : j(i / n), off(i % n) {}
  __device__ __forceinline__ void step(int n) {
    off += 32;
    while (off >= n) {
      off -= n;
      ++j;
    }
  }
};

// The row of n words that block `ref` holds: a hot slot where ref >= 0,
// else the cold copy's union row ~ref.
template <typename T>
__device__ __forceinline__ const T* run_src(int ref, const T* hot,
                                            const T* cold, long n) {
  return ref >= 0 ? hot + ref * n : cold + static_cast<long>(~ref) * n;
}

// Pass 2b, one warp per query row, R_WARPS rows a CTA; shared memory
// holds a row of 2·F + F·ε words a warp (each block's source, the picked
// ids, the selection key).
template <bool IP>
__global__ void __launch_bounds__(R_WARPS * 32) rank_kernel(
    const float* __restrict__ q, const int* __restrict__ u,
    const int* __restrict__ rank2d, const int* __restrict__ uniq, int r,
    const int* __restrict__ hot_slot_of, int rho,
    const float* __restrict__ hot_vecs, const int* __restrict__ hot_vid,
    const int* __restrict__ hot_nbrs, int h, const float* __restrict__ tv,
    const int* __restrict__ ti, const int* __restrict__ tn, int qn, int f,
    int eps, int d, int lam, int n_expand, int bq,
    float* __restrict__ dd_out, int* __restrict__ vid_out,
    int* __restrict__ nbrs_out, int* __restrict__ hit_out,
    int* __restrict__ ord_out) {
  extern __shared__ int sm[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long qi = static_cast<long>(blockIdx.x) * R_WARPS + w;
  if (qi >= qn) return;
  const int fe = f * eps;
  int* ref = sm + w * (2 * f + fe);                // [f] block source
  int* uu = ref + f;                               // [f] picked ids
  float* key = reinterpret_cast<float*>(uu + f);   // [fe] selection key

  // the row's u and rank2d, in flight together; the tile's u only where
  // the row itself picked nothing
  const int* urow = u + qi * f;
  const int* rrow = rank2d + qi * f;
  int my_u = -1, my_r = 0;
  if (lane < f) {
    my_u = urow[lane];
    my_r = rrow[lane];
  }
  const long t0 = (qi / bq) * bq * f, nt = static_cast<long>(bq) * f;
  bool any = false;
  if (__any_sync(FULL, my_u >= 0))
    any = true;
  else if (((t0 | nt) & 3) == 0 && (reinterpret_cast<uintptr_t>(u) & 15) == 0) {
    const int4* u4 = reinterpret_cast<const int4*>(u + t0);
#pragma unroll 4
    for (long i = lane; i < nt / 4; i += 32) {
      const int4 v = u4[i];
      any |= (v.x >= 0) | (v.y >= 0) | (v.z >= 0) | (v.w >= 0);
    }
  } else {
#pragma unroll 4
    for (long i = lane; i < nt; i += 32) any |= u[t0 + i] >= 0;
  }
  if (!__any_sync(FULL, any)) {                    // all-idle tile
    warp_fill(reinterpret_cast<int*>(dd_out + qi * fe), fe, 0, lane);
    warp_fill(vid_out + qi * fe, fe, -1, lane);
    warp_fill(nbrs_out + qi * fe * lam, static_cast<long>(fe) * lam, -1,
              lane);
    warp_fill(hit_out + qi * f, f, 0, lane);
    warp_fill(ord_out + qi * n_expand, n_expand, 0, lane);
    return;
  }

  // tier-0 probe: rank2d -> uniq -> hot_slot_of, a lane per block
  for (int j = lane; j < f; j += 32) {
    const int rr = clampi(j == lane ? my_r : rrow[j], 0, r - 1);
    const int blk = clampi(uniq[rr], 0, rho - 1);
    const int hs = hot_slot_of[blk];
    ref[j] = hs >= 0 ? min(hs, h - 1) : ~rr;
    uu[j] = j == lane ? my_u : urow[j];
    hit_out[qi * f + j] = hs >= 0 ? 1 : 0;
  }
  __syncwarp();

  // every payload load before any arithmetic or store: the first pass of
  // the neighbour rows (F runs of ε·Λ words, laid end to end in the
  // output row) ...
  const long nl = static_cast<long>(eps) * lam;
  int* nrow = nbrs_out + qi * fe * lam;
  const bool nwide = nl % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(nbrs_out) |
        reinterpret_cast<uintptr_t>(hot_nbrs) |
        reinterpret_cast<uintptr_t>(tn)) & 15) == 0;
  const int nu = static_cast<int>(nwide ? nl / 4 : nl);   // units a run
  const long ntot = static_cast<long>(f) * nu;
  RunPos np(lane, nu);
  int4 nv[R_NB];
#pragma unroll
  for (int k = 0; k < R_NB; ++k) {
    if (lane + 32 * k < ntot) {
      nv[k] = load_unit(run_src(ref[np.j], hot_nbrs, tn, nl), np.off, nwide);
      np.step(nu);
    }
  }
  // ... the id of slot `lane` ...
  RunPos vp(lane, eps);
  int v0 = -1;
  if (lane < fe) v0 = run_src(ref[vp.j], hot_vid, ti, eps)[vp.off];
  // ... and the vectors, R_SG slots a pass
  const float* qrow = q + qi * d;
  int sj = 0, se = 0;                              // slot cursor: block, row
  for (int s0 = 0; s0 < fe; s0 += R_SG) {
    const float* t[R_SG];
#pragma unroll
    for (int k = 0; k < R_SG; ++k) {
      t[k] = qrow;
      if (s0 + k < fe) {
        t[k] = run_src(ref[sj], hot_vecs, tv, static_cast<long>(eps) * d) +
               static_cast<long>(se) * d;
        if (++se == eps) {
          se = 0;
          ++sj;
        }
      }
    }
    const float dist = warp_dists<IP, R_SG>(t, fe - s0, qrow, d, lane);
    const int s = s0 + (lane >> 1);                // on lanes 2k and 2k+1
    if ((lane & 1) == 0 && s < fe) {
      dd_out[qi * fe + s] = dist;
      key[s] = dist;
    }
  }

  // the neighbour rows' stores, then their passes left
#pragma unroll
  for (int k = 0; k < R_NB; ++k)
    if (lane + 32 * k < ntot) store_unit(nrow, lane + 32 * k, nv[k], nwide);
  for (long i0 = lane + 32 * R_NB; i0 < ntot; i0 += 32 * R_NB) {
#pragma unroll
    for (int k = 0; k < R_NB; ++k) {
      if (i0 + 32 * k < ntot) {
        nv[k] = load_unit(run_src(ref[np.j], hot_nbrs, tn, nl), np.off,
                          nwide);
        np.step(nu);
      }
    }
#pragma unroll
    for (int k = 0; k < R_NB; ++k)
      if (i0 + 32 * k < ntot) store_unit(nrow, i0 + 32 * k, nv[k], nwide);
  }
  __syncwarp();                                    // key[] holds the distances

  // ids out, and the selection key: targets -inf, invalid slots +inf,
  // else the distance
  for (int s = lane; s < fe; s += 32) {
    int v = v0;
    if (s != lane) {
      vp.step(eps);
      v = run_src(ref[vp.j], hot_vid, ti, eps)[vp.off];
    }
    vid_out[qi * fe + s] = v;
    bool target = false;
    if (v >= 0)
      for (int jj = 0; jj < f; ++jj) target |= (v == uu[jj]);
    const bool valid = (v >= 0) && (uu[vp.j] >= 0);
    key[s] = target ? -INFINITY : (valid ? key[s] : INFINITY);
  }
  __syncwarp();

  // stable rank by counting: position = #smaller + #equal-before
  for (int s = lane; s < fe; s += 32) {
    const float ks = key[s];
    int pos = 0;
    for (int t = 0; t < fe; ++t) {
      const float kt = key[t];
      pos += (kt < ks) || (kt == ks && t < s);
    }
    if (pos < n_expand) ord_out[qi * n_expand + pos] = s;
  }
}

// ------------------------------------------------------------------ probe

constexpr int P_WARPS = 4;    // (query, block) pairs (warps) a probe CTA
constexpr int P_SG = 8;       // block rows a distance pass takes
static_assert(P_SG == 8, "probe_kernel reads row k's total on lane 4k");

// A warp per (query, block) pair, P_WARPS pairs a CTA. dd [Q, F*eps]
// row-major is pair * eps + row; row k of a pass lands on lanes 4k..4k+3,
// so lanes 0, 4, ... store the pass's rows side by side.
template <bool IP>
__global__ void __launch_bounds__(P_WARPS * 32) probe_kernel(
    const float* __restrict__ q, const int* __restrict__ blocks, long pairs,
    int f, const int* __restrict__ hot_slot_of, int rho,
    const float* __restrict__ hot_vecs, int h,
    const float* __restrict__ cold_vecs, int eps, int d,
    float* __restrict__ dd_out, int* __restrict__ hit_out) {
  const int lane = threadIdx.x & 31;
  const long pair =
      static_cast<long>(blockIdx.x) * P_WARPS + (threadIdx.x >> 5);
  if (pair >= pairs) return;
  const float* qrow = q + (pair / f) * d;
  const int blk = clampi(blocks[pair], 0, rho - 1);
  const int hs = hot_slot_of[blk];
  const long vd = static_cast<long>(eps) * d;
  const float* tile = hs >= 0 ? hot_vecs + min(hs, h - 1) * vd
                              : cold_vecs + blk * vd;
  if (lane == 0) hit_out[pair] = hs >= 0 ? 1 : 0;
  for (int e0 = 0; e0 < eps; e0 += P_SG) {
    const float* t[P_SG];
#pragma unroll
    for (int k = 0; k < P_SG; ++k)
      t[k] = e0 + k < eps ? tile + static_cast<long>(e0 + k) * d : qrow;
    const float dist = warp_dists<IP, P_SG>(t, eps - e0, qrow, d, lane);
    const int e = e0 + (lane >> 2);
    if ((lane & 3) == 0 && e < eps) dd_out[pair * eps + e] = dist;
  }
}

}  // namespace

extern "C" {

// Shared memory of the union CTA for rho blocks, the bitmap in it or not.
static size_t union_smem(int rho, bool with_bitmap) {
  const size_t words = (static_cast<size_t>(rho) + 31) / 32;
  return ((words + 31) / 32 + 1 + (with_bitmap ? words : 0)) *
         sizeof(unsigned);
}

static int union_limits(int* max_smem, int* max_ctas) {
  static int smem = 0, ctas = 0;
  if (!smem) {
    int dev = 0, sms = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(union_gather_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(union_gather_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem = optin;
    ctas = 2 * sms;
  }
  *max_smem = smem;
  *max_ctas = ctas;
  return 0;
}

// 1 if a union over rho blocks keeps its bitmap in shared memory; 0 if it
// needs the device bitmap of (rho + 31) / 32 zeroed words; < 0 on error.
int t0_union_in_smem(int rho) {
  int smem = 0, ctas = 0;
  const int e = union_limits(&smem, &ctas);
  if (e) return -e;
  return union_smem(rho, true) <= static_cast<size_t>(smem) ? 1 : 0;
}

// b [r] i32 -> uniq [r] i32 (ascending, 0 past the distinct count), rank
// [r] i32, tiles [r, eps, d] f32, vid [r, eps] i32, nbrs [r, eps, lam]
// i32. bm: the zeroed device bitmap where t0_union_in_smem(rho) is 0,
// else unused.
int t0_gather_union(const int* b, int r, unsigned* bm, const float* vecs,
                    const int* vid, const int* nbrs, int rho, int eps, int d,
                    int lam, int* uniq, int* rank, float* tv, int* ti,
                    int* tn, void* stream) {
  if (r <= 0) return 0;
  if (rho <= 0) return static_cast<int>(cudaErrorInvalidValue);
  int smem = 0, max_ctas = 0;
  const int e = union_limits(&smem, &max_ctas);
  if (e) return e;
  const int ctas = std::min((r + U_ROWS - 1) / U_ROWS, max_ctas);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (union_smem(rho, true) <= static_cast<size_t>(smem)) {
    union_gather_kernel<true><<<ctas, U_NT, union_smem(rho, true), st>>>(
        b, r, rho, nullptr, vecs, vid, nbrs, eps, d, lam, uniq, rank, tv, ti,
        tn);
  } else {
    if (bm == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    mark_kernel<<<(r + 255) / 256, 256, 0, st>>>(b, r, rho, bm);
    const cudaError_t me = cudaGetLastError();
    if (me != cudaSuccess) return static_cast<int>(me);
    union_gather_kernel<false><<<ctas, U_NT, union_smem(rho, false), st>>>(
        b, r, rho, bm, vecs, vid, nbrs, eps, d, lam, uniq, rank, tv, ti, tn);
  }
  return static_cast<int>(cudaGetLastError());
}

// uniq [r] -> tiles [r, eps, d] f32, vid [r, eps] i32, nbrs [r, eps, lam]
// i32: a warp per row, G_WARPS rows a CTA.
int t0_gather(const int* uniq, int r, const float* vecs, const int* vid,
              const int* nbrs, int rho, int eps, int d, int lam, float* tv,
              int* ti, int* tn, void* stream) {
  if (r <= 0) return 0;
  gather_kernel<<<(r + G_WARPS - 1) / G_WARPS, G_WARPS * 32, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      uniq, r, rho, vecs, vid, nbrs, eps, d, lam, tv, ti, tn);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2b of the round: a warp per query row, R_WARPS rows a CTA.
int t0_rank(const float* q, const int* u, const int* rank2d,
            const int* uniq, int r, const int* hot_slot_of, int rho,
            const float* hot_vecs, const int* hot_vid, const int* hot_nbrs,
            int h, const float* tv, const int* ti, const int* tn, int qn,
            int f, int eps, int d, int lam, int n_expand, int bq, int ip,
            float* dd, int* vid, int* nbrs, int* hit, int* order,
            void* stream) {
  if (qn <= 0) return 0;
  const size_t smem =
      static_cast<size_t>(R_WARPS) * (2 * f + f * eps) * sizeof(int);
  const int ctas = (qn + R_WARPS - 1) / R_WARPS;
  auto kernel = ip ? rank_kernel<true> : rank_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<ctas, R_WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      q, u, rank2d, uniq, r, hot_slot_of, rho, hot_vecs, hot_vid, hot_nbrs,
      h, tv, ti, tn, qn, f, eps, d, lam, n_expand, bq, dd, vid, nbrs, hit,
      order);
  return static_cast<int>(cudaGetLastError());
}

// tier0_fetch_rank: queries [qn, d] x blocks [qn, f] -> dd [qn, f*eps]
// f32, hit [qn, f] i32: a warp per (query, block), P_WARPS a CTA.
int t0_fetch_rank(const float* q, const int* blocks, int qn, int f,
                  const int* hot_slot_of, int rho, const float* hot_vecs,
                  int h, const float* cold_vecs, int eps, int d, int ip,
                  float* dd, int* hit, void* stream) {
  if (qn <= 0 || f <= 0) return 0;
  const long pairs = static_cast<long>(qn) * f;
  const long ctas = (pairs + P_WARPS - 1) / P_WARPS;
  if (ctas > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = ip ? probe_kernel<true> : probe_kernel<false>;
  kernel<<<static_cast<unsigned>(ctas), P_WARPS * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(
      q, blocks, pairs, f, hot_slot_of, rho, hot_vecs, h, cold_vecs, eps, d,
      dd, hit);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
