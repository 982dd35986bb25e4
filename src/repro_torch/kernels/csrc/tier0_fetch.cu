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
// What bounds them on an H100 is bytes, not arithmetic: a round moves a
// few MB of block payload (ε·D floats, ε ids, ε·Λ neighbour ids per block)
// and computes Q·F·ε·D multiply-adds, some 10^2 operations per KB.
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
//  * Gather (t0_gather, gather_unique). One CTA per union row copies the
//    row's block with 16-byte loads and stores where the row is 16-byte
//    aligned, so each distinct block is read from HBM once.
//  * Rank. One CTA per query. The query's tile (bq rows) is idle when no
//    row picked a candidate; then the CTA writes the sentinels and stops.
//    Otherwise it probes the tier-0 map for each of its F union rows,
//    reads the hot-pack tile or the cold copy (the hot pack is small
//    enough to stay in the 50 MB L2), computes the F·ε distances one warp
//    per slot with coalesced loads, and ranks the selection key by
//    counting (stable: index breaks ties), which is exactly
//    argsort(stable)[:n_expand].
//  * Probe (tier0_fetch_rank). The rank pass's probe and distance without
//    its broadcast and order: one CTA per (query, block) pair probes the
//    tier-0 map, reads the hot-pack tile or the block's cold tile once,
//    and writes its ε distances and the hit bit. Its traffic is the
//    tiles of the named blocks, some 3 KB a pair; the launch dominates
//    at the sizes a round gives it.
//
// Every index read from an input is clamped into range, as the JAX
// gathers clamp. Each entry point launches on the given stream and
// returns cudaGetLastError().
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// n words from src to dst by one warp: 16-byte moves where both rows are
// 16-byte aligned, eight in flight per lane, else one word at a time.
__device__ __forceinline__ void warp_copy(int* __restrict__ dst,
                                          const int* __restrict__ src,
                                          long n, int lane) {
  if (n % 4 == 0 && ((reinterpret_cast<uintptr_t>(dst) |
                      reinterpret_cast<uintptr_t>(src)) & 15) == 0) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    const long n4 = n / 4;
    for (long i0 = lane; i0 < n4; i0 += 8 * 32) {
      int4 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + 32 * u < n4) v[u] = s4[i0 + 32 * u];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (i0 + 32 * u < n4) d4[i0 + 32 * u] = v[u];
    }
  } else {
    for (long i = lane; i < n; i += 32) dst[i] = src[i];
  }
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
// warp per row, 16-byte moves); rows past the distinct count copy block
// 0, as uniq holds 0 there.
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
              reinterpret_cast<const int*>(vecs + blk * vd), vd, lane);
    warp_copy(ti + static_cast<long>(j) * eps, vid + static_cast<long>(blk) * eps,
              eps, lane);
    warp_copy(tn + j * vl, nbrs + blk * vl, vl, lane);
  }
}

// ----------------------------------------------------------------- gather

__device__ __forceinline__ void copy_words(int* __restrict__ dst,
                                           const int* __restrict__ src,
                                           int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  bool vec = (n % 4 == 0) &&
             (((reinterpret_cast<uintptr_t>(dst) |
                reinterpret_cast<uintptr_t>(src)) & 15) == 0);
  if (vec) {
    const int4* s4 = reinterpret_cast<const int4*>(src);
    int4* d4 = reinterpret_cast<int4*>(dst);
    for (int i = tid; i < n / 4; i += nt) d4[i] = s4[i];
  } else {
    for (int i = tid; i < n; i += nt) dst[i] = src[i];
  }
}

__global__ void gather_kernel(const int* __restrict__ uniq, int rho,
                              const float* __restrict__ vecs,
                              const int* __restrict__ vid,
                              const int* __restrict__ nbrs, int eps, int d,
                              int lam, float* __restrict__ tv,
                              int* __restrict__ ti, int* __restrict__ tn) {
  const long row = blockIdx.x;
  const long blk = clampi(uniq[row], 0, rho - 1);
  const long vd = static_cast<long>(eps) * d, vl = static_cast<long>(eps) * lam;
  copy_words(reinterpret_cast<int*>(tv + row * vd),
             reinterpret_cast<const int*>(vecs + blk * vd), static_cast<int>(vd));
  copy_words(ti + row * eps, vid + blk * eps, eps);
  copy_words(tn + row * vl, nbrs + blk * vl, static_cast<int>(vl));
}

// --------------------------------------------------------------- distance

// sum((t - q)^2), or -sum(q * t) for ip, of one d-float row, summed by
// one warp: lane c takes columns c, c+32, ..., the partial sums meet by
// xor shuffles, so every lane returns the total. The rank and the probe
// kernels share it, so both give the same f32 sums.
template <bool IP>
__device__ __forceinline__ float warp_dist(const float* __restrict__ t,
                                           const float* __restrict__ q,
                                           int d, int lane) {
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) {
    float x = t[c], y = q[c];
    if (IP) {
      acc = fmaf(x, y, acc);
    } else {
      float df = x - y;
      acc = fmaf(df, df, acc);
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return IP ? -acc : acc;
}

// ------------------------------------------------------------------- rank

template <bool IP>
__global__ void rank_kernel(
    const float* __restrict__ q, const int* __restrict__ u,
    const int* __restrict__ rank2d, const int* __restrict__ uniq, int r,
    const int* __restrict__ hot_slot_of, int rho,
    const float* __restrict__ hot_vecs, const int* __restrict__ hot_vid,
    const int* __restrict__ hot_nbrs, int h, const float* __restrict__ tv,
    const int* __restrict__ ti, const int* __restrict__ tn, int f, int eps,
    int d, int lam, int n_expand, int bq, float* __restrict__ dd_out,
    int* __restrict__ vid_out, int* __restrict__ nbrs_out,
    int* __restrict__ hit_out, int* __restrict__ ord_out) {
  extern __shared__ int sm[];
  const int fe = f * eps;
  float* key = reinterpret_cast<float*>(sm);      // [fe]
  int* vsh = sm + fe;                             // [fe] vertex ids
  int* hslot = vsh + fe;                          // [f] hot slot or -1
  int* urow = hslot + f;                          // [f] union row
  int* ush = urow + f;                            // [f] picked ids
  const long qi = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;

  const long t0 = (qi / bq) * bq;
  int live = 0;
  for (int i = tid; i < bq * f; i += nt) live |= (u[t0 * f + i] >= 0);
  live = __syncthreads_or(live);
  if (!live) {                                    // all-idle tile
    for (int s = tid; s < fe; s += nt) {
      dd_out[qi * fe + s] = 0.f;
      vid_out[qi * fe + s] = -1;
    }
    for (long i = tid; i < static_cast<long>(fe) * lam; i += nt)
      nbrs_out[qi * fe * lam + i] = -1;
    for (int j = tid; j < f; j += nt) hit_out[qi * f + j] = 0;
    for (int j = tid; j < n_expand; j += nt) ord_out[qi * n_expand + j] = 0;
    return;
  }

  for (int j = tid; j < f; j += nt) {             // tier-0 probe
    int rr = clampi(rank2d[qi * f + j], 0, r - 1);
    int blk = clampi(uniq[rr], 0, rho - 1);
    int hs = hot_slot_of[blk];
    hslot[j] = hs >= 0 ? min(hs, h - 1) : -1;
    urow[j] = rr;
    ush[j] = u[qi * f + j];
    hit_out[qi * f + j] = hs >= 0 ? 1 : 0;
  }
  __syncthreads();

  for (int s = tid; s < fe; s += nt) {
    int j = s / eps, e = s - j * eps, hs = hslot[j];
    int v = hs >= 0 ? hot_vid[static_cast<long>(hs) * eps + e]
                    : ti[static_cast<long>(urow[j]) * eps + e];
    vsh[s] = v;
    vid_out[qi * fe + s] = v;
  }
  for (long i = tid; i < static_cast<long>(fe) * lam; i += nt) {
    int s = static_cast<int>(i / lam), c = static_cast<int>(i - static_cast<long>(s) * lam);
    int j = s / eps, e = s - j * eps, hs = hslot[j];
    const int* src = hs >= 0 ? hot_nbrs + (static_cast<long>(hs) * eps + e) * lam
                             : tn + (static_cast<long>(urow[j]) * eps + e) * lam;
    nbrs_out[qi * fe * lam + i] = src[c];
  }

  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const float* qrow = q + qi * d;
  for (int s = warp; s < fe; s += nwarps) {
    int j = s / eps, e = s - j * eps, hs = hslot[j];
    const float* t = hs >= 0 ? hot_vecs + (static_cast<long>(hs) * eps + e) * d
                             : tv + (static_cast<long>(urow[j]) * eps + e) * d;
    float dist = warp_dist<IP>(t, qrow, d, lane);
    if (lane == 0) {
      dd_out[qi * fe + s] = dist;
      key[s] = dist;
    }
  }
  __syncthreads();

  // selection key: targets -inf, invalid slots +inf, else the distance
  for (int s = tid; s < fe; s += nt) {
    int v = vsh[s], j = s / eps;
    bool target = false;
    if (v >= 0)
      for (int jj = 0; jj < f; ++jj) target |= (v == ush[jj]);
    bool valid = (v >= 0) && (ush[j] >= 0);
    key[s] = target ? -INFINITY : (valid ? key[s] : INFINITY);
  }
  __syncthreads();

  // stable rank by counting: position = #smaller + #equal-before
  for (int s = tid; s < fe; s += nt) {
    float ks = key[s];
    int pos = 0;
    for (int t = 0; t < fe; ++t) {
      float kt = key[t];
      pos += (kt < ks) || (kt == ks && t < s);
    }
    if (pos < n_expand) ord_out[qi * n_expand + pos] = s;
  }
}

// ------------------------------------------------------------------ probe

// One CTA per (query, block) pair; its warps take the block's slots in
// turn. dd [Q, F*eps] row-major is pair * eps + slot.
template <bool IP>
__global__ void probe_kernel(const float* __restrict__ q,
                             const int* __restrict__ blocks, int f,
                             const int* __restrict__ hot_slot_of, int rho,
                             const float* __restrict__ hot_vecs, int h,
                             const float* __restrict__ cold_vecs, int eps,
                             int d, float* __restrict__ dd_out,
                             int* __restrict__ hit_out) {
  const long pair = blockIdx.x;
  const long qi = pair / f;
  const int blk = clampi(blocks[pair], 0, rho - 1);
  const int hs = hot_slot_of[blk];
  const long vd = static_cast<long>(eps) * d;
  const float* tile = hs >= 0 ? hot_vecs + min(hs, h - 1) * vd
                              : cold_vecs + blk * vd;
  if (threadIdx.x == 0) hit_out[pair] = hs >= 0 ? 1 : 0;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int e = warp; e < eps; e += nwarps) {
    float dist = warp_dist<IP>(tile + static_cast<long>(e) * d, q + qi * d,
                               d, lane);
    if (lane == 0) dd_out[pair * eps + e] = dist;
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

// uniq [r] -> tiles [r, eps, d] f32, vid [r, eps] i32, nbrs [r, eps, lam] i32.
int t0_gather(const int* uniq, int r, const float* vecs, const int* vid,
              const int* nbrs, int rho, int eps, int d, int lam, float* tv,
              int* ti, int* tn, void* stream) {
  if (r <= 0) return 0;
  gather_kernel<<<r, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      uniq, rho, vecs, vid, nbrs, eps, d, lam, tv, ti, tn);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2b of the round: one CTA per query row.
int t0_rank(const float* q, const int* u, const int* rank2d,
            const int* uniq, int r, const int* hot_slot_of, int rho,
            const float* hot_vecs, const int* hot_vid, const int* hot_nbrs,
            int h, const float* tv, const int* ti, const int* tn, int qn,
            int f, int eps, int d, int lam, int n_expand, int bq, int ip,
            float* dd, int* vid, int* nbrs, int* hit, int* order,
            void* stream) {
  if (qn <= 0) return 0;
  const int fe = f * eps;
  size_t smem = static_cast<size_t>(2 * fe + 3 * f) * sizeof(int);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ip)
    rank_kernel<true><<<qn, 128, smem, st>>>(
        q, u, rank2d, uniq, r, hot_slot_of, rho, hot_vecs, hot_vid, hot_nbrs,
        h, tv, ti, tn, f, eps, d, lam, n_expand, bq, dd, vid, nbrs, hit,
        order);
  else
    rank_kernel<false><<<qn, 128, smem, st>>>(
        q, u, rank2d, uniq, r, hot_slot_of, rho, hot_vecs, hot_vid, hot_nbrs,
        h, tv, ti, tn, f, eps, d, lam, n_expand, bq, dd, vid, nbrs, hit,
        order);
  return static_cast<int>(cudaGetLastError());
}

// tier0_fetch_rank: queries [qn, d] x blocks [qn, f] -> dd [qn, f*eps]
// f32, hit [qn, f] i32.
int t0_fetch_rank(const float* q, const int* blocks, int qn, int f,
                  const int* hot_slot_of, int rho, const float* hot_vecs,
                  int h, const float* cold_vecs, int eps, int d, int ip,
                  float* dd, int* hit, void* stream) {
  if (qn <= 0 || f <= 0) return 0;
  const int pairs = qn * f;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ip)
    probe_kernel<true><<<pairs, 128, 0, st>>>(
        q, blocks, f, hot_slot_of, rho, hot_vecs, h, cold_vecs, eps, d, dd,
        hit);
  else
    probe_kernel<false><<<pairs, 128, 0, st>>>(
        q, blocks, f, hot_slot_of, rho, hot_vecs, h, cold_vecs, eps, d, dd,
        hit);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
