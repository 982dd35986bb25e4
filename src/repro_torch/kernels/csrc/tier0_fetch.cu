// Round kernels of the batched device search, written for Hopper (sm_90a).
//
// They replace the Pallas TPU kernels of repro/kernels/tier0_fetch.py:
//
//   t0_union + t0_gather  <-  gather_union (_union_into_smem,
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
//  * Union. The TPU kernel uses an O(R^2) sort-free formulation because
//    Mosaic has no sort. Here one CTA bitonic-sorts the R (key, slot)
//    pairs as 64-bit words in shared memory (R <= 4096, 32 KB), marks the
//    first slot of each key run and prefix-sums the marks into ranks. The
//    slot index in the low word makes every word distinct, so the sorted
//    order is the stable order and the outputs equal the plain
//    sorted_unique_ranks exactly. The union is one CTA: at R = 2048 it is
//    a few microseconds of launch and shared-memory work.
//  * Gather. One CTA per union row copies the row's block with 16-byte
//    loads and stores where the row is 16-byte aligned, so each distinct
//    block is read from HBM once. Many CTAs in flight take the place of
//    the TPU's two-slot make_async_copy schedule; cp.async / TMA staging
//    is later work.
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

namespace {

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// ------------------------------------------------------------------ union

__global__ void union_kernel(const int* __restrict__ b, int r, int p,
                             int* __restrict__ uniq, int* __restrict__ rank) {
  extern __shared__ unsigned long long words[];   // [p] + scan scratch
  int* warp_sum = reinterpret_cast<int*>(words + p);  // [32]
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < p; i += nt) {
    unsigned long long w = ~0ull;                 // padding sorts last
    if (i < r) {
      unsigned int k = static_cast<unsigned int>(b[i]) ^ 0x80000000u;
      w = (static_cast<unsigned long long>(k) << 32) |
          static_cast<unsigned int>(i);
    }
    words[i] = w;
  }
  __syncthreads();

  // bitonic sort, ascending
  for (int k = 2; k <= p; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = tid; i < p; i += nt) {
        int ixj = i ^ j;
        if (ixj > i) {
          unsigned long long a = words[i], c = words[ixj];
          bool up = (i & k) == 0;
          if ((a > c) == up) {
            words[i] = c;
            words[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
  }

  // each thread owns a contiguous run of sorted positions
  const int per = (r + nt - 1) / nt;
  const int lo = min(tid * per, r), hi = min(lo + per, r);
  int firsts = 0;
  for (int i = lo; i < hi; ++i)
    firsts += (i == 0) || ((words[i] >> 32) != (words[i - 1] >> 32));

  // block-wide exclusive scan of the per-thread counts
  const int lane = tid & 31, warp = tid >> 5, nwarps = (nt + 31) >> 5;
  int incl = firsts;
  for (int off = 1; off < 32; off <<= 1) {
    int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int v = lane < nwarps ? warp_sum[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      int s = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += s;
    }
    warp_sum[lane] = v;                           // inclusive warp prefix
  }
  __syncthreads();
  const int distinct = warp_sum[nwarps - 1];
  int run = incl - firsts + (warp > 0 ? warp_sum[warp - 1] : 0);

  for (int i = lo; i < hi; ++i) {
    unsigned long long w = words[i];
    bool first = (i == 0) || ((w >> 32) != (words[i - 1] >> 32));
    run += first;
    int rk = run - 1;
    rank[static_cast<unsigned int>(w & 0xffffffffu)] = rk;
    if (first)
      uniq[rk] = static_cast<int>(static_cast<unsigned int>(w >> 32) ^
                                  0x80000000u);
  }
  for (int i = distinct + tid; i < r; i += nt) uniq[i] = 0;
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

// b [r] i32 -> uniq [r] i32 (0 past the distinct count), rank [r] i32.
int t0_union(const int* b, int r, int* uniq, int* rank, void* stream) {
  if (r <= 0) return 0;
  int p = 1;
  while (p < r) p <<= 1;
  const int threads = 1024;
  size_t smem = static_cast<size_t>(p) * sizeof(unsigned long long) +
                32 * sizeof(int);
  union_kernel<<<1, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      b, r, p, uniq, rank);
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
