// K6 and K7: IVF and IVF-PQ approximate k-NN on Hopper.
//
// Replace the JAX package's XLA programs `ivf_search` / `ivf_search_batch`
// (K6; opensearch_tpu/ops/ivf.py:140,170) and `ivfpq_search_l2` (K7;
// :236): the probe (the nprobe centroids nearest the query), then the
// scan of the probed clusters and each segment's top k.  One call covers
// every (query, segment) of a request or batch; it is two kernels on one
// stream with no host sync between them:
//
//   ivf_probe_kernel   a block per (query, segment): cd_c = |c|^2 - 2 c.q
//                      over the segment's nlist centroids (float64 sums,
//                      rows.cuh, rounded to float32 once), as keys
//                      (orderable(-cd) << 32 | ~c) in shared memory, a
//                      bitonic sort, the first nprobe written out: the
//                      nearest first, the lower centroid on ties.
//   ivf_scan_kernel    a block per (query, segment, probe rank): the
//   ivfpq_scan_kernel  valid rows of its cluster only (staged cluster
//                      after cluster, no padding row; ops/ivf.py
//                      `stage_index`), each scored, masked by live[id],
//                      and kept as the key (orderable(score) << 32 |
//                      ~flat) with flat = rank * c_pad + position: the
//                      reference's `lax.top_k` over its padded [nprobe *
//                      c_pad] array breaks ties by that flat index, not by
//                      doc id.  The block keeps its best kp keys over
//                      tiles of kBuf - kp rows (topk.cuh `select_top`);
//                      the last block of a (query, segment) to finish
//                      merges the segment's blocks (`finish_segment`) and
//                      maps each kept flat index to its doc id on output.
//                      K6 scores rows as K1 does (rows.cuh: v.q and |v|^2
//                      in float64 in K1's lane order, the space's
//                      translation rounded once).  K7 first builds the
//                      probe's LUT[m][256] in shared memory (r = q -
//                      centroid in float32; each entry sum_t (codeword_t -
//                      r_t)^2 in float64 over the subspace in order,
//                      rounded to float32; 1 KB per subspace: 10 KB at
//                      m = 10, at most kMMax = IVF_M_MAX subspaces), then
//                      a thread per row sums its m entries in float64 from
//                      subspace 0 up; score 1 / (1 + d2) rounded once.
//
// ops/ivf.py's plain twins (`ivf_search_segments`,
// `ivfpq_search_segments`) compute the same numbers in the same order,
// so the kernels equal them byte for byte.  A segment asking for more
// than kKMax hits takes the scores mode instead (TOPK false): the scan
// writes every probed slot's score and id to a flat buffer and the
// wrapper sorts it (ops/cuda_ivf.py, counted as the sorted route).
//
// Bound on the card: memory.  A K6 block reads its cluster's rows once
// (d * 4 bytes a row) and does 4 d float64 flops a row, far below the
// H100's float64 rate per byte; a K7 row is m bytes of codes and m table
// reads from shared memory.  The probe reads nlist * d * 4 bytes a
// (query, segment).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rows.cuh"
#include "topk.cuh"

namespace {

// The wrapper (ops/cuda_ivf.py) owns the launch table and the limits and
// passes them in with -D.
#if !defined(IVF_K_MAX) || !defined(IVF_SEG_WORDS) || !defined(IVF_NLIST_MAX) || \
    !defined(IVF_M_MAX) || !defined(IVF_D_MAX)
#error "build through ops/cuda_ivf.py, which defines IVF_K_MAX, IVF_SEG_WORDS, IVF_NLIST_MAX, IVF_M_MAX, IVF_D_MAX"
#endif

constexpr int kThreads = 256;
constexpr int kBuf = 1024;         // keys a scan block holds: its best kp, then a tile
constexpr int kMergeBatch = 512;   // keys the segment's merge reads a round
constexpr int kKMax = IVF_K_MAX;
constexpr int kSegWords = IVF_SEG_WORDS;
constexpr int kNlistMax = IVF_NLIST_MAX;
constexpr int kMMax = IVF_M_MAX;
constexpr int kDMax = IVF_D_MAX;
constexpr int kCodewords = 256;
static_assert((kKMax & (kKMax - 1)) == 0 && kKMax <= kBuf - kMergeBatch,
              "kKMax: a power of two the merge buffer holds beside one round");

// Words of a segment's entry in the launch table (ops/cuda_ivf.py
// `launch_table`).
enum : int {
  wCentroids = 0,  // f32 [nlist, d]
  wRows = 1,       // K6: f32 [n_valid, d]; K7: uint8 codes [n_valid, m]
  wIds = 2,        // i32 [n_valid] doc ids
  wStarts = 3,     // i32 [nlist + 1] each cluster's first row
  wLive = 4,       // bool [n_pad]
  wCodebooks = 5,  // K7: f32 [m, 256, d / m]
  wNlist = 6,
  wNprobe = 7,
  wK = 8,          // hits the segment returns
  wCpad = 9,       // the reference's padded cluster width (tie order)
  wProbeOff = 10,  // the segment's first probe (and block) within a query's
  wOutCol = 11,    // the segment's first output column
  wFlatOff = 12,   // scores mode: its first slot of a query's flat buffer
  wM = 13,         // K7: subspaces
};

using topk::u64;

__host__ __device__ __forceinline__ int round16(int b) { return (b + 15) & ~15; }

// Where scan block blockIdx.x works: query, segment, probe rank and the
// probed cluster's rows.
struct Probe {
  const long long* e;
  int qi, seg, rank, nprobe, cluster, count;
  long long lo, c_pad;
};

__device__ __forceinline__ Probe locate(const long long* table, int n_seg, int p_tot,
                                        const int* probes) {
  Probe p;
  p.qi = blockIdx.x / p_tot;
  const int j = blockIdx.x % p_tot;
  int lo = 0, hi = n_seg - 1;  // the last segment whose first probe is <= j
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[(long long)mid * kSegWords + wProbeOff] <= j) lo = mid; else hi = mid - 1;
  }
  p.seg = lo;
  p.e = table + (long long)lo * kSegWords;
  p.rank = j - (int)p.e[wProbeOff];
  p.nprobe = (int)p.e[wNprobe];
  p.cluster = probes[(long long)p.qi * p_tot + j];
  const int* starts = reinterpret_cast<const int*>(p.e[wStarts]);
  p.lo = starts[p.cluster];
  p.count = starts[p.cluster + 1] - starts[p.cluster];
  p.c_pad = p.e[wCpad];
  return p;
}

// A block per (query, segment): the segment's nprobe nearest centroids.
template <int W>
__global__ void __launch_bounds__(kThreads)
ivf_probe_kernel(const long long* __restrict__ table, int n_seg,
                 const float* __restrict__ queries, int d, int p_tot, int* __restrict__ probes) {
  extern __shared__ __align__(16) char smem[];
  double* q_s = reinterpret_cast<double*>(smem);
  u64* keys = reinterpret_cast<u64*>(smem + round16(8 * d));
  const int qi = blockIdx.x / n_seg, seg = blockIdx.x % n_seg;
  const long long* e = table + (long long)seg * kSegWords;
  const float* cent = reinterpret_cast<const float*>(e[wCentroids]);
  const int nlist = (int)e[wNlist], nprobe = (int)e[wNprobe];
  const float* q = queries + (long long)qi * d;
  const int tid = threadIdx.x;
  for (int i = tid; i < d; i += kThreads) q_s[i] = (double)q[i];
  __syncthreads();
  const int L = rowsum::row_lanes(d), groups = kThreads / L;
  const int sub = tid & (L - 1), grp = tid / L;
  for (int base = 0; base < nlist; base += groups) {  // block-uniform: whole warps shuffle
    const int c = base + grp;
    double dot = 0.0, v2 = 0.0;
    if (c < nlist) rowsum::row_accumulate<W>(cent + (long long)c * d, q_s, d, L, sub, dot, v2);
    rowsum::group_sum(dot, v2, L);
    if (c < nlist && sub == 0) keys[c] = topk::make_key(-__double2float_rn(v2 - 2.0 * dot), c);
  }
  const int n = topk::pow2_at_least(nlist);
  for (int i = nlist + tid; i < n; i += kThreads) keys[i] = 0;
  __syncthreads();
  topk::bitonic_desc<kThreads>(keys, n);
  int* out = probes + (long long)qi * p_tot + e[wProbeOff];
  for (int r = tid; r < nprobe; r += kThreads) out[r] = topk::key_id(keys[r]);
}

// A scored row: into the tile of keys (TOPK) or the flat buffers.
template <bool TOPK>
__device__ __forceinline__ void keep_row(const Probe& p, int kp, int r, int pos, int id, bool ok,
                                         float sc, u64* keys, long long f_tot,
                                         float* flat_vals, int* flat_ids) {
  if (TOPK) {
    keys[kp + r] = ok ? topk::make_key(sc, p.rank * p.c_pad + pos) : 0;
  } else {
    const long long at = (long long)p.qi * f_tot + p.e[wFlatOff] + p.rank * p.c_pad + pos;
    flat_vals[at] = ok ? sc : -INFINITY;
    flat_ids[at] = ok ? id : -1;
  }
}

// After a tile: pad it with "no candidate" and keep the best kp keys in
// keys[0, kp).  All threads call.
__device__ __forceinline__ void select_tile(u64* keys, int kp, int trows) {
  for (int i = kp + trows + threadIdx.x; i < kBuf; i += kThreads) keys[i] = 0;
  __syncthreads();
  topk::select_top<kThreads, kBuf>(keys, kp);
}

// The end of a TOPK block: keys[0, kp) hold its best kp.  The last block
// of the (query, segment) merges every block's and writes the segment's k
// hits, each kept flat index mapped back to its doc id; (-inf, -1) past
// the candidates.
__device__ void finish(u64* keys, int kp, const Probe& p, int n_seg, int p_tot,
                       const int* __restrict__ probes, u64* __restrict__ scratch, int* counters,
                       int k_tot, float* __restrict__ out_vals, int* __restrict__ out_ids) {
  const long long first = (long long)p.qi * p_tot + p.e[wProbeOff];
  if (!topk::finish_segment<kThreads, kBuf, kMergeBatch>(keys, kp, scratch, first, p.rank,
                                                        p.nprobe, &counters[p.qi * n_seg + p.seg]))
    return;
  const int k = (int)p.e[wK];
  const int* starts = reinterpret_cast<const int*>(p.e[wStarts]);
  const int* ids = reinterpret_cast<const int*>(p.e[wIds]);
  const long long out = (long long)p.qi * k_tot + p.e[wOutCol];
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const u64 key = keys[i];
    if (key == 0) {
      out_vals[out + i] = -INFINITY;
      out_ids[out + i] = -1;
      continue;
    }
    const long long f = (long long)(uint32_t)topk::key_id(key);
    const int c = probes[first + f / p.c_pad];
    out_vals[out + i] = topk::key_score(key);
    out_ids[out + i] = ids[starts[c] + (int)(f % p.c_pad)];
  }
}

// K6's scan: a block per (query, segment, probe rank).  Shared memory:
// the query (float64) | kBuf keys.
template <int SPACE, int W, bool TOPK>
__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const long long* __restrict__ table, int n_seg, const float* __restrict__ queries,
                int d, int p_tot, const int* __restrict__ probes, int kp, int k_tot,
                float* __restrict__ out_vals, int* __restrict__ out_ids, u64* __restrict__ scratch,
                long long f_tot, float* __restrict__ flat_vals, int* __restrict__ flat_ids) {
  extern __shared__ __align__(16) char smem[];
  double* q_s = reinterpret_cast<double*>(smem);
  u64* keys = reinterpret_cast<u64*>(smem + round16(8 * d));
  const Probe p = locate(table, n_seg, p_tot, probes);
  int* counters = reinterpret_cast<int*>(const_cast<long long*>(table + (long long)n_seg * kSegWords));
  const float* rows = reinterpret_cast<const float*>(p.e[wRows]) + p.lo * d;
  const int* ids = reinterpret_cast<const int*>(p.e[wIds]) + p.lo;
  const uint8_t* live = reinterpret_cast<const uint8_t*>(p.e[wLive]);
  const float* q = queries + (long long)p.qi * d;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int i = tid; i < d; i += kThreads) q_s[i] = (double)q[i];
  if (TOPK)
    for (int i = tid; i < kp; i += kThreads) keys[i] = 0;
  __syncthreads();
  const double q2 = rowsum::query_norm2(q_s, d, lane);
  const int L = rowsum::row_lanes(d), groups = kThreads / L;
  const int sub = tid & (L - 1), grp = tid / L;
  const int T = TOPK ? kBuf - kp : p.count;
  for (int t0 = 0; t0 < p.count; t0 += T) {
    const int trows = min(T, p.count - t0);
    for (int b0 = 0; b0 < trows; b0 += groups) {  // block-uniform: whole warps shuffle
      const int r = b0 + grp;
      const bool has = r < trows;
      double dot = 0.0, v2 = 0.0;
      if (has) rowsum::row_accumulate<W>(rows + (long long)(t0 + r) * d, q_s, d, L, sub, dot, v2);
      rowsum::group_sum(dot, v2, L);
      if (has && sub == 0) {
        const int pos = t0 + r, id = ids[pos];
        const bool ok = id >= 0 && live[id];
        const float sc = ok ? rowsum::translate<SPACE>(dot, v2, q2) : -INFINITY;
        keep_row<TOPK>(p, kp, r, pos, id, ok, sc, keys, f_tot, flat_vals, flat_ids);
      }
    }
    if (TOPK) select_tile(keys, kp, trows);
  }
  if (TOPK) finish(keys, kp, p, n_seg, p_tot, probes, scratch, counters, k_tot, out_vals, out_ids);
}

// K7's scan: a block per (query, segment, probe rank).  Shared memory:
// kBuf keys | LUT [m][256] f32 | the residual r (f32 [d]).
template <bool TOPK>
__global__ void __launch_bounds__(kThreads)
ivfpq_scan_kernel(const long long* __restrict__ table, int n_seg, const float* __restrict__ queries,
                  int d, int p_tot, const int* __restrict__ probes, int kp, int k_tot,
                  float* __restrict__ out_vals, int* __restrict__ out_ids, u64* __restrict__ scratch,
                  long long f_tot, float* __restrict__ flat_vals, int* __restrict__ flat_ids) {
  extern __shared__ __align__(16) char smem[];
  const Probe p = locate(table, n_seg, p_tot, probes);
  const int m = (int)p.e[wM], dsub = d / m;
  u64* keys = reinterpret_cast<u64*>(smem);
  float* lut = reinterpret_cast<float*>(smem + 8 * kBuf);
  float* r_s = lut + m * kCodewords;
  int* counters = reinterpret_cast<int*>(const_cast<long long*>(table + (long long)n_seg * kSegWords));
  const float* cent = reinterpret_cast<const float*>(p.e[wCentroids]) + (long long)p.cluster * d;
  const float* cb = reinterpret_cast<const float*>(p.e[wCodebooks]);
  const uint8_t* codes = reinterpret_cast<const uint8_t*>(p.e[wRows]) + p.lo * m;
  const int* ids = reinterpret_cast<const int*>(p.e[wIds]) + p.lo;
  const uint8_t* live = reinterpret_cast<const uint8_t*>(p.e[wLive]);
  const float* q = queries + (long long)p.qi * d;
  const int tid = threadIdx.x;
  for (int i = tid; i < d; i += kThreads) r_s[i] = __fsub_rn(q[i], cent[i]);
  if (TOPK)
    for (int i = tid; i < kp; i += kThreads) keys[i] = 0;
  __syncthreads();
  for (int x = tid; x < m * kCodewords; x += kThreads) {
    const float* w = cb + (long long)x * dsub;
    const float* rr = r_s + (x / kCodewords) * dsub;
    double acc = 0.0;
    for (int t = 0; t < dsub; ++t) {
      const double diff = (double)__fsub_rn(w[t], rr[t]);
      acc = fma(diff, diff, acc);
    }
    lut[x] = __double2float_rn(acc);
  }
  __syncthreads();
  const int T = TOPK ? kBuf - kp : p.count;
  for (int t0 = 0; t0 < p.count; t0 += T) {
    const int trows = min(T, p.count - t0);
    for (int r = tid; r < trows; r += kThreads) {
      const int pos = t0 + r, id = ids[pos];
      const uint8_t* row = codes + (long long)pos * m;
      double d2 = 0.0;
      for (int s = 0; s < m; ++s) d2 += (double)lut[s * kCodewords + row[s]];
      const bool ok = id >= 0 && live[id];
      const float sc = ok ? __double2float_rn(1.0 / (1.0 + d2)) : -INFINITY;
      keep_row<TOPK>(p, kp, r, pos, id, ok, sc, keys, f_tot, flat_vals, flat_ids);
    }
    if (TOPK) select_tile(keys, kp, trows);
  }
  if (TOPK) finish(keys, kp, p, n_seg, p_tot, probes, scratch, counters, k_tot, out_vals, out_ids);
}

int pow2_host(int n) {
  int p = 2;
  while (p < n) p <<= 1;
  return p;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename K, typename... Args>
cudaError_t launch(K kernel, int blocks, size_t smem, cudaStream_t st, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

template <int SPACE, int W>
cudaError_t launch_flat_scan(bool topk_mode, int blocks, size_t smem, cudaStream_t st,
                             const long long* table, int n_seg, const float* queries, int d,
                             int p_tot, const int* probes, int kp, int k_tot, float* out_vals,
                             int* out_ids, u64* scratch, long long f_tot, float* flat_vals,
                             int* flat_ids) {
  if (topk_mode)
    return launch(ivf_scan_kernel<SPACE, W, true>, blocks, smem, st, table, n_seg, queries, d,
                  p_tot, probes, kp, k_tot, out_vals, out_ids, scratch, f_tot, flat_vals,
                  flat_ids);
  return launch(ivf_scan_kernel<SPACE, W, false>, blocks, smem, st, table, n_seg, queries, d, p_tot,
                probes, kp, k_tot, out_vals, out_ids, scratch, f_tot, flat_vals, flat_ids);
}

template <int W>
cudaError_t launch_flat_space(int space, bool topk_mode, int blocks, size_t smem,
                              cudaStream_t st, const long long* table, int n_seg,
                              const float* queries, int d, int p_tot, const int* probes, int kp,
                              int k_tot, float* out_vals, int* out_ids, u64* scratch,
                              long long f_tot, float* flat_vals, int* flat_ids) {
  switch (space) {
    case 0:
      return launch_flat_scan<0, W>(topk_mode, blocks, smem, st, table, n_seg, queries, d, p_tot,
                                    probes, kp, k_tot, out_vals, out_ids, scratch, f_tot,
                                    flat_vals, flat_ids);
    case 1:
      return launch_flat_scan<1, W>(topk_mode, blocks, smem, st, table, n_seg, queries, d, p_tot,
                                    probes, kp, k_tot, out_vals, out_ids, scratch, f_tot,
                                    flat_vals, flat_ids);
    case 2:
      return launch_flat_scan<2, W>(topk_mode, blocks, smem, st, table, n_seg, queries, d, p_tot,
                                    probes, kp, k_tot, out_vals, out_ids, scratch, f_tot,
                                    flat_vals, flat_ids);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// Shared memory of each kernel for width d, the call's largest nlist and
// largest m (the wrapper checks them against the card's limit).
long long ivf_probe_smem(int d, int nlist_max) {
  return round16(8 * d) + 8ll * pow2_host(nlist_max);
}
long long ivf_scan_smem(int d) { return round16(8 * d) + 8ll * kBuf; }
long long ivfpq_scan_smem(int d, int m_max) {
  return 8ll * kBuf + 4ll * m_max * kCodewords + round16(4 * d);
}

// One K6 (pq = 0) or K7 (pq = 1) call: the probe kernel over n_queries x
// n_seg blocks, then the scan over n_queries x p_tot blocks, on `stream`.
// table: n_seg entries of IVF_SEG_WORDS int64 (words above), then
// n_queries x n_seg int32 counters, zero.  queries f32 [n_queries, d];
// probes i32 [n_queries, p_tot] (scratch between the kernels).  topk = 1:
// each segment's top k into out_vals / out_ids [n_queries, k_tot]
// (scratch: n_queries * p_tot * kp keys; kp a power of two <= IVF_K_MAX);
// topk = 0: every probed slot into flat_vals / flat_ids [n_queries,
// f_tot], which the caller filled with (-inf, -1).  space: 0 l2, 1
// cosinesimil, 2 innerproduct (K6; K7 is l2).  Returns the CUDA error of
// the launches (0 on success); faults surface at the caller's next sync.
int ivf_search_launch(const long long* table, int n_seg, int n_queries, const float* queries,
                      int d, int p_tot, int nlist_max, int m_max, int pq, int space, int topk_mode,
                      int kp, int k_tot, int* probes, float* out_vals, int* out_ids, u64* scratch,
                      long long f_tot, float* flat_vals, int* flat_ids, void* stream) {
  if (n_seg <= 0 || n_queries <= 0) return 0;
  if (d <= 0 || d > kDMax || p_tot <= 0 || nlist_max <= 0 || nlist_max > kNlistMax ||
      (pq && (m_max <= 0 || m_max > kMMax)) || (!pq && (space < 0 || space > 2)) ||
      (topk_mode && (kp < 1 || kp > kKMax || (kp & (kp - 1)))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w4 = (d & 3) == 0;
  const size_t probe_smem = (size_t)ivf_probe_smem(d, nlist_max);
  cudaError_t err = w4 ? launch(ivf_probe_kernel<4>, n_queries * n_seg, probe_smem, st, table,
                                n_seg, queries, d, p_tot, probes)
                       : launch(ivf_probe_kernel<1>, n_queries * n_seg, probe_smem, st, table,
                                n_seg, queries, d, p_tot, probes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = n_queries * p_tot;
  const bool tk = topk_mode != 0;
  if (pq) {
    const size_t smem = (size_t)ivfpq_scan_smem(d, m_max);
    err = tk ? launch(ivfpq_scan_kernel<true>, blocks, smem, st, table, n_seg, queries, d, p_tot,
                      (const int*)probes, kp, k_tot, out_vals, out_ids, scratch, f_tot, flat_vals,
                      flat_ids)
             : launch(ivfpq_scan_kernel<false>, blocks, smem, st, table, n_seg, queries, d, p_tot,
                      (const int*)probes, kp, k_tot, out_vals, out_ids, scratch, f_tot, flat_vals,
                      flat_ids);
  } else {
    const size_t smem = (size_t)ivf_scan_smem(d);
    err = w4 ? launch_flat_space<4>(space, tk, blocks, smem, st, table, n_seg, queries, d, p_tot,
                                    probes, kp, k_tot, out_vals, out_ids, scratch, f_tot,
                                    flat_vals, flat_ids)
             : launch_flat_space<1>(space, tk, blocks, smem, st, table, n_seg, queries, d, p_tot,
                                    probes, kp, k_tot, out_vals, out_ids, scratch, f_tot,
                                    flat_vals, flat_ids);
  }
  return static_cast<int>(err);
}

}  // extern "C"
