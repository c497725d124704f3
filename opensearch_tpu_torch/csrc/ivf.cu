// K6 and K7: IVF and IVF-PQ approximate k-NN on Hopper.
//
// Replace the JAX package's XLA programs `ivf_search` / `ivf_search_batch`
// (K6; opensearch_tpu/ops/ivf.py:140,170) and `ivfpq_search_l2` (K7;
// :236): the probe (the nprobe centroids nearest the query), then the
// scan of the probed clusters and each segment's top k.  One call covers
// every (query, segment) of a request or batch: two kernels (K6) or three
// (K7) on one stream, no host sync.  Each kernel after the first is a
// programmatic dependent launch (IVF_PDL): its blocks take their places
// once the kernel before has written its output, stage what needs none
// of it (the launch table, the query, K7's codebook subspace: nothing a
// kernel of the call writes), then wait for that kernel to end
// (griddepcontrol.wait) before they read its output.
//
//   ivf_probe_kernel   a thread-block cluster of G = IVF_PROBE_BLOCKS
//                      blocks (at most 8, a portable cluster) per
//                      (query, segment): block b scores its slice of
//                      the segment's centroids, cd_c = |c|^2 - 2 c.q
//                      (float64 sums, rows.cuh, rounded to float32 once),
//                      as keys (orderable(-cd) << 32 | ~c), and ranks
//                      them within the slice; each block copies every
//                      slice's sorted list out of distributed shared
//                      memory, and each key among its slice's first
//                      nprobe finds its rank in the segment by a binary
//                      search of the other lists: the first nprobe are
//                      written out, the nearest first, the lower centroid
//                      on ties.
//   ivfpq_lut_kernel   (K7) a block per (query, segment, subspace, group
//                      of kResBatch probes): the subspace's codebook
//                      copied into shared memory once, then the group's
//                      tables LUT[m][256] (r = q - centroid in float32;
//                      each entry sum_t (codeword_t - r_t)^2 in float64
//                      over the subspace in order, rounded to float32),
//                      written to a buffer in device memory.  A block reads
//                      its 1 / m of the codebook, not all of it.
//   ivf_scan_kernel    a block per (query, segment, probe rank, chunk of
//   ivfpq_scan_kernel  the probed cluster's rows): the chunk's staged
//                      rows (staged cluster after cluster, no padding row;
//                      ops/ivf.py `stage_index`), its ids and (K7) the
//                      probe's table come into shared memory by bulk
//                      asynchronous copies (cp.async.bulk on mbarriers;
//                      K6 streams its rows through a ring of kStages
//                      stages; each copy a 16-byte window of one byte
//                      range), the chunk's live bytes are gathered at
//                      once, and each row is scored and kept as the key
//                      (orderable(score) << 32 | ~flat) with flat = rank *
//                      c_pad + position: the reference's `lax.top_k` over
//                      its padded [nprobe * c_pad] array breaks ties by
//                      that flat index, not by doc id, so no split of a
//                      cluster into chunks changes which key wins.  A
//                      block keeps its best kp keys; a chunk with rows
//                      posts them to a slot of its (query, segment), a
//                      chunk past its cluster's rows only counts itself,
//                      and the last block to finish merges the posted keys
//                      and maps each kept flat index to its doc id on
//                      output.  The chunks per probe come from the
//                      segment's largest cluster, so the grid is known
//                      without a sync.  Selections of up to kSmallK keys
//                      run in the warps' registers (`top_small`), larger
//                      ones through topk.cuh.
//
// K6 scores rows as K1 does (rows.cuh: v.q and |v|^2 in float64 in K1's
// lane order, from shared memory; the space's translation rounded once,
// a thread a row after the chunk's sums).  No tensor cores: each row set
// meets one query, a matrix-vector product, and the float64 order rules
// out TF32 and BF16.  K7 sums a row's m table entries in float64 from
// subspace 0 up; score 1 / (1 + d2) rounded once.
//
// ops/ivf.py's plain twins (`ivf_search_segments`,
// `ivfpq_search_segments`) compute the same numbers in the same order,
// so the kernels equal them byte for byte.  A segment asking for more
// than kKMax hits takes the scores mode instead (TOPK false): the scan
// writes every probed slot's score and id to a flat buffer and the
// wrapper sorts it (ops/cuda_ivf.py, counted as the sorted route).
//
// Bound on the card: memory.  K6 reads its probed rows once (d * 4 bytes
// a row) and does 4 d float64 flops a row, far below the H100's float64
// rate per byte; a K7 row is m bytes of codes and m table reads from
// shared memory.  The probe reads nlist * d * 4 bytes a (query, segment).
// K7's table pass converts each (codeword - r) to float64 before its
// square: the card's float32-to-float64 conversions, not bytes, set its
// pace.  A library built with -DQUANT_PHASES adds phases.cuh's marks and
// `ivf_empty_pair`, the floor two dependent launches set.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bulk.cuh"
#include "phases.cuh"
#include "rows.cuh"
#include "topk.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace bulk;

// The wrapper (ops/cuda_ivf.py) owns the launch table and the limits and
// passes them in with -D.
// The work split is fixed at build time too: IVF_PROBE_BLOCKS (the
// probe's cluster), IVF_CHUNK_ROWS / IVF_PQ_CHUNK_ROWS (rows a K6 / K7
// scan block takes), IVF_STAGE_BYTES (each K6 row stage), IVF_SMALL_K
// (kp up to this selects in warp registers) and IVF_PDL (1: each kernel
// after the first is a programmatic dependent launch); testing/
// k6_sweep.py builds variants.
#if !defined(IVF_K_MAX) || !defined(IVF_SEG_WORDS) || !defined(IVF_NLIST_MAX) ||   \
    !defined(IVF_M_MAX) || !defined(IVF_D_MAX) || !defined(IVF_CHUNK_MAX) ||       \
    !defined(IVF_PROBE_BLOCKS) || !defined(IVF_CHUNK_ROWS) || !defined(IVF_PQ_CHUNK_ROWS) || \
    !defined(IVF_STAGE_BYTES) || !defined(IVF_SMALL_K) || !defined(IVF_PDL)
#error "build through ops/cuda_ivf.py, whose defines() gives the IVF_* macros"
#endif

constexpr int kThreads = 256;
constexpr int kProbeThreads = 512; // a probe block: one pass over a slice of 64 centroids at d = 100
constexpr int kBuf = 1024;         // keys a scan block holds: its best kp, then a tile
constexpr int kSmallK = IVF_SMALL_K;  // kp up to this: the warps' selection (top_small)
constexpr int kMergeBatch = 512;   // keys the segment's merge reads a round
constexpr int kStages = 3;         // K6's ring of row stages
constexpr int kProbeBlocks = IVF_PROBE_BLOCKS;  // the probe's cluster
constexpr int kChunkRows = IVF_CHUNK_ROWS;
constexpr int kPqChunkRows = IVF_PQ_CHUNK_ROWS;
constexpr int kPqCodeBytes = 64 * kPqChunkRows;  // K7's codes room: kPqChunkRows rows up to m = 64
constexpr int kStageBytes = IVF_STAGE_BYTES;
constexpr bool kPdl = IVF_PDL != 0;
constexpr int kResBatch = 8;       // K7's LUT: probes a thread's entries advance together
constexpr int kResFloats = 2048;   // ... their residuals in shared memory
constexpr int kCbSmemFloats = 16384;  // a subspace's codebook in shared memory (64 KB)
constexpr int kKMax = IVF_K_MAX;
constexpr int kSegWords = IVF_SEG_WORDS;
constexpr int kNlistMax = IVF_NLIST_MAX;
constexpr int kMMax = IVF_M_MAX;
constexpr int kDMax = IVF_D_MAX;
constexpr int kChunkMax = IVF_CHUNK_MAX;
constexpr int kCodewords = 256;
static_assert((kKMax & (kKMax - 1)) == 0 && kKMax <= kBuf - kMergeBatch,
              "kKMax: a power of two the merge buffer holds beside one round");
static_assert(kProbeBlocks >= 1 && kProbeBlocks <= 8, "a portable cluster: 1 to 8 blocks");
static_assert(kChunkRows >= 1 && kChunkRows <= kChunkMax && kPqChunkRows >= 1 &&
                  kPqChunkRows <= kChunkMax && kStageBytes >= 16,
              "chunks of 1 to IVF_CHUNK_MAX rows");
static_assert(kSmallK == 0 || kSmallK == 32, "the warps' selection keeps 32 keys or none");

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
  wProbeOff = 10,  // the segment's first probe within a query's
  wOutCol = 11,    // the segment's first output column
  wFlatOff = 12,   // scores mode: its first slot of a query's flat buffer
  wM = 13,         // K7: subspaces
  wBlockOff = 14,  // the segment's first scan block within a query's
  wChunks = 15,    // scan blocks per probe: its largest cluster's chunks
};

using topk::u64;

__host__ __device__ __forceinline__ int round16(long long b) { return (int)((b + 15) & ~15ll); }

// -- programmatic dependent launch (mbarriers and bulk copies: bulk.cuh) --

__device__ __forceinline__ void wait_for_inputs() {
  if constexpr (kPdl) asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void let_dependents_start() {
  if constexpr (kPdl) asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// -- where a scan block works --

// Scan block blockIdx.x: query, segment, probe rank and chunk (from the
// table alone: known before the probe kernel ends).
struct Block {
  const long long* e;
  int qi, seg, rank, chunk, nprobe, n_blocks;
  long long first_block, first_probe, c_pad;
};

__device__ __forceinline__ Block locate(const long long* table, int n_seg, int p_tot, int b_tot) {
  Block b;
  b.qi = blockIdx.x / b_tot;
  const int j = blockIdx.x % b_tot;
  int lo = 0, hi = n_seg - 1;  // the last segment whose first block is <= j
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table[(long long)mid * kSegWords + wBlockOff] <= j) lo = mid; else hi = mid - 1;
  }
  b.seg = lo;
  b.e = table + (long long)lo * kSegWords;
  const int local = j - (int)b.e[wBlockOff], chunks = (int)b.e[wChunks];
  b.rank = local / chunks;
  b.chunk = local % chunks;
  b.nprobe = (int)b.e[wNprobe];
  b.n_blocks = b.nprobe * chunks;
  b.first_block = (long long)b.qi * b_tot + b.e[wBlockOff];
  b.first_probe = (long long)b.qi * p_tot + b.e[wProbeOff];
  b.c_pad = b.e[wCpad];
  return b;
}

// The probed cluster's first row and the chunk's rows (<= 0: the chunk
// lies past them).  After wait_for_inputs: reads the probe kernel's output.
__device__ __forceinline__ void chunk_rows(const Block& b, const int* probes, int chunk,
                                           long long& row0, int& rows) {
  const int c = probes[b.first_probe + b.rank];
  const int* starts = reinterpret_cast<const int*>(b.e[wStarts]);
  const int c0 = b.chunk * chunk;
  row0 = (long long)starts[c] + c0;
  rows = min(chunk, starts[c + 1] - starts[c] - c0);
}

// -- the probe --

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A cluster of G = kProbeBlocks blocks per (query, segment): the segment's nprobe
// nearest centroids.  Shared memory: the query (float64) | the block's
// slice of keys | the same, sorted descending | every slice's sorted
// list (G x per keys).
template <int W>
__global__ void __launch_bounds__(kProbeThreads)
ivf_probe_kernel(const long long* __restrict__ table, int n_seg,
                 const float* __restrict__ queries, int d, int p_tot, int* __restrict__ probes) {
  extern __shared__ __align__(16) char smem[];
  QPHASE_START();
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int G = kProbeBlocks;
  const int me = (int)cluster.block_rank();
  const int pair = blockIdx.x / G, qi = pair / n_seg, seg = pair % n_seg;
  const long long* e = table + (long long)seg * kSegWords;
  const float* cent = reinterpret_cast<const float*>(e[wCentroids]);
  const int nlist = (int)e[wNlist], nprobe = (int)e[wNprobe];
  const int per = (nlist + G - 1) / G;
  const int c_lo = min(nlist, me * per), n_own = min(nlist, c_lo + per) - c_lo;
  double* q_s = reinterpret_cast<double*>(smem);
  u64* own = reinterpret_cast<u64*>(smem + round16(8ll * d));
  u64* sorted = own + per;
  u64* all = sorted + per;
  const float* q = queries + (long long)qi * d;
  const int tid = threadIdx.x;
  const int L = rowsum::row_lanes(d), groups = kProbeThreads / L;
  const int sub = tid & (L - 1), grp = tid / L, units = d / W;
  // A slice of one pass whose rows a lane covers in kPre units: the lane's
  // loads go out before the query's (block-uniform).
  constexpr int kPre = 4;
  const bool one_pass = n_own <= groups && units <= kPre * L;
  float a[kPre][W];
  if (one_pass && grp < n_own) {
    const float* row = cent + (long long)(c_lo + grp) * d;
#pragma unroll
    for (int u = 0; u < kPre; ++u) {
      const int j = sub + u * L;
      if (j < units) {
        if constexpr (W == 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(row) + j);
          a[u][0] = v.x; a[u][1] = v.y; a[u][2] = v.z; a[u][3] = v.w;
        } else {
          a[u][0] = __ldg(row + j);
        }
      }
    }
  }
  for (int i = tid; i < d; i += kProbeThreads) q_s[i] = (double)q[i];
  __syncthreads();
  if (one_pass) {  // rowsum::row_accumulate's units in its order
    double dot = 0.0, v2 = 0.0;
    if (grp < n_own) {
#pragma unroll
      for (int u = 0; u < kPre; ++u) {
        const int j = sub + u * L;
        if (j < units) {
#pragma unroll
          for (int c = 0; c < W; ++c) {
            const double x = a[u][c];
            dot = fma(x, q_s[W * j + c], dot);
            v2 = fma(x, x, v2);
          }
        }
      }
    }
    rowsum::group_sum(dot, v2, L);
    if (grp < n_own && sub == 0)
      own[grp] = topk::make_key(-__double2float_rn(v2 - 2.0 * dot), c_lo + grp);
  }
  for (int base = 0; !one_pass && base < n_own; base += groups) {  // whole warps shuffle
    const int i = base + grp;
    double dot = 0.0, v2 = 0.0;
    if (i < n_own) rowsum::row_accumulate<W>(cent + (long long)(c_lo + i) * d, q_s, d, L, sub, dot, v2);
    rowsum::group_sum(dot, v2, L);
    if (i < n_own && sub == 0) own[i] = topk::make_key(-__double2float_rn(v2 - 2.0 * dot), c_lo + i);
  }
  __syncthreads();
  QPHASE(0);
  // each key's rank within the slice (keys are distinct: one per centroid)
  for (int i = tid; i < n_own; i += kProbeThreads) {
    const u64 k = own[i];
    int r = 0;
    for (int j = 0; j < n_own; ++j) r += own[j] > k;
    sorted[r] = k;
  }
  cluster.sync();  // every slice's sorted list is complete
  for (int x = tid; x < G * per; x += kProbeThreads) {  // the lists, here
    const int b = x / per, i = x - b * per;
    const int size = max(0, min(nlist, (b + 1) * per) - min(nlist, b * per));
    if (i < size) all[x] = b == me ? sorted[i] : cluster.map_shared_rank(sorted, b)[i];
  }
  cluster_arrive();  // this block reads no other block's memory after here
  __syncthreads();
  int top = 1;
  while (top < per) top <<= 1;
  int* out = probes + (long long)qi * p_tot + e[wProbeOff];
  int sizes[G];
#pragma unroll
  for (int b = 0; b < G; ++b)
    sizes[b] = b != me ? max(0, min(nlist, (b + 1) * per) - min(nlist, b * per)) : 0;
  for (int i = tid; i < min(n_own, nprobe); i += kProbeThreads) {
    const u64 k = sorted[i];
    int above[G];  // keys of slice b above k, by binary lifting
#pragma unroll
    for (int b = 0; b < G; ++b) above[b] = 0;
    for (int step = top; step > 0; step >>= 1) {
#pragma unroll
      for (int b = 0; b < G; ++b)  // the slices' searches side by side
        if (above[b] + step <= sizes[b] && all[b * per + above[b] + step - 1] > k) above[b] += step;
    }
    int r = i;
#pragma unroll
    for (int b = 0; b < G; ++b) r += above[b];
    if (r < nprobe) out[r] = topk::key_id(k);
  }
  cluster_wait();  // no block leaves while another still reads its list
  QPHASE(1);
  // the probes are written: the next kernel's blocks may take their
  // places, stage what needs no probe, then wait for this grid to end
  // (letting them start earlier in the kernel made back-to-back calls
  // fault on the card)
  let_dependents_start();
}

// -- the scan's common parts --

constexpr unsigned kFull = 0xffffffffu;

// v sorted descending across the warp's lanes (a bitonic network).
__device__ __forceinline__ u64 warp_sort_desc(u64 v, int lane) {
  for (int size = 2; size <= 32; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 o = __shfl_xor_sync(kFull, v, stride);
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
      v = keep_max ? max(v, o) : min(v, o);
    }
  }
  return v;
}

// The 32 largest of two sequences sorted descending across the lanes,
// sorted descending: the larger of each lane and its mirror is a bitonic
// sequence holding them, then one half-cleaner per stride.
__device__ __forceinline__ u64 warp_merge_desc(u64 best, u64 x, int lane) {
  u64 z = max(best, __shfl_sync(kFull, x, 31 - lane));
  for (int stride = 16; stride > 0; stride >>= 1) {
    const u64 o = __shfl_xor_sync(kFull, z, stride);
    z = (lane & stride) == 0 ? max(z, o) : min(z, o);
  }
  return z;
}

// The kp (<= kSmallK) largest of src[0, n) -- shared memory, or device
// memory written by other blocks when GLOBAL (read with __ldcg, the next
// round's keys in flight while one is merged) -- and, with `kept`, of
// keys[0, kp), into keys[0, kp), sorted descending.  Each warp keeps its
// 32 best in registers over rounds of a key a thread, skipping a round
// none of whose keys passes its kp-th best; then the warps' lists merge
// pairwise in shared memory, half the warps a level.  All threads call;
// enters and leaves synchronised.
template <bool GLOBAL>
__device__ void top_small(u64* keys, int kp, bool kept, const u64* src, long long n) {
  __shared__ u64 cand[kThreads];  // each warp's 32 best
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // keys[0, kp) are sorted descending (a selection's output, or zeros)
  u64 best = kept && warp == 0 && lane < kp ? keys[lane] : 0ull;
  auto load = [&](long long i) -> u64 {
    if (i >= n) return 0ull;
    return GLOBAL ? __ldcg(src + i) : src[i];
  };
  u64 next = load(tid);
  u64 floor_key = __shfl_sync(kFull, best, kp - 1);  // the warp's kp-th: below it no key counts
  for (long long base = 0; base < n; base += kThreads) {  // block-uniform
    const u64 x = next;
    next = load(base + kThreads + tid);
    if (__any_sync(kFull, x > floor_key)) {  // warp-uniform
      best = warp_merge_desc(best, warp_sort_desc(x, lane), lane);
      floor_key = __shfl_sync(kFull, best, kp - 1);
    }
  }
  cand[warp * 32 + lane] = best;
  for (int half = kThreads / 64; half > 0; half >>= 1) {
    __syncthreads();
    if (warp < half) {
      best = warp_merge_desc(best, cand[(warp + half) * 32 + lane], lane);
      cand[warp * 32 + lane] = best;
    }
  }
  __syncthreads();  // every read of src and keys is done
  if (warp == 0 && lane < kp) keys[lane] = best;
  __syncthreads();
}

// After a tile: keep the best kp of keys[0, kp + fill) in keys[0, kp),
// sorted descending: the warps' selection for kp <= kSmallK, else
// `select_top` through the smallest buffer that holds them, padded with
// "no candidate".  All threads call (block-uniform), the tile's keys
// written.
__device__ __forceinline__ void select_tile(u64* keys, int kp, int fill) {
  __syncthreads();
  if (kp <= kSmallK) {
    top_small<false>(keys, kp, true, keys + kp, fill);
    return;
  }
  const int n = kp + fill;
  const int buf = n <= 256 ? 256 : n <= 512 ? 512 : kBuf;
  for (int i = n + threadIdx.x; i < buf; i += kThreads) keys[i] = 0;
  __syncthreads();
  if (buf == 256) topk::select_top<kThreads, 256>(keys, kp);
  else if (buf == 512) topk::select_top<kThreads, 512>(keys, kp);
  else topk::select_top<kThreads, kBuf>(keys, kp);
}

// The end of a TOPK block: keys[0, kp) hold its best kp (0 for a chunk
// past its cluster's rows, which posts nothing).  A chunk with rows posts
// them to the next free slot of its (query, segment); every block then
// counts itself done, and the last merges the posted keys and writes the
// segment's k hits, each kept flat index mapped back to its doc id;
// (-inf, -1) past the candidates.  counters: per (query, segment) the
// slots taken, then the blocks done.
__device__ void finish(u64* keys, int kp, bool has_rows, const Block& b, int n_seg,
                       const int* __restrict__ probes, u64* __restrict__ scratch, int* counters,
                       int k_tot, float* __restrict__ out_vals, int* __restrict__ out_ids) {
  __shared__ int slot_s, last_s;
  if (b.n_blocks > 1) {
    int* slots = counters + 2 * ((long long)b.qi * n_seg + b.seg);
    if (has_rows) {
      if (threadIdx.x == 0) slot_s = atomicAdd(slots, 1);
      __syncthreads();
      u64* mine = scratch + (b.first_block + slot_s) * kp;
      for (int i = threadIdx.x; i < kp; i += kThreads) mine[i] = keys[i];
      __threadfence();
    }
    __syncthreads();
    if (threadIdx.x == 0) last_s = atomicAdd(slots + 1, 1) == b.n_blocks - 1;
    __syncthreads();
    if (!last_s) return;
    __threadfence();
    const long long posted = (long long)atomicAdd(slots, 0) * kp;
    if (kp <= kSmallK)
      top_small<true>(keys, kp, false, scratch + b.first_block * kp, posted);
    else
      topk::merge_segment<kThreads, kBuf, kMergeBatch>(keys, scratch + b.first_block * kp, posted,
                                                       kp);
  }
  const int k = (int)b.e[wK];
  const int* starts = reinterpret_cast<const int*>(b.e[wStarts]);
  const int* ids = reinterpret_cast<const int*>(b.e[wIds]);
  const long long out = (long long)b.qi * k_tot + b.e[wOutCol];
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const u64 key = keys[i];
    if (key == 0) {
      out_vals[out + i] = -INFINITY;
      out_ids[out + i] = -1;
      continue;
    }
    const long long f = (long long)(uint32_t)topk::key_id(key);
    const int c = probes[b.first_probe + f / b.c_pad];
    out_vals[out + i] = topk::key_score(key);
    out_ids[out + i] = ids[starts[c] + (int)(f % b.c_pad)];
  }
}

// A scored row at `pos` of its cluster: into the tile of keys (TOPK) or
// the flat buffers.
template <bool TOPK>
__device__ __forceinline__ void keep_row(const Block& b, u64* slot, int pos, int id, bool ok,
                                         float sc, long long f_tot, float* flat_vals,
                                         int* flat_ids) {
  if (TOPK) {
    *slot = ok ? topk::make_key(sc, b.rank * b.c_pad + pos) : 0;
  } else {
    const long long at = (long long)b.qi * f_tot + b.e[wFlatOff] + b.rank * b.c_pad + pos;
    flat_vals[at] = ok ? sc : -INFINITY;
    flat_ids[at] = ok ? id : -1;
  }
}

// The chunk's live bytes, gathered at once from its ids in shared memory.
__device__ __forceinline__ void gather_live(const int* ids_w, int rows, const uint8_t* live,
                                            uint8_t* ok_s) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const int id = ids_w[r];
    ok_s[r] = id >= 0 && live[id];
  }
}

// Rows a K6 stage holds: whole passes of the block's row groups in at
// most kStageBytes (one row at least), no more than a chunk.
__host__ __device__ inline int stage_rows_for(int d) {
  const int groups = kThreads / rowsum::row_lanes(d);
  int t = max(1, kStageBytes / (4 * d));
  if (t >= groups) t -= t % groups;
  return min(t, kChunkRows);
}

// K6's shared memory, in order: the query (float64) | kBuf keys |
// kStages row stages | the chunk's rows' sums (v.q, |v|^2) | its ids |
// its live bytes | kStages + 1 mbarriers.
struct ScanLayout {
  int stage_rows, keys, stage, stages, sums, ids, ok, bars, total;
  __host__ __device__ explicit ScanLayout(int d) {
    stage_rows = stage_rows_for(d);
    keys = round16(8ll * d);
    stages = keys + 8 * kBuf;
    stage = round16((long long)stage_rows * d * 4 + 32);
    sums = stages + kStages * stage;
    ids = sums + 16 * kChunkRows;
    ok = ids + round16(4ll * kChunkRows + 32);
    bars = ok + round16(kChunkRows);
    total = bars + 8 * (kStages + 1);
  }
};

// K6's scan: a block per (query, segment, probe rank, chunk).
template <int SPACE, int W, bool TOPK>
__global__ void __launch_bounds__(kThreads)
ivf_scan_kernel(const long long* __restrict__ table, int n_seg, const float* __restrict__ queries,
                int d, int p_tot, int b_tot, const int* __restrict__ probes, int kp, int k_tot,
                float* __restrict__ out_vals,
                int* __restrict__ out_ids, u64* __restrict__ scratch, long long f_tot,
                float* __restrict__ flat_vals, int* __restrict__ flat_ids) {
  extern __shared__ __align__(16) char smem[];
  const ScanLayout lay(d);
  const int stage_rows = lay.stage_rows;
  double* q_s = reinterpret_cast<double*>(smem);
  u64* keys = reinterpret_cast<u64*>(smem + lay.keys);
  char* ids_s = smem + lay.ids;
  uint8_t* ok_s = reinterpret_cast<uint8_t*>(smem + lay.ok);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  const Block b = locate(table, n_seg, p_tot, b_tot);
  int* counters = reinterpret_cast<int*>(const_cast<long long*>(table + (long long)n_seg * kSegWords));
  const float* q = queries + (long long)b.qi * d;
  const int tid = threadIdx.x, lane = tid & 31;
  // what needs no probe: the query, the kept keys, the barriers
  if (tid == 0) {
    for (int s = 0; s <= kStages; ++s) bar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < d; i += kThreads) q_s[i] = (double)q[i];
  if (TOPK)
    for (int i = tid; i < kp; i += kThreads) keys[i] = 0;
  __syncthreads();
  const double q2 = rowsum::query_norm2(q_s, d, lane);
  wait_for_inputs();
  QPHASE_START();
  long long row0;
  int rows;
  chunk_rows(b, probes, kChunkRows, row0, rows);
  if (rows <= 0) {
    if (TOPK) finish(keys, kp, false, b, n_seg, probes, scratch, counters, k_tot, out_vals, out_ids);
    return;
  }
  const float* src = reinterpret_cast<const float*>(b.e[wRows]) + row0 * d;
  const int* ids = reinterpret_cast<const int*>(b.e[wIds]) + row0;
  const uint8_t* live = reinterpret_cast<const uint8_t*>(b.e[wLive]);
  const int n_sub = (rows + stage_rows - 1) / stage_rows;
  auto issue = [&](int i) {  // stage i % kStages <- the rows of sub-tile i
    const int t0 = i * stage_rows, n = min(stage_rows, rows - t0);
    const float* from = src + (long long)t0 * d;
    const int w = window_bytes(from, 4ll * n * d);
    uint64_t* bar = &bars[i % kStages];
    bar_expect(bar, w);
    copy_window(smem + lay.stages + (i % kStages) * lay.stage, from, w, bar);
  };
  if (tid == 0) {
    const int w = window_bytes(ids, 4ll * rows);
    bar_expect(&bars[kStages], w);
    copy_window(ids_s, ids, w, &bars[kStages]);
    for (int i = 0; i < min(kStages, n_sub); ++i) issue(i);
  }
  bar_wait(&bars[kStages], 0);
  const int* ids_w = reinterpret_cast<const int*>(ids_s + window_skip(ids));
  gather_live(ids_w, rows, live, ok_s);
  __syncthreads();
  QPHASE(3);
  const int L = rowsum::row_lanes(d), groups = kThreads / L;
  const int sub = tid & (L - 1), grp = tid / L;
  const int c0 = b.chunk * kChunkRows;
  double2* sums = reinterpret_cast<double2*>(smem + lay.sums);
  for (int i = 0; i < n_sub; ++i) {
    const int t0 = i * stage_rows, trows = min(stage_rows, rows - t0);
    bar_wait(&bars[i % kStages], (i / kStages) & 1);
    QPHASE(3);
    const float* srow = reinterpret_cast<const float*>(
        smem + lay.stages + (i % kStages) * lay.stage + window_skip(src + (long long)t0 * d));
    for (int b0 = 0; b0 < trows; b0 += groups) {  // block-uniform: whole warps shuffle
      const int r = b0 + grp;
      const bool has = r < trows;
      double dot = 0.0, v2 = 0.0;
      if (has) rowsum::row_accumulate_shared<W>(srow + (long long)r * d, q_s, d, L, sub, dot, v2);
      rowsum::group_sum(dot, v2, L);
      if (has && sub == 0) sums[t0 + r] = make_double2(dot, v2);
    }
    __syncthreads();  // every read of this stage before its next copy
    if (tid == 0 && i + kStages < n_sub) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(i + kStages);
    }
    QPHASE(4);
  }
  // the translations, a thread a row, and the top kp, in tiles of the key
  // buffer (one tile when kp + chunk <= kBuf)
  const int T = TOPK ? kBuf - kp : rows;
  for (int t0 = 0; t0 < rows; t0 += T) {
    const int trows = min(T, rows - t0);
    for (int r = tid; r < trows; r += kThreads) {
      const bool ok = ok_s[t0 + r];
      const double2 s2 = sums[t0 + r];
      const float sc = ok ? rowsum::translate<SPACE>(s2.x, s2.y, q2) : -INFINITY;
      keep_row<TOPK>(b, &keys[kp + r], c0 + t0 + r, ids_w[t0 + r], ok, sc, f_tot, flat_vals,
                     flat_ids);
    }
    QPHASE(4);
    if (TOPK) {
      select_tile(keys, kp, trows);
      QPHASE(5);
    }
  }
  if (TOPK) {
    finish(keys, kp, true, b, n_seg, probes, scratch, counters, k_tot, out_vals, out_ids);
    QPHASE(6);
    QPHASE_COUNT(7);
  }
}

// -- K7 --

// K7's table pass: a block per (query, segment, subspace, group of
// kResBatch probes).  Shared memory: the subspace's codebook [256][dsub]
// (one bulk copy, issued before the probes exist) when 256 * dsub <=
// cb_floats, else read from device memory | the residuals of the probes
// a thread's entries advance together (max(kResFloats, d) floats).
__global__ void __launch_bounds__(kThreads)
ivfpq_lut_kernel(const long long* __restrict__ table, int n_seg, const float* __restrict__ queries,
                 int d, int p_tot, int m_max, int n_groups, int cb_floats,
                 const int* __restrict__ probes, float* __restrict__ lut) {
  extern __shared__ __align__(16) char smem[];
  __shared__ __align__(8) uint64_t bar;
  int x = blockIdx.x;
  const int g = x % n_groups;
  x /= n_groups;
  const int s = x % m_max;
  x /= m_max;
  const int seg = x % n_seg, qi = x / n_seg;
  const long long* e = table + (long long)seg * kSegWords;
  const int m = (int)e[wM], nprobe = (int)e[wNprobe], p0 = g * kResBatch;
  if (s >= m || p0 >= nprobe) return;
  const int dsub = d / m, tid = threadIdx.x;
  const bool in_smem = kCodewords * dsub <= cb_floats;
  const float* cb_g = reinterpret_cast<const float*>(e[wCodebooks]) + (long long)s * kCodewords * dsub;
  float* cb_s = reinterpret_cast<float*>(smem);
  float* res = cb_s + cb_floats;
  if (in_smem && tid == 0) {  // before the probes exist
    bar_init(&bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int w = window_bytes(cb_g, 4ll * kCodewords * dsub);
    bar_expect(&bar, w);
    copy_window(cb_s, cb_g, w, &bar);
  }
  const float* cb = in_smem ? cb_s + window_skip(cb_g) / 4 : cb_g;
  const float* qs = queries + (long long)qi * d + s * dsub;
  const float* cent = reinterpret_cast<const float*>(e[wCentroids]) + s * dsub;
  const long long first = (long long)qi * p_tot + e[wProbeOff] + p0;
  const int nb = min(kResBatch, nprobe - p0);
  const int batch = max(1, min(kResBatch, max(kResFloats, d) / dsub));
  wait_for_inputs();
  QPHASE_START();
  for (int r0 = 0; r0 < nb; r0 += batch) {
    const int n = min(batch, nb - r0);
    __syncthreads();  // the barrier is set up; the last batch's residuals are read
    for (int i = tid; i < n * dsub; i += kThreads) {
      const int rr = i / dsub, t = i - rr * dsub;
      const int c = probes[first + r0 + rr];
      res[i] = __fsub_rn(qs[t], cent[(long long)c * d + t]);
    }
    __syncthreads();
    if (in_smem && r0 == 0) bar_wait(&bar, 0);
    for (int w = tid; w < kCodewords; w += kThreads) {
      const float* cw = cb + w * dsub;
      double acc[kResBatch];
#pragma unroll
      for (int rr = 0; rr < kResBatch; ++rr) acc[rr] = 0.0;
      for (int t = 0; t < dsub; ++t) {
        const float c_t = cw[t];
#pragma unroll
        for (int rr = 0; rr < kResBatch; ++rr) {
          if (rr < n) {
            const double diff = (double)__fsub_rn(c_t, res[rr * dsub + t]);
            acc[rr] = fma(diff, diff, acc[rr]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kResBatch; ++rr)
        if (rr < n)
          lut[((first + r0 + rr) * m_max + s) * kCodewords + w] = __double2float_rn(acc[rr]);
    }
  }
  QPHASE(2);
  let_dependents_start();  // the tables are written
}

// Rows a K7 scan block takes in a call whose largest m is m_max:
// kPqChunkRows, halved until the chunk's codes fit kPqCodeBytes (above m
// = 64 the table alone takes 64 KB and more).
__host__ __device__ inline int pq_chunk(int m_max) {
  int chunk = kPqChunkRows;
  while (chunk > 1 && (long long)chunk * m_max > kPqCodeBytes) chunk >>= 1;
  return chunk;
}

// K7's shared memory, in order: kBuf keys | the LUT [m][256] f32 | the
// chunk's codes | its ids | its live bytes | 3 mbarriers (ids, LUT,
// codes).
struct PqLayout {
  int chunk, lut, codes, ids, ok, bars, total;
  __host__ __device__ explicit PqLayout(int m_max) {
    chunk = pq_chunk(m_max);
    lut = 8 * kBuf;
    codes = lut + 4 * m_max * kCodewords;
    ids = codes + round16((long long)chunk * m_max + 32);
    ok = ids + round16(4ll * chunk + 32);
    bars = ok + round16(chunk);
    total = bars + 24;
  }
};

// K7's scan: a block per (query, segment, probe rank, chunk).
template <bool TOPK>
__global__ void __launch_bounds__(kThreads)
ivfpq_scan_kernel(const long long* __restrict__ table, int n_seg, int p_tot, int b_tot,
                  const int* __restrict__ probes, const float* __restrict__ lut, int m_max,
                  int kp, int k_tot, float* __restrict__ out_vals,
                  int* __restrict__ out_ids, u64* __restrict__ scratch, long long f_tot,
                  float* __restrict__ flat_vals, int* __restrict__ flat_ids) {
  extern __shared__ __align__(16) char smem[];
  const PqLayout lay(m_max);
  const int chunk = lay.chunk;
  u64* keys = reinterpret_cast<u64*>(smem);
  const float* lut_s = reinterpret_cast<const float*>(smem + lay.lut);
  uint8_t* ok_s = reinterpret_cast<uint8_t*>(smem + lay.ok);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);
  const Block b = locate(table, n_seg, p_tot, b_tot);
  int* counters = reinterpret_cast<int*>(const_cast<long long*>(table + (long long)n_seg * kSegWords));
  const int tid = threadIdx.x, m = (int)b.e[wM];
  if (tid == 0) {
    for (int i = 0; i < 3; ++i) bar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (TOPK)
    for (int i = tid; i < kp; i += kThreads) keys[i] = 0;
  __syncthreads();
  wait_for_inputs();
  QPHASE_START();
  if (tid == 0) {  // the probe's table needs no cluster: its copy first
    const float* table_src = lut + (b.first_probe + b.rank) * m_max * kCodewords;
    bar_expect(&bars[1], 4 * m * kCodewords);
    copy_window(smem + lay.lut, table_src, 4 * m * kCodewords, &bars[1]);
  }
  long long row0;
  int rows;
  chunk_rows(b, probes, chunk, row0, rows);
  if (rows <= 0) {
    bar_wait(&bars[1], 0);  // no copy outlives its block
    if (TOPK) finish(keys, kp, false, b, n_seg, probes, scratch, counters, k_tot, out_vals, out_ids);
    return;
  }
  const uint8_t* codes = reinterpret_cast<const uint8_t*>(b.e[wRows]) + row0 * m;
  const int* ids = reinterpret_cast<const int*>(b.e[wIds]) + row0;
  const uint8_t* live = reinterpret_cast<const uint8_t*>(b.e[wLive]);
  if (tid == 0) {
    const int wi = window_bytes(ids, 4ll * rows);
    bar_expect(&bars[0], wi);
    copy_window(smem + lay.ids, ids, wi, &bars[0]);
    const int wc = window_bytes(codes, (long long)rows * m);
    bar_expect(&bars[2], wc);
    copy_window(smem + lay.codes, codes, wc, &bars[2]);
  }
  bar_wait(&bars[0], 0);
  const int* ids_w = reinterpret_cast<const int*>(smem + lay.ids + window_skip(ids));
  gather_live(ids_w, rows, live, ok_s);
  bar_wait(&bars[1], 0);
  bar_wait(&bars[2], 0);
  __syncthreads();
  QPHASE(3);
  const uint8_t* codes_s = reinterpret_cast<const uint8_t*>(smem + lay.codes + window_skip(codes));
  const int c0 = b.chunk * chunk;
  const int T = TOPK ? kBuf - kp : rows;
  for (int t0 = 0; t0 < rows; t0 += T) {
    const int trows = min(T, rows - t0);
    constexpr int kRows = 4;  // a thread's rows, their sums side by side
    for (int r0 = tid; r0 < trows; r0 += kRows * kThreads) {
      double d2[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) d2[u] = 0.0;
      for (int s = 0; s < m; ++s) {
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const int r = r0 + u * kThreads;
          if (r < trows) d2[u] += (double)lut_s[s * kCodewords + codes_s[(long long)(t0 + r) * m + s]];
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = r0 + u * kThreads;
        if (r < trows) {
          const bool ok = ok_s[t0 + r];
          const float sc = ok ? __double2float_rn(1.0 / (1.0 + d2[u])) : -INFINITY;
          keep_row<TOPK>(b, &keys[kp + r], c0 + t0 + r, ids_w[t0 + r], ok, sc, f_tot, flat_vals,
                         flat_ids);
        }
      }
    }
    QPHASE(4);
    if (TOPK) {
      select_tile(keys, kp, trows);
      QPHASE(5);
    }
  }
  if (TOPK) {
    finish(keys, kp, true, b, n_seg, probes, scratch, counters, k_tot, out_vals, out_ids);
    QPHASE(6);
    QPHASE_COUNT(7);
  }
}

// -- launches --

// Above 48 KB of shared memory a block, static and dynamic together, a
// kernel must opt in; the kernels' static arrays stay under kStaticSmem.
constexpr size_t kStaticSmem = 4096;

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem + kStaticSmem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// A launch of `kernel` on `blocks` blocks of `threads`: in clusters of
// kProbeBlocks when `cluster`, and after the stream's previous kernel by
// programmatic dependent launch when `dependent` (and kPdl).
template <typename... KArgs, typename... Args>
cudaError_t launch(void (*kernel)(KArgs...), int blocks, int threads, size_t smem, cudaStream_t st,
                   bool cluster, bool dependent, Args... args) {
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attrs[2];
  int n = 0;
  if (cluster) {
    attrs[n].id = cudaLaunchAttributeClusterDimension;
    attrs[n].val.clusterDim.x = kProbeBlocks;
    attrs[n].val.clusterDim.y = 1;
    attrs[n].val.clusterDim.z = 1;
    ++n;
  }
  if (dependent && kPdl) {
    attrs[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attrs[n].val.programmaticStreamSerializationAllowed = 1;
    ++n;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attrs;
  cfg.numAttrs = n;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
  const cudaError_t last = cudaGetLastError();  // also clears a refused launch's error
  return err != cudaSuccess ? err : last;
}

template <int SPACE, int W>
cudaError_t launch_flat_scan(bool topk_mode, int blocks, size_t smem, cudaStream_t st,
                             const long long* table, int n_seg, const float* queries, int d,
                             int p_tot, int b_tot, const int* probes, int kp, int k_tot,
                             float* out_vals, int* out_ids, u64* scratch, long long f_tot,
                             float* flat_vals, int* flat_ids) {
  auto kernel = topk_mode ? ivf_scan_kernel<SPACE, W, true> : ivf_scan_kernel<SPACE, W, false>;
  return launch(kernel, blocks, kThreads, smem, st, false, true, table, n_seg, queries, d, p_tot,
                b_tot, probes, kp, k_tot, out_vals, out_ids, scratch, f_tot, flat_vals, flat_ids);
}

template <int W>
cudaError_t launch_flat_space(int space, bool topk_mode, int blocks, size_t smem,
                              cudaStream_t st, const long long* table, int n_seg,
                              const float* queries, int d, int p_tot, int b_tot, const int* probes,
                              int kp, int k_tot, float* out_vals, int* out_ids, u64* scratch,
                              long long f_tot, float* flat_vals, int* flat_ids) {
  switch (space) {
    case 0:
      return launch_flat_scan<0, W>(topk_mode, blocks, smem, st, table, n_seg, queries, d, p_tot,
                                    b_tot, probes, kp, k_tot, out_vals, out_ids, scratch, f_tot,
                                    flat_vals, flat_ids);
    case 1:
      return launch_flat_scan<1, W>(topk_mode, blocks, smem, st, table, n_seg, queries, d, p_tot,
                                    b_tot, probes, kp, k_tot, out_vals, out_ids, scratch, f_tot,
                                    flat_vals, flat_ids);
    case 2:
      return launch_flat_scan<2, W>(topk_mode, blocks, smem, st, table, n_seg, queries, d, p_tot,
                                    b_tot, probes, kp, k_tot, out_vals, out_ids, scratch, f_tot,
                                    flat_vals, flat_ids);
    default:
      return cudaErrorInvalidValue;
  }
}

#ifdef QUANT_PHASES
__global__ void ivf_empty_probe_kernel() { let_dependents_start(); }
__global__ void ivf_empty_scan_kernel() { wait_for_inputs(); }
#endif

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// Rows a scan block takes: K6's (pq = 0) or, in a call whose largest m
// is m_max, K7's.  The wrapper sizes the launch table's chunks with it.
int ivf_scan_chunk(int pq, int m_max) { return pq ? pq_chunk(m_max) : kChunkRows; }

// Shared memory of each kernel (the wrapper checks them against the
// card's limit): the probe for width d and the call's largest nlist;
// K6's scan for width d; K7's table pass for width d and the call's
// smallest m; K7's scan for the call's largest m.
long long ivf_probe_smem(int d, int nlist_max) {
  const int per = (nlist_max + kProbeBlocks - 1) / kProbeBlocks;
  return round16(8ll * d) + 8ll * per * (2 + kProbeBlocks);
}
long long ivf_scan_smem(int d) { return ScanLayout(d).total; }
int ivfpq_lut_cb_floats(int d, int m_min) {
  const int need = kCodewords * (d / m_min);
  return need <= kCbSmemFloats ? need : 0;
}
long long ivfpq_lut_smem(int d, int cb_floats) { return 4ll * (cb_floats + max(kResFloats, d)); }
long long ivfpq_scan_smem(int m_max) { return PqLayout(m_max).total; }

// One K6 (pq = 0) or K7 (pq = 1) call on `stream`: the probe kernel over
// n_queries x n_seg clusters of kProbeBlocks blocks, (K7) the table pass
// over n_queries x n_seg x m_max x ceil(nprobe_max / 8) blocks, then the
// scan over n_queries x b_tot blocks.  table: n_seg entries of
// IVF_SEG_WORDS int64 (words above; wChunks from `ivf_scan_chunk`), then
// n_queries x n_seg pairs of int32 counters, zero.  queries f32
// [n_queries, d]; probes i32 [n_queries, p_tot] and (K7) lut f32
// [n_queries * p_tot, m_max, 256]: scratch between the kernels.
// cb_floats: K7's codebook room (`ivfpq_lut_cb_floats`).  topk = 1: each
// segment's top k into out_vals / out_ids [n_queries, k_tot] (scratch:
// n_queries * b_tot * kp keys; kp a power of two <= IVF_K_MAX); topk =
// 0: every probed slot into flat_vals / flat_ids [n_queries, f_tot],
// which the caller filled with (-inf, -1).  space: 0 l2, 1 cosinesimil,
// 2 innerproduct (K6; K7 is l2).  Returns 0, or the CUDA error of the
// first launch refused plus 1000 x its kernel (1 probe, 2 table pass, 3
// scan; an argument out of range: the bare error); faults surface at the
// caller's next sync.
int ivf_search_launch(const long long* table, int n_seg, int n_queries, const float* queries,
                      int d, int p_tot, int b_tot, int nlist_max, int nprobe_max, int m_max, int pq,
                      int space, int topk_mode, int kp, int k_tot, int cb_floats, int* probes,
                      float* lut, float* out_vals, int* out_ids, u64* scratch, long long f_tot,
                      float* flat_vals, int* flat_ids, void* stream) {
  if (n_seg <= 0 || n_queries <= 0) return 0;
  if (d <= 0 || d > kDMax || p_tot <= 0 || b_tot <= 0 || nlist_max <= 0 ||
      nlist_max > kNlistMax || nprobe_max <= 0 || nprobe_max > nlist_max ||
      (pq && (m_max <= 0 || m_max > kMMax)) || (!pq && (space < 0 || space > 2)) ||
      (topk_mode && (kp < 1 || kp > kKMax || (kp & (kp - 1)))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool w4 = (d & 3) == 0;
  const int pairs = n_queries * n_seg;
  const size_t probe_smem = (size_t)ivf_probe_smem(d, nlist_max);
  cudaError_t err =
      w4 ? launch(ivf_probe_kernel<4>, pairs * kProbeBlocks, kProbeThreads, probe_smem, st, true,
                  false, table, n_seg, queries, d, p_tot, probes)
         : launch(ivf_probe_kernel<1>, pairs * kProbeBlocks, kProbeThreads, probe_smem, st, true,
                  false, table, n_seg, queries, d, p_tot, probes);
  if (err != cudaSuccess) return static_cast<int>(err) + 1000;
  const int blocks = n_queries * b_tot;
  const bool tk = topk_mode != 0;
  if (pq) {
    const int n_groups = (nprobe_max + kResBatch - 1) / kResBatch;
    err = launch(ivfpq_lut_kernel, pairs * m_max * n_groups, kThreads,
                 (size_t)ivfpq_lut_smem(d, cb_floats), st, false, true, table, n_seg, queries, d,
                 p_tot, m_max, n_groups, cb_floats, (const int*)probes, lut);
    if (err != cudaSuccess) return static_cast<int>(err) + 2000;
    auto kernel = tk ? ivfpq_scan_kernel<true> : ivfpq_scan_kernel<false>;
    err = launch(kernel, blocks, kThreads, (size_t)ivfpq_scan_smem(m_max), st, false, true, table,
                 n_seg, p_tot, b_tot, (const int*)probes, (const float*)lut, m_max, kp, k_tot,
                 out_vals, out_ids, scratch, f_tot, flat_vals, flat_ids);
  } else {
    const size_t smem = (size_t)ivf_scan_smem(d);
    err = w4 ? launch_flat_space<4>(space, tk, blocks, smem, st, table, n_seg, queries, d, p_tot,
                                    b_tot, probes, kp, k_tot, out_vals, out_ids, scratch, f_tot,
                                    flat_vals, flat_ids)
             : launch_flat_space<1>(space, tk, blocks, smem, st, table, n_seg, queries, d, p_tot,
                                    b_tot, probes, kp, k_tot, out_vals, out_ids, scratch, f_tot,
                                    flat_vals, flat_ids);
  }
  return err == cudaSuccess ? 0 : static_cast<int>(err) + 3000;
}

#ifdef QUANT_PHASES
// The floor two launches set: an empty kernel on `pairs` clusters of
// kProbeBlocks blocks, then one on scan_blocks blocks (a programmatic
// dependent launch when kPdl), as ivf_search_launch launches them.
int ivf_empty_pair(int pairs, int scan_blocks, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      launch(ivf_empty_probe_kernel, pairs * kProbeBlocks, kProbeThreads, 0, st, true, false);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch(ivf_empty_scan_kernel, scan_blocks, kThreads, 0, st, false, true));
}
#endif

}  // extern "C"
