// K1: exact k-NN on Hopper -- per-row scores, and each segment's exact
// top-k.
//
// Replaces the JAX package's Pallas kernel `knn_scores_pallas`
// (opensearch_tpu/ops/pallas_knn.py:62, bodies `_score_kernel_l2`,
// `_score_kernel_cosine`, `_score_kernel_ip`) together with the
// `lax.top_k` that follows it (opensearch_tpu/ops/knn.py:53,72), and
// the `vec @ q` and row norms of score scripts' vector functions
// (opensearch_tpu/search/scripting.py:267-282, which XLA computes in the
// JAX package): a function of every row of vectors[n, d] (float32)
// against query[d], one of six (`fn`, ops/knn.py FUNCTIONS):
//   0 l2:               1 / (1 + max(|v|^2 - 2 v.q + |q|^2, 0))
//   1 cosinesimil:      (1 + cos) / 2, norm product floored at 1e-30
//   2 innerproduct:     v.q >= 0 ? v.q + 1 : 1 / (1 - v.q)
//   3 dotProduct:       v.q
//   4 l2Squared:        max(|v|^2 - 2 v.q + |q|^2, 0)
//   5 cosineSimilarity: v.q / max(|v| |q|, 1e-30)
// and -inf on rows that are not valid (exists & live & mask, read here;
// a null pointer reads as all true).
//
// Two entries:
//   knn_topk_segments_launch   one launch per query over every segment
//                              of a shard; returns each segment's exact
//                              top-k (score descending, lower row id
//                              first).  Functions 0-2.
//   knn_scores_segments_launch one launch over a table of segments; the
//                              scores of every row, written out.  All six
//                              functions (the sorted route of the k-NN
//                              top-k; script_score's vector functions).
//
// Bound on the card: memory.  Each row is d*4 bytes read once and 4*d
// fp64 flops: at d = 128 that is 1 flop per byte, far below the H100's
// ~10 fp64 flops per byte of HBM.  16 segments of 65,536 x 128 are 537
// MB, about 0.16 ms at 3.35 TB/s.
//
// Precision: v.q, |v|^2 and |q|^2 are summed in float64 (each product of
// two floats is exact there) in an order fixed by d alone (`row_sums`:
// lane j of a row's L lanes adds the units j, j + L, ... in turn, then a
// fixed xor-shuffle tree; |q|^2 over the 32 lanes of a warp), the same
// in both entries, and the result is rounded to float32 once.  The plain
// version (ops/knn.py `vector_scores`) sums in this very order, so the
// card and the CPU give the same bytes; a hybrid query's min_max
// normalization, which divides by the spread of its top scores, would
// otherwise magnify float32 sums' order-dependent last bits.
//
// Design of the top-k entry:
// - A block scores one chunk of kChunkRows rows of one segment (2 MiB at
//   d = 128, so the 16 segments of 65,536 rows are one wave of two
//   blocks per SM).  The launch takes a flat work list of (segment,
//   chunk) pairs and a per-segment table of pointers, both in one small
//   buffer the host copies per query.
// - Rows stream through a ring of `stages` shared-memory tiles filled by
//   16-byte cp.async (4-byte where a segment's base is not 16-byte
//   aligned), so several tiles are in flight while warps reduce the
//   current one.  A group of L lanes reduces one row (L = 8 at d = 128,
//   so a warp takes four rows at once and a tile of 32 rows is one pass
//   of the block).
// - |q|^2 is summed by every warp from the query in shared memory (one
//   order, so every block gets the same value); validity bytes of the
//   chunk are read into shared memory while the first tiles load.
// - Top-k: every row becomes the 64-bit key
//   (orderable(score) << 32) | (0xFFFFFFFF - row) of topk.cuh, so a
//   larger key is a higher score, then a lower row; -inf sits below every
//   finite score and key 0 marks "no row".  The chunk's best kp keys (k rounded up to
//   a power of two) are selected in shared memory (`select_top`: a
//   threshold from warp shuffles, then a bitonic sort of the few keys
//   above it) and go to a scratch buffer.  The last chunk of a segment to
//   finish (atomicAdd on a per-segment counter after __threadfence)
//   merges the segment's candidates in the same launch (`merge_segment`:
//   only keys at or above the kp-th kept so far enter its buffer): no
//   second launch, and the merge of one segment overlaps the streaming
//   of the others.  Exact, since every member of a segment's top-k is
//   among its chunk's top-k.
// - No intermediate score reaches device memory on the top-k path.
//
// Design of the scores entry (redesigned: it was one launch per segment
// of 512-row blocks staging tiles through the ring above, 128 blocks for
// a 65,536-row segment, one per SM, at 47% of the bound):
// - One launch takes the head of the top-k entry's table layout in
//   device memory (word 7 is the segment's first element of the flat
//   output; no work list: a block finds its segment by a binary search of
//   the first blocks), so a request's segments are one grid of (segment,
//   chunk) blocks.  The wrapper sizes the chunk from the table's rows and
//   the card's SM count (at least two waves of kScoreMinBlocks resident
//   blocks per SM; ops/cuda_knn.py `score_chunk_rows`), as a whole number
//   of passes of the block.
// - No shared-memory ring: each lane loads its units of its row straight
//   from device memory into registers (float4 loads, or four floats where
//   the segment's base is not 16-byte aligned), four units at once, and
//   the first batch of the next row is issued before the current row's
//   shuffles, translation and store.  With four blocks of 256 threads
//   resident per SM, some 64 KB per SM are in flight.  The query sits in
//   shared memory as float64 (8d bytes), loaded after the first rows'
//   loads are issued.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rows.cuh"
#include "topk.cuh"

namespace {

// The wrapper (ops/cuda_knn.py) owns the launch table's layout and the
// chunk decisions and passes them in with -D: rows per block of the top-k
// entry, the largest k it selects, int64 words per segment in the table,
// and the scores entry's resident blocks per SM that its chunks assume.
#if !defined(KNN_CHUNK_ROWS) || !defined(KNN_K_MAX) || !defined(KNN_SEG_WORDS) || \
    !defined(KNN_SCORE_MIN_BLOCKS)
#error "build through ops/cuda_knn.py, which defines KNN_CHUNK_ROWS, KNN_K_MAX, KNN_SEG_WORDS, KNN_SCORE_MIN_BLOCKS"
#endif

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkRows = KNN_CHUNK_ROWS;
constexpr int kScoreThreads = 256;   // threads of a scores-entry block
constexpr int kScoreMinBlocks = KNN_SCORE_MIN_BLOCKS;  // ... resident per SM
constexpr int kScoreBatch = 4;       // units a lane loads at once
constexpr int kStageBytes = 16384;   // target bytes of one ring stage
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448 - 256;  // a block's shared memory on sm_90, less the static part
constexpr int kKMax = KNN_K_MAX;
constexpr int kSegWords = KNN_SEG_WORDS;
// keys the merge reads per round; the merge buffer (kChunkRows keys)
// holds the kp kept so far plus one round
constexpr int kMergeBatch = kChunkRows / 2;
static_assert((kChunkRows & (kChunkRows - 1)) == 0 && kChunkRows % kThreads == 0,
              "kChunkRows: a power of two, a multiple of kThreads");
static_assert((kKMax & (kKMax - 1)) == 0 && kKMax <= kChunkRows - kMergeBatch,
              "kKMax: a power of two the merge buffer holds beside one round");
static_assert(kSegWords >= 8, "a segment's table entry holds 8 words");

using rowsum::group_sum;
using rowsum::query_norm2;
using rowsum::row_lanes;
using rowsum::translate;
using topk::u64;

struct Seg {
  const float* vec;
  const uint8_t* exists;
  const uint8_t* live;   // may be null
  const uint8_t* mask;   // may be null
  long long n;
};

struct Cfg {
  int lanes;       // lanes that reduce one row (power of two, <= 32)
  int tile_rows;
  int stages;
  int stage_bytes;
  int q_bytes;
  size_t smem;
};

__host__ __device__ __forceinline__ int round16(int b) { return (b + 15) & ~15; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most stages - 1 groups are pending: the oldest tile landed.
__device__ __forceinline__ void cp_async_wait_oldest(int stages) {
  if (stages >= 4) asm volatile("cp.async.wait_group 3;\n" ::);
  else if (stages == 3) asm volatile("cp.async.wait_group 2;\n" ::);
  else asm volatile("cp.async.wait_group 1;\n" ::);
}

// The streaming core: scores rows [row0, row0 + rows) of `s` (rows <=
// CAP) into shared memory -- as 64-bit keys (TOPK) or as floats -- with
// -inf on invalid rows.  Ends with all threads synchronised.  Shared
// layout: query (float64) | ring of `stages` tiles | out[CAP] (8 B each) |
// valid[CAP].
template <int SPACE, bool TOPK, int CAP>
__device__ void stream_chunk(const Seg& s, long long row0, int rows,
                             const float* __restrict__ query, int d,
                             const Cfg& c, char* smem) {
  double* q_s = reinterpret_cast<double*>(smem);
  char* ring = smem + c.q_bytes;
  char* out_s = ring + c.stages * c.stage_bytes;
  uint8_t* valid_s = reinterpret_cast<uint8_t*>(out_s + CAP * 8);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int T = c.tile_rows;
  const int ntiles = (rows + T - 1) / T;
  const bool vec4 = (d & 3) == 0;
  const bool copy16 = vec4 && (reinterpret_cast<uintptr_t>(s.vec) & 15) == 0;

  auto load_tile = [&](int tile) {
    char* dst = ring + (tile % c.stages) * c.stage_bytes;
    const int trows = min(T, rows - tile * T);
    const float* src = s.vec + (row0 + (long long)tile * T) * d;
    if (copy16) {
      const int nv = trows * d / 4;
      for (int i = tid; i < nv; i += kThreads) cp_async16(dst + 16 * i, src + 4 * i);
    } else {
      const int ne = trows * d;
      for (int i = tid; i < ne; i += kThreads) cp_async4(dst + 4 * i, src + i);
    }
  };

  for (int st = 0; st < c.stages - 1; ++st) {
    if (st < ntiles) load_tile(st);
    cp_async_commit();
  }
  // while the first tiles load: the query and the chunk's validity (all
  // loads started before any is used)
  for (int i = tid; i < d; i += kThreads) q_s[i] = (double)query[i];
  constexpr int kPer = CAP / kThreads;
  uint8_t e[kPer], l[kPer], m[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = tid + i * kThreads;
    const long long g = row0 + (r < rows ? r : 0);
    const bool in = r < rows;
    e[i] = in ? s.exists[g] : 0;
    l[i] = (in && s.live != nullptr) ? s.live[g] : 1;
    m[i] = (in && s.mask != nullptr) ? s.mask[g] : 1;
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i) valid_s[tid + i * kThreads] = e[i] & l[i] & m[i];
  __syncthreads();
  const double q2 = query_norm2(q_s, d, lane);

  // c.lanes lanes reduce one row; a warp takes 32 / c.lanes rows at once
  const int L = c.lanes;
  const int per_warp = 32 / L;
  const int sub = lane & (L - 1), grp = lane / L;
  for (int t = 0; t < ntiles; ++t) {
    if (t + c.stages - 1 < ntiles) load_tile(t + c.stages - 1);
    cp_async_commit();
    cp_async_wait_oldest(c.stages);
    __syncthreads();
    const float* tile = reinterpret_cast<const float*>(ring + (t % c.stages) * c.stage_bytes);
    const int trows = min(T, rows - t * T);
    for (int base = warp * per_warp; base < trows; base += kWarps * per_warp) {
      const int rr = base + grp;
      const bool has_row = rr < trows;
      const float* v = tile + rr * d;
      double dot = 0.0, v2 = 0.0;
      if (has_row && vec4) {
        const float4* v4 = reinterpret_cast<const float4*>(v);
        const double2* q2v = reinterpret_cast<const double2*>(q_s);
        for (int j = sub; j < (d >> 2); j += L) {
          const float4 a = v4[j];
          const double2 b0 = q2v[2 * j], b1 = q2v[2 * j + 1];
          const double ax = a.x, ay = a.y, az = a.z, aw = a.w;
          dot = fma(ax, b0.x, dot); v2 = fma(ax, ax, v2);
          dot = fma(ay, b0.y, dot); v2 = fma(ay, ay, v2);
          dot = fma(az, b1.x, dot); v2 = fma(az, az, v2);
          dot = fma(aw, b1.y, dot); v2 = fma(aw, aw, v2);
        }
      } else if (has_row) {
        for (int j = sub; j < d; j += L) {
          const double a = v[j];
          dot = fma(a, q_s[j], dot);
          v2 = fma(a, a, v2);
        }
      }
      group_sum(dot, v2, L);
      if (has_row && sub == 0) {
        const int r = t * T + rr;
        const float sc = valid_s[r] ? translate<SPACE>(dot, v2, q2) : -INFINITY;
        if (TOPK) reinterpret_cast<u64*>(out_s)[r] = topk::make_key(sc, row0 + r);
        else reinterpret_cast<float*>(out_s)[r] = sc;
      }
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_all;\n" ::);
}

// A unit of a row: a float4 (W = 4; loaded as one 16-byte load when
// ALIGNED, else as four floats) or one float (W = 1).
template <int W, bool ALIGNED>
__device__ __forceinline__ float4 load_unit(const float* __restrict__ row, int j) {
  if (W == 1) return make_float4(__ldg(row + j), 0.f, 0.f, 0.f);
  if (ALIGNED) return __ldg(reinterpret_cast<const float4*>(row) + j);
  const float* p = row + 4 * j;
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// Units j0, j0 + L, ... (kScoreBatch of them, those below `units`).
template <int W, bool ALIGNED>
__device__ __forceinline__ void load_batch(float4 (&a)[kScoreBatch], const float* row,
                                           int j0, int L, int units) {
#pragma unroll
  for (int u = 0; u < kScoreBatch; ++u) {
    const int j = j0 + u * L;
    if (j < units) a[u] = load_unit<W, ALIGNED>(row, j);
  }
}

// The scores entry: `head` is the launch table's head (kSegWords words a
// segment, word 5 = its first block, word 7 = its first output element).
// Block b takes the segment s whose blocks [first(s), first(s + 1)) hold
// b (a binary search of the head), rows
// [(b - first(s)) * chunk_rows, +chunk_rows) of it, and writes their
// scores to out[word 7 + row].  A group of L lanes takes one row a pass;
// every lane of the block runs every pass (the shuffles need whole
// warps).
template <int FN, int W, bool ALIGNED>
__global__ void __launch_bounds__(kScoreThreads, kScoreMinBlocks)
knn_scores_kernel(const long long* __restrict__ head, int n_seg, const float* __restrict__ query,
                  int d, int L,
                  int chunk_rows, float* __restrict__ out) {
  extern __shared__ __align__(16) double q_s[];
  const long long b = blockIdx.x;
  int seg = 0;
  for (int hi = n_seg - 1; seg < hi;) {
    const int mid = (seg + hi + 1) >> 1;
    if (head[mid * kSegWords + 5] <= b) seg = mid; else hi = mid - 1;
  }
  const long long* h = head + seg * kSegWords;
  const float* vec = reinterpret_cast<const float*>(h[0]);
  const uint8_t* exists = reinterpret_cast<const uint8_t*>(h[1]);
  const uint8_t* live = reinterpret_cast<const uint8_t*>(h[2]);
  const uint8_t* mask = reinterpret_cast<const uint8_t*>(h[3]);
  const long long row0 = (b - h[5]) * (long long)chunk_rows;
  const int rows = (int)max(0ll, min((long long)chunk_rows, h[4] - row0));
  float* dst = out + h[7] + row0;
  const int tid = threadIdx.x, lane = tid & 31;
  const int sub = tid & (L - 1), grp = tid / L, groups = kScoreThreads / L;
  const int units = d / W;
  const int passes = (rows + groups - 1) / groups;

  float4 a[kScoreBatch];
  // the first row's first batch is in flight while the query is staged
  if (grp < rows) load_batch<W, ALIGNED>(a, vec + (row0 + grp) * d, sub, L, units);
  for (int i = tid; i < d; i += kScoreThreads) q_s[i] = (double)query[i];
  __syncthreads();
  const double q2 = query_norm2(q_s, d, lane);

  for (int p = 0; p < passes; ++p) {
    const int r = p * groups + grp;
    const bool has_row = r < rows;
    const float* v = vec + (row0 + r) * d;
    double dot = 0.0, v2 = 0.0;
    if (has_row) {
      for (int j0 = sub; j0 < units; j0 += kScoreBatch * L) {
        if (j0 != sub) load_batch<W, ALIGNED>(a, v, j0, L, units);
#pragma unroll
        for (int u = 0; u < kScoreBatch; ++u) {
          const int j = j0 + u * L;
          if (j >= units) break;
          const double ax = a[u].x;
          dot = fma(ax, q_s[W * j], dot); v2 = fma(ax, ax, v2);
          if (W == 4) {
            const double ay = a[u].y, az = a[u].z, aw = a[u].w;
            dot = fma(ay, q_s[4 * j + 1], dot); v2 = fma(ay, ay, v2);
            dot = fma(az, q_s[4 * j + 2], dot); v2 = fma(az, az, v2);
            dot = fma(aw, q_s[4 * j + 3], dot); v2 = fma(aw, aw, v2);
          }
        }
      }
      // the next row's first batch flies over this row's tail
      if (r + groups < rows) load_batch<W, ALIGNED>(a, v + (long long)groups * d, sub, L, units);
    }
    group_sum(dot, v2, L);
    if (has_row && sub == 0) {
      const long long g = row0 + r;
      const bool ok = (exists == nullptr || exists[g]) && (live == nullptr || live[g]) &&
                      (mask == nullptr || mask[g]);
      dst[r] = ok ? translate<FN>(dot, v2, q2) : -INFINITY;
    }
  }
}

// table: n_seg entries of kSegWords int64 {vectors, exists, live, mask,
// n, first chunk, chunks, output row}, then the work list (one int64 per
// block: segment << 32 | chunk), then n_seg int32 counters, zero on
// entry.
template <int SPACE>
__global__ void __launch_bounds__(kThreads, 2)  // two blocks per SM, as shared memory allows
knn_topk_kernel(const long long* __restrict__ table, int n_seg,
                const float* __restrict__ query, int d, int k, int kp, Cfg c,
                float* __restrict__ out_vals, int* __restrict__ out_ids,
                u64* __restrict__ scratch) {
  extern __shared__ __align__(16) char smem[];
  const long long* work = table + (long long)n_seg * kSegWords;
  int* counters = reinterpret_cast<int*>(const_cast<long long*>(work + gridDim.x));
  const long long w = work[blockIdx.x];
  const int seg = (int)(w >> 32);
  const int chunk = (int)(w & 0xFFFFFFFFll);
  const long long* e = table + (long long)seg * kSegWords;
  const Seg s{reinterpret_cast<const float*>(e[0]), reinterpret_cast<const uint8_t*>(e[1]),
              reinterpret_cast<const uint8_t*>(e[2]), reinterpret_cast<const uint8_t*>(e[3]),
              e[4]};
  const long long first = e[5];
  const int n_chunks = (int)e[6];
  const long long out_row = e[7];
  const long long row0 = (long long)chunk * kChunkRows;
  const int rows = (int)max(0ll, min((long long)kChunkRows, s.n - row0));

  stream_chunk<SPACE, true, kChunkRows>(s, row0, rows, query, d, c, smem);
  u64* keys = reinterpret_cast<u64*>(smem + c.q_bytes + c.stages * c.stage_bytes);
  for (int r = rows + threadIdx.x; r < kChunkRows; r += kThreads) keys[r] = 0;
  __syncthreads();
  topk::select_top<kThreads, kChunkRows>(keys, kp);
  if (!topk::finish_segment<kThreads, kChunkRows, kMergeBatch>(keys, kp, scratch, first, chunk,
                                                              n_chunks, &counters[seg]))
    return;
  topk::write_topk<kThreads>(keys, k, out_vals + out_row * k, out_ids + out_row * k);
}

// Lanes per row, tile rows (one pass of all warps, at most about
// kStageBytes) and ring depth (2..kMaxStages, as many as fit) of the
// top-k entry for width d and `cap` rows per block.  False when two
// stages of one row do not fit.
bool config(int d, int cap, Cfg* c) {
  const int lanes = row_lanes(d);
  c->lanes = lanes;
  const int pass = (32 / lanes) * kWarps;
  const int fit = kStageBytes / (4 * d);
  int t = 1;
  while (t * 2 <= pass && t * 2 <= fit) t *= 2;
  c->tile_rows = t;
  c->q_bytes = round16(8 * d);
  c->stage_bytes = round16(4 * d * t);
  for (int stg = kMaxStages; stg >= 2; --stg) {
    const size_t smem = (size_t)c->q_bytes + (size_t)stg * c->stage_bytes + (size_t)cap * 9;
    if (smem <= (size_t)kSmemLimit) {
      c->stages = stg;
      c->smem = smem;
      return true;
    }
  }
  return false;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int FN, int W, bool ALIGNED>
cudaError_t launch_scores(const long long* head, int n_seg, int n_blocks, const float* query,
                          int d, int chunk_rows, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)round16(8 * d);
  cudaError_t err = allow_smem(knn_scores_kernel<FN, W, ALIGNED>, smem);
  if (err != cudaSuccess) return err;
  knn_scores_kernel<FN, W, ALIGNED><<<n_blocks, kScoreThreads, smem, stream>>>(
      head, n_seg, query, d, row_lanes(d), chunk_rows, out);
  return cudaGetLastError();
}

template <int FN>
cudaError_t launch_scores_fn(const long long* head, int n_seg, int n_blocks, const float* query, int d,
                             int chunk_rows, bool aligned, float* out, cudaStream_t st) {
  if ((d & 3) != 0)
    return launch_scores<FN, 1, false>(head, n_seg, n_blocks, query, d, chunk_rows, out, st);
  if (aligned)
    return launch_scores<FN, 4, true>(head, n_seg, n_blocks, query, d, chunk_rows, out, st);
  return launch_scores<FN, 4, false>(head, n_seg, n_blocks, query, d, chunk_rows, out, st);
}

cudaError_t launch_scores_any(int fn, const long long* head, int n_seg, int n_blocks,
                              const float* query, int d, int chunk_rows, bool al, float* out,
                              cudaStream_t st) {
  switch (fn) {
    case 0: return launch_scores_fn<0>(head, n_seg, n_blocks, query, d, chunk_rows, al, out, st);
    case 1: return launch_scores_fn<1>(head, n_seg, n_blocks, query, d, chunk_rows, al, out, st);
    case 2: return launch_scores_fn<2>(head, n_seg, n_blocks, query, d, chunk_rows, al, out, st);
    case 3: return launch_scores_fn<3>(head, n_seg, n_blocks, query, d, chunk_rows, al, out, st);
    case 4: return launch_scores_fn<4>(head, n_seg, n_blocks, query, d, chunk_rows, al, out, st);
    case 5: return launch_scores_fn<5>(head, n_seg, n_blocks, query, d, chunk_rows, al, out, st);
    default: return cudaErrorInvalidValue;
  }
}

template <int SPACE>
cudaError_t launch_topk(const long long* table, int n_seg, int n_chunks, const float* query,
                        int d, int k, int kp, const Cfg& c, float* out_vals, int* out_ids,
                        u64* scratch, cudaStream_t stream) {
  cudaError_t err = allow_smem(knn_topk_kernel<SPACE>, c.smem);
  if (err != cudaSuccess) return err;
  knn_topk_kernel<SPACE><<<n_chunks, kThreads, c.smem, stream>>>(
      table, n_seg, query, d, k, kp, c, out_vals, out_ids, scratch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// Largest d the kernels take (two ring stages of one row still fit).
int knn_d_max() {
  Cfg c;
  int lo = 1, hi = 1 << 16;
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (config(mid, kChunkRows, &c)) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Threads of a scores-entry block and lanes per row of width d (the
// wrapper sizes chunks as whole passes of a block).
int knn_scores_threads() { return kScoreThreads; }
int knn_row_lanes(int d) { return row_lanes(d); }

// Function `fn` (0-5, see the header) of every row of every segment of a
// launch table's head in device memory (the top-k entry's layout, without
// the work list; word 7 = the segment's first element of `out`).
// n_blocks = the segments' chunks in all, each block `chunk_rows` rows, a
// whole number of passes of kScoreThreads / knn_row_lanes(d) rows.
// `aligned`: every segment's base is 16-byte aligned.  Returns the CUDA
// error of the launch (0 on success); faults surface at the caller's next
// sync.
int knn_scores_segments_launch(const long long* head, int n_seg, int n_blocks,
                               const float* query, int d, int chunk_rows, int aligned, int fn,
                               float* out, void* stream) {
  if (n_blocks <= 0) return 0;
  Cfg c;
  if (d <= 0 || !config(d, kChunkRows, &c) || chunk_rows <= 0 ||
      chunk_rows % (kScoreThreads / row_lanes(d)) != 0 || n_seg <= 0 || head == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_scores_any(fn, head, n_seg, n_blocks, query, d, chunk_rows,
                                            aligned != 0, out, static_cast<cudaStream_t>(stream)));
}

// Exact top-k of every segment of `table` (device memory, layout above)
// into rows of out_vals/out_ids [*, k]; scratch holds n_chunks * kp keys.
int knn_topk_segments_launch(const long long* table, int n_seg, int n_chunks,
                             const float* query, int d, int k, int kp, int space,
                             float* out_vals, int* out_ids, u64* scratch, void* stream) {
  if (n_chunks <= 0) return 0;
  Cfg c;
  if (d <= 0 || !config(d, kChunkRows, &c) || k < 1 || k > kp || kp > kKMax || (kp & (kp - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (space) {
    case 0: return launch_topk<0>(table, n_seg, n_chunks, query, d, k, kp, c, out_vals, out_ids, scratch, st);
    case 1: return launch_topk<1>(table, n_seg, n_chunks, query, d, k, kp, c, out_vals, out_ids, scratch, st);
    case 2: return launch_topk<2>(table, n_seg, n_chunks, query, d, k, kp, c, out_vals, out_ids, scratch, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
