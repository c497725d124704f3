// K1: exact k-NN on Hopper -- scores, and each segment's exact top-k.
//
// Replaces the JAX package's Pallas kernel `knn_scores_pallas`
// (opensearch_tpu/ops/pallas_knn.py:62, bodies `_score_kernel_l2`,
// `_score_kernel_cosine`, `_score_kernel_ip`) together with the
// `lax.top_k` that follows it (opensearch_tpu/ops/knn.py:53,72): the
// score of every row of vectors[n, d] (float32) against query[d],
// translated per space
//   l2:           1 / (1 + max(|v|^2 - 2 v.q + |q|^2, 0))
//   cosinesimil:  (1 + cos) / 2, norm product floored at 1e-30
//   innerproduct: v.q >= 0 ? v.q + 1 : 1 / (1 - v.q)
// and -inf on rows that are not valid (exists & live & mask, read here).
//
// Two entries share one streaming core:
//   knn_topk_segments_launch  one launch per query over every segment of
//                             a shard; returns each segment's exact top-k
//                             (score descending, lower row id first).
//   knn_scores_launch         the scores of one segment, written out.
//
// Bound on the card: memory.  Each row is d*4 bytes read once and 4*d
// flops: at d = 128 that is 1 flop per byte, far below the H100's ~20
// fp32 flops per byte of HBM.  16 segments of 65,536 x 128 are 537 MB,
// about 0.16 ms at 3.35 TB/s.
//
// Design for that bound:
// - A block scores one chunk of kChunkRows rows of one segment (2 MiB at
//   d = 128, so the 16 segments of 65,536 rows are one wave of two
//   blocks per SM; kScoreRows for the scores-only entry, whose single
//   segment needs more, smaller blocks to fill the card).  The top-k launch takes a flat work list of (segment,
//   chunk) pairs and a per-segment table of pointers, both in one small
//   buffer the host copies per query.
// - Rows stream through a ring of `stages` shared-memory tiles filled by
//   16-byte cp.async (4-byte where a segment's base is not 16-byte
//   aligned), so several tiles are in flight while warps reduce the
//   current one.  A group of L lanes reduces one row (L = 8 at d = 128,
//   so a warp takes four rows at once and a tile of 32 rows is one pass
//   of the block): lane j of the group sums the float4s j, j + L, ... of
//   the row with explicit fmaf, then a fixed xor-shuffle tree.  The
//   order depends on d alone, so two identical rows score identically
//   wherever they lie.
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
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

// The wrapper (ops/cuda_knn.py) owns the launch table's layout and the
// chunk decision and passes them in with -D: rows per block of the top-k
// entry, the largest k it selects, int64 words per segment in the table.
#if !defined(KNN_CHUNK_ROWS) || !defined(KNN_K_MAX) || !defined(KNN_SEG_WORDS)
#error "build through ops/cuda_knn.py, which defines KNN_CHUNK_ROWS, KNN_K_MAX, KNN_SEG_WORDS"
#endif

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkRows = KNN_CHUNK_ROWS;
constexpr int kScoreRows = 512;      // rows per block of the scores-only entry
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int SPACE>
__device__ __forceinline__ float translate(float dot, float v2, float q2) {
  if (SPACE == 0) {  // l2
    float d2 = fmaxf(v2 - 2.0f * dot + q2, 0.0f);
    return 1.0f / (1.0f + d2);
  } else if (SPACE == 1) {  // cosinesimil
    float cosv = dot / fmaxf(sqrtf(v2) * sqrtf(q2), 1e-30f);
    return (1.0f + cosv) / 2.0f;
  } else {  // innerproduct
    return dot >= 0.0f ? dot + 1.0f : 1.0f / (1.0f - dot);
  }
}

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
// layout: query | ring of `stages` tiles | out[CAP] (8 B each) |
// valid[CAP].
template <int SPACE, bool TOPK, int CAP>
__device__ void stream_chunk(const Seg& s, long long row0, int rows,
                             const float* __restrict__ query, int d,
                             const Cfg& c, char* smem) {
  float* q_s = reinterpret_cast<float*>(smem);
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
  for (int i = tid; i < d; i += kThreads) q_s[i] = query[i];
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
  float q2 = 0.0f;
  for (int j = lane; j < d; j += 32) q2 = fmaf(q_s[j], q_s[j], q2);
  q2 = warp_sum(q2);

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
      float dot = 0.0f, v2 = 0.0f;
      if (has_row && vec4) {
        const float4* v4 = reinterpret_cast<const float4*>(v);
        const float4* q4 = reinterpret_cast<const float4*>(q_s);
        for (int j = sub; j < (d >> 2); j += L) {
          const float4 a = v4[j], b = q4[j];
          dot = fmaf(a.x, b.x, dot); v2 = fmaf(a.x, a.x, v2);
          dot = fmaf(a.y, b.y, dot); v2 = fmaf(a.y, a.y, v2);
          dot = fmaf(a.z, b.z, dot); v2 = fmaf(a.z, a.z, v2);
          dot = fmaf(a.w, b.w, dot); v2 = fmaf(a.w, a.w, v2);
        }
      } else if (has_row) {
        for (int j = sub; j < d; j += L) {
          const float a = v[j];
          dot = fmaf(a, q_s[j], dot);
          v2 = fmaf(a, a, v2);
        }
      }
      for (int off = L >> 1; off > 0; off >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
        v2 += __shfl_xor_sync(0xffffffffu, v2, off);
      }
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

template <int SPACE>
__global__ void __launch_bounds__(kThreads)
knn_scores_kernel(Seg s, const float* __restrict__ query, float* __restrict__ out,
                  int d, Cfg c) {
  extern __shared__ __align__(16) char smem[];
  const long long row0 = (long long)blockIdx.x * kScoreRows;
  const int rows = (int)min((long long)kScoreRows, s.n - row0);
  stream_chunk<SPACE, false, kScoreRows>(s, row0, rows, query, d, c, smem);
  const float* sc = reinterpret_cast<const float*>(smem + c.q_bytes + c.stages * c.stage_bytes);
  for (int r = threadIdx.x; r < rows; r += kThreads) out[row0 + r] = sc[r];
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

// Lanes per row (each lane about four float4s of it), tile rows (one
// pass of all warps, at most about kStageBytes) and ring depth
// (2..kMaxStages, as many as fit) for width d and `cap` rows per block.
// False when two stages of one row do not fit.
bool config(int d, int cap, Cfg* c) {
  const int units = (d & 3) == 0 ? d / 4 : d;
  int lanes = 1;
  while (lanes < 32 && lanes * 4 < units) lanes *= 2;
  c->lanes = lanes;
  const int pass = (32 / lanes) * kWarps;
  const int fit = kStageBytes / (4 * d);
  int t = 1;
  while (t * 2 <= pass && t * 2 <= fit) t *= 2;
  c->tile_rows = t;
  c->q_bytes = round16(4 * d);
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

template <int SPACE>
cudaError_t launch_scores(const Seg& s, const float* query, float* out, int d, const Cfg& c,
                          cudaStream_t stream) {
  cudaError_t err = allow_smem(knn_scores_kernel<SPACE>, c.smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (s.n + kScoreRows - 1) / kScoreRows;
  knn_scores_kernel<SPACE><<<(unsigned)blocks, kThreads, c.smem, stream>>>(s, query, out, d, c);
  return cudaGetLastError();
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

// Scores of one segment.  space: 0 = l2, 1 = cosinesimil, 2 =
// innerproduct; `live` and `mask` may be null.  Returns the CUDA error of
// the launch (0 on success); faults surface at the caller's next sync.
int knn_scores_launch(const float* vectors, const uint8_t* exists, const uint8_t* live,
                      const uint8_t* mask, const float* query, float* out, long long n,
                      int d, int space, void* stream) {
  if (n <= 0) return 0;
  Cfg c;
  if (d <= 0 || !config(d, kScoreRows, &c)) return static_cast<int>(cudaErrorInvalidValue);
  const Seg s{vectors, exists, live, mask, n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (space) {
    case 0: return launch_scores<0>(s, query, out, d, c, st);
    case 1: return launch_scores<1>(s, query, out, d, c, st);
    case 2: return launch_scores<2>(s, query, out, d, c, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
