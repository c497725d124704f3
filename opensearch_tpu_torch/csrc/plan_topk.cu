// The plan top-k on Hopper: `run_topk` / `topk_from_scores` of every
// segment of a request in one launch.
//
// Replaces the JAX package's `run_topk` and `topk_from_scores`
// (opensearch_tpu/search/plan.py:1760, :1773) after a plan's dense
// evaluation, for every plan that is not a scored term bag at the root
// (those have the top-k inside K2, K3 and K4): `bool`, `constant_score`,
// the filters, `knn`'s injected winners, `hybrid`'s sub-queries,
// `script_score`, and the hits of an aggregations request.  Per segment:
// matched = matched & live & (scores >= min_score); the top k of the
// matched docs by score, the lower doc id first on ties (`lax.top_k`'s
// lower index first); the matched total; the largest matched score, -inf
// when nothing matched.  The port's plain version is a stable descending
// sort of each segment's [n_pad] keys (ops/bm25.py plan_topk_segments).
//
// Design: one launch over a table of segments, built on the host and
// sent by one pinned copy.  Block b owns the (segment, tile) of work word
// b, kTile docs: each thread reads kPer docs' score, matched byte and live
// byte (coalesced: doc tid + i * kThreads), makes each matched doc the key
// of topk.cuh (orderable score, then the lower doc id; 0 when unmatched),
// and the block keeps its best kp (`select_top`).  The total is an integer
// atomicAdd per segment (exact in any order).  The last tile of a segment
// to finish merges every tile's kp keys (`finish_segment`) and writes the
// segment's row: k (score, doc id) pairs, (-inf, -1) past the matched docs,
// the total, and the max, which is the first kept doc's score (the
// largest key).  The key folds -0.0 into +0.0, as a sort compares them
// equal; every score written (the max included) is read back from the
// doc's own score, so a -0.0 stays -0.0 as the sort returns it.
//
// Bound on the card: memory.  Per doc a 4-byte score, a matched byte and a
// live byte are read once; a segment writes 8k + 8 bytes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

// The wrapper (ops/cuda_plan.py) owns the table's layout and the tile
// decision and passes them in with -D.
#if !defined(PLAN_TILE_DOCS) || !defined(PLAN_K_MAX) || !defined(PLAN_SEG_WORDS)
#error "build through ops/cuda_plan.py, which defines PLAN_TILE_DOCS, PLAN_K_MAX, PLAN_SEG_WORDS"
#endif

using topk::u64;

constexpr int kThreads = 256;
constexpr int kTile = PLAN_TILE_DOCS;
constexpr int kKMax = PLAN_K_MAX;
constexpr int kPer = kTile / kThreads;  // docs of the tile each thread keys
// keys the merge reads per round; the key buffer holds the kp kept so far
// plus one round
constexpr int kMergeBatch = kTile / 2;
static_assert((kTile & (kTile - 1)) == 0 && kTile % kThreads == 0 && kTile * 8 <= 48 * 1024,
              "kTile: a power of two, a multiple of kThreads, its keys in static shared memory");
static_assert((kKMax & (kKMax - 1)) == 0 && kKMax <= kTile - kMergeBatch,
              "kKMax: a power of two the merge buffer holds beside one round");
static_assert(PLAN_SEG_WORDS >= 7, "a segment's table entry holds 7 words");

// table (int64 words): n_seg entries of PLAN_SEG_WORDS {scores, matched,
// live (0: every doc live), n_pad, first tile, tiles, output row}; then
// the work list (one word per block: segment << 32 | tile); then 2 * n_seg
// int32, zero on entry: the tile counters and the totals of the segments.
__global__ void __launch_bounds__(kThreads)
plan_topk_kernel(const long long* __restrict__ table, int n_seg, int k, int kp, float min_score,
                 float* __restrict__ out_vals, int* __restrict__ out_ids,
                 int* __restrict__ out_totals, float* __restrict__ out_maxes,
                 u64* __restrict__ scratch) {
  __shared__ __align__(16) u64 keys[kTile];
  const long long* work = table + (long long)n_seg * PLAN_SEG_WORDS;
  int* counters = reinterpret_cast<int*>(const_cast<long long*>(work + gridDim.x));
  const long long wk = work[blockIdx.x];
  const int seg = (int)(wk >> 32);
  const int tile = (int)(wk & 0xFFFFFFFFll);
  const long long* e = table + (long long)seg * PLAN_SEG_WORDS;
  const float* scores = reinterpret_cast<const float*>(e[0]);
  const uint8_t* matched = reinterpret_cast<const uint8_t*>(e[1]);
  const uint8_t* live = reinterpret_cast<const uint8_t*>(e[2]);
  const int n_pad = (int)e[3];
  const long long first = e[4];
  const int n_tiles = (int)e[5];
  const long long out_row = e[6];
  int* total = counters + n_seg + seg;
  const int tid = threadIdx.x, lane = tid & 31;
  const int doc0 = tile * kTile;
  const int docs = min(kTile, n_pad - doc0);

  float sc[kPer];
  bool hit[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {  // every load in flight before any compare
    const int d = tid + i * kThreads;
    const bool in = d < docs;
    sc[i] = in ? __ldg(scores + doc0 + d) : 0.0f;
    hit[i] = in && __ldg(matched + doc0 + d) != 0 &&
             (live == nullptr || __ldg(live + doc0 + d) != 0);
  }
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = tid + i * kThreads;
    const bool h = hit[i] && sc[i] >= min_score;
    cnt += h;
    keys[d] = h ? topk::make_key(sc[i], doc0 + d) : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  if (lane == 0 && cnt > 0) atomicAdd(total, cnt);
  __syncthreads();
  topk::select_top<kThreads, kTile>(keys, kp);
  if (!topk::finish_segment<kThreads, kTile, kMergeBatch>(keys, kp, scratch, first, tile, n_tiles,
                                                         counters + seg))
    return;
  float* vals = out_vals + out_row * k;
  int* ids = out_ids + out_row * k;
  for (int i = tid; i < k; i += kThreads) {
    const u64 key = keys[i];
    const int id = key == 0 ? -1 : topk::key_id(key);
    vals[i] = key == 0 ? -INFINITY : __ldg(scores + id);
    ids[i] = id;
  }
  if (tid == 0) {  // every tile's atomics are in: read them coherently
    out_totals[out_row] = atomicAdd(total, 0);
    out_maxes[out_row] = keys[0] == 0 ? -INFINITY : __ldg(scores + topk::key_id(keys[0]));
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// Top-k, matched total and max of every segment of `table` (device memory,
// layout above, n_blocks words in its work list) into rows of
// out_vals/out_ids [*, k] and out_totals/out_maxes [*]; scratch holds
// n_blocks * kp keys.  min_score is -inf when unset.  Returns the CUDA
// error of the launch (0 on success); faults surface at the caller's next
// sync.
int plan_topk_launch(const long long* table, int n_seg, int n_blocks, int k, int kp,
                     float min_score, float* out_vals, int* out_ids, int* out_totals,
                     float* out_maxes, u64* scratch, void* stream) {
  if (n_blocks <= 0) return 0;
  if (k < 1 || k > kp || kp > kKMax || (kp & (kp - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  plan_topk_kernel<<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n_seg, k, kp, min_score, out_vals, out_ids, out_totals, out_maxes, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
