// Exact top-k selection in shared memory, shared by K1 (knn.cu) and K2
// (bm25.cu).
//
// A candidate is the 64-bit key (orderable(score) << 32) | (0xFFFFFFFF -
// id): a larger key is a higher score, then a lower id, which is the
// reference's tie-break (`lax.top_k`: equal scores -> lower index
// first).  -inf sits below every finite score, and key 0 marks "no
// candidate".  A block keeps its best kp keys (k rounded up to a power of
// two) with `select_top`; the last block of a segment merges every
// block's kp keys with `merge_segment`.  The templates take the block's
// thread count and the length of its key buffer in shared memory.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace topk {

typedef unsigned long long u64;

// Monotone map of float bits to uint32 (NaN is not ordered: the scores
// here are never NaN).  -0.0 is folded into +0.0 first, as a sort
// compares them equal.
__device__ __forceinline__ uint32_t orderable(float s) {
  uint32_t b = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float from_orderable(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

__device__ __forceinline__ u64 make_key(float s, long long id) {
  return ((u64)orderable(s) << 32) | (u64)(0xFFFFFFFFu - (uint32_t)id);
}

__device__ __forceinline__ float key_score(u64 key) {
  return from_orderable((uint32_t)(key >> 32));
}

__device__ __forceinline__ int key_id(u64 key) {
  return (int)(0xFFFFFFFFu - (uint32_t)(key & 0xFFFFFFFFull));
}

__device__ __forceinline__ int pow2_at_least(int n) {
  int p = 2;
  while (p < n) p <<= 1;
  return p;
}

// Bitonic sort of s[0, n) descending, n a power of two; all threads call.
template <int kThreads>
__device__ void bitonic_desc(u64* s, int n) {
  for (int size = 2; size <= n; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (n >> 1); i += kThreads) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const u64 a = s[lo], b = s[hi];
        const bool desc = (lo & size) == 0;
        if ((a < b) == desc) { s[lo] = b; s[hi] = a; }
      }
      __syncthreads();
    }
  }
}

// Leaves the kp largest of keys[0, kBuf) in keys[0, kp), sorted
// descending (the rest of keys is scratch after).  A threshold that at
// least kp keys reach -- the least, over the warps, of each warp's j-th
// largest thread maximum, j = ceil(kp / warps) -- keeps a few
// candidates, which are compacted and bitonic-sorted: a handful of
// barriers instead of a sort of the whole buffer.  The threshold is at
// least 1: key 0 ("no candidate") never enters the sort, so a warp
// holding no keys (a short block, a sparse merge buffer) cannot pull it
// to 0 and send the whole buffer through the sort; fewer than kp keys
// are padded with 0.  All threads call; enters and leaves synchronised.
template <int kThreads, int kBuf>
__device__ void select_top(u64* keys, int kp) {
  constexpr int kWarps = kThreads / 32;
  constexpr int kPer = kBuf / kThreads;
  static_assert(kBuf % kThreads == 0 && kThreads % 32 == 0, "whole warps, whole rows");
  __shared__ u64 warp_thr[kWarps];
  __shared__ int warp_cnt[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  u64 x[kPer];
  u64 mx = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    x[i] = keys[tid + i * kThreads];
    mx = max(mx, x[i]);
  }
  u64 v = mx;  // the warp's thread maxima, sorted descending across lanes
  for (int size = 2; size <= 32; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const u64 o = __shfl_xor_sync(0xffffffffu, v, stride);
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
      v = keep_max ? max(v, o) : min(v, o);
    }
  }
  const int j = (kp + kWarps - 1) / kWarps;
  const u64 tj = __shfl_sync(0xffffffffu, v, j - 1);
  if (lane == 0) warp_thr[warp] = tj;
  __syncthreads();
  u64 thr = warp_thr[0];
  for (int w = 1; w < kWarps; ++w) thr = min(thr, warp_thr[w]);
  thr = max(thr, 1ull);
  int cnt = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) cnt += x[i] >= thr;
  int incl = cnt;  // block-wide prefix of the counts
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) warp_cnt[warp] = incl;
  __syncthreads();
  int pos = incl - cnt, total = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) pos += warp_cnt[w];
    total += warp_cnt[w];
  }
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    if (x[i] >= thr) keys[pos++] = x[i];
  const int n = pow2_at_least(max(total, kp));
  for (int i = total + tid; i < n; i += kThreads) keys[i] = 0;
  __syncthreads();
  bitonic_desc<kThreads>(keys, n);
}

// Leaves the kp largest of cand[0, total) -- every block's kp best of one
// segment, written by other blocks (read with __ldcg) -- in keys[0, kp),
// sorted descending.  Reads kBatch keys a round and keeps only those at
// or above a floor, the kp-th key kept so far (this block's own kp-th key
// to start with: the segment's kp-th best is at least that), so after the
// first rounds few keys pass; select_top runs again only when the buffer
// could not take another round.  Keys are distinct (one per id) apart
// from 0, "no candidate", which the floor (>= 1) drops.  All threads
// call; keys[kp - 1] holds this block's own kp-th key on entry.
template <int kThreads, int kBuf, int kBatch>
__device__ void merge_segment(u64* keys, const u64* cand, long long total, int kp) {
  static_assert(kBatch % kThreads == 0 && kBatch < kBuf, "a round fits beside the kept keys");
  __shared__ int have_s;
  constexpr int kPer = kBatch / kThreads;
  const int tid = threadIdx.x, lane = tid & 31;
  u64 floor_key = max(keys[kp - 1], 1ull);
  int have = 0;
  if (tid == 0) have_s = 0;
  __syncthreads();
  for (long long pos = 0; pos < total; pos += kBatch) {
    if (have > kBuf - kBatch) {  // block-uniform
      for (int i = have + tid; i < kBuf; i += kThreads) keys[i] = 0;
      __syncthreads();
      select_top<kThreads, kBuf>(keys, kp);
      floor_key = max(keys[kp - 1], 1ull);
      have = kp;
      if (tid == 0) have_s = kp;
      __syncthreads();
    }
    u64 x[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const long long at = pos + tid + i * kThreads;
      x[i] = at < total ? __ldcg(cand + at) : 0;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {  // warp-aggregated append
      const bool keep = x[i] >= floor_key;
      const unsigned m = __ballot_sync(0xffffffffu, keep);
      int base = 0;
      if (lane == 0 && m) base = atomicAdd(&have_s, __popc(m));
      base = __shfl_sync(0xffffffffu, base, 0);
      if (keep) keys[base + __popc(m & ((1u << lane) - 1))] = x[i];
    }
    __syncthreads();
    have = have_s;
    __syncthreads();
  }
  for (int i = have + tid; i < kBuf; i += kThreads) keys[i] = 0;
  __syncthreads();
  select_top<kThreads, kBuf>(keys, kp);
}

// The common ending of a block of a top-k launch: its best kp keys are
// in keys[0, kp).  When its segment spans several blocks, it posts them
// to scratch[(first + block) * kp ..], and the last block of the segment
// to finish (counter after __threadfence) merges everyone's.  Returns
// true in the block that then holds the segment's top kp in keys[0, kp)
// (every block of a one-block segment); block-uniform.
template <int kThreads, int kBuf, int kBatch>
__device__ bool finish_segment(u64* keys, int kp, u64* scratch, long long first, int block,
                               int n_blocks, int* counter) {
  __shared__ int is_last;
  if (n_blocks <= 1) return true;
  u64* mine = scratch + (first + block) * kp;
  for (int i = threadIdx.x; i < kp; i += kThreads) mine[i] = keys[i];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(counter, 1) == n_blocks - 1;
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  merge_segment<kThreads, kBuf, kBatch>(keys, scratch + first * kp, (long long)n_blocks * kp, kp);
  return true;
}

// Writes keys[0, k) as (score, id) to vals/ids, (-inf, -1) for key 0.
template <int kThreads>
__device__ void write_topk(const u64* keys, int k, float* vals, int* ids) {
  for (int i = threadIdx.x; i < k; i += kThreads) {
    const u64 key = keys[i];
    vals[i] = key == 0 ? -INFINITY : key_score(key);
    ids[i] = key == 0 ? -1 : key_id(key);
  }
}

}  // namespace topk
