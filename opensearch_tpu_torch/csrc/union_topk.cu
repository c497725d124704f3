// K3: the batched term-bag top-k on Hopper.
//
// Replaces the JAX package's `batch_impact_union_topk`
// (opensearch_tpu/search/batch.py:69), an XLA program there: per segment,
// one gather of the union of a batch's query terms, a scatter of
// idf * imp into a dense [T, n_pad] arena, each query's weighted row
// gathers in its own term order (w * dense[slot][d], added from 0.0), the
// presence counts against `required` where the batch needs them, the live
// mask, and a top-k per query with the lower doc id first on ties, its
// matched total and its largest matched score.
//
// Bound on the card: memory.  The function reads each union posting once
// (a 4-byte doc id and a 4-byte impact), one live byte per doc, and writes
// k * 8 + 8 bytes per (query, segment); its operations (3 per posting of
// each query) sit far below the card's float32 rate.  What costs time is
// latency: dependent loads and barriers.
//
// Design:
// - One launch per batch.  The grid is (doc range r, segment s, query
//   chunk c): a few persistent blocks per segment and chunk, one wave for a
//   batch of 64 over 16 segments.  The wrapper (ops/cuda_bm25.py) cuts the
//   batch into chunks whose staging and candidate buffers fit in shared
//   memory, and picks the sub-tile width D.
// - Cursors: at its start a block finds each union row's range in its doc
//   range (two binary searches per row, all rows at once) and where each
//   sub-tile's postings begin in each row: a coarse pass over every 16th
//   doc id of the ranges, all threads over all rows together, then a
//   4-step search per bound.
// - Staging: per sub-tile, dense[T][D] f32 in shared memory holds idf * imp
//   of the T union terms the chunk names in the segment (and a presence
//   byte per term and doc when the batch needs counts).  The sub-tile's
//   postings, flattened over the rows, were copied into a posting buffer
//   with cp.async (a warp a term) while the previous sub-tile was scored;
//   the block scatters them from there (postings past the buffer's
//   capacity are loaded directly), then issues the copy of the next
//   sub-tile's.
// - Scoring: the block's threads form groups, a group per query at most
//   16 (one warp each for chunks of 16 queries or more); a thread owns up
//   to 16 doc columns of the sub-tile and loops over its group's queries
//   (one warp per group: the warps take the queries from a counter).  It
//   reads its live bytes once, then each query's slots in term order,
//   neighbouring threads on neighbouring docs (no bank conflict).  Per
//   doc, s = 0, then s = s + w * dense[slot][d], each spelled __fmul_rn /
//   __fadd_rn (the build passes -fmad=false): the reference's
//   accumulation, byte for byte.  matched = s > 0 (fast: every query an OR
//   bag of positive weights) else presence count >= required, then & live.
//   A query with no posting in the sub-tile is skipped.
// - Selection: each query keeps candidate buffers of C keys (topk.cuh's
//   64-bit key: score, then lower doc id), each with its running
//   threshold, its kp-th best key.  A doc passes only with a score above
//   the best of the query's thresholds as they stood at the sub-tile's
//   start (the kept docs come from earlier sub-tiles, with lower ids, so
//   an equal score loses; and a doc below the kp-th key of any buffer is
//   below kp others) and, while the query has no threshold, at or above
//   its warp's floor (the kp-th best of the warp's lanes' best scores):
//   most (query, doc) pairs cost one float compare.  Where a group is one
//   warp, that warp offers the passing docs to the query's buffer as it
//   scores them; otherwise a selection phase does, with 16 / queries warps
//   per query, each on its own buffer, a word of pass bits a round.  A
//   warp flushes its buffer (a warp bitonic sort in registers; keep kp)
//   when a round could overflow it: no block barrier.  Each block merges
//   a query's buffers (a tree of pairwise merges) and posts its kp best
//   keys; the last block of a (chunk, segment) to finish merges those, a
//   warp per query, queries in parallel.  Matched counts and maxes gather
//   per (warp, query) in shared memory, then take one atomic per (query,
//   segment, block).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

using topk::u64;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLoads = 4;    // postings a thread loads at once past the buffer
constexpr int kSample = 16;  // postings between two samples of the bounds' coarse pass
constexpr int kMaxDocs = 4096;               // the widest sub-tile
constexpr int kLivePer = kMaxDocs / kThreads;  // live bytes a thread loads a sub-tile
constexpr int kPer = 16;     // docs a thread owns in scoring at most
constexpr unsigned kFull = 0xffffffffu;

// Built with -DUNION_PHASES (testing/k3_sweep.py), thread 0 of each block
// adds the cycles from one phase mark to the next into union_phase_cycles:
// 0 block start (searches, bounds), 1 zeroing and the wait for the copy,
// 2 scatter, 3 scoring, 4 selection, 5 posting, 6 the last block's merge;
// and lane 0 of each warp adds its own cycles issuing the next sub-tile's
// copy (7), scoring (8) and selecting (9).
#ifdef UNION_PHASES
__device__ unsigned long long union_phase_cycles[10];
#define WARP_CLOCK(v) const long long v = clock64()
#define WARP_ADD(i, v)                                                                   \
  do {                                                                                   \
    if ((threadIdx.x & 31) == 0)                                                         \
      atomicAdd(&union_phase_cycles[i], (unsigned long long)(clock64() - v));            \
  } while (0)
#define PHASE_START() long long phase_t = clock64()
#define PHASE(i)                                                              \
  do {                                                                        \
    if (threadIdx.x == 0) {                                                   \
      const long long now = clock64();                                        \
      atomicAdd(&union_phase_cycles[i], (unsigned long long)(now - phase_t)); \
      phase_t = now;                                                          \
    }                                                                         \
  } while (0)
#else
#define WARP_CLOCK(v) \
  do {                \
  } while (0)
#define WARP_ADD(i, v) \
  do {                 \
  } while (0)
#define PHASE_START() \
  do {                \
  } while (0)
#define PHASE(i) \
  do {           \
  } while (0)
#endif

// Word offsets of the launch table's sections (ops/cuda_bm25.py
// `union_table` lays it out): per segment {doc_ids, impacts, live, n_pad,
// blocks, span}; per chunk {first query, queries}; per (chunk, segment)
// {first term | terms << 32, first slot | slots << 32}; per (query,
// segment) {slot offset in its chunk's slots | slots << 32}; per query its
// required count; int32 counters, zero on entry (per (chunk, segment) the
// blocks done; per (query, segment) the total and the max key); then 2
// words per term {start | end << 32, idf bits} and 1 per slot {term |
// weight bits << 32}.
struct Layout {
  long long seg, chunk, cs, qs, req, counters, term, slot;
  int n_seg, n_q;
};

__host__ __device__ inline long long align16(long long x) { return (x + 15) & ~15ll; }

// Candidate buffers a block keeps: one per (query, selecting warp).
__host__ __device__ inline int n_buffers(int q_cap) { return q_cap > kWarps ? q_cap : kWarps; }

// Dynamic shared memory of a block; the wrapper sizes chunks with the same
// sum.  Sections in this order, each 16-byte aligned: candidate buffers,
// their thresholds and counts, dense rows, the posting buffer (doc ids,
// impacts, terms; raw_cap a multiple of 8), slots, per-term row range and
// idf, two prefixes over the terms, per-term sub-tile bounds, per-query
// state, per-(warp, query) matched counts and maxes, pass bits, presence
// bytes, live bytes.
__host__ __device__ inline long long smem_bytes(int t_cap, int q_cap, int s_cap, int sub_cap,
                                                 int docs, int cand, int raw_cap, bool counts) {
  const long long nb = n_buffers(q_cap);
  return align16(nb * cand * 8) + align16(nb * 8) + align16(nb * 4) +
         align16((long long)t_cap * docs * 4) + align16((long long)raw_cap * 10) +
         align16((long long)s_cap * 8) + align16((long long)t_cap * 12) +
         align16(2ll * (t_cap + 1) * 4) + align16((long long)t_cap * (sub_cap + 1) * 4) +
         align16((long long)q_cap * 32) + align16((long long)q_cap * kWarps * 8) +
         align16((long long)q_cap * (docs / 32) * 4) +
         (counts ? align16((long long)t_cap * docs) : 0) + align16(docs);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Bitonic sort of s[0, N) descending by one warp, N a power of two from
// 64, in registers: key i = lane + 32 j sits in register j of its lane, so
// a stride of 32 or more compares two registers of one lane and a
// shorter one a register across lanes (a shuffle): no shared-memory round
// trip between the stages.
template <int N>
__device__ __forceinline__ void warp_sort_desc(u64* s, int lane) {
  constexpr int R = N / 32;
  u64 r[R];
#pragma unroll
  for (int j = 0; j < R; ++j) r[j] = s[lane + 32 * j];
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      if (stride >= 32) {
        const int js = stride / 32;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          if (j & js) continue;  // (j, j | js): j the lower key
          const bool desc = ((lane + 32 * j) & size) == 0;
          const u64 a = r[j], b = r[j | js];
          r[j] = desc ? max(a, b) : min(a, b);
          r[j | js] = desc ? min(a, b) : max(a, b);
        }
      } else {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int i = lane + 32 * j;
          const u64 o = __shfl_xor_sync(kFull, r[j], stride);
          r[j] = (((i & stride) == 0) == ((i & size) == 0)) ? max(r[j], o) : min(r[j], o);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < R; ++j) s[lane + 32 * j] = r[j];
  __syncwarp();
}

// Sorts buf[0, N) descending, zeroing buf[cnt, N) first; out of line, so
// the unrolled network stays out of the scoring loop's code.
template <int N>
__device__ __noinline__ void sort_buffer(u64* buf, int cnt, int lane) {
  for (int i = cnt + lane; i < N; i += 32) buf[i] = 0;
  __syncwarp();
  warp_sort_desc<N>(buf, lane);
}

// buf[0, N / 2) holds the kept keys sorted descending, buf[N / 2, N) the
// keys offered since (zero where none): sorts the second half, then
// merges the halves' best N / 2 into buf[0, N / 2), sorted (the larger of
// each pair of the kept keys and the new ones reversed is bitonic, and a
// bitonic merge orders it).  Half the stages of sorting all N.
template <int N>
__device__ __noinline__ void merge_buffer(u64* buf, int cnt, int lane) {
  constexpr int H = N / 64;  // registers a lane of each half
  for (int i = cnt + lane; i < N; i += 32) buf[i] = 0;
  __syncwarp();
  warp_sort_desc<N / 2>(buf + N / 2, lane);
  u64 m[H];
#pragma unroll
  for (int j = 0; j < H; ++j)
    m[j] = max(buf[lane + 32 * j], buf[N - 1 - lane - 32 * j]);
#pragma unroll
  for (int stride = N / 4; stride > 0; stride >>= 1) {
    if (stride >= 32) {
      const int js = stride / 32;
#pragma unroll
      for (int j = 0; j < H; ++j) {
        if (j & js) continue;
        const u64 a = m[j], b = m[j | js];
        m[j] = max(a, b);
        m[j | js] = min(a, b);
      }
    } else {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const u64 o = __shfl_xor_sync(kFull, m[j], stride);
        m[j] = (lane & stride) == 0 ? max(m[j], o) : min(m[j], o);
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < H; ++j) buf[lane + 32 * j] = m[j];
  __syncwarp();
}

// A query's candidate buffer of kCand keys in shared memory: keys in
// buf[0, cnt), each above thr when it entered.  Warp-uniform state, the
// whole warp calls.  Between calls the state lives in buf, cnt and thr.
template <int kCand>
struct Cands {
  u64* buf;
  int cnt;
  u64 thr;
  int kp;

  // Sorts the buffer descending (zero past cnt), keeps the best kp: the
  // threshold becomes the kp-th key once kp are kept.  Once it is set, the
  // kept keys are sorted, and a buffer of 2 kp merges the new ones in.
  __device__ __forceinline__ void flush(int lane) {
    if (kCand >= 128 && thr != 0)  // kp = kCand / 2 kept sorted: merge
      merge_buffer<kCand>(buf, cnt, lane);
    else
      sort_buffer<kCand>(buf, cnt, lane);
    cnt = min(cnt, kp);
    if (cnt == kp) thr = buf[kp - 1];
  }

  // Offers one key a lane (0: none).  Keys are distinct, so a key equal to
  // thr is the kept one itself and never offered twice.
  __device__ __forceinline__ void offer(u64 key, int lane) {
    bool want = key > thr;
    unsigned m = __ballot_sync(kFull, want);
    if (m == 0) return;
    if (cnt > kCand - 32) {  // no room for a round: flush, then offer again
      flush(lane);
      want = key > thr;
      m = __ballot_sync(kFull, want);
      if (m == 0) return;
    }
    if (want) buf[cnt + __popc(m & ((1u << lane) - 1u))] = key;
    cnt += __popc(m);
    __syncwarp();
  }
};

// First p in [lo, hi) with ids[p] >= target, else hi (a row's ids ascend).
__device__ int lower_bound(const int32_t* __restrict__ ids, int lo, int hi, int target) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(ids + mid) < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// Doc d's score for one query, its slots {term, weight bits} read from
// shared memory: x = 0, then x = x + w * dense[term][d] in slot order, the
// scoring pass's accumulation.
__device__ __forceinline__ float score_doc(const float* dense, const int2* sl, int n_sl, int docs,
                                           int d) {
  float x = 0.0f;
  for (int j = 0; j < n_sl; ++j)
    x = __fadd_rn(x, __fmul_rn(__int_as_float(sl[j].y), dense[sl[j].x * docs + d]));
  return x;
}

// Warp 0: pre[t] = sum of len(u) for u < t, t in [0, n], len(t) given.
template <class Len>
__device__ void warp_prefix(int* pre, int n, Len len, int lane) {
  int carry = 0;
  for (int base = 0; base < n; base += 32) {
    const int t = base + lane;
    int x = t < n ? len(t) : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, x, o);
      if (lane >= o) x += y;
    }
    if (t < n) pre[t + 1] = carry + x;
    carry += __shfl_sync(kFull, x, 31);
  }
  if (lane == 0) pre[0] = 0;
}

// The k-th largest of the warp's 32 values v (k in 1..32): a bitonic sort
// descending across the lanes, then lane k - 1's.
__device__ __forceinline__ float warp_kth(float v, int k, int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      const float o = __shfl_xor_sync(kFull, v, stride);
      const bool keep_max = ((lane & stride) == 0) == ((lane & size) == 0);
      v = keep_max ? fmaxf(v, o) : fminf(v, o);
    }
  }
  return __shfl_sync(kFull, v, k - 1);
}

// The t in [0, n) with pre[t] <= f < pre[t + 1] (pre ascending from 0).
__device__ int find_term(const int* pre, int n, int f) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (pre[mid] <= f)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// What the scoring of a sub-tile reads and writes, in shared memory.
struct Scoring {
  const float* dense;
  const uint8_t* pres;
  const uint8_t* live;
  const int2* slots;
  const int *qoff, *qn, *req, *act;
  int* hasp;
  const float* thrf;
  unsigned* pass;
  int* tot_w;
  unsigned* mx_w;
  u64* cand;
  u64* thr;
  int* cnt;
  int* next;  // where a group is one warp: the next query to score
  int docs, words, q_cap, kp, nq, parts, groups, cols, sub;
};

// One sub-tile's scoring by one thread: its PER docs col + u * cols, for
// each query of its group (g, g + groups, ...; where a group is one warp,
// the warps take the queries in the order they ask, as a query whose
// docs pass often costs more).  Per doc, x = 0, then x =
// x + w * dense[slot][d] in slot order.  Matched counts and maxes go to
// the warp's slots; passing docs (matched, above the query's threshold and
// the warp's floor) go to the query's buffer straight from the registers
// where a group is one warp (the query's only selector), else to the pass
// bits that the selection phase reads.
template <int kCand, int PER, bool FAST>
__device__ __forceinline__ void score_sub_tile(const Scoring& S, int g, int col, int lane, int warp) {
  const int cols = S.cols, docs = S.docs;
  const int col0 = col - lane;  // the warp's first column
  unsigned live_bits = 0;
#pragma unroll
  for (int u = 0; u < PER; ++u) live_bits |= (S.live[col + u * cols] != 0 ? 1u : 0u) << u;
  const bool one_warp = S.cols == 32;
  auto next_query = [&](int q) {
    if (!one_warp) return q + S.groups;
    int i = 0;
    if (lane == 0) i = atomicAdd(S.next, 1);
    return __shfl_sync(kFull, i, 0);
  };
  for (int q = next_query(g - S.groups); q < S.nq; q = next_query(q)) {
    if (!S.act[q]) continue;
    const int2* sl = S.slots + S.qoff[q];
    const int n_sl = S.qn[q];
    float x[PER];
    int cnt[PER];
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      x[u] = 0.0f;
      cnt[u] = 0;
    }
    for (int j = 0; j < n_sl; ++j) {
      const int2 y = sl[j];
      const float w = __int_as_float(y.y);
      const float* row = S.dense + y.x * docs + col;
      const uint8_t* prow = S.pres + y.x * docs + col;
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        x[u] = __fadd_rn(x[u], __fmul_rn(w, row[u * cols]));
        if (!FAST) cnt[u] += prow[u * cols];
      }
    }
    const float thr_f = S.thrf[q];
    const int req = S.req[q];
    unsigned hits = 0;
    int tot = 0;
    float top = -INFINITY;  // the lane's best matched score
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const bool hit = ((live_bits >> u) & 1u) && (FAST ? x[u] > 0.0f : cnt[u] >= req);
      hits |= (hit ? 1u : 0u) << u;
      tot += hit;
      if (hit) top = fmaxf(top, x[u]);
    }
    // no threshold yet (the query's buffers hold fewer than kp keys): the
    // kp-th best lane score of the warp bounds the block's kp-th best
    // score from below (kp docs of distinct lanes reach it), so a doc
    // below it never enters the top kp; an equal one may (a lower id), so
    // it passes
    const float floor_f =
        thr_f == -INFINITY && S.kp <= 32 ? warp_kth(top, S.kp, lane) : -INFINITY;
    unsigned pass = 0;  // bit u: doc col + u * cols passes
#pragma unroll
    for (int u = 0; u < PER; ++u)
      pass |= (((hits >> u) & 1u) && x[u] > thr_f && x[u] >= floor_f ? 1u : 0u) << u;
    if (one_warp) {
      // the query's warp: offer the passing docs, one a lane a round
      if (__any_sync(kFull, pass != 0)) {
        const int b = q * S.parts;
        Cands<kCand> cs{S.cand + (long long)b * kCand, S.cnt[b], S.thr[b], S.kp};
        while (__any_sync(kFull, pass != 0)) {
          u64 key = 0;
          if (pass) {
            const int u = __ffs(pass) - 1;
            pass &= pass - 1;
            float xv = 0.0f;
#pragma unroll
            for (int v = 0; v < PER; ++v)
              if (v == u) xv = x[v];
            key = topk::make_key(xv, S.sub + col + u * cols);
          }
          cs.offer(key, lane);
        }
        if (lane == 0) {
          S.cnt[b] = cs.cnt;
          S.thr[b] = cs.thr;
        }
      }
    } else {
      unsigned word = 0;  // lane u < PER: the pass bits of docs col0 + u * cols + [0, 32)
#pragma unroll
      for (int u = 0; u < PER; ++u) {
        const unsigned v = __ballot_sync(kFull, (pass >> u) & 1u);
        if (lane == u) word = v;
      }
      if (lane < PER) S.pass[q * S.words + ((col0 + lane * cols) >> 5)] = word;
      if (__any_sync(kFull, word != 0) && lane == 0) S.hasp[q] = 1;
    }
    tot = __reduce_add_sync(kFull, tot);
    const unsigned mx = __reduce_max_sync(kFull, hits ? topk::orderable(top) : 0u);
    if (lane == 0) {
      S.tot_w[warp * S.q_cap + q] += tot;
      S.mx_w[warp * S.q_cap + q] = max(S.mx_w[warp * S.q_cap + q], mx);
    }
  }
}

template <int kCand>
__global__ void __launch_bounds__(kThreads, 1)
union_topk_kernel(const long long* __restrict__ table, Layout L, int t_cap, int q_cap, int s_cap,
                  int sub_cap, int docs, int raw_cap, int k, int kp, int need_counts,
                  float* __restrict__ out_vals, int* __restrict__ out_ids,
                  int* __restrict__ out_totals, float* __restrict__ out_maxes,
                  u64* __restrict__ scratch) {
  const int r = blockIdx.x, s = blockIdx.y, c = blockIdx.z;
  const int R = gridDim.x;
  const long long* e = table + L.seg + 6ll * s;
  const int blocks = (int)e[4];
  if (r >= blocks) return;
  PHASE_START();
  const int32_t* __restrict__ ids = reinterpret_cast<const int32_t*>(e[0]);
  const float* __restrict__ imp = reinterpret_cast<const float*>(e[1]);
  const uint8_t* __restrict__ live = reinterpret_cast<const uint8_t*>(e[2]);
  const int n_pad = (int)e[3];
  const int span = (int)e[5];
  const int q0 = (int)table[L.chunk + 2ll * c];
  const int nq = (int)table[L.chunk + 2ll * c + 1];
  const unsigned long long cs0 = (unsigned long long)table[L.cs + 2ll * (c * L.n_seg + s)];
  const unsigned long long cs1 = (unsigned long long)table[L.cs + 2ll * (c * L.n_seg + s) + 1];
  const int term0 = (int)(cs0 & 0xFFFFFFFFull), nt = (int)(cs0 >> 32);
  const int slot0 = (int)(cs1 & 0xFFFFFFFFull), ns = (int)(cs1 >> 32);
  const bool fast = !need_counts;
  int* counters = reinterpret_cast<int*>(const_cast<long long*>(table + L.counters));
  int* done = counters + c * L.n_seg + s;
  int* totals = counters + gridDim.z * L.n_seg;              // [query * S + s]
  unsigned* max_keys = reinterpret_cast<unsigned*>(totals + L.n_q * L.n_seg);
  // warps that select for one query, each with its own candidate buffer
  const int parts = nq < kWarps ? kWarps / nq : 1;
  const int words = docs / 32;

  extern __shared__ __align__(16) char smem[];
  char* at = smem;
  const long long n_buf = n_buffers(q_cap);
  u64* cand_s = reinterpret_cast<u64*>(at);  // buffer b = q * parts + part
  at += align16(n_buf * kCand * 8);
  u64* thr_s = reinterpret_cast<u64*>(at);
  at += align16(n_buf * 8);
  int* cnt_s = reinterpret_cast<int*>(at);
  at += align16(n_buf * 4);
  float* dense = reinterpret_cast<float*>(at);
  at += align16((long long)t_cap * docs * 4);
  int* raw_id = reinterpret_cast<int*>(at);  // the next sub-tile's postings
  float* raw_imp = reinterpret_cast<float*>(raw_id + raw_cap);
  uint16_t* raw_t = reinterpret_cast<uint16_t*>(raw_imp + raw_cap);
  at += align16((long long)raw_cap * 10);
  int2* slots_s = reinterpret_cast<int2*>(at);
  at += align16((long long)s_cap * 8);
  int* lo_s = reinterpret_cast<int*>(at);   // the row's range, then the block's
  int* hi_s = lo_s + t_cap;
  float* idf_s = reinterpret_cast<float*>(hi_s + t_cap);
  at += align16((long long)t_cap * 12);
  int* pre_s = reinterpret_cast<int*>(at);  // two prefixes of postings over the terms
  at += align16(2ll * (t_cap + 1) * 4);
  int* bnd = reinterpret_cast<int*>(at);    // bnd[t * (n_sub + 1) + i]: sub-tile i's first posting
  at += align16((long long)t_cap * (sub_cap + 1) * 4);
  int* qoff_s = reinterpret_cast<int*>(at);
  int* qn_s = qoff_s + q_cap;
  int* req_s = qn_s + q_cap;
  int* act_s = req_s + q_cap;   // a posting of the query in the sub-tile
  int* hasp_s = act_s + q_cap;  // a pass bit in the sub-tile
  float* thrf_s = reinterpret_cast<float*>(hasp_s + q_cap);  // score of the best threshold
  at += align16((long long)q_cap * 32);
  // matched counts and max keys per (warp, query): each warp adds to its
  // own, with no atomic that 16 warps in step would queue on
  int* tot_w = reinterpret_cast<int*>(at);
  unsigned* mx_w = reinterpret_cast<unsigned*>(tot_w + kWarps * q_cap);
  at += align16((long long)q_cap * kWarps * 8);
  unsigned* pass_s = reinterpret_cast<unsigned*>(at);  // [q][words]
  at += align16((long long)q_cap * words * 4);
  uint8_t* pres = reinterpret_cast<uint8_t*>(at);
  if (need_counts) at += align16((long long)t_cap * docs);
  uint8_t* live_s = reinterpret_cast<uint8_t*>(at);
  __shared__ int is_last;
  __shared__ int next_item;  // the next query to score, or (query, part) to select

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d_begin = r * span;
  const int d_end = min(n_pad, d_begin + span);
  const int n_sub = (d_end - d_begin + docs - 1) / docs;
  const int shift = __ffs(docs) - 1;

  for (int i = tid; i < nt; i += kThreads) {
    const unsigned long long w = (unsigned long long)table[L.term + 2ll * (term0 + i)];
    lo_s[i] = (int)(w & 0xFFFFFFFFull);
    hi_s[i] = (int)(w >> 32);
    idf_s[i] = __uint_as_float((unsigned)table[L.term + 2ll * (term0 + i) + 1]);
  }
  for (int i = tid; i < ns; i += kThreads) {
    const unsigned long long w = (unsigned long long)table[L.slot + slot0 + i];
    slots_s[i] = make_int2((int)(w & 0xFFFFFFFFull), (int)(w >> 32));
  }
  for (int q = tid; q < nq; q += kThreads) {
    const unsigned long long w = (unsigned long long)table[L.qs + (long long)(q0 + q) * L.n_seg + s];
    qoff_s[q] = (int)(w & 0xFFFFFFFFull);
    qn_s[q] = (int)(w >> 32);
    req_s[q] = (int)table[L.req + q0 + q];
  }
  for (int i = tid; i < kWarps * nq; i += kThreads) {
    tot_w[(i / nq) * q_cap + i % nq] = 0;
    mx_w[(i / nq) * q_cap + i % nq] = 0;
  }
  for (int b = tid; b < nq * parts; b += kThreads) {
    cnt_s[b] = 0;
    thr_s[b] = 0;
  }
  __syncthreads();
  // each row's range in [d_begin, d_end): two searches per row, all rows
  // at once (search i < nt the start of row i, nt <= i < 2 nt the end of
  // row i - nt), into bnd until every search has read lo_s and hi_s
  for (int i = tid; i < 2 * nt; i += kThreads) {
    const int t = i < nt ? i : i - nt;
    bnd[i] = lower_bound(ids, lo_s[t], hi_s[t], i < nt ? d_begin : d_end);
  }
  __syncthreads();
  for (int t = tid; t < nt; t += kThreads) {
    lo_s[t] = bnd[t];
    hi_s[t] = bnd[nt + t];
  }
  __syncthreads();
  // every sub-tile's bound in every row: bnd[t][i] = the first posting of
  // the range with doc >= d_begin + i * D (hi where there is none).  A
  // coarse pass reads every kSample-th doc id of the ranges, all rows at
  // once, and brackets each bound within kSample postings; a short search
  // in each bracket (log2 kSample loads, all bounds at once) finishes it.
  const int nb = n_sub + 1;
  auto samples = [&](int t) { return (hi_s[t] - lo_s[t] + kSample - 1) / kSample; };
  // the bracket after a row's last sample, where bounds past it lie
  for (int i = tid; i < nt * nb; i += kThreads) {
    const int t = i / nb, n = samples(t);
    bnd[i] = n ? lo_s[t] + (n - 1) * kSample + 1 : lo_s[t];
  }
  if (warp == 0) warp_prefix(pre_s, nt, samples, lane);
  __syncthreads();
  for (int f0 = tid; f0 < pre_s[nt]; f0 += kThreads * kLoads) {
    int tt[kLoads], pp[kLoads], dd[kLoads], prev[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int f = f0 + u * kThreads;
      tt[u] = f < pre_s[nt] ? find_term(pre_s, nt, f) : -1;
      pp[u] = tt[u] < 0 ? 0 : lo_s[tt[u]] + (f - pre_s[tt[u]]) * kSample;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      dd[u] = tt[u] < 0 ? 0 : __ldg(ids + pp[u]);
      prev[u] = tt[u] < 0 || pp[u] == lo_s[tt[u]] ? d_begin - 1 : __ldg(ids + pp[u] - kSample);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (tt[u] < 0) continue;
      // bounds in (sub-tile of the previous sample, this one's]: between
      // the two samples
      const int a = prev[u] < d_begin ? -1 : (prev[u] - d_begin) >> shift;
      const int b = (dd[u] - d_begin) >> shift;
      const int from = pp[u] == lo_s[tt[u]] ? pp[u] : pp[u] - kSample + 1;
      for (int i = a + 1; i <= b; ++i) bnd[tt[u] * nb + i] = from;
    }
  }
  __syncthreads();
  for (int i = tid; i < nt * nb; i += kThreads) {
    const int t = i / nb;
    bnd[i] = lower_bound(ids, bnd[i], min(bnd[i] + kSample, hi_s[t]), d_begin + (i % nb) * docs);
  }
  __syncthreads();
  int* pre_a = pre_s;  // sub-tile i's prefix in pre_a (i even) or pre_b (i odd)
  int* pre_b = pre_s + t_cap + 1;
  auto sub_prefix = [&](int* pre, int i) {
    warp_prefix(pre, nt, [&](int t) { return bnd[t * nb + i + 1] - bnd[t * nb + i]; }, lane);
  };
  if (warp == 0) sub_prefix(pre_a, 0);
  __syncthreads();
  PHASE(0);

  // the first raw_cap postings of sub-tile i into the posting buffer,
  // asynchronously, a warp a term (its lanes the term's postings, no
  // search for a posting's term); each thread waits for its own copies
  // before the barrier that opens the sub-tile
  auto issue = [&](int i, const int* pre) {
    for (int t = warp; t < nt && pre[t] < raw_cap; t += kWarps) {
      const int f0 = pre[t], n = min(pre[t + 1], raw_cap) - f0;
      const int p0 = bnd[t * nb + i];
      for (int j = lane; j < n; j += 32) {
        cp_async4(raw_id + f0 + j, ids + p0 + j);
        cp_async4(raw_imp + f0 + j, imp + p0 + j);
        raw_t[f0 + j] = (uint16_t)t;
      }
    }
    cp_async_commit();
  };
  // live bytes of a sub-tile, kLivePer a thread, loaded a sub-tile ahead
  uint8_t lv[kLivePer];
  auto load_live = [&](int sub) {
#pragma unroll
    for (int u = 0; u < kLivePer; ++u) {
      const int d = sub + tid + u * kThreads;
      lv[u] = tid + u * kThreads < docs && d < d_end ? __ldg(live + d) : 0;
    }
  };
  issue(0, pre_a);
  load_live(d_begin);
  // scoring: the block in `groups` groups of `cols` threads, group g on
  // the queries g, g + groups, ...; a thread owns the docs col + u * cols,
  // u < per, of the sub-tile, so a query's loads and votes cover many
  // docs.  groups: the largest power of two up to min(queries, warps),
  // within what D allows (per from 1 to kPer)
  int groups = 1;
  while (groups * 2 <= min(nq, kWarps)) groups *= 2;
  groups = min(max(groups, kThreads / docs), min(kWarps, kThreads * kPer / docs));
  const int cols = kThreads / groups, per = docs / cols;
  const int g = tid / cols, col = tid % cols;

  for (int sub_i = 0; sub_i < n_sub; ++sub_i) {
    const int sub = d_begin + sub_i * docs;
    const int* cur = (sub_i & 1) ? pre_b : pre_a;
    int* nxt = (sub_i & 1) ? pre_a : pre_b;
    float4* dense4 = reinterpret_cast<float4*>(dense);
    for (int i = tid; i < nt * (docs >> 2); i += kThreads)
      dense4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (need_counts) {
      uint4* pres4 = reinterpret_cast<uint4*>(pres);
      for (int i = tid; i < nt * (docs >> 4); i += kThreads) pres4[i] = make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kLivePer; ++u)
      if (tid + u * kThreads < docs) live_s[tid + u * kThreads] = lv[u];
    cp_async_wait_all();
    __syncthreads();
    PHASE(1);
    // the sub-tile's postings, flattened over the rows: from the posting
    // buffer, then any past its capacity from global memory
    const int total = cur[nt];
    const int n_raw = min(total, raw_cap);
    for (int f = tid; f < n_raw; f += kThreads) {
      const int t = raw_t[f];
      const int d = raw_id[f] - sub;
      dense[t * docs + d] = __fmul_rn(idf_s[t], raw_imp[f]);
      if (need_counts) pres[t * docs + d] = 1;
    }
    for (int f0 = n_raw + tid; f0 < total; f0 += kThreads * kLoads) {
      int tt[kLoads], pp[kLoads], dd[kLoads];
      float vv[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int f = f0 + u * kThreads;
        tt[u] = f < total ? find_term(cur, nt, f) : -1;
        pp[u] = tt[u] < 0 ? 0 : bnd[tt[u] * nb + sub_i] + f - cur[tt[u]];
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        dd[u] = tt[u] < 0 ? 0 : __ldg(ids + pp[u]);
        vv[u] = tt[u] < 0 ? 0.0f : __ldg(imp + pp[u]);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (tt[u] < 0) continue;
        dense[tt[u] * docs + dd[u] - sub] = __fmul_rn(idf_s[tt[u]], vv[u]);
        if (need_counts) pres[tt[u] * docs + dd[u] - sub] = 1;
      }
    }
    // per query: a posting in the sub-tile (no posting, no match: a
    // matched doc needs a slot, or a positive score), and the score of its
    // best threshold as it stands now
    for (int q = tid; q < nq; q += kThreads) {
      int n_post = 0;
      for (int j = 0; j < qn_s[q]; ++j) {
        const int* b = bnd + slots_s[qoff_s[q] + j].x * nb + sub_i;
        n_post += b[1] - b[0];
      }
      act_s[q] = n_post > 0 || (!fast && req_s[q] <= 0);
      hasp_s[q] = 0;
      u64 best = 0;
      for (int p = 0; p < parts; ++p) best = max(best, thr_s[q * parts + p]);
      thrf_s[q] = best ? topk::key_score(best) : -INFINITY;
    }
    if (tid == 0) next_item = 0;
    if (warp == 0 && sub_i + 1 < n_sub) sub_prefix(nxt, sub_i + 1);
    __syncthreads();
    PHASE(2);
    WARP_CLOCK(issue_t);
    if (sub_i + 1 < n_sub) {  // in flight while this sub-tile is scored
      issue(sub_i + 1, nxt);
      load_live(sub + docs);
    }
    WARP_ADD(7, issue_t);
    WARP_CLOCK(score_t);

    // scoring: the thread's docs, every query of its group
    const Scoring sc{dense,  pres,  live_s, slots_s,  qoff_s, qn_s,  req_s, act_s, hasp_s,
                     thrf_s, pass_s, tot_w,  mx_w,     cand_s, thr_s, cnt_s, &next_item,
                     docs,   words,  q_cap, kp,       nq,     parts, groups, cols,  sub};
#define UNION_SCORE(P)                                        \
  case P:                                                     \
    if (fast)                                                 \
      score_sub_tile<kCand, P, true>(sc, g, col, lane, warp); \
    else                                                      \
      score_sub_tile<kCand, P, false>(sc, g, col, lane, warp);\
    break
    switch (per) {
      UNION_SCORE(1);
      UNION_SCORE(2);
      UNION_SCORE(4);
      UNION_SCORE(8);
      UNION_SCORE(16);
    }
#undef UNION_SCORE
    WARP_ADD(8, score_t);
    __syncthreads();
    PHASE(3);
    if (cols == 32) continue;  // each query's warp offered its docs as it scored them
    WARP_CLOCK(select_t);

    // selection: warp (q, part) offers the docs of every parts-th word of
    // q's pass bits to its buffer, a word a round; the warps take the
    // (query, part)s in the order they ask (a query whose docs pass often
    // costs more than one whose docs do not)
    auto grab = [&]() {
      int i = 0;
      if (lane == 0) i = atomicAdd(&next_item, 1);
      return __shfl_sync(kFull, i, 0);
    };
    for (int item = grab(); item < nq * parts; item = grab()) {
      const int q = item / parts, part = item % parts;
      if (!hasp_s[q]) continue;
      Cands<kCand> cs{cand_s + (long long)item * kCand, cnt_s[item], thr_s[item], kp};
      const int2* sl = slots_s + qoff_s[q];
      const int n_sl = qn_s[q];
      for (int w = part; w < words; w += parts) {
        const unsigned m = pass_s[q * words + w];
        if (m == 0) continue;
        const int d = w * 32 + lane;
        cs.offer((m >> lane) & 1u ? topk::make_key(score_doc(dense, sl, n_sl, docs, d), sub + d)
                                  : 0ull,
                 lane);
      }
      if (lane == 0) {
        cnt_s[item] = cs.cnt;
        thr_s[item] = cs.thr;
      }
    }
    WARP_ADD(9, select_t);
    __syncthreads();  // the rows are read before the next sub-tile overwrites them
    PHASE(4);
  }

  // post this block's kp best keys per query, its total and max.  Every
  // buffer flushes (sorted, its best kp kept), all at once; then a query's
  // buffers merge pairwise, a tree of log2(parts) levels, each pair on its
  // own warp
  for (int item = warp; item < nq * parts; item += kWarps) {
    Cands<kCand> cs{cand_s + (long long)item * kCand, cnt_s[item], thr_s[item], kp};
    cs.flush(lane);
    if (lane == 0) {
      cnt_s[item] = cs.cnt;
      thr_s[item] = cs.thr;
    }
  }
  for (int half = 1; half < parts; half *= 2) {
    __syncthreads();
    for (int item = warp; item < nq * parts; item += kWarps) {
      const int part = item % parts;
      if (part % (2 * half) != 0 || part + half >= parts) continue;
      Cands<kCand> cs{cand_s + (long long)item * kCand, cnt_s[item], thr_s[item], kp};
      const u64* o = cand_s + (long long)(item + half) * kCand;
      const int n = cnt_s[item + half];
      for (int i0 = 0; i0 < n; i0 += 32) cs.offer(i0 + lane < n ? o[i0 + lane] : 0ull, lane);
      cs.flush(lane);
      if (lane == 0) {
        cnt_s[item] = cs.cnt;
        thr_s[item] = cs.thr;
      }
    }
  }
  __syncthreads();
  for (int q = warp; q < nq; q += kWarps) {
    const u64* best = cand_s + (long long)q * parts * kCand;
    u64* mine = scratch + (((long long)(q0 + q) * L.n_seg + s) * R + r) * kp;
    for (int i = lane; i < kp; i += 32) mine[i] = best[i];
    int tot = lane < kWarps ? tot_w[lane * q_cap + q] : 0;
    unsigned mx = lane < kWarps ? mx_w[lane * q_cap + q] : 0u;
    tot = __reduce_add_sync(kFull, tot);
    mx = __reduce_max_sync(kFull, mx);
    if (lane == 0 && tot > 0) {
      atomicAdd(totals + (q0 + q) * L.n_seg + s, tot);
      atomicMax(max_keys + (q0 + q) * L.n_seg + s, mx);
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(done, 1) == blocks - 1;
  __syncthreads();
  PHASE(5);
  if (!is_last) return;
  __threadfence();

  // the last block of (chunk, segment): merge every block's keys, a warp
  // per query
  for (int q = warp; q < nq; q += kWarps) {
    Cands<kCand> cs{cand_s + (long long)q * parts * kCand, 0, 0ull, kp};
    const u64* src = scratch + ((long long)(q0 + q) * L.n_seg + s) * R * kp;
    const int n = blocks * kp;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      cs.offer(i < n ? __ldcg(src + i) : 0ull, lane);
    }
    cs.flush(lane);
    const long long row = (long long)(q0 + q) * L.n_seg + s;
    for (int i = lane; i < k; i += 32) {
      const u64 key = cs.buf[i];
      out_vals[row * k + i] = key == 0 ? -INFINITY : topk::key_score(key);
      out_ids[row * k + i] = key == 0 ? -1 : topk::key_id(key);
    }
    if (lane == 0) {  // every block's atomics are in: read them coherently
      const unsigned key = atomicMax(max_keys + row, 0u);
      out_totals[row] = atomicAdd(totals + row, 0);
      out_maxes[row] = key == 0 ? -INFINITY : topk::from_orderable(key);
    }
  }
  PHASE(6);
}

template <int kCand>
int launch(dim3 grid, long long smem, cudaStream_t stream, const long long* table, Layout L,
           int t_cap, int q_cap, int s_cap, int sub_cap, int docs, int raw_cap, int k, int kp,
           int need_counts, float* out_vals, int* out_ids, int* out_totals, float* out_maxes,
           u64* scratch) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        union_topk_kernel<kCand>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  union_topk_kernel<kCand><<<grid, kThreads, (size_t)smem, stream>>>(
      table, L, t_cap, q_cap, s_cap, sub_cap, docs, raw_cap, k, kp, need_counts, out_vals, out_ids,
      out_totals, out_maxes, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// Dynamic shared memory a block of union_topk_launch takes at these caps
// (the wrapper checks its own sum against it).
long long union_topk_smem_bytes(int t_cap, int q_cap, int s_cap, int sub_cap, int docs, int cand,
                                int raw_cap, int need_counts) {
  return smem_bytes(t_cap, q_cap, s_cap, sub_cap, docs, cand, raw_cap, need_counts != 0);
}

// One launch over the batch's table (device memory, layout above): grid
// (blocks_per_segment, n_seg, n_chunks).  Each (query, segment)'s top-k,
// total and max land in row query * n_seg + segment of out_vals/out_ids
// [*, k] and out_totals/out_maxes [*]; scratch holds n_q * n_seg *
// blocks_per_segment * kp keys.  t_cap, q_cap and s_cap bound the terms,
// queries and slots of any (chunk, segment), sub_cap the sub-tiles of a
// block (span / docs); docs is the sub-tile width (a power of two,
// 32..4096), cand the keys of a candidate buffer (the larger of 64 and
// 2 kp), raw_cap the postings of the asynchronous posting buffer (a
// multiple of 8, 0 for none).  Returns the CUDA error of the launch (0 on
// success).
int union_topk_launch(const long long* table, int n_seg, int n_chunks, int n_q, int n_terms,
                      int blocks_per_segment, int t_cap, int q_cap, int s_cap, int sub_cap,
                      int docs, int cand, int raw_cap, int k, int kp, int need_counts,
                      float* out_vals, int* out_ids, int* out_totals, float* out_maxes,
                      u64* scratch, void* stream) {
  if (n_seg <= 0 || n_chunks <= 0 || n_q <= 0) return 0;
  if (k < 1 || k > kp || (kp & (kp - 1)) || cand != (2 * kp > 64 ? 2 * kp : 64) || docs < 32 ||
      docs > kMaxDocs || (docs & (docs - 1)) || blocks_per_segment < 1 || sub_cap < 1 ||
      raw_cap < 0 || (raw_cap & 7) || t_cap > 65535 || n_chunks > 65535 || n_seg > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Layout L;
  L.n_seg = n_seg;
  L.n_q = n_q;
  L.seg = 0;
  L.chunk = L.seg + 6ll * n_seg;
  L.cs = L.chunk + 2ll * n_chunks;
  L.qs = L.cs + 2ll * n_chunks * n_seg;
  L.req = L.qs + (long long)n_q * n_seg;
  L.counters = L.req + n_q;
  L.term = L.counters + ((long long)n_chunks * n_seg + 2ll * n_q * n_seg + 1) / 2;
  L.slot = L.term + 2ll * n_terms;
  const long long smem =
      smem_bytes(t_cap, q_cap, s_cap, sub_cap, docs, cand, raw_cap, need_counts != 0);
  if (smem > 232448 - 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_per_segment, n_seg, n_chunks);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define UNION_LAUNCH(C)                                                                      \
  case C:                                                                                    \
    return launch<C>(grid, smem, st, table, L, t_cap, q_cap, s_cap, sub_cap, docs, raw_cap, \
                     k, kp, need_counts, out_vals, out_ids, out_totals, out_maxes, scratch)
  switch (cand) {
    UNION_LAUNCH(64);
    UNION_LAUNCH(128);
    UNION_LAUNCH(256);
    UNION_LAUNCH(512);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef UNION_LAUNCH
}

#ifdef UNION_PHASES
// Copies the cycle sums to out[0, 10) and zeroes them.
int union_topk_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, union_phase_cycles, sizeof(unsigned long long) * 10);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[10] = {};
  return static_cast<int>(cudaMemcpyToSymbol(union_phase_cycles, zero, sizeof(zero)));
}
#endif

}  // extern "C"
