// K8 and K9 on Hopper: phrase and span-near scores over every (leaf,
// segment) job of a request, in one launch per kernel.
//
// K8 `phrase_scores_kernel` replaces the JAX package's `phrase_freqs`
// (opensearch_tpu/ops/phrase.py:49, with `gather_term_positions` at :27)
// and the BM25 scoring after it; K9 `span_scores_kernel` replaces its
// `span_near_freqs` (opensearch_tpu/ops/span.py:32) and the same
// scoring.  The reference gathers a power-of-two budget of int64 (doc,
// position) keys for every slot and runs a `searchsorted` for every
// occurrence of the anchor over each other slot's keys.  Here:
//
// - Work: the anchor's positions.  A job's anchor row (slot 0: K8's
//   rarest slot, K9's clause 0) holds its positions contiguously, so a
//   block owns POS_CHUNK of them (the last block of a job fewer): every
//   block of the grid holds the same work, whatever the docs' lengths.
//   Right after reading its job, a block starts three bulk asynchronous
//   copies into shared memory (cp.async.bulk, bulk.cuh): its positions,
//   and a window of the row's position offsets and doc ids around the
//   entries its positions fall in, placed by the row's mean positions
//   an entry; it then finds its first and last entry in the window (a
//   window that misses them, rare, is searched for in device memory by
//   the whole block and copied again).
// - Docs by intersection: the other slots are taken one after another
//   (no cap on slots: each thread carries its positions' state from slot
//   to slot in registers).  For a slot on another row, the block finds,
//   by one warp search each, the window of the slot's doc-id row between
//   its first and its last doc; then each of its entries' doc is looked
//   up in that window: the window is walked tile by tile through shared
//   memory, or, when it is more than POS_SPARSE times longer than the
//   block's entries (a rare anchor beside a common term), a warp
//   searches it for one doc at a time; the entry found keeps its
//   positions' [lo, hi).  A slot on the anchor's own row ("t0 t0") takes
//   the anchor's entry with no search, and reads its positions from
//   shared memory where the block holds them.
// - Positions by merge walk: a thread takes POS_CHUNK / POS_THREADS
//   consecutive anchor positions.  K8's exact shift, K9's ordered greedy
//   chain (the first position after the previous clause's) and its
//   unordered nearest occurrence are monotone in the anchor position, so
//   within one entry the thread seeks a slot's positions once and then
//   advances one cursor.  A heavy entry (one doc holding thousands of the
//   anchor's positions) is spread over the threads, and over the blocks,
//   like any other.
// - Counts: each thread adds its runs of confirmed positions to its
//   entries' counters in shared memory (integer atomics: any order gives
//   the same sum).  An entry inside one block is final there; an entry
//   that spans blocks adds its part to an integer pair in `scratch`
//   (keyed by the block its positions start in) and the last of its
//   blocks to arrive finishes it.  No float atomics.
// - Scores: per doc of a final count, `matched` = 1 and, for a scored
//   leaf, `weight * tf / (tf + k1 * (1 - b + b * dl / avgdl))` in the
//   reference's float32 order (its XLA code fuses `tf + k1 * inner`:
//   one fmaf), written once.  The caller zeroes the outputs (one memset
//   a request).
//
// (doc, position) pairs compare as the reference's keys `doc * 2^22 +
// position` do while every position plus its offset is below 2^22.
// Every index and position fits in 32 bits (the columns hold fewer than
// 2^31 elements): a block works in int, the table's int64 words cast on
// reading.
//
// Bound on the card: memory.  The anchor's doc ids, position offsets and
// positions are read once, the other slots' rows (windows, and the
// positions of matching entries) about once, each anchor doc's length
// once, and every job's [n_pad] scores and matched written once (the
// memset).  The design spends its reads on that: one staged copy of the
// anchor's run, one walk of each slot's window, no search per position.
// What holds it back instead is each block's chain of dependent steps
// (the job, its copies, the barriers): testing/k8_sweep.py splits a
// block's cycles by phase (-DQUANT_PHASES, phases.cuh).
//
// Build through ops/cuda_positions.py, whose defines() gives the POS_*
// macros: POS_CHUNK (anchor positions a block owns), POS_THREADS,
// POS_MIN_BLOCKS (blocks an SM should hold: __launch_bounds__' second
// argument, which caps the registers a thread), POS_TILE_IDS (a slot
// window's tile), POS_SPARSE, POS_JOB_WORDS (the
// launch table's words a job), POS_BASE (the reference's gap 2^22),
// POS_K1_BITS / POS_B_BITS / POS_ONE_MINUS_B_BITS (BM25's k1, b and
// 1 - b as float32 bits).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "bulk.cuh"
#include "phases.cuh"

#if !defined(POS_CHUNK) || !defined(POS_THREADS) || !defined(POS_MIN_BLOCKS) ||   \
    !defined(POS_TILE_IDS) || !defined(POS_SPARSE) || !defined(POS_JOB_WORDS) ||   \
    !defined(POS_BASE) || !defined(POS_K1_BITS) || !defined(POS_B_BITS) ||          \
    !defined(POS_ONE_MINUS_B_BITS)
#error "build through ops/cuda_positions.py, whose defines() gives the POS_* macros"
#endif

namespace {

using namespace bulk;

constexpr int kChunk = POS_CHUNK;
constexpr int kThreads = POS_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = kChunk / kThreads;
constexpr int kTile = POS_TILE_IDS;
constexpr int kSparse = POS_SPARSE;
constexpr int kJobWords = POS_JOB_WORDS;
constexpr int kSlotWords = 3;    // table words a slot: {row start, row end, shift}
constexpr int kSlotCache = 32;   // slots whose words a block keeps in shared memory
constexpr int kPosBase = POS_BASE;
constexpr int kMargin = kChunk / 4;            // a window's entries before the estimate
constexpr int kWindow = kChunk + 2 * kMargin;  // ... and its entries in all
static_assert(kChunk % kThreads == 0 && kPerThread >= 1 && kPerThread <= 32,
              "a thread takes 1 to 32 positions");
static_assert(kThreads % 32 == 0 && kWarps >= 2, "whole warps, at least two");
static_assert(kChunk % 4 == 0, "staged runs start on 16 bytes");
static_assert(kTile >= kChunk, "the tile doubles as the per-entry counts");

// A job's words in the launch table (ops/cuda_positions.py job_table).
enum JobWord {
  wDocIds = 0,      // the segment's staged columns (device addresses)
  wPosOffsets = 1,
  wPositions = 2,
  wDocLens = 3,
  wOut = 4,         // the job's first element in the outputs
  wSlots = 5,       // its slots' first word in the table
  wNSlots = 6,
  wBlock0 = 7,      // its first block
  wPBegin = 8,      // the anchor row's first position (an index of `positions`)
  wPCount = 9,      // ... and its position count
  wScoring = 10,    // weight (float32 bits) | avgdl (float32 bits) << 32
  wFlags = 11,      // kScored | kOrdered | kSameTerm
  wSlop = 12,
  wEnd = 13,
  wRow0 = 14,       // the anchor's row: its first posting entry
  wRow1 = 15,       // ... and its end
};
static_assert(kJobWords == 16, "POS_JOB_WORDS is the JobWord count");
constexpr int kScored = 1, kOrdered = 2, kSameTerm = 4;

struct __align__(16) Shared {
  int pos[kChunk + 8];    // the block's anchor positions (a 16-byte window)
  int doc[kWindow + 8];   // a window of the anchor's doc ids holding the block's entries
  int off[kWindow + 12];  // ... and of their position offsets (one more)
  int ent_lo[kChunk];     // a slot's entry per block entry: its positions' [lo, hi)
  int ent_hi[kChunk];     // (empty: none; not kept for the anchor's own row)
  int tile[kTile];        // a tile of a slot's window; at the end the counts
  float dl[kChunk];       // each block entry's doc length
  long long job[kJobWords];
  int slot[kSlotCache][kSlotWords];
  int win[2];             // a slot's window [lo, hi) of doc ids
  int entry[3];           // the block's first and last anchor entries; 1: not in the window
  uint64_t bars[2];
  int job_index;
};

// lower_bound over a[lo, hi) by a whole warp, 32 probes a step; every
// lane returns the first index whose value is >= x (hi if none).
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ a, int lo, int hi, int x,
                                                int lane) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int i = lo + lane * step;
    const int n = __popc(__ballot_sync(0xffffffffu, i < hi && __ldg(a + i) < x));
    if (n == 0) return lo;
    const int next_hi = min(hi, lo + n * step);
    lo += (n - 1) * step + 1;
    hi = next_hi;
  }
  const int i = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu, i < hi && __ldg(a + i) < x));
}

// lower_bound of x0 and of x1 over a[lo, hi) by the whole block (every
// thread calls it and gets both): kThreads probes a step for each, so
// 2 steps for up to kThreads^2 elements.
__device__ __forceinline__ int2 block_lower_bounds(const int* __restrict__ a, int lo, int hi,
                                                   int x0, int x1) {
  int lo0 = lo, hi0 = hi, lo1 = lo, hi1 = hi;
  while (lo0 < hi0 || lo1 < hi1) {
    const int s0 = (hi0 - lo0 + kThreads - 1) / kThreads;
    const int s1 = (hi1 - lo1 + kThreads - 1) / kThreads;
    const int i0 = lo0 + (int)threadIdx.x * s0, i1 = lo1 + (int)threadIdx.x * s1;
    const bool p0 = i0 < hi0 && __ldg(a + i0) < x0;
    const bool p1 = i1 < hi1 && __ldg(a + i1) < x1;
    const int n0 = __syncthreads_count(p0), n1 = __syncthreads_count(p1);
    if (lo0 < hi0) {
      const int h = n0 ? min(hi0, lo0 + n0 * s0) : lo0;
      lo0 = n0 ? lo0 + (n0 - 1) * s0 + 1 : lo0;
      hi0 = h;
    }
    if (lo1 < hi1) {
      const int h = n1 ? min(hi1, lo1 + n1 * s1) : lo1;
      lo1 = n1 ? lo1 + (n1 - 1) * s1 + 1 : lo1;
      hi1 = h;
    }
  }
  return make_int2(lo0, lo1);
}

// The last index i of a[0, n) with a[i] <= x (-1 if none): a thread's
// binary search of shared memory.
__device__ __forceinline__ int last_at_most(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int m = (lo + hi) >> 1;
    if (a[m] <= x) lo = m + 1; else hi = m;
  }
  return lo - 1;
}

// BM25 of a phrase or span frequency, in the reference's float32 order.
__device__ __forceinline__ float bm25(int count, float dl, float weight, float avgdl) {
  const float tf = (float)count;
  const float inner = __fadd_rn(__int_as_float(POS_ONE_MINUS_B_BITS),
                                __fdiv_rn(__fmul_rn(__int_as_float(POS_B_BITS), dl), avgdl));
  return __fdiv_rn(__fmul_rn(weight, tf), __fmaf_rn(__int_as_float(POS_K1_BITS), inner, tf));
}

// Each block entry's entry in the slot on row [r0, r1), another row
// than the anchor's: the slot's window of doc ids between the block's
// first and last doc (a warp a bound), then each block entry's doc
// looked up in it (a warp a doc past kSparse times the entries, else
// tile by tile through shared memory); kept as the entry's positions
// [lo, hi), empty when the doc has none.  Then the window's positions,
// contiguous in `positions`, go to the tile when they fit: returns their
// first index there (-1: not staged).  Starts and ends on a barrier.
__device__ __forceinline__ int slot_entries(Shared& sm, int r0, int r1,
                                            const int* __restrict__ doc_ids,
                                            const int* __restrict__ pos_offsets,
                                            const int* __restrict__ positions,
                                            const int* s_doc, int n_ent) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // the previous slot's reads are done
  if (warp < 2) {
    const int w =
        warp_lower_bound(doc_ids, r0, r1, warp ? s_doc[n_ent - 1] + 1 : s_doc[0], lane);
    if (lane == 0) sm.win[warp] = w;
  }
  for (int e = tid; e < n_ent; e += kThreads) sm.ent_lo[e] = sm.ent_hi[e] = 0;
  __syncthreads();
  const int lo = sm.win[0], hi = sm.win[1];
  if (hi - lo > kTile && hi - lo > kSparse * n_ent) {
    for (int e = warp; e < n_ent; e += kWarps) {
      const int d = s_doc[e];
      const int k = warp_lower_bound(doc_ids, lo, hi, d, lane);
      if (lane == 0 && k < hi && __ldg(doc_ids + k) == d) {
        sm.ent_lo[e] = __ldg(pos_offsets + k);
        sm.ent_hi[e] = __ldg(pos_offsets + k + 1);
      }
    }
  } else {
    for (int t0 = lo; t0 < hi; t0 += kTile) {
      const int n = min(kTile, hi - t0);
      if (t0 > lo) __syncthreads();  // the previous tile's reads are done
      for (int i = tid; i < n; i += kThreads) sm.tile[i] = __ldg(doc_ids + t0 + i);
      __syncthreads();
      const int first = sm.tile[0], last = sm.tile[n - 1];
      for (int e = tid; e < n_ent; e += kThreads) {
        const int d = s_doc[e];
        if (d < first || d > last) continue;
        int a = 0, c = n;
        while (a < c) {
          const int m = (a + c) >> 1;
          if (sm.tile[m] < d) a = m + 1; else c = m;
        }
        if (sm.tile[a] == d) {
          sm.ent_lo[e] = __ldg(pos_offsets + t0 + a);
          sm.ent_hi[e] = __ldg(pos_offsets + t0 + a + 1);
        }
      }
    }
  }
  const int p0 = hi > lo ? __ldg(pos_offsets + lo) : 0;
  const int p1 = hi > lo ? __ldg(pos_offsets + hi) : 0;
  __syncthreads();  // the tile's reads are done
  if (p1 - p0 > kTile) return -1;
  for (int i = tid; i < p1 - p0; i += kThreads) sm.tile[i] = __ldg(positions + p0 + i);
  __syncthreads();
  return p0;
}

template <bool kSpan>
__device__ __forceinline__ void positional_block(const long long* __restrict__ table, int n_jobs,
                                                 float* __restrict__ scores,
                                                 unsigned char* __restrict__ matched,
                                                 int* __restrict__ scratch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& sm = *reinterpret_cast<Shared*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  QPHASE_START();
  const int b = blockIdx.x;
  // the job: the last whose first block is at or before this one
  if (warp == 0) {
    int found = 0;
    for (int base = 0; base < n_jobs; base += 32) {
      const int j = base + lane;
      const bool at = j < n_jobs && table[(long long)j * kJobWords + wBlock0] <= b;
      const int n = __popc(__ballot_sync(0xffffffffu, at));
      found = base + n - 1;
      if (n < 32) break;
    }
    if (lane == 0) {
      sm.job_index = found;
      sm.entry[2] = 0;
      bar_init(&sm.bars[0]);
      bar_init(&sm.bars[1]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  if (tid < kJobWords) sm.job[tid] = table[(long long)sm.job_index * kJobWords + tid];
  __syncthreads();
  QPHASE(0);
  const int* __restrict__ doc_ids = reinterpret_cast<const int*>(sm.job[wDocIds]);
  const int* __restrict__ pos_offsets = reinterpret_cast<const int*>(sm.job[wPosOffsets]);
  const int* __restrict__ positions = reinterpret_cast<const int*>(sm.job[wPositions]);
  const float* __restrict__ doc_lens = reinterpret_cast<const float*>(sm.job[wDocLens]);
  const long long* __restrict__ slots = table + sm.job[wSlots];
  const int n_slots = (int)sm.job[wNSlots];
  const int flags = (int)sm.job[wFlags];
  const bool ordered = (flags & kOrdered) != 0;
  const int slop = (int)sm.job[wSlop], end = (int)sm.job[wEnd];
  const int block0 = (int)sm.job[wBlock0];
  const int p_begin = (int)sm.job[wPBegin], p_count = (int)sm.job[wPCount];
  const int p_lo = p_begin + (b - block0) * kChunk;
  const int p_hi = min(p_lo + kChunk, p_begin + p_count);
  const int n_pos = p_hi - p_lo;
  const int e0 = (int)sm.job[wRow0], e1 = (int)sm.job[wRow1];
  // the window of entries: around the estimate from the row's mean
  // positions an entry, within the row
  const int guess = e0 + (int)((long long)(p_lo - p_begin) * (e1 - e0) / p_count);
  const int ws = max(e0, min(guess - kMargin, e1 - kWindow));
  const int n_win = min(kWindow, e1 - ws);
  if (tid == 0) {
    const int wp = window_bytes(positions + p_lo, 4ll * n_pos);
    bar_expect(&sm.bars[0], wp);
    copy_window(sm.pos, positions + p_lo, wp, &sm.bars[0]);
    const int wd = window_bytes(doc_ids + ws, 4ll * n_win);
    const int wo = window_bytes(pos_offsets + ws, 4ll * (n_win + 1));
    bar_expect(&sm.bars[1], wd + wo);
    copy_window(sm.doc, doc_ids + ws, wd, &sm.bars[1]);
    copy_window(sm.off, pos_offsets + ws, wo, &sm.bars[1]);
  }
  if (tid < min(n_slots, kSlotCache) * kSlotWords)  // the slots' words, meanwhile
    sm.slot[tid / kSlotWords][tid % kSlotWords] = (int)slots[tid];
  const int* s_pos = sm.pos + (window_skip(positions + p_lo) >> 2);  // [0, n_pos)
  const int* w_doc = sm.doc + (window_skip(doc_ids + ws) >> 2);      // [0, n_win)
  const int* w_off = sm.off + (window_skip(pos_offsets + ws) >> 2);  // [0, n_win]
  bar_wait(&sm.bars[1], 0);
  if (tid < 2) {  // the entries holding the first and the last position, if in the window
    const int i = last_at_most(w_off, n_win + 1, tid ? p_hi - 1 : p_lo);
    sm.entry[tid] = ws + i;
    if (i < 0 || i >= n_win) sm.entry[2] = 1;
  }
  __syncthreads();
  QPHASE(1);
  const int* s_doc;
  const int* s_off;
  int ea = sm.entry[0];
  if (sm.entry[2]) {  // search the row, then copy the block's entries
    const int2 e = block_lower_bounds(pos_offsets, e0, e1 + 1, p_lo + 1, p_hi);
    ea = e.x - 1;
    const int n = e.y - e.x + 1;
    if (tid == 0) {
      sm.entry[1] = e.y - 1;
      const int wd = window_bytes(doc_ids + ea, 4ll * n);
      const int wo = window_bytes(pos_offsets + ea, 4ll * (n + 1));
      bar_expect(&sm.bars[1], wd + wo);
      copy_window(sm.doc, doc_ids + ea, wd, &sm.bars[1]);
      copy_window(sm.off, pos_offsets + ea, wo, &sm.bars[1]);
    }
    bar_wait(&sm.bars[1], 1);
    s_doc = sm.doc + (window_skip(doc_ids + ea) >> 2);
    s_off = sm.off + (window_skip(pos_offsets + ea) >> 2);
    __syncthreads();
  } else {
    s_doc = w_doc + (ea - ws);
    s_off = w_off + (ea - ws);
  }
  const int n_ent = sm.entry[1] - ea + 1;  // <= kChunk: every entry holds a position
  if (flags & kScored)  // read now, used at the end
    for (int e = tid; e < n_ent; e += kThreads) sm.dl[e] = __ldg(doc_lens + s_doc[e]);
  bar_wait(&sm.bars[0], 0);
  QPHASE(2);

  // this thread's positions, their entries (local) and their state
  const int i0 = tid * kPerThread;
  int v[kPerThread], own[kPerThread], prev[kPerThread];
  unsigned alive = 0;
  {
    int o = max(0, last_at_most(s_off, n_ent, p_lo + i0));
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      own[k] = o;
      v[k] = prev[k] = 0;
      if (i0 + k < n_pos) {
        while (s_off[o + 1] <= p_lo + i0 + k) ++o;
        own[k] = o;
        v[k] = prev[k] = s_pos[i0 + k];
        if (!kSpan || v[k] < end) alive |= 1u << k;
      }
    }
  }
  QPHASE(3);

  for (int j = 1; j < n_slots; ++j) {
    int r0, r1, shift;
    if (j < kSlotCache) {
      r0 = sm.slot[j][0];
      r1 = sm.slot[j][1];
      shift = sm.slot[j][2];
    } else {
      r0 = (int)slots[j * kSlotWords];
      r1 = (int)slots[j * kSlotWords + 1];
      shift = (int)slots[j * kSlotWords + 2];
    }
    const bool same = r0 == e0 && r1 == e1;  // the anchor's own row
    // where shared memory holds the slot's positions: [lo, hi) of
    // `positions` at `held` (the block's run on the anchor's row, else
    // the slot window's positions when they fit the tile)
    const int* held = s_pos;
    int lo = p_lo, hi = p_hi;
    if (!same) {
      lo = slot_entries(sm, r0, r1, doc_ids, pos_offsets, positions, s_doc, n_ent);
      hi = lo < 0 ? -1 : lo + kTile;
      held = sm.tile;
    }
    QPHASE(4);
    auto at = [&](int q) -> int {
      return (q >= lo && q < hi) ? held[q - lo] : __ldg(positions + q);
    };
    // the first index of [q, q1) whose position is >= t (q1 if none): a
    // few steps forward, then a binary search
    auto seek = [&](int q, int q1, int t) -> int {
      for (int n = 0; n < 4 && q < q1; ++n, ++q)
        if (at(q) >= t) return q;
      int c = q1;
      while (q < c) {
        const int m = (q + c) >> 1;
        if (at(m) < t) q = m + 1; else c = m;
      }
      return q;
    };
    int cur = -1, q = 0, q0 = 0, q1 = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (!((alive >> k) & 1u)) continue;
      // the first position of the entry at or after t
      const int t = !kSpan ? v[k] + shift : ordered ? prev[k] + 1 : v[k];
      if (own[k] != cur) {  // a new entry
        cur = own[k];
        if (same) {  // the anchor's own entry: when t >= v, from this position on
          q0 = s_off[cur];
          q1 = s_off[cur + 1];
          q = t >= v[k] ? p_lo + i0 + k : q0;
        } else {
          q = q0 = sm.ent_lo[cur];
          q1 = sm.ent_hi[cur];
        }
      }
      q = seek(q, q1, t);
      bool ok;
      if (!kSpan) {
        ok = q < q1 && at(q) == t;
      } else if (ordered) {
        ok = q < q1;
        if (ok) prev[k] = at(q);
      } else {  // the nearest occurrence either side, never the anchor itself for one term
        int best = kPosBase;
        for (int c = q - 1; c <= q + 1; ++c) {
          if (c < q0 || c >= q1) continue;
          const int x = at(c);
          if ((flags & kSameTerm) && x == v[k]) continue;
          const int gap = (x > v[k] ? x - v[k] : v[k] - x) - 1;
          best = gap < best ? gap : best;
        }
        ok = best <= slop;
      }
      if (!ok) alive &= ~(1u << k);
    }
    QPHASE(5);
  }
  if (kSpan && ordered && n_slots > 1) {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k)
      if ((long long)prev[k] - v[k] - (n_slots - 1) > slop) alive &= ~(1u << k);
  }

  // each entry's count: runs of a thread's positions, then across blocks
  __syncthreads();  // the last slot's reads of the tile are done
  int* count = sm.tile;
  for (int e = tid; e < n_ent; e += kThreads) count[e] = 0;
  __syncthreads();
  {
    int run = own[0], c = 0;
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (i0 + k >= n_pos) break;
      if (own[k] != run) {
        if (c) atomicAdd(&count[run], c);
        run = own[k];
        c = 0;
      }
      c += (alive >> k) & 1u;
    }
    if (c) atomicAdd(&count[run], c);
  }
  __syncthreads();
  QPHASE(6);
  const long long out = sm.job[wOut];
  const float weight = __int_as_float((int)(sm.job[wScoring] & 0xffffffffll));
  const float avgdl = __int_as_float((int)(sm.job[wScoring] >> 32));
  for (int e = tid; e < n_ent; e += kThreads) {
    int c = count[e];
    const int bf = (s_off[e] - p_begin) / kChunk;
    const int bl = (s_off[e + 1] - 1 - p_begin) / kChunk;
    if (bf != bl) {  // the entry spans blocks bf..bl: the last to arrive writes
      int* pair = scratch + 2ll * (block0 + bf);
      atomicAdd(pair, c);
      __threadfence();
      if (atomicAdd(pair + 1, 1) != bl - bf) continue;
      __threadfence();
      c = atomicAdd(pair, 0);
    }
    if (c > 0) {
      const int d = s_doc[e];
      matched[out + d] = 1;
      if (flags & kScored) scores[out + d] = bm25(c, sm.dl[e], weight, avgdl);
    }
  }
  QPHASE(7);
}

// K8: a job's slot 0 is the phrase's rarest slot, each slot's shift its
// position minus the anchor's.
__global__ void __launch_bounds__(kThreads, POS_MIN_BLOCKS)
phrase_scores_kernel(const long long* __restrict__ table, int n_jobs, float* __restrict__ scores,
                     unsigned char* __restrict__ matched, int* __restrict__ scratch) {
  positional_block<false>(table, n_jobs, scores, matched, scratch);
}

// K9: slot 0 is clause 0.  ordered: the greedy chain, accepted when
// last - first - (n_slots - 1) <= slop; unordered (2 slots): the nearest
// occurrence of slot 1 either side, |gap| - 1 <= slop (2^22 when the doc
// has none), never the anchor itself when both clauses are one term.
// Every mode drops an anchor at or past `end`.
__global__ void __launch_bounds__(kThreads, POS_MIN_BLOCKS)
span_scores_kernel(const long long* __restrict__ table, int n_jobs, float* __restrict__ scores,
                   unsigned char* __restrict__ matched, int* __restrict__ scratch) {
  positional_block<true>(table, n_jobs, scores, matched, scratch);
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// One launch of K8 (span 0) or K9 (span 1) over the launch table
// `table` (device memory: n_jobs jobs of POS_JOB_WORDS words, then their
// slots) in n_blocks blocks, writing `scores` / `matched`, which the
// caller zeroed with `scratch` (two ints a block).  Returns the CUDA
// error of the launch (0 on success).
int positions_launch(int span, const long long* table, int n_jobs, long long n_blocks,
                     float* scores, unsigned char* matched, int* scratch, void* stream) {
  if (n_blocks <= 0) return 0;
  if (n_jobs < 1 || n_blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = (int)sizeof(Shared);
  static bool sized = false;  // above 48 KB only once allowed (an idempotent call)
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(phrase_scores_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(span_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  if (span)
    span_scores_kernel<<<(unsigned)n_blocks, kThreads, smem, s>>>(table, n_jobs, scores, matched,
                                                                  scratch);
  else
    phrase_scores_kernel<<<(unsigned)n_blocks, kThreads, smem, s>>>(table, n_jobs, scores,
                                                                    matched, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
