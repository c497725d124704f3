// K8 and K9 on Hopper: per-doc phrase and span-near frequencies over a
// segment's positions.
//
// K8 `phrase_freqs_kernel` replaces the JAX package's `phrase_freqs`
// (opensearch_tpu/ops/phrase.py:49, with `gather_term_positions` at :27);
// K9 `span_near_kernel` replaces its `span_near_freqs`
// (opensearch_tpu/ops/span.py:32).  The reference gathers a power-of-two
// budget of int64 (doc, position) keys for every slot and runs a
// `searchsorted` for every occurrence of the anchor over each other slot's
// keys.  Here the anchor's posting entries (one doc each) are the work:
//
// - a thread per posting entry of the anchor term (slot 0 of the table);
// - for each other slot, the doc's entry in that slot's term row is found
//   once by binary search of the doc-ascending `doc_ids` (the first
//   kCachedSlots entries are kept in the thread's local array, later ones
//   are searched again per position, so the slot count has no cap);
// - for each anchor position, a binary search of that entry's positions:
//   K8 for `position + shift[j]` (the anchor is the slot with the fewest
//   positions; `shift[j]` is slot j's offset from it, negative for a slot
//   before it); K9 ordered for the smallest position after the previous
//   clause's match, K9 unordered for the nearest occurrence either side;
// - the thread writes its doc's count once, as a float: a doc appears once
//   in a term's row, so no two threads share an output and the result is
//   the same in any order.  The wrapper zeroes `tf` before the launch.
//
// (doc, position) pairs compare as the reference's keys `doc * 2^22 +
// position` do while every position plus its offset is below 2^22.
//
// Bound on the card: memory.  The anchor's doc ids, position offsets and
// positions are read once; a search reads about log2(row) doc ids and
// log2(entry) positions of another slot, and the [n_pad] float output is
// written once (most of it by the zeroing).
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCachedSlots = 8;
constexpr int kSlotWords = 3;         // table words per slot: {row start, row end, shift}
constexpr long long kPosBase = 1ll << 22;  // the reference's gap when nothing is near

// The first index in [lo, hi) whose value is >= x (> x when kRight), hi if none.
template <bool kRight>
__device__ __forceinline__ long long bound(const int* __restrict__ a, long long lo, long long hi,
                                           long long x) {
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    const long long v = __ldg(a + mid);
    if (kRight ? v <= x : v < x)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// The posting entry of `doc` in the doc-ascending row [r0, r1), -1 if none.
__device__ __forceinline__ long long find_entry(const int* __restrict__ doc_ids, long long r0,
                                                long long r1, int doc) {
  const long long e = bound<false>(doc_ids, r0, r1, doc);
  return (e < r1 && __ldg(doc_ids + e) == doc) ? e : -1;
}

// Slot j's entry for `doc`: from the thread's cache for the first slots.
__device__ __forceinline__ long long slot_entry(const long long* __restrict__ table,
                                                const long long* cache, int j,
                                                const int* __restrict__ doc_ids, int doc) {
  if (j < kCachedSlots) return cache[j];
  return find_entry(doc_ids, table[j * kSlotWords], table[j * kSlotWords + 1], doc);
}

// Finds every slot's entry for `doc` (slots 1..n_slots-1, the first
// kCachedSlots kept in `cache`); false when one is missing.
__device__ __forceinline__ bool find_slots(const long long* __restrict__ table, int n_slots,
                                           const int* __restrict__ doc_ids, int doc,
                                           long long* cache) {
  for (int j = 1; j < n_slots; ++j) {
    const long long e =
        find_entry(doc_ids, table[j * kSlotWords], table[j * kSlotWords + 1], doc);
    if (e < 0) return false;
    if (j < kCachedSlots) cache[j] = e;
  }
  return true;
}

// table (int64): n_slots entries of {row start, row end, shift}; slot 0 is
// the anchor, whose row holds n_anchor entries.
__global__ void __launch_bounds__(kThreads)
phrase_freqs_kernel(const long long* __restrict__ table, int n_slots,
                    const int* __restrict__ doc_ids, const int* __restrict__ pos_offsets,
                    const int* __restrict__ positions, float* __restrict__ tf,
                    long long n_anchor) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_anchor) return;
  const long long e0 = table[0] + i;
  const int doc = __ldg(doc_ids + e0);
  long long cache[kCachedSlots];
  if (!find_slots(table, n_slots, doc_ids, doc, cache)) return;  // tf stays 0
  int count = 0;
  const int p1 = __ldg(pos_offsets + e0 + 1);
  for (int p = __ldg(pos_offsets + e0); p < p1; ++p) {
    const long long pos = __ldg(positions + p);
    bool ok = true;
    for (int j = 1; j < n_slots && ok; ++j) {
      const long long e = slot_entry(table, cache, j, doc_ids, doc);
      const long long target = pos + table[j * kSlotWords + 2];
      const long long q1 = __ldg(pos_offsets + e + 1);
      const long long k = bound<false>(positions, __ldg(pos_offsets + e), q1, target);
      ok = k < q1 && __ldg(positions + k) == target;
    }
    count += ok;
  }
  tf[doc] = (float)count;
}

// K9: slot 0 is clause 0.  ordered: the greedy chain, accepted when
// last - first - (n_slots - 1) <= slop; unordered (2 slots): the nearest
// occurrence of slot 1 either side, |gap| - 1 <= slop, never the anchor
// itself when `same_term`.  Every mode drops an anchor at or past `end`.
__global__ void __launch_bounds__(kThreads)
span_near_kernel(const long long* __restrict__ table, int n_slots,
                 const int* __restrict__ doc_ids, const int* __restrict__ pos_offsets,
                 const int* __restrict__ positions, float* __restrict__ tf,
                 long long n_anchor, int ordered, int slop, int end, int same_term) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_anchor) return;
  const long long e0 = table[0] + i;
  const int doc = __ldg(doc_ids + e0);
  long long cache[kCachedSlots];
  long long q0 = 0, q1 = 0;  // unordered: slot 1's positions in this doc
  if (ordered) {
    if (!find_slots(table, n_slots, doc_ids, doc, cache)) return;
  } else {
    // no entry: every anchor keeps the gap kPosBase, as in the reference
    const long long e = find_entry(doc_ids, table[kSlotWords], table[kSlotWords + 1], doc);
    if (e >= 0) {
      q0 = __ldg(pos_offsets + e);
      q1 = __ldg(pos_offsets + e + 1);
    }
  }
  int count = 0;
  const int p1 = __ldg(pos_offsets + e0 + 1);
  for (int p = __ldg(pos_offsets + e0); p < p1; ++p) {
    const long long pos = __ldg(positions + p);
    if (pos >= end) break;  // positions ascend within the entry
    bool ok;
    if (ordered) {
      long long prev = pos;
      ok = true;
      for (int j = 1; j < n_slots && ok; ++j) {
        const long long e = slot_entry(table, cache, j, doc_ids, doc);
        const long long r1 = __ldg(pos_offsets + e + 1);
        const long long k = bound<true>(positions, __ldg(pos_offsets + e), r1, prev);
        ok = k < r1;
        if (ok) prev = __ldg(positions + k);
      }
      ok = ok && (n_slots == 1 || prev - pos - (n_slots - 1) <= slop);
    } else {
      const long long near = bound<false>(positions, q0, q1, pos);
      long long best = kPosBase;
      for (long long c = near - 1; c <= near + 1; ++c) {
        if (c < q0 || c >= q1) continue;
        const long long x = __ldg(positions + c);
        if (same_term && x == pos) continue;
        const long long gap = (x > pos ? x - pos : pos - x) - 1;
        best = gap < best ? gap : best;
      }
      ok = best <= slop;
    }
    count += ok;
  }
  tf[doc] = (float)count;
}

inline int blocks_for(long long n) { return (int)((n + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// K8 over one segment: `table` (device memory, n_slots * 3 int64 words,
// layout above), the staged columns, and tf [n_pad] float zeroed by the
// caller.  Returns the CUDA error of the launch (0 on success).
int phrase_freqs_launch(const long long* table, int n_slots, const int* doc_ids,
                        const int* pos_offsets, const int* positions, float* tf,
                        long long n_anchor, void* stream) {
  if (n_anchor <= 0) return 0;
  if (n_slots < 1 || n_anchor > (long long)INT_MAX * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  phrase_freqs_kernel<<<blocks_for(n_anchor), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n_slots, doc_ids, pos_offsets, positions, tf, n_anchor);
  return static_cast<int>(cudaGetLastError());
}

// K9 over one segment, as K8; `ordered` 0 takes exactly 2 slots.
int span_near_launch(const long long* table, int n_slots, const int* doc_ids,
                     const int* pos_offsets, const int* positions, float* tf, long long n_anchor,
                     int ordered, int slop, int end, int same_term, void* stream) {
  if (n_anchor <= 0) return 0;
  if (n_slots < 1 || (!ordered && n_slots != 2) || n_anchor > (long long)INT_MAX * kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  span_near_kernel<<<blocks_for(n_anchor), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n_slots, doc_ids, pos_offsets, positions, tf, n_anchor, ordered, slop, end,
      same_term);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
