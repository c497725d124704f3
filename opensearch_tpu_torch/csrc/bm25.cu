// K2: term-bag impact scoring on Hopper.
//
// Replaces the JAX package's `gather_postings` + `impact_scores` /
// `impact_score_count` / `match_count` (opensearch_tpu/ops/bm25.py:83,
// :191, :206, :225), XLA ops there, not Pallas kernels: a searchsorted
// flatten of the query terms' CSR rows into `budget` lanes, then a
// scatter-add of w[slot] * (idf[slot] * imp[p]) into dense float32
// scores[n_pad] and of 1 into int32 counts[n_pad]; and, on the `match`
// path, the `run_topk` after them (opensearch_tpu/search/plan.py:1760):
// live and min_score masks, the top-k with the lower doc id first on
// ties, the matched total and the largest matched score.
//
// Two entries:
//   term_bag_topk_segments_launch  one launch per `match` query over every
//                                  segment of a shard: each segment's
//                                  exact top-k, total and max, and no
//                                  dense score in device memory.  (The
//                                  batched path has its own kernel, K3,
//                                  csrc/union_topk.cu.)
//   term_bag_dense_launch          the dense scores and/or counts of one
//                                  term bag over every segment of a
//                                  request in one launch per row layout
//                                  (bool, constant_score, count, filter
//                                  bags, postings_mask, the k-NN filter):
//                                  the same tile core, a block per
//                                  (segment, tile of kFoldTile docs),
//                                  each tile's columns written once from
//                                  shared memory into the request's
//                                  arena.
//
// The quantized row layout (the dense entry's QuantRows instantiations, K4's per-slot entry)
// replaces the reference's `gather_postings_packed` and `_dequant` /
// `quantized_impact_scores` / `quantized_impact_score_count`
// (opensearch_tpu/ops/bm25.py:114, opensearch_tpu/ops/quantized.py:30,46,64):
// on a segment that index/codec.py quantizes, posting p's doc is base[term]
// plus a `width`-bit delta packed in uint32 words, and its impact is an
// int8/int16 code times the term's scale, or the term's exact f32 impact
// where the rank-parity guard stored one.  Every entry reads rows through
// one row reader (F32Rows, QuantRows<int8_t>, QuantRows<int16_t>), a
// template parameter, so the f32 instantiation that K2 runs carries no
// branch and no register of the quantized layout.  K4's top-k entry has
// its own kernel (csrc/quant_topk.cu); the top-k kernel's quantized
// instantiation (term_bag_topk_quantized_launch) is kept only as its
// yardstick in testing/k4_sweep.py.
//
// Bound on the card: memory.  Per posting of an active term the work
// reads a 4-byte doc id and a 4-byte impact and does 2 multiplies and an
// add.  The top-k entry also reads one live byte per doc and writes k * 8
// + 8 bytes per segment, so its bound is (8 * postings + n_pad + 8k + 8)
// / 3.35 TB/s per segment; the dense entry writes n_pad * 4 bytes per
// column instead, and in counts-only mode reads the 4-byte doc id alone.
// On the quantized layout a posting reads width / 8 bytes of packed delta
// and 1 or 2 bytes of code, or 4 bytes of exact impact on a guarded term.
//
// Exactness: per doc the contributions add in slot order from 0.0, each
// spelled w * (idf * imp) with __fmul_rn / __fadd_rn, and the library is
// built with -fmad=false (no FMA contraction, which would round
// differently): the reference's per-doc accumulation, byte for byte.  Doc
// ids are unique within a row (rows are doc-ascending, checked at
// staging), so within one slot no two threads touch one doc.  A quantized
// impact is __fmul_rn((float)q, scale), the reference's
// `q.astype(f32) * scale`: K4 equals K2 fed QuantizedPostings.dequantized(),
// byte for byte.  Quantized codes are at least 1, so scores > 0 still
// means matched on the fast path.
//
// Design of the top-k entry:
// - A block owns a tile of kTile docs of one segment: their scores (and
//   matched-slot counts, off the fast path) live in shared memory.  A
//   per-query table, one pinned host-to-device copy, names each
//   segment's pointers and n_pad and each active slot's posting range,
//   idf and weight; a work list names (segment, tile) per block.
// - For each group of up to eight slots, warp w finds where slot w's row
//   enters and leaves the tile: its two half-warps each run a 16-ary
//   search (16 evenly spaced ids a round), about 4 dependent loads for a
//   row of 62,500 postings where a binary search takes 16.  On the
//   quantized layout each probe decodes base + delta (deltas ascend
//   within a row as the ids do); the term's base, scale and exact range
//   come from the launch table, so no probe waits on a per-term load.  Then the
//   block adds the slots' postings into shared memory one slot after the
//   other, a barrier between slots: slot order per doc, no atomics.
// - Epilogue in the same block: matched = scores > 0 on the fast path
//   (required == 1, all w and idf > 0), else counts >= required; then &
//   live & scores >= min_score.  The total is an integer atomicAdd per
//   segment (exact in any order), the max an atomicMax on orderable bits.
//   Each doc becomes the key of topk.cuh (score, then lower doc id; 0
//   when unmatched), the tile keeps its best kp (`select_top`), and the
//   last tile of a segment to finish merges them (`merge_segment`) and
//   writes the segment's row of the output: no second launch.
//
// Design of the dense entry (term_bag_dense_launch): the top-k entry's
// table and work list, built on the host in one go and sent by one pinned
// copy: per segment its row pointers, n_pad and the offset of its columns
// in the request's output arena; per active slot its posting range, idf
// and weight (and, quantized, its term's base, scale and exact range).  No
// block loads a term id or a CSR offset.  Block b owns the (segment, tile)
// of work word b, kFoldTile docs; for each group of eight slots, eight
// warps find the slots' sub-ranges of the tile (group_lower_bound) and the
// block adds them into shared memory in slot order, a barrier between
// slots; then the tile's scores and counts, zeros included, go to device
// memory in one coalesced pass, so the output needs no memset.  A segment
// with no active slot (the field absent, every term missing) still gets its
// zero columns.  Counts-only mode (match_count, postings_mask) reads no
// impact.  The per-segment kernel it replaced (term_bag_fold_kernel, which
// read term ids, active flags and CSR offsets from the caller's device
// arrays) is built only with -DBM25_OLD_FOLD, into testing/k2_sweep.py's
// library, as its yardstick.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "topk.cuh"

namespace {

// The wrapper (ops/cuda_bm25.py) owns the launch table's layout and the
// tile decision and passes them in with -D: docs per block of the top-k
// entry, the largest k it selects, int64 words per segment in the table
// (f32 and quantized) and per slot of a quantized table.
#if !defined(BM25_TILE_DOCS) || !defined(BM25_K_MAX) || !defined(BM25_SEG_WORDS) || \
    !defined(BM25_QSEG_WORDS) || !defined(BM25_QSLOT_WORDS) || !defined(BM25_FOLD_TILE_DOCS)
#error "build through ops/cuda_bm25.py, which defines BM25_TILE_DOCS, BM25_K_MAX, BM25_SEG_WORDS, BM25_QSEG_WORDS, BM25_QSLOT_WORDS, BM25_FOLD_TILE_DOCS"
#endif

using topk::u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = BM25_TILE_DOCS;
constexpr int kKMax = BM25_K_MAX;
constexpr int kPer = kTile / kThreads;  // docs of the tile each thread masks and keys
constexpr int kFoldTile = BM25_FOLD_TILE_DOCS;  // docs a block of the dense entry owns
// keys the merge reads per round; the merge buffer (kTile keys) holds
// the kp kept so far plus one round
constexpr int kMergeBatch = kTile / 2;
constexpr int kSearchLanes = 16;  // lanes of one search (a half-warp)
constexpr int kScatterLoads = 8;  // postings a thread loads at once
static_assert((kTile & (kTile - 1)) == 0 && kTile % kThreads == 0,
              "kTile: a power of two, a multiple of kThreads");
static_assert((kKMax & (kKMax - 1)) == 0 && kKMax <= kTile - kMergeBatch,
              "kKMax: a power of two the merge buffer holds beside one round");
static_assert((kFoldTile & (kFoldTile - 1)) == 0 && kFoldTile % kThreads == 0 &&
                  kFoldTile * 8 <= 48 * 1024,
              "kFoldTile: a power of two, a multiple of kThreads, its columns in static shared memory");
static_assert(BM25_SEG_WORDS >= 11, "an f32 segment's table entry holds 11 words");
static_assert(BM25_QSEG_WORDS >= 13, "a quantized segment's table entry holds 13 words");
static_assert(BM25_QSLOT_WORDS >= 4, "a quantized slot's table entry holds 4 words");

// Row readers: (doc, impact) of posting p of a term's row.  `Term` is what
// the reader needs of the term beyond its posting range; `from_entry`
// reads a segment's table entry, `read_term` a slot's.

// The f32 layout: doc ids and impacts, one 4-byte column each.
struct F32Rows {
  static constexpr int kSegWords = BM25_SEG_WORDS;
  static constexpr int kSlotWords = 2;
  struct Term {};
  const int32_t* __restrict__ ids;
  const float* __restrict__ imp;

  static __device__ F32Rows from_entry(const long long* e) {
    return {reinterpret_cast<const int32_t*>(e[0]), reinterpret_cast<const float*>(e[1])};
  }
  static __device__ Term read_term(const long long*, int) { return {}; }
  __device__ int doc(int p, const Term&) const { return __ldg(ids + p); }
  __device__ float impact(int p, const Term&) const { return __ldg(imp + p); }
};

// The quantized layout (index/codec.py): base[term] + a `width`-bit delta
// at bit p * width of `packed`, and code q of type Q times the term's
// scale, or exact_vals[e0 + (p - start)] on a term the parity guard kept
// exact.
template <typename Q>
struct QuantRows {
  static constexpr int kSegWords = BM25_QSEG_WORDS;
  static constexpr int kSlotWords = BM25_QSLOT_WORDS;
  struct Term {
    int32_t base;
    float scale;
    int32_t exact0;  // e0 - start: exact_vals index of posting p is exact0 + p
    bool exact;
  };
  const uint32_t* __restrict__ packed;
  const Q* __restrict__ qvals;
  const float* __restrict__ exact_vals;
  int width;

  static __device__ QuantRows from_entry(const long long* e) {
    return {reinterpret_cast<const uint32_t*>(e[0]), reinterpret_cast<const Q*>(e[1]),
            reinterpret_cast<const float*>(e[11]), (int)e[12]};
  }
  // slot words 2 and 3: {base | scale bits << 32, exact start | exact << 32}
  static __device__ Term read_term(const long long* sl, int start) {
    const u64 bs = (u64)sl[2], ex = (u64)sl[3];
    return {(int32_t)(bs & 0xFFFFFFFFull), __uint_as_float((unsigned)(bs >> 32)),
            (int32_t)(ex & 0xFFFFFFFFull) - start, (ex >> 32) != 0};
  }
  // p = 32a + b, so p * width = 32 * (a * width) + b * width: no int32
  // overflow at any posting count.  The two words as one u64, shifted by
  // at most 31; the guard word keeps w + 1 in bounds.
  __device__ int doc(int p, const Term& t) const {
    const int bit = (p & 31) * width;
    const int w = (p >> 5) * width + (bit >> 5);
    const u64 pair = ((u64)__ldg(packed + w + 1) << 32) | (u64)__ldg(packed + w);
    return t.base + (int)((unsigned)(pair >> (bit & 31)) & ((1u << width) - 1u));
  }
  __device__ float impact(int p, const Term& t) const {
    return t.exact ? __ldg(exact_vals + (t.exact0 + p)) : __fmul_rn((float)__ldg(qvals + p), t.scale);
  }
};

// First p in [lo, hi) with doc(p) >= target, else hi, over a row of
// ascending docs.  The kSearchLanes lanes of a group (lanes base ..  base
// + 15 of the warp, named by `mask`; lo, hi and target the same in each)
// probe 16 evenly spaced docs a round: each round cuts the range 16-fold,
// so a row of n postings takes about log16(n) + 1 dependent loads.
template <class Rows>
__device__ int group_lower_bound(const Rows& rows, const typename Rows::Term& term, int lo, int hi,
                                 int target, int g, int base, unsigned mask) {
  constexpr unsigned kAll = (1u << kSearchLanes) - 1;
  while (hi - lo > kSearchLanes) {
    const int step = (hi - lo + kSearchLanes - 1) / kSearchLanes;
    const int p = lo + (g + 1) * step - 1;  // the last id of piece g
    const bool ge = p >= hi || rows.doc(p, term) >= target;
    const unsigned b = (__ballot_sync(mask, ge) >> base) & kAll;
    if (b == 0) return hi;  // the last piece ends at hi - 1, below target
    const int f = __ffs(b) - 1;  // the answer lies in piece f
    hi = min(hi, lo + (f + 1) * step - 1);
    lo += f * step;
  }
  const int p = lo + g;
  const bool ge = p >= hi || rows.doc(p, term) >= target;
  const unsigned b = (__ballot_sync(mask, ge) >> base) & kAll;
  return b == 0 ? hi : min(hi, lo + __ffs(b) - 1);
}

// One query-term slot as the tile core reads it: its posting range
// [start, end), its idf and weight, and what the row reader needs of its
// term.  An inactive slot is the empty range.
template <class Rows>
struct Slot {
  int start, end;
  float idf, w;
  typename Rows::Term term;
};

// Slot j of a segment's run in the top-k entry's launch table (words
// {start | end << 32, idf bits | weight bits << 32, ...}).
template <class Rows>
struct TableSlots {
  const long long* words;  // the segment's first slot
  __device__ Slot<Rows> operator()(int j) const {
    const long long* sl = words + Rows::kSlotWords * j;
    const u64 range = (u64)sl[0], iw = (u64)sl[1];
    const int start = (int)(range & 0xFFFFFFFFull);
    return {start, (int)(range >> 32), __uint_as_float((unsigned)(iw & 0xFFFFFFFFull)),
            __uint_as_float((unsigned)(iw >> 32)), Rows::read_term(sl, start)};
  }
};

// The tile core: adds slots 0 .. n_slots - 1, in slot order, into the
// block's shared columns of the docs [doc0, doc0 + tile_docs): scores
// (w * (idf * imp), from 0.0) when add_scores, matched-slot counts when
// add_counts.  For each group of up to kWarps slots, warp w finds where
// slot w's row enters and leaves the tile (its two half-warps search
// the two bounds); then the block adds the slots' postings one slot
// after the other, a barrier between slots.  Doc ids are unique within
// a row, so no two threads touch one doc within a slot: no atomics.
// All threads of the block call it; it ends on a barrier.
template <class Rows, class Slots>
__device__ void accumulate_tile(const Rows& rows, const Slots& slots, int n_slots, int doc0,
                                int tile_docs, float* scores, int* counts, bool add_scores,
                                bool add_counts) {
  __shared__ int lo_s[kWarps], hi_s[kWarps];
  __shared__ float idf_s[kWarps], w_s[kWarps];
  __shared__ typename Rows::Term term_s[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int g = 0; g < n_slots; g += kWarps) {
    const int m = min(kWarps, n_slots - g);
    if (warp < m) {  // warp w: where slot g + w's row enters and leaves the tile
      const Slot<Rows> sl = slots(g + warp);
      const int half = lane >> 4;
      const int at = group_lower_bound(rows, sl.term, sl.start, sl.end, doc0 + half * tile_docs,
                                       lane & 15, half * 16, half ? 0xFFFF0000u : 0x0000FFFFu);
      if (lane == 0) {
        lo_s[warp] = at;
        idf_s[warp] = sl.idf;
        w_s[warp] = sl.w;
        term_s[warp] = sl.term;
      }
      if (lane == 16) hi_s[warp] = at;
    }
    __syncthreads();
    for (int j = 0; j < m; ++j) {  // slot order
      const int lo = lo_s[j], hi = hi_s[j];
      if (lo >= hi) continue;  // block-uniform
      const float idf = idf_s[j], w = w_s[j];
      const typename Rows::Term term = term_s[j];
      // kScatterLoads postings a thread are loaded before any is added,
      // so their loads are in flight together (a shared-memory store
      // between two loads through generic pointers keeps them in order)
      for (int base = lo; base < hi; base += kThreads * kScatterLoads) {
        int dd[kScatterLoads];
        float im[kScatterLoads];
#pragma unroll
        for (int u = 0; u < kScatterLoads; ++u) {
          const int p = base + tid + u * kThreads;
          dd[u] = p < hi ? rows.doc(p, term) - doc0 : -1;
          im[u] = add_scores && p < hi ? rows.impact(p, term) : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kScatterLoads; ++u) {
          if (dd[u] < 0) continue;
          if (add_scores)
            scores[dd[u]] = __fadd_rn(scores[dd[u]], __fmul_rn(w, __fmul_rn(idf, im[u])));
          if (add_counts) counts[dd[u]] += 1;
        }
      }
      __syncthreads();
    }
    __syncthreads();  // lo_s .. w_s are read before the next group overwrites them
  }
}

// The dense entry: block b owns the (segment, tile) of work word b, docs
// [tile * kFoldTile, (tile + 1) * kFoldTile) of that segment; it runs the
// tile core over the segment's slots from the table and writes the tile's
// scores and counts (either may be null) at the segment's offset in the
// output arena, zeros included.
//
// table (int64 words): n_seg entries of Rows::kSegWords {row pointers 0
// and 1, -, n_pad, -, -, output offset, first slot, slots, -, -}
// (quantized: then {exact_vals, width}); then Rows::kSlotWords words per
// active slot, as the top-k entry's; then the work list, one word per
// block, segment << 32 | tile.
template <class Rows>
__global__ void __launch_bounds__(kThreads)
term_bag_dense_kernel(const long long* __restrict__ table, int n_seg, int n_slots,
                      float* __restrict__ out_scores, int32_t* __restrict__ out_counts) {
  __shared__ float scores[kFoldTile];
  __shared__ int counts[kFoldTile];
  const long long* slots = table + (long long)n_seg * Rows::kSegWords;
  const long long wk = slots[(long long)Rows::kSlotWords * n_slots + blockIdx.x];
  const long long* e = table + (wk >> 32) * Rows::kSegWords;
  const int doc0 = (int)(wk & 0xFFFFFFFFll) * kFoldTile;
  const int docs = min(kFoldTile, (int)e[3] - doc0);
  const long long out = e[6] + doc0;
  const bool add_scores = out_scores != nullptr, add_counts = out_counts != nullptr;
  for (int i = threadIdx.x; i < kFoldTile; i += kThreads) {
    scores[i] = 0.0f;
    counts[i] = 0;
  }
  __syncthreads();
  accumulate_tile(Rows::from_entry(e), TableSlots<Rows>{slots + Rows::kSlotWords * e[7]}, (int)e[8],
                  doc0, kFoldTile, scores, counts, add_scores, add_counts);
  for (int i = threadIdx.x; i < docs; i += kThreads) {
    if (add_scores) out_scores[out + i] = scores[i];
    if (add_counts) out_counts[out + i] = counts[i];
  }
}

#ifdef BM25_OLD_FOLD
// The per-segment dense kernel the table form replaced (built only into
// testing/k2_sweep.py's library, as its yardstick): one launch per segment
// and call, each block loading term_active[j] -> term_ids[j] ->
// offsets[term] from the caller's device arrays before its search.
template <class Rows>
struct ArrayTerms {  // F32Rows: nothing beyond the posting range
  __device__ typename Rows::Term operator()(int32_t, int32_t) const { return {}; }
};
template <typename Q>
struct ArrayTerms<QuantRows<Q>> {
  const int32_t* __restrict__ base;
  const float* __restrict__ scales;
  const int32_t* __restrict__ exact_offsets;
  __device__ typename QuantRows<Q>::Term operator()(int32_t tid, int32_t start) const {
    const int32_t e0 = exact_offsets[tid];
    return {base[tid], scales[tid], e0 - start, exact_offsets[tid + 1] > e0};
  }
};

template <class Rows>
struct ArraySlots {
  ArrayTerms<Rows> terms;
  const int32_t* __restrict__ offsets;
  const int32_t* __restrict__ term_ids;
  const uint8_t* __restrict__ term_active;
  const float* __restrict__ idfs;
  const float* __restrict__ weights;
  __device__ Slot<Rows> operator()(int j) const {
    if (!term_active[j]) return {0, 0, 0.0f, 0.0f, typename Rows::Term{}};
    const int32_t tid = term_ids[j];
    const int32_t start = offsets[tid];
    return {start, offsets[tid + 1], idfs != nullptr ? idfs[j] : 0.0f,
            weights != nullptr ? weights[j] : 0.0f, terms(tid, start)};
  }
};

template <class Rows>
__global__ void __launch_bounds__(kThreads)
term_bag_fold_kernel(Rows rows, ArraySlots<Rows> slots, int t_pad, int n_pad,
                     float* __restrict__ out_scores, int32_t* __restrict__ out_counts) {
  __shared__ float scores[kFoldTile];
  __shared__ int counts[kFoldTile];
  const int doc0 = blockIdx.x * kFoldTile;
  const int docs = min(kFoldTile, n_pad - doc0);
  const bool add_scores = out_scores != nullptr, add_counts = out_counts != nullptr;
  for (int i = threadIdx.x; i < kFoldTile; i += kThreads) {
    scores[i] = 0.0f;
    counts[i] = 0;
  }
  __syncthreads();
  if (!add_scores) slots.idfs = slots.weights = nullptr;
  accumulate_tile(rows, slots, t_pad, doc0, kFoldTile, scores, counts, add_scores, add_counts);
  for (int i = threadIdx.x; i < docs; i += kThreads) {
    if (add_scores) out_scores[doc0 + i] = scores[i];
    if (add_counts) out_counts[doc0 + i] = counts[i];
  }
}

template <class Rows>
int fold_launch(Rows rows, ArraySlots<Rows> slots, int t_pad, int n_pad, float* scores,
                int32_t* counts, void* stream) {
  if (n_pad <= 0 || (scores == nullptr && counts == nullptr)) return 0;
  const int blocks = (n_pad + kFoldTile - 1) / kFoldTile;
  term_bag_fold_kernel<Rows><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, slots, t_pad, n_pad, scores, counts);
  return static_cast<int>(cudaGetLastError());
}
#endif  // BM25_OLD_FOLD

// table (int64 words): n_seg entries of Rows::kSegWords {doc_ids, impacts,
// live, n_pad, first tile, tiles, output row, first slot, slots,
// required, fast} (quantized: {packed, qvals, live, ..., fast,
// exact_vals, width}); then Rows::kSlotWords words per active slot, in
// slot order within each segment {start | end << 32, idf bits | weight
// bits << 32} (quantized: then {base | scale bits << 32, exact start |
// exact << 32}); then the work list (one word per block: segment << 32 |
// tile); then 3 * n_seg int32, zero on entry: the tile counters, the
// totals and the max keys of the segments.
template <class Rows>
__global__ void __launch_bounds__(kThreads)
term_bag_topk_kernel(const long long* __restrict__ table, int n_seg, int n_slots, int k, int kp,
                     float min_score, float* __restrict__ out_vals, int* __restrict__ out_ids,
                     int* __restrict__ out_totals, float* __restrict__ out_maxes,
                     u64* __restrict__ scratch) {
  extern __shared__ __align__(16) char smem[];  // kTile * 8 bytes
  float* scores = reinterpret_cast<float*>(smem);
  int* counts = reinterpret_cast<int*>(smem + kTile * 4);
  u64* keys = reinterpret_cast<u64*>(smem);  // over scores and counts, once they are read
  const long long* slots = table + (long long)n_seg * Rows::kSegWords;
  const long long* work = slots + (long long)Rows::kSlotWords * n_slots;
  int* counters = reinterpret_cast<int*>(const_cast<long long*>(work + gridDim.x));
  const long long wk = work[blockIdx.x];
  const int seg = (int)(wk >> 32);
  const int tile = (int)(wk & 0xFFFFFFFFll);
  const long long* e = table + (long long)seg * Rows::kSegWords;
  const Rows rows = Rows::from_entry(e);
  const uint8_t* live = reinterpret_cast<const uint8_t*>(e[2]);
  const int n_pad = (int)e[3];
  const long long first = e[4];
  const int n_tiles = (int)e[5];
  const long long out_row = e[6];
  const long long slot0 = e[7];
  const int seg_slots = (int)e[8];
  const int required = (int)e[9];
  const bool fast = e[10] != 0;
  int* total = counters + n_seg + seg;
  unsigned* max_key = reinterpret_cast<unsigned*>(counters + 2 * n_seg + seg);
  const int tid = threadIdx.x, lane = tid & 31;
  const int doc0 = tile * kTile;
  const int docs = min(kTile, n_pad - doc0);

  // the tile's live bytes, in flight while the rows are searched
  uint8_t lv[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = tid + i * kThreads;
    lv[i] = d < docs ? __ldg(live + doc0 + d) : 0;
  }
  for (int i = tid; i < kTile; i += kThreads) {
    scores[i] = 0.0f;
    counts[i] = 0;
  }

  accumulate_tile(rows, TableSlots<Rows>{slots + Rows::kSlotWords * slot0}, seg_slots, doc0,
                  kTile, scores, counts, true, !fast);

  float sc[kPer];
  bool hit[kPer];
  int cnt = 0;
  unsigned mx = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = tid + i * kThreads;
    sc[i] = scores[d];
    const bool matched = fast ? sc[i] > 0.0f : counts[d] >= required;
    hit[i] = d < docs && lv[i] && matched && sc[i] >= min_score;
    cnt += hit[i];
    if (hit[i]) mx = max(mx, topk::orderable(sc[i]));
  }
  __syncthreads();  // scores and counts are read: keys overwrite them
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = tid + i * kThreads;
    keys[d] = hit[i] ? topk::make_key(sc[i], doc0 + d) : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  }
  if (lane == 0 && cnt > 0) {
    atomicAdd(total, cnt);
    atomicMax(max_key, mx);
  }
  __syncthreads();
  topk::select_top<kThreads, kTile>(keys, kp);
  if (!topk::finish_segment<kThreads, kTile, kMergeBatch>(keys, kp, scratch, first, tile, n_tiles,
                                                         counters + seg))
    return;
  topk::write_topk<kThreads>(keys, k, out_vals + out_row * k, out_ids + out_row * k);
  if (tid == 0) {  // every tile's atomics are in: read them coherently
    const unsigned key = atomicMax(max_key, 0u);
    out_totals[out_row] = atomicAdd(total, 0);
    out_maxes[out_row] = key == 0 ? -INFINITY : topk::from_orderable(key);
  }
}

template <class Rows>
int dense_launch(const long long* table, int n_seg, int n_slots, int n_blocks, float* scores,
                 int32_t* counts, void* stream) {
  if (n_blocks <= 0 || (scores == nullptr && counts == nullptr)) return 0;
  term_bag_dense_kernel<Rows><<<n_blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, n_seg, n_slots, scores, counts);
  return static_cast<int>(cudaGetLastError());
}

template <class Rows>
int topk_launch(const long long* table, int n_seg, int n_slots, int n_blocks, int k, int kp,
                float min_score, float* out_vals, int* out_ids, int* out_totals, float* out_maxes,
                u64* scratch, void* stream) {
  if (n_blocks <= 0) return 0;
  if (k < 1 || k > kp || kp > kKMax || (kp & (kp - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr size_t smem = (size_t)kTile * 8;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        term_bag_topk_kernel<Rows>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  term_bag_topk_kernel<Rows><<<n_blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      table, n_seg, n_slots, k, kp, min_score, out_vals, out_ids, out_totals, out_maxes, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// Dense scores and/or matched-slot counts of a term bag over every
// segment of `table` (device memory, layout at term_bag_dense_kernel;
// n_blocks words in its work list), in one launch of
// term_bag_dense_kernel: each segment's n_pad docs written at its output
// offset of `scores` / `counts`, zeros included.  Either may be null to
// skip that column (no impact is read without `scores`).  q_bytes picks the
// row layout of every segment of the table: 0 f32 doc ids and impacts, 1
// int8 or 2 int16 quantized codes.  Returns the CUDA error of the launch
// (0 on success).
int term_bag_dense_launch(const long long* table, int n_seg, int n_slots, int n_blocks, int q_bytes,
                          float* scores, int32_t* counts, void* stream) {
  if (q_bytes == 0)
    return dense_launch<F32Rows>(table, n_seg, n_slots, n_blocks, scores, counts, stream);
  if (q_bytes == 1)
    return dense_launch<QuantRows<int8_t>>(table, n_seg, n_slots, n_blocks, scores, counts,
                                           stream);
  if (q_bytes == 2)
    return dense_launch<QuantRows<int16_t>>(table, n_seg, n_slots, n_blocks, scores, counts,
                                            stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef BM25_OLD_FOLD
// The replaced per-segment route (testing/k2_sweep.py only): one segment's
// dense columns in one launch of term_bag_fold_kernel, slot j's term
// term_ids[j] (active when term_active[j] != 0), its row offsets[term] ..
// offsets[term + 1] of doc_ids / impacts.
int term_bag_launch(const int32_t* offsets, const int32_t* doc_ids, const float* impacts,
                    const int32_t* term_ids, const uint8_t* term_active, const float* idfs,
                    const float* weights, int t_pad, int n_pad, float* scores, int32_t* counts,
                    void* stream) {
  return fold_launch(F32Rows{doc_ids, impacts},
                     ArraySlots<F32Rows>{{}, offsets, term_ids, term_active, idfs, weights},
                     t_pad, n_pad, scores, counts, stream);
}

// term_bag_launch over a quantized segment: `packed` at `width` bits with
// its guard word, `base` / `scales` / `exact_offsets` per term, `qvals`
// q_bytes-wide codes (1: int8, 2: int16), `exact_vals` the guarded terms'
// f32 impacts.
int term_bag_quantized_launch(const int32_t* offsets, const uint32_t* packed, const int32_t* base,
                              int width, const void* qvals, int q_bytes, const float* scales,
                              const float* exact_vals, const int32_t* exact_offsets,
                              const int32_t* term_ids, const uint8_t* term_active,
                              const float* idfs, const float* weights, int t_pad, int n_pad,
                              float* scores, int32_t* counts, void* stream) {
  if (width < 1 || width > 31) return static_cast<int>(cudaErrorInvalidValue);
  if (q_bytes == 1)
    return fold_launch(
        QuantRows<int8_t>{packed, static_cast<const int8_t*>(qvals), exact_vals, width},
        ArraySlots<QuantRows<int8_t>>{{base, scales, exact_offsets}, offsets, term_ids,
                                      term_active, idfs, weights},
        t_pad, n_pad, scores, counts, stream);
  if (q_bytes == 2)
    return fold_launch(
        QuantRows<int16_t>{packed, static_cast<const int16_t*>(qvals), exact_vals, width},
        ArraySlots<QuantRows<int16_t>>{{base, scales, exact_offsets}, offsets, term_ids,
                                       term_active, idfs, weights},
        t_pad, n_pad, scores, counts, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
#endif  // BM25_OLD_FOLD

// Exact top-k, total and max of every segment of `table` (device memory,
// layout above, n_blocks entries in its work list) into rows of
// out_vals/out_ids [*, k] and out_totals/out_maxes [*]; scratch holds
// n_blocks * kp keys.  min_score is -inf when unset.  Returns the CUDA
// error of the launch (0 on success); faults surface at the caller's
// next sync.
int term_bag_topk_segments_launch(const long long* table, int n_seg, int n_slots, int n_blocks,
                                  int k, int kp, float min_score, float* out_vals, int* out_ids,
                                  int* out_totals, float* out_maxes, u64* scratch, void* stream) {
  return topk_launch<F32Rows>(table, n_seg, n_slots, n_blocks, k, kp, min_score, out_vals,
                              out_ids, out_totals, out_maxes, scratch, stream);
}

// term_bag_topk_segments_launch over a table of quantized segments, all of
// q_bytes-wide codes (1: int8, 2: int16): the route K4's top-k entry took
// before csrc/quant_topk.cu, called only by testing/k4_sweep.py.
int term_bag_topk_quantized_launch(const long long* table, int n_seg, int n_slots, int n_blocks,
                                   int k, int kp, float min_score, float* out_vals, int* out_ids,
                                   int* out_totals, float* out_maxes, u64* scratch, int q_bytes,
                                   void* stream) {
  if (q_bytes == 1)
    return topk_launch<QuantRows<int8_t>>(table, n_seg, n_slots, n_blocks, k, kp, min_score,
                                          out_vals, out_ids, out_totals, out_maxes, scratch,
                                          stream);
  if (q_bytes == 2)
    return topk_launch<QuantRows<int16_t>>(table, n_seg, n_slots, n_blocks, k, kp, min_score,
                                           out_vals, out_ids, out_totals, out_maxes, scratch,
                                           stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
