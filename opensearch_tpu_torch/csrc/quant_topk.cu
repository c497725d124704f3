// K4: the quantized term-bag top-k on Hopper.
//
// Replaces the JAX package's `gather_postings_packed` and `_dequant` /
// `quantized_impact_scores` / `quantized_impact_score_count`
// (opensearch_tpu/ops/bm25.py:114, opensearch_tpu/ops/quantized.py:30,46,64),
// XLA ops there, with the `run_topk` after them on the `match` path
// (opensearch_tpu/search/plan.py:1760): on a segment that index/codec.py
// quantizes, posting p of a term's row is doc base[term] plus a `width`-bit
// delta at bit p * width of the packed uint32 words, with the impact
// q * scale[term] of an int8 / int16 code q, or the term's exact f32 impact
// where the rank-parity guard stored one; the bag adds w * (idf * imp) per
// doc in slot order, masks by matched, live and min_score, and keeps each
// segment's top-k (lower doc id first on ties), matched total and max.
//
// Bound on the card: memory.  Per posting of an active term the call reads
// width / 8 bytes of packed delta and its code (1 or 2 bytes) or its exact
// impact (4 bytes), and does 3 or 4 operations; per segment it reads one
// live byte a doc and writes k * 8 + 8 bytes.  What costs time is latency:
// the row searches, the loads of the postings and the barriers of the
// selection, one chain per block.
//
// Exactness: per doc the contributions add in slot order from 0.0, each
// spelled w * (idf * imp) with __fmul_rn / __fadd_rn, imp =
// __fmul_rn((float)q, scale) or the exact value, and the library is built
// with -fmad=false: byte-equal to the plain twin (ops/quantized.py) and to
// K2 (csrc/bm25.cu) over QuantizedPostings.dequantized().  Doc ids are
// unique within a row, so within one slot no two threads touch one doc.
// Codes are at least 1, so scores > 0 still means matched on the fast path.
//
// Design:
// - The launch table is K2's quantized one (ops/cuda_bm25.py
//   `launch_table`), its tiles of kTile docs: a block owns one tile of one
//   segment, its scores (and matched-slot counts off the fast path) in
//   shared memory.
// - Searches: per group of up to four slots, one warp per (slot, boundary)
//   finds where the row enters and leaves the tile, 32 evenly spaced ids a
//   round (a 125,000-posting row takes 4 dependent probes), each id decoded
//   from the two packed words that hold it.
// - Staging: a block's postings in its tile are one run [lo, hi) of each
//   row, contiguous in every column: packed words [(lo w) >> 5, ((hi w - 1)
//   >> 5) + 2), and codes [lo, hi) or exact values [e + lo, e + hi).  One
//   thread copies the run's packed words and the one value column the term
//   reads into a stage buffer with two bulk asynchronous copies (TMA's
//   cp.async.bulk, completing on the buffer's mbarrier), each window widened
//   to 16-byte bounds (tests/test_torch_k4.py models `window_of` and the
//   decode): the staged columns are padded to whole 16-byte units
//   (DeviceSegment.quantized, checked by the wrapper), so a widened window
//   never reads past one.  Two stage buffers: slot j + 1's copies are in
//   flight while slot j is scattered.
// - Scatter from shared memory: delta = __funnelshift_r(win[i], win[i + 1],
//   bit & 31) & mask, i relative to the window, from p = 32a + b so no int32
//   overflows at any row length; no global load per posting.
// - Epilogue as K2's (topk.cuh): the live and min_score masks, one key per
//   doc, `select_top`, the total and max atomics, and the last tile of a
//   segment merging every tile's kp keys (`finish_segment`).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "phases.cuh"
#include "topk.cuh"

namespace {

// The wrapper (ops/cuda_bm25.py) owns the table's layout and the tile size
// and passes them in with -D: docs per block, the largest k, int64 words per
// segment and per slot of the table.
#if !defined(QUANT_TILE_DOCS) || !defined(QUANT_K_MAX) || !defined(QUANT_SEG_WORDS) || \
    !defined(QUANT_SLOT_WORDS)
#error "build through ops/cuda_bm25.py, which defines QUANT_TILE_DOCS, QUANT_K_MAX, QUANT_SEG_WORDS, QUANT_SLOT_WORDS"
#endif

using topk::u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = QUANT_TILE_DOCS;
constexpr int kKMax = QUANT_K_MAX;
constexpr int kSegWords = QUANT_SEG_WORDS;
constexpr int kSlotWords = QUANT_SLOT_WORDS;
constexpr int kPer = kTile / kThreads;  // docs of the tile each thread masks and keys
constexpr int kMergeBatch = kTile / 2;  // keys the last block's merge reads a round
constexpr int kGroup = kWarps / 2;      // slots searched at once: a warp per boundary
constexpr int kUnroll = 4;              // postings a thread reads before it adds any
constexpr unsigned kFull = 0xffffffffu;
// A stage buffer: the packed words of a run of up to kTile postings at up to
// 31 bits, with the guard word and the 16-byte slack at both ends, then its
// values as exact f32 (the widest column), with their slack.
constexpr int kWinWords = kTile * 31 / 32 + 16;
constexpr int kWinBytes = kWinWords * 4;
constexpr int kValBytes = kTile * 4 + 32;
constexpr int kStageBytes = kWinBytes + kValBytes;
constexpr int kSmem = kTile * 8 + 2 * kStageBytes;  // scores and counts (then keys), 2 stages
constexpr int kMinBlocks = kSmem <= 52 * 1024 ? 4 : (kSmem <= 110 * 1024 ? 2 : 1);
static_assert((kTile & (kTile - 1)) == 0 && kTile % kThreads == 0 && kTile >= 1024,
              "kTile: a power of two, a multiple of kThreads");
static_assert((kKMax & (kKMax - 1)) == 0 && kKMax <= kTile - kMergeBatch,
              "kKMax: a power of two the merge buffer holds beside one round");
static_assert(kSegWords >= 13 && kSlotWords >= 4, "the quantized table's entries");
static_assert(kWinBytes % 16 == 0 && kStageBytes % 16 == 0, "16-byte aligned stage buffers");

// One active slot's run in the block's tile, with what its postings need.
struct Run {
  int lo, hi;     // postings [lo, hi) of the row lie in the tile
  float idf, w;   // the slot's idf and weight
  int base;       // the term's first doc
  float scale;    // the term's code scale
  int exact0;     // exact_vals index of posting p is exact0 + p
  int exact;      // the parity guard kept the term exact
};

// What of a run is staged: packed words [word0, word0 + words) and values
// [val0, val0 + vbytes / size) of the column the term reads, each window
// 16-byte aligned and a whole number of 16 bytes.
struct Window {
  int word0, words, val0, vbytes;
};

// (p * width) >> 5, the packed word that holds posting p's first bit, as
// (p >> 5) * width + ((p & 31) * width >> 5): no int32 overflow.
__device__ __forceinline__ int word_of(int p, int width) {
  return (p >> 5) * width + (((p & 31) * width) >> 5);
}

template <typename Q>
__device__ __forceinline__ Window window_of(const Run& r, int width) {
  Window win;
  // the word of the run's last bit, (hi * width - 1) >> 5
  const int last = word_of(r.hi, width) - ((((r.hi & 31) * width) & 31) == 0 ? 1 : 0);
  win.word0 = word_of(r.lo, width) & ~3;
  win.words = ((last + 2 + 3) & ~3) - win.word0;  // + 1: the funnel shift reads a word past
  const int size = r.exact ? 4 : (int)sizeof(Q);
  const int per16 = 16 / size;
  const int first = r.exact ? r.exact0 + r.lo : r.lo;
  const int end = first + (r.hi - r.lo);
  win.val0 = first & ~(per16 - 1);
  win.vbytes = (((end + per16 - 1) & ~(per16 - 1)) - win.val0) * size;
  return win;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One thread: the run's packed words and values into `stage`, both
// completing on `bar` (one arrival that expects their bytes).
template <typename Q>
__device__ void issue_copies(const Run& r, const Window& win, char* stage, uint64_t* bar,
                             const uint32_t* packed, const Q* qvals, const float* exact_vals) {
  if (win.words > kWinWords || win.vbytes > kValBytes) __trap();  // a row's ids repeat
  const uint32_t b = smem_u32(bar);
  const void* vsrc = r.exact ? static_cast<const void*>(exact_vals + win.val0)
                             : static_cast<const void*>(qvals + win.val0);
  // the stage's earlier reads (generic proxy) before the copies' writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(b),
               "r"(win.words * 4 + win.vbytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(stage)),
      "l"(reinterpret_cast<uint64_t>(packed + win.word0)), "r"(win.words * 4), "r"(b)
      : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(stage + kWinBytes)),
      "l"(reinterpret_cast<uint64_t>(vsrc)), "r"(win.vbytes), "r"(b)
      : "memory");
}

// Doc of posting p, decoded from the packed words in device memory (the
// searches' probes).
__device__ __forceinline__ int doc_at(const uint32_t* __restrict__ packed, int width, unsigned mask,
                                      int base, int p) {
  const int bit = (p & 31) * width;
  const int w = (p >> 5) * width + (bit >> 5);
  return base + (int)(__funnelshift_r(__ldg(packed + w), __ldg(packed + w + 1), bit & 31) & mask);
}

// First p in [lo, hi) with doc(p) >= target, else hi, over a row of
// ascending docs: the warp probes 32 evenly spaced ids a round, so a row of
// n postings takes about log32(n) + 1 dependent probes.  (The first rounds'
// probes are the same in every tile of a segment: L2 serves most of them.)
__device__ int warp_lower_bound(const uint32_t* __restrict__ packed, int width, unsigned mask,
                                int base, int lo, int hi, int target, int lane) {
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + (lane + 1) * step - 1;  // the last id of piece `lane`
    const bool ge = p >= hi || doc_at(packed, width, mask, base, p) >= target;
    const unsigned b = __ballot_sync(kFull, ge);
    if (b == 0) return hi;  // the last piece ends at hi - 1, below target
    const int f = __ffs(b) - 1;  // the answer lies in piece f
    hi = min(hi, lo + (f + 1) * step - 1);
    lo += f * step;
  }
  const int p = lo + lane;
  const bool ge = p >= hi || doc_at(packed, width, mask, base, p) >= target;
  const unsigned b = __ballot_sync(kFull, ge);
  return b == 0 ? hi : min(hi, lo + __ffs(b) - 1);
}

// Adds run r's postings into the tile's scores (and counts) from the
// stage, EXACT: the run's values are exact f32 (else codes), FAST: no
// counts.  A thread's postings lie kThreads apart, so their bit offset in
// a word is the same and their word index steps by kThreads / 32 * width.
template <typename Q, bool EXACT, bool FAST>
__device__ void scatter(const Run& r, const Window& win, const char* stage, int width, int doc0,
                        float* scores, int* counts) {
  const uint32_t* words = reinterpret_cast<const uint32_t*>(stage);
  const Q* codes = reinterpret_cast<const Q*>(stage + kWinBytes);
  const float* exact = reinterpret_cast<const float*>(stage + kWinBytes);
  const unsigned mask = (1u << width) - 1u;
  const int step = kThreads / 32 * width;
  int p = r.lo + threadIdx.x;
  const int bit = (p & 31) * width;
  const int shift = bit & 31;
  int i = (p >> 5) * width + (bit >> 5) - win.word0;
  // the stage's value of posting p: vals[p - vshift]
  const int vshift = (EXACT ? -r.exact0 : 0) + win.val0;
  const int dbase = r.base - doc0;
  for (; p < r.hi; p += kThreads * kUnroll, i += step * kUnroll) {
    int dd[kUnroll];
    float im[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = p + u * kThreads, iq = i + u * step;
      dd[u] = -1;
      im[u] = 0.0f;
      if (q < r.hi) {
        dd[u] = dbase + (int)(__funnelshift_r(words[iq], words[iq + 1], shift) & mask);
        im[u] = EXACT ? exact[q - vshift] : __fmul_rn((float)codes[q - vshift], r.scale);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (dd[u] < 0) continue;
      scores[dd[u]] = __fadd_rn(scores[dd[u]], __fmul_rn(r.w, __fmul_rn(r.idf, im[u])));
      if (!FAST) counts[dd[u]] += 1;
    }
  }
}

// table: see ops/cuda_bm25.py `launch_table` (quantized): per segment
// {packed, qvals, live, n_pad, first tile, tiles, output row, first slot,
// slots, required, fast, exact_vals, width}; per active slot {start | end
// << 32, idf bits | weight bits << 32, base | scale bits << 32, exact start
// | exact << 32}; the work list (segment << 32 | tile per block); 3 * n_seg
// int32 zeros (tile counters, totals, max keys).
template <typename Q>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
quant_topk_kernel(const long long* __restrict__ table, int n_seg, int n_slots, int k, int kp,
                  float min_score, float* __restrict__ out_vals, int* __restrict__ out_ids,
                  int* __restrict__ out_totals, float* __restrict__ out_maxes,
                  u64* __restrict__ scratch) {
  QPHASE_START();
  extern __shared__ __align__(128) char smem[];
  float* scores = reinterpret_cast<float*>(smem);
  int* counts = reinterpret_cast<int*>(smem + kTile * 4);
  u64* keys = reinterpret_cast<u64*>(smem);  // over scores and counts, once they are read
  char* stages = smem + kTile * 8;
  __shared__ __align__(8) uint64_t bars[2];
  __shared__ Run runs[kGroup];
  __shared__ __align__(16) uint8_t live_s[kTile];

  const long long* slots = table + (long long)n_seg * kSegWords;
  const long long* work = slots + (long long)kSlotWords * n_slots;
  int* counters = reinterpret_cast<int*>(const_cast<long long*>(work + gridDim.x));
  const long long wk = work[blockIdx.x];
  const int seg = (int)(wk >> 32);
  const int tile = (int)(wk & 0xFFFFFFFFll);
  const long long* e = table + (long long)seg * kSegWords;
  const uint32_t* packed = reinterpret_cast<const uint32_t*>(e[0]);
  const Q* qvals = reinterpret_cast<const Q*>(e[1]);
  const uint8_t* live = reinterpret_cast<const uint8_t*>(e[2]);
  const int n_pad = (int)e[3];
  const long long first = e[4];
  const int n_tiles = (int)e[5];
  const long long out_row = e[6];
  const long long slot0 = e[7];
  const int seg_slots = (int)e[8];
  const int required = (int)e[9];
  const bool fast = e[10] != 0;
  const float* exact_vals = reinterpret_cast<const float*>(e[11]);
  const int width = (int)e[12];
  const unsigned mask = (1u << width) - 1u;
  int* total = counters + n_seg + seg;
  unsigned* max_key = reinterpret_cast<unsigned*>(counters + 2 * n_seg + seg);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int doc0 = tile * kTile;
  const int docs = min(kTile, n_pad - doc0);

  if (tid == 0) {
    bar_init(&bars[0]);
    bar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the tile's live bytes into shared memory, 16 a thread: their loads are
  // in flight while the rows are searched, and done by the first barrier
  const bool vec = (reinterpret_cast<uintptr_t>(live + doc0) & 15) == 0;
  for (int d = tid * 16; d < docs; d += kThreads * 16) {
    if (vec && d + 16 <= docs) {
      *reinterpret_cast<uint4*>(live_s + d) = __ldg(reinterpret_cast<const uint4*>(live + doc0 + d));
    } else {
      for (int i = d; i < min(d + 16, docs); ++i) live_s[i] = __ldg(live + doc0 + i);
    }
  }
  float4* zero = reinterpret_cast<float4*>(smem);
  for (int i = tid; i < (fast ? kTile / 4 : kTile / 2); i += kThreads)
    zero[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // Threads write live_s, scores and counts at other indices than they
  // read at the key build: a barrier must lie between.  The group loop's
  // first barrier is it; a segment where no term of the bag occurs runs no
  // group, so it takes its own (block-uniform).
  if (seg_slots == 0) __syncthreads();
  QPHASE(0);

  unsigned parity = 0;  // bit b: the phase of stage b's barrier to wait for
  for (int g = 0; g < seg_slots; g += kGroup) {
    const int m = min(kGroup, seg_slots - g);
    if (warp < 2 * m) {  // warp 2j + side: where slot g + j's row enters (0) or leaves (1) the tile
      const int j = warp >> 1, side = warp & 1;
      const long long* sl = slots + kSlotWords * (slot0 + g + j);
      const u64 range = (u64)sl[0], bs = (u64)sl[2];
      const int start = (int)(range & 0xFFFFFFFFull);
      const int base = (int)(bs & 0xFFFFFFFFull);
      const int at = warp_lower_bound(packed, width, mask, base, start, (int)(range >> 32),
                                      doc0 + side * kTile, lane);
      if (lane == 0) {
        if (side) {
          runs[j].hi = at;
        } else {
          const u64 iw = (u64)sl[1], ex = (u64)sl[3];
          runs[j].lo = at;
          runs[j].idf = __uint_as_float((unsigned)(iw & 0xFFFFFFFFull));
          runs[j].w = __uint_as_float((unsigned)(iw >> 32));
          runs[j].base = base;
          runs[j].scale = __uint_as_float((unsigned)(bs >> 32));
          runs[j].exact0 = (int)(ex & 0xFFFFFFFFull) - start;
          runs[j].exact = (ex >> 32) != 0;
        }
      }
    }
    __syncthreads();
    QPHASE(1);
    // both stages are free: every earlier read of them ended at a barrier
    if (tid == 0) {
      for (int j = 0; j < min(2, m); ++j) {
        const Run r = runs[j];
        if (r.lo < r.hi)
          issue_copies<Q>(r, window_of<Q>(r, width), stages + j * kStageBytes, &bars[j], packed,
                          qvals, exact_vals);
      }
    }
    for (int j = 0; j < m; ++j) {  // slot order
      const int s = j & 1;
      const Run r = runs[j];
      if (r.lo < r.hi) {  // block-uniform
        const Window win = window_of<Q>(r, width);
        bar_wait(&bars[s], (parity >> s) & 1u);
        parity ^= 1u << s;
        QPHASE(2);
        const char* stage = stages + s * kStageBytes;
        if (r.exact)
          fast ? scatter<Q, true, true>(r, win, stage, width, doc0, scores, counts)
               : scatter<Q, true, false>(r, win, stage, width, doc0, scores, counts);
        else
          fast ? scatter<Q, false, true>(r, win, stage, width, doc0, scores, counts)
               : scatter<Q, false, false>(r, win, stage, width, doc0, scores, counts);
        __syncthreads();  // slot order per doc; stage s is read
        QPHASE(3);
        QPHASE_COUNT(7);
      }
      if (tid == 0 && j + 2 < m) {  // slot j + 2 into the stage slot j has left
        const Run n = runs[j + 2];
        if (n.lo < n.hi)
          issue_copies<Q>(n, window_of<Q>(n, width), stages + s * kStageBytes, &bars[s], packed,
                          qvals, exact_vals);
      }
    }
    __syncthreads();  // runs are read before the next group overwrites them
  }

  float sc[kPer];
  bool hit[kPer];
  int cnt = 0;
  unsigned mx = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int d = tid + i * kThreads;
    sc[i] = scores[d];
    const bool matched = fast ? sc[i] > 0.0f : counts[d] >= required;
    hit[i] = d < docs && live_s[d] && matched && sc[i] >= min_score;
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
    cnt += __shfl_xor_sync(kFull, cnt, off);
    mx = max(mx, __shfl_xor_sync(kFull, mx, off));
  }
  if (lane == 0 && cnt > 0) {
    atomicAdd(total, cnt);
    atomicMax(max_key, mx);
  }
  __syncthreads();
  QPHASE(4);
  topk::select_top<kThreads, kTile>(keys, kp);
  QPHASE(5);
  const bool last = topk::finish_segment<kThreads, kTile, kMergeBatch>(keys, kp, scratch, first,
                                                                      tile, n_tiles, counters + seg);
  QPHASE(6);
  if (!last) return;
  topk::write_topk<kThreads>(keys, k, out_vals + out_row * k, out_ids + out_row * k);
  if (tid == 0) {  // every tile's atomics are in: read them coherently
    const unsigned key = atomicMax(max_key, 0u);
    out_totals[out_row] = atomicAdd(total, 0);
    out_maxes[out_row] = key == 0 ? -INFINITY : topk::from_orderable(key);
  }
  QPHASE(6);
}

template <typename Q>
int launch(const long long* table, int n_seg, int n_slots, int n_blocks, int k, int kp,
           float min_score, float* out_vals, int* out_ids, int* out_totals, float* out_maxes,
           u64* scratch, void* stream) {
  // beside the static shared memory, even a 48 KB request needs the opt-in
  const cudaError_t err = cudaFuncSetAttribute(
      quant_topk_kernel<Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_topk_kernel<Q><<<n_blocks, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      table, n_seg, n_slots, k, kp, min_score, out_vals, out_ids, out_totals, out_maxes, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// Exact top-k, total and max of every quantized segment of `table` (device
// memory, n_blocks entries in its work list, tiles of QUANT_TILE_DOCS docs),
// all of q_bytes-wide codes (1: int8, 2: int16), into rows of
// out_vals/out_ids [*, k] and out_totals/out_maxes [*]; scratch holds
// n_blocks * kp keys.  min_score is -inf when unset.  Returns the CUDA error
// of the launch (0 on success); faults surface at the caller's next sync.
int quant_topk_launch(const long long* table, int n_seg, int n_slots, int n_blocks, int k, int kp,
                      float min_score, float* out_vals, int* out_ids, int* out_totals,
                      float* out_maxes, u64* scratch, int q_bytes, void* stream) {
  if (n_blocks <= 0) return 0;
  if (k < 1 || k > kp || kp > kKMax || (kp & (kp - 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (q_bytes == 1)
    return launch<int8_t>(table, n_seg, n_slots, n_blocks, k, kp, min_score, out_vals, out_ids,
                          out_totals, out_maxes, scratch, stream);
  if (q_bytes == 2)
    return launch<int16_t>(table, n_seg, n_slots, n_blocks, k, kp, min_score, out_vals, out_ids,
                           out_totals, out_maxes, scratch, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
