// K5: the bucket collector of aggregations on Hopper.
//
// Replaces the JAX package's XLA scatters of opensearch_tpu/ops/aggs.py
// (`ordinal_counts` :58, `bucketed_counts` :67, `masked_metrics` :80,
// `per_doc_partials` :92 and `scatter_partials_to_buckets` :107), as the
// collect phase of opensearch_tpu/search/aggs.py calls them per segment:
// each bucket's doc count and, per metric sub-column, each bucket's
// (sum f64, count i64, min f64, max f64), for every job of a call: a job is
// one key column over one segment (several columns in the single mode).
// The plain version is ops/aggs.py `bucket_collect_plain`.
//
// Modes (the bucket of entry e of a job's key column):
//   0 ordinal  keys[e] (int32 ordinal; < 0 is no value); ordinals are
//              deduplicated per doc, so every entry counts;
//   1 edges    upper_bound(edges, double(keys[e])) - 1, valid in
//              [0, n_buckets); only the first (doc, bucket) entry of a doc
//              counts, for its doc count and its metrics alike;
//   2 single   bucket 0 (an int32 key column counts ordinals >= 0).  A job
//              with self_metric has the key column's own values as its one
//              metric (an entry's partial is its value), duplicates
//              included.
// A valid entry also needs matched[doc].  Entry e's validity is a pure
// function of entries e - 1 and e, so no state is carried along a column.
// A sub-column's partial for a valid entry is its doc's (sum, count, min,
// max): the doc's values offsets[d] .. offsets[d + 1] in column order,
// summed from 0.0.
//
// Summation order (the trap): counts, min and max do not depend on it;
// float64 sums do.  Each bucket's sum is the PAIRWISE TREE over the
// bucket's valid entries in entry order (ops/aggs.py `pairwise_sums`):
// the node of rank r at level l (r a multiple of 2^(l+1)) takes the node
// of rank r + 2^l.  No float atomics: the complete nodes of the tree are
// built inside chunks and merged in chunk order as a binary counter
// (`push`); the incomplete tail is folded from the lowest level up, which
// is exactly the plain tree's right-nested remainder.  So the card equals
// the plain version on the CPU and on the card, byte for byte, and two
// launches give the same bytes.
//
// Bound on the card: bytes.  Each key entry is read once (4 or 8 bytes,
// 4 for its doc, 1 for matched) and, per sub-column, its doc's offsets and
// values; outputs are (1 + 4 S) words per bucket.  About 21 bytes per
// entry with one sub-column: ~6 us per 1M entries at 3.35 TB/s.
//
// Design: every job's entries are cut into chunks of kChunk (AGG_CHUNK)
// entries, one block of kThreads each, over every chunk of every job of
// the call; no block reads a chunk twice per kernel, and every block
// takes all the buckets of its chunk.  Four kernels on one stream, no
// host sync between them:
//   1 count   per chunk: each entry's bucket and validity (entry e - 1
//             read from global memory at a chunk's first entry), a
//             block-local stable radix sort of the chunk's entries by
//             bucket (invalid entries to the dead bucket n_buckets_pad - 1,
//             last), then the chunk's records, one per bucket it holds:
//             bucket, count, start in the sorted order; the sorted order
//             itself (`perm`).  A job with n_buckets_pad <= kChunk also
//             gets a dense row per chunk, bucket -> record.
//   2 scan    a warp per (job, bucket): a lane per chunk (32 at a time)
//             finds the bucket's record there (the dense row, else a
//             binary search of the chunk's records); a warp scan of the
//             counts gives each record's starting rank r0 (chunk order);
//             lane 0 writes the bucket's doc count.
//   3 reduce  per chunk with sub-columns: each sorted entry's rank in its
//             bucket's run (r0 + its place in the record), its partials,
//             and the sums' complete tree nodes inside [r0, r0 + n),
//             aligned to the global ranks (shared memory, a barrier per
//             level); count, min and max (order-free) reduced per warp
//             over each record's piece of 32 neighbours, then per record;
//             each record's maximal nodes (at most 2 log2 n + 1), in rank
//             order, and its count, min and max to global scratch.
//   4 merge   a warp per (job, sub-column, bucket): a lane per chunk (16
//             at a time) stages its record's maximal nodes in shared
//             memory in chunk order (ranks from a warp scan); lane 0
//             pushes them into the bucket's binary counter, folds the
//             tail and writes the outputs (buckets without entries get (0,
//             0.0, 0, +inf, -inf), as the plain version's scatters leave
//             them).
// No atomics; the merge order is fixed by the chunk index.  Scratch comes
// from the wrapper (torch.empty); the kernels allocate nothing.  A
// library built with -DQUANT_PHASES (csrc/phases.cuh) adds each phase's
// cycles: 0 count's load, buckets and validity, 1 its sort, 2 its
// records, 3 scan, 4 reduce's partials, 5 its tree, 6 its nodes, 7 merge.
//
// Layouts (ops/cuda_aggs.py `launch_table`): the device table holds per
// job kHeadWords words {matched, keys, key_docs, n_entries, n_buckets,
// n_buckets_pad, output offset, flags (key dtype | self_metric << 8 |
// sub-columns << 16), first chunk, chunks, record base, record stride,
// dense base (-1: none), node base, sub-record base, 0}, then 2 words
// {values, offsets} per sub-column of the call (0 where the segment lacks
// it); then the work lists: one word per chunk (job << 32 | chunk), per
// scan block (job << 32 | block), per merge block (job << 40 | sub << 32
// | block).  The host words (`agg_collect_launch`'s `w`) carry the counts,
// the mode and the device addresses of the outputs, the edges and the
// scratch.

#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_radix_sort.cuh>

#include "phases.cuh"

#ifndef AGG_CHUNK
#error "build with -DAGG_CHUNK=<entries a block> (ops/cuda_aggs.py defines())"
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = AGG_CHUNK;
constexpr int kItems = kChunk / kThreads;
constexpr int kHeadWords = 16;
constexpr int kLineThreads = 256;     // scan: a warp a bucket
constexpr int kLineWarps = kLineThreads / 32;
constexpr int kMergeWarps = 4;        // merge: a warp a bucket,
constexpr int kMergeChunks = 16;      // 16 chunks a round (lanes 0-15)
constexpr int kMaxLevels = 48;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kChunk % kThreads == 0 && kItems >= 1 && kChunk <= 65536,
              "AGG_CHUNK: a multiple of 512 entries, at most 65,536");
constexpr int log2_floor(int x) { return x > 1 ? 1 + log2_floor(x >> 1) : 0; }
// maximal nodes of a run of at most kChunk entries
constexpr int kNodesMax = 2 * log2_floor(kChunk) + 1;

enum Mode { kOrdinal = 0, kEdges = 1, kSingle = 2 };
enum Dtype { kI32 = 0, kI64 = 1, kF64 = 2 };

struct Params {
  const long long* table;
  int n_jobs;
  int job_words;
  long long n_chunk_items;
  long long n_scan_items;
  int mode;
  unsigned sub_f64;      // bit j: sub-column j holds float64 (else int64)
  const double* edges;
  int n_edges;
  int edges_smem;
  int dense_cols;        // widest dense row of the call (count's smem)
  int rec_stride_max;    // widest record stride of the call (reduce's smem)
  long long* out;
  int* rec_n;            // [chunks] records of each chunk
  int* rec_bucket;       // [slots]
  int* rec_cnt;          // [slots]
  int* rec_loc;          // [slots] start in the chunk's sorted order
  int* rec_r0;           // [slots] rank of the record's first entry
  int* dense_idx;        // [rows] bucket -> record, -1
  unsigned short* perm;  // [chunks * kChunk] sorted order -> chunk entry
  double* nodes;         // maximal nodes' sums
  long long* sub_cnt;    // per record and sub-column
  double* sub_min;
  double* sub_max;
};

struct Job {
  const unsigned char* matched;
  const void* keys;
  const int* key_docs;
  long long n;
  int nb, nbp;
  long long out_off;
  int key_dtype, self_metric, n_subs;
  long long chunk0;
  int n_chunks;
  long long rec_base;
  int rec_stride;
  long long dense_base;
  long long node_base, subrec_base;
  const long long* subs;
};

__device__ __forceinline__ Job load_job(const Params& P, int job) {
  const long long* h = P.table + (long long)job * P.job_words;
  Job J;
  J.matched = reinterpret_cast<const unsigned char*>(h[0]);
  J.keys = reinterpret_cast<const void*>(h[1]);
  J.key_docs = reinterpret_cast<const int*>(h[2]);
  J.n = h[3];
  J.nb = static_cast<int>(h[4]);
  J.nbp = static_cast<int>(h[5]);
  J.out_off = h[6];
  J.key_dtype = static_cast<int>(h[7] & 0xff);
  J.self_metric = static_cast<int>((h[7] >> 8) & 0xff);
  J.n_subs = static_cast<int>((h[7] >> 16) & 0xff);
  J.chunk0 = h[8];
  J.n_chunks = static_cast<int>(h[9]);
  J.rec_base = h[10];
  J.rec_stride = static_cast<int>(h[11]);
  J.dense_base = h[12];
  J.node_base = h[13];
  J.subrec_base = h[14];
  J.subs = h + kHeadWords;
  return J;
}

__device__ __forceinline__ double key_value(const void* keys, int dtype, long long e) {
  if (dtype == kI64) return static_cast<double>(static_cast<const long long*>(keys)[e]);
  if (dtype == kF64) return static_cast<const double*>(keys)[e];
  return static_cast<double>(static_cast<const int*>(keys)[e]);
}

__device__ __forceinline__ double sub_value(const void* vals, bool f64, long long k) {
  return f64 ? static_cast<const double*>(vals)[k]
             : static_cast<double>(static_cast<const long long*>(vals)[k]);
}

__device__ __forceinline__ double pos_inf() { return __longlong_as_double(0x7ff0000000000000LL); }
__device__ __forceinline__ double neg_inf() {
  return __longlong_as_double((long long)0xfff0000000000000ULL);
}

// Count of edges <= v (searchsorted side="right").
__device__ __forceinline__ int upper_bound(const double* edges, int n, double v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (edges[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The raw bucket of entry e (the plain version's `b`, before validity).
__device__ __forceinline__ int raw_bucket(const Job& J, int mode, const double* edges,
                                          int n_edges, long long e) {
  if (mode == kOrdinal) return static_cast<const int*>(J.keys)[e];
  if (mode == kEdges) return upper_bound(edges, n_edges, key_value(J.keys, J.key_dtype, e)) - 1;
  return (J.key_dtype == kI32 && static_cast<const int*>(J.keys)[e] < 0) ? -1 : 0;
}

// The largest level l of an aligned node at rank p inside [p, end):
// p a multiple of 2^l and p + 2^l <= end.  Ranks are below 2^31.
__device__ __forceinline__ int node_level(int p, int end) {
  const int cap = 31 - __clz(end - p);
  return p ? min(__ffs(p) - 1, cap) : cap;
}

// Adds a complete node of 2^l entries, whose first entry has rank p (a
// multiple of 2^l), to the counter `st` of a bucket holding p entries.
__device__ __forceinline__ void push(double* st, int p, int l, double v) {
  double carry = v;
  while ((p >> l) & 1) {
    carry = st[l] + carry;
    ++l;
  }
  st[l] = carry;
}

// Exclusive block-wide sum of one int a thread; *total gets the sum.
// `wsum` holds kWarps + 1 ints of shared memory.
__device__ __forceinline__ int block_exclusive_sum(int v, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int x = lane < kWarps ? wsum[lane] : 0;
    int s = x;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, s, off);
      if (lane >= off) s += y;
    }
    if (lane < kWarps) wsum[lane] = s - x;
    if (lane == 31) wsum[kWarps] = s;
  }
  __syncthreads();
  const int out = wsum[warp] + incl - v;
  *total = wsum[kWarps];
  __syncthreads();
  return out;
}

// Bucket b's record in chunk k of job J, or -1.
__device__ __forceinline__ int find_record(const Params& P, const Job& J, int k, int b) {
  if (J.dense_base >= 0) return P.dense_idx[J.dense_base + (long long)k * J.nbp + b];
  const int* rb = P.rec_bucket + J.rec_base + (long long)k * J.rec_stride;
  const int n = P.rec_n[J.chunk0 + k];
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rb[mid] < b) lo = mid + 1; else hi = mid;
  }
  return (lo < n && rb[lo] == b) ? lo : -1;
}

using BlockSort = cub::BlockRadixSort<unsigned, kThreads, kItems, unsigned>;

__global__ void __launch_bounds__(kThreads) agg_count_kernel(Params P) {
  __shared__ typename BlockSort::TempStorage sort_tmp;
  extern __shared__ __align__(16) unsigned char smem[];
  QPHASE_START();
  const int tid = threadIdx.x;
  const long long work = P.table[(long long)P.n_jobs * P.job_words + blockIdx.x];
  const int job = static_cast<int>(work >> 32);
  const int k = static_cast<int>(work & 0xffffffff);
  const Job J = load_job(P, job);
  const long long e0 = (long long)k * kChunk;
  const int n_here = static_cast<int>(min((long long)kChunk, J.n - e0));
  const long long g = J.chunk0 + k;

  double* sedges = reinterpret_cast<double*>(smem);                // [n_edges] or none
  int* rloc = reinterpret_cast<int*>(sedges + (P.edges_smem ? P.n_edges : 0));  // [kChunk + 1]
  int* tail_d = rloc + kChunk + 1;                                 // [kThreads]
  int* tail_b = tail_d + kThreads;                                 // [kThreads]
  int* wsum = tail_b + kThreads;                                   // [kWarps + 1]
  int* drow = wsum + kWarps + 1;                                   // [nbp], dense jobs
  const bool dense = J.dense_base >= 0;

  const double* edges = P.edges;
  if (P.mode == kEdges && P.edges_smem) {
    for (int i = tid; i < P.n_edges; i += kThreads) sedges[i] = P.edges[i];
    edges = sedges;
  }
  if (dense)
    for (int i = tid; i < J.nbp; i += kThreads) drow[i] = -1;
  __syncthreads();

  // entries t * kItems .. + kItems of the chunk (blocked), in entry order
  int d[kItems], b[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int li = tid * kItems + i;
    d[i] = -1;
    b[i] = -1;
    if (li < n_here) {
      d[i] = J.key_docs[e0 + li];
      b[i] = raw_bucket(J, P.mode, edges, P.n_edges, e0 + li);
    }
  }
  tail_d[tid] = d[kItems - 1];
  tail_b[tid] = b[kItems - 1];
  __syncthreads();
  int pd = -1, pb = -1;        // entry e - 1's (doc, raw bucket)
  if (tid > 0) {
    pd = tail_d[tid - 1];
    pb = tail_b[tid - 1];
  } else if (e0 > 0 && P.mode == kEdges) {
    pd = J.key_docs[e0 - 1];
    pb = raw_bucket(J, P.mode, edges, P.n_edges, e0 - 1);
  }
  const unsigned dead = static_cast<unsigned>(J.nbp - 1);
  unsigned key[kItems], val[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int li = tid * kItems + i;
    bool valid = li < n_here && b[i] >= 0 && b[i] < J.nb && J.matched[d[i]];
    if (P.mode == kEdges) valid = valid && !(pd == d[i] && pb == b[i]);
    key[i] = valid ? static_cast<unsigned>(b[i]) : dead;
    val[i] = static_cast<unsigned>(li);
    pd = d[i];
    pb = b[i];
  }
  QPHASE(0);
  const int bits = 31 - __clz(J.nbp);        // n_buckets_pad is a power of two
  BlockSort(sort_tmp).Sort(key, val, 0, bits);
  __syncthreads();
  QPHASE(1);

  // sorted positions t * kItems .. + kItems: records start where the
  // bucket changes; the dead bucket is last and is no record
  tail_b[tid] = static_cast<int>(key[kItems - 1]);
  __syncthreads();
  unsigned prev = tid ? static_cast<unsigned>(tail_b[tid - 1]) : 0xffffffffu;
  int starts = 0, valid_n = 0;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    starts += key[i] != dead && key[i] != prev;
    valid_n += key[i] != dead;
    prev = key[i];
  }
  int n_rec, n_valid;
  int r = block_exclusive_sum(starts, wsum, &n_rec);
  block_exclusive_sum(valid_n, wsum, &n_valid);
  int* rec_bucket = P.rec_bucket + J.rec_base + (long long)k * J.rec_stride;
  prev = tid ? static_cast<unsigned>(tail_b[tid - 1]) : 0xffffffffu;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const int q = tid * kItems + i;
    if (key[i] != dead) {
      if (key[i] != prev) {
        rloc[r] = q;
        rec_bucket[r] = static_cast<int>(key[i]);
        if (dense) drow[key[i]] = r;
        ++r;
      }
      P.perm[g * kChunk + q] = static_cast<unsigned short>(val[i]);
    }
    prev = key[i];
  }
  if (tid == 0) {
    rloc[n_rec] = n_valid;
    P.rec_n[g] = n_rec;
  }
  __syncthreads();
  int* rec_cnt = P.rec_cnt + J.rec_base + (long long)k * J.rec_stride;
  int* rec_loc = P.rec_loc + J.rec_base + (long long)k * J.rec_stride;
  for (int i = tid; i < n_rec; i += kThreads) {
    rec_loc[i] = rloc[i];
    rec_cnt[i] = rloc[i + 1] - rloc[i];
  }
  if (dense) {
    int* row = P.dense_idx + J.dense_base + (long long)k * J.nbp;
    for (int i = tid; i < J.nbp; i += kThreads) row[i] = drow[i];
  }
  QPHASE(2);
}

// Warp-wide inclusive sum.
template <typename T>
__device__ __forceinline__ T warp_inclusive_sum(T v) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += y;
  }
  return v;
}

__device__ __forceinline__ double dmin(double a, double b) { return b < a ? b : a; }
__device__ __forceinline__ double dmax(double a, double b) { return b > a ? b : a; }

// A warp per (job, bucket): each lane takes a chunk (32 at a time), finds
// the bucket's record there, and a warp scan of the counts gives each
// record's r0; lane 0 writes the bucket's doc count.
__global__ void __launch_bounds__(kLineThreads) agg_scan_kernel(Params P) {
  QPHASE_START();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long work =
      P.table[(long long)P.n_jobs * P.job_words + P.n_chunk_items + blockIdx.x];
  const Job J = load_job(P, static_cast<int>(work >> 32));
  const int b = static_cast<int>(work & 0xffffffff) * kLineWarps + warp;
  if (b < J.nbp) {
    long long r = 0;
    for (int k0 = 0; k0 < J.n_chunks; k0 += kMergeChunks) {
      const int k = k0 + lane;
      const int i = (lane < kMergeChunks && k < J.n_chunks) ? find_record(P, J, k, b) : -1;
      const long long slot = J.rec_base + (long long)k * J.rec_stride + i;
      const int cnt = i >= 0 ? P.rec_cnt[slot] : 0;
      const int incl = warp_inclusive_sum(cnt);
      if (i >= 0) P.rec_r0[slot] = static_cast<int>(r + incl - cnt);
      r += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) P.out[J.out_off + b] = r;
  }
  QPHASE(3);
}

__global__ void __launch_bounds__(kThreads) agg_reduce_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  QPHASE_START();
  const int tid = threadIdx.x, lane = tid & 31;
  const long long work = P.table[(long long)P.n_jobs * P.job_words + blockIdx.x];
  const int job = static_cast<int>(work >> 32);
  const int k = static_cast<int>(work & 0xffffffff);
  const Job J = load_job(P, job);
  const long long g = J.chunk0 + k;
  const int D = P.rec_n[g];
  if (J.n_subs == 0 || D == 0) return;      // uniform across the block
  const long long e0 = (long long)k * kChunk;
  const long long slot0 = J.rec_base + (long long)k * J.rec_stride;
  const int R = P.rec_stride_max;

  double* xs = reinterpret_cast<double*>(smem);                    // [kChunk]
  double* pmn = xs + kChunk;                                       // [kChunk]
  double* pmx = pmn + kChunk;                                      // [kChunk]
  long long* pc = reinterpret_cast<long long*>(pmx + kChunk);      // [kChunk]
  int* rloc = reinterpret_cast<int*>(pc + kChunk);                 // [R + 1]
  int* rr0 = rloc + R + 1;                                         // [R]

  for (int i = tid; i < D; i += kThreads) {
    rloc[i] = P.rec_loc[slot0 + i];
    rr0[i] = P.rec_r0[slot0 + i];
  }
  if (tid == 0) rloc[D] = P.rec_loc[slot0 + D - 1] + P.rec_cnt[slot0 + D - 1];
  __syncthreads();
  const int n_valid = rloc[D];

  // sorted positions q = tid + m * kThreads (a warp holds 32 neighbours):
  // the record, the rank in the bucket's run, the run's end, the entry
  int rid[kItems], rq[kItems], rend[kItems], eq[kItems], dq[kItems];
#pragma unroll
  for (int m = 0; m < kItems; ++m) {
    const int q = tid + m * kThreads;
    rid[m] = -1;
    rq[m] = rend[m] = eq[m] = dq[m] = 0;
    if (q < n_valid) {
      int lo = 0, hi = D;        // the record holding q: last rloc <= q
      while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (rloc[mid] <= q) lo = mid; else hi = mid;
      }
      rid[m] = lo;
      rq[m] = rr0[lo] + (q - rloc[lo]);
      rend[m] = rr0[lo] + (rloc[lo + 1] - rloc[lo]);
      eq[m] = static_cast<int>(e0) + P.perm[g * kChunk + q];
      if (!J.self_metric) dq[m] = J.key_docs[eq[m]];   // a sub-column's doc
    }
  }
  const long long node_stride = (long long)J.n_chunks * kChunk;
  const long long sub_stride = (long long)J.n_chunks * J.rec_stride;
  for (int j = 0; j < J.n_subs; ++j) {
    const void* vals = J.self_metric ? nullptr : reinterpret_cast<const void*>(J.subs[2 * j]);
    const int* offs = J.self_metric ? nullptr : reinterpret_cast<const int*>(J.subs[2 * j + 1]);
    const bool f64 = (P.sub_f64 >> j) & 1u;
#pragma unroll
    for (int m = 0; m < kItems; ++m) {
      const int q = tid + m * kThreads;
      double s = 0.0, mn = pos_inf(), mx = neg_inf();
      long long c = 0;
      if (rid[m] >= 0) {
        if (J.self_metric) {
          s = key_value(J.keys, J.key_dtype, eq[m]);
          mn = mx = s;
          c = 1;
        } else if (vals != nullptr) {
          const int lo = offs[dq[m]], hi = offs[dq[m] + 1];
          for (int v = lo; v < hi; ++v) {
            const double x = sub_value(vals, f64, v);
            s = s + x;
            mn = x < mn ? x : mn;
            mx = x > mx ? x : mx;
          }
          c = hi - lo;
        }
        xs[q] = s;
      }
      // count, min and max are order-free: a segmented reduction over the
      // warp's 32 neighbours of one record (a piece: the record within a
      // 32-aligned run of positions), kept at the piece's first position
      const int prev = __shfl_up_sync(kFull, rid[m], 1);
      const unsigned heads = __ballot_sync(kFull, lane == 0 || prev != rid[m]);
      const int first = 31 - __clz(heads & ((2u << lane) - 1u));
      const unsigned after = heads & ~((2u << lane) - 1u);
      const int last = after ? __ffs(after) - 2 : 31;
      for (int off = 1; off < 32; off <<= 1) {
        const long long yc = __shfl_up_sync(kFull, c, off);
        const double ymn = __shfl_up_sync(kFull, mn, off);
        const double ymx = __shfl_up_sync(kFull, mx, off);
        if (lane - off >= first) {
          c += yc;
          mn = dmin(mn, ymn);
          mx = dmax(mx, ymx);
        }
      }
      if (lane == last && rid[m] >= 0) {
        const int at = q - lane + first;
        pc[at] = c;
        pmn[at] = mn;
        pmx[at] = mx;
      }
    }
    __syncthreads();
    QPHASE(4);
    // the sums' complete nodes inside each record's ranks, level by level
    for (int step = 1; step < n_valid; step <<= 1) {
#pragma unroll
      for (int m = 0; m < kItems; ++m) {
        const int q = tid + m * kThreads;
        if (rid[m] >= 0 && (rq[m] & (2 * step - 1)) == 0 && rq[m] + 2 * step <= rend[m])
          xs[q] = xs[q] + xs[q + step];
      }
      __syncthreads();
    }
    QPHASE(5);
    // each record's maximal nodes, in rank order, and its totals (a
    // thread a record; a warp a record where the chunk holds fewer
    // records than warps, its lanes over the record's pieces)
    double* nodes = P.nodes + J.node_base + j * node_stride + (long long)k * kChunk;
    const long long sr = J.subrec_base + j * sub_stride + (long long)k * J.rec_stride;
    const bool by_warp = D < kWarps;
    const int lanes = by_warp ? 32 : 1;
    for (int i = by_warp ? tid >> 5 : tid; i < D; i += by_warp ? kWarps : kThreads) {
      const int lo = rloc[i], hi = rloc[i + 1];
      const int sub = by_warp ? lane : 0;
      if (sub == 0) {
        const int r0 = rr0[i], end = r0 + (hi - lo);
        int kk = 0;
        for (int p = r0; p < end; p += 1 << node_level(p, end))
          nodes[lo + kk++] = xs[lo + (p - r0)];
      }
      long long c = 0;
      double mn = pos_inf(), mx = neg_inf();
      for (int blk = (lo >> 5) + sub; blk <= ((hi - 1) >> 5); blk += lanes) {
        const int q = max(lo, blk << 5);
        c += pc[q];
        mn = dmin(mn, pmn[q]);
        mx = dmax(mx, pmx[q]);
      }
      if (by_warp) {
        for (int off = 16; off > 0; off >>= 1) {
          c += __shfl_xor_sync(kFull, c, off);
          mn = dmin(mn, __shfl_xor_sync(kFull, mn, off));
          mx = dmax(mx, __shfl_xor_sync(kFull, mx, off));
        }
      }
      if (sub == 0) {
        P.sub_cnt[sr + i] = c;
        P.sub_min[sr + i] = mn;
        P.sub_max[sr + i] = mx;
      }
    }
    __syncthreads();
    QPHASE(6);
  }
}

// A warp per (job, sub-column, bucket): each of 16 lanes takes a chunk (16
// at a time), finds the bucket's record and its r0 (a warp scan), and stages
// the record's maximal nodes in shared memory in chunk order; lane 0 then
// pushes them into the bucket's counter in that order.  Count, min and max
// are warp reductions (order-free).  Lane 0 folds the tail and writes.
__global__ void __launch_bounds__(kMergeWarps * 32) agg_merge_kernel(Params P, long long merge_at) {
  __shared__ double buf[kMergeWarps][kMergeChunks * kNodesMax];
  __shared__ int wr0[kMergeWarps][32], wcnt[kMergeWarps][32], wpos[kMergeWarps][32];
  __shared__ double counter[kMergeWarps][kMaxLevels];
  QPHASE_START();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long work = P.table[merge_at + blockIdx.x];
  const Job J = load_job(P, static_cast<int>(work >> 40));
  const int j = static_cast<int>((work >> 32) & 0xff);
  const int b = static_cast<int>(work & 0xffffffff) * kMergeWarps + warp;
  if (b < J.nbp) {                          // uniform across the warp
    const long long node_stride = (long long)J.n_chunks * kChunk;
    const long long sub_stride = (long long)J.n_chunks * J.rec_stride;
    double* st = counter[warp];
    long long r = 0, c = 0;
    double mn = pos_inf(), mx = neg_inf();
    for (int k0 = 0; k0 < J.n_chunks; k0 += kMergeChunks) {
      const int k = k0 + lane;
      const int i = (lane < kMergeChunks && k < J.n_chunks) ? find_record(P, J, k, b) : -1;
      const long long slot = J.rec_base + (long long)k * J.rec_stride + i;
      int cnt = 0, nn = 0, loc = 0;
      if (i >= 0) {
        cnt = P.rec_cnt[slot];
        loc = P.rec_loc[slot];
        const long long sr = J.subrec_base + j * sub_stride + (long long)k * J.rec_stride + i;
        c += P.sub_cnt[sr];
        mn = dmin(mn, P.sub_min[sr]);
        mx = dmax(mx, P.sub_max[sr]);
      }
      const int incl = warp_inclusive_sum(cnt);
      const int r0 = static_cast<int>(r) + incl - cnt, end = r0 + cnt;
      for (int p = r0; p < end; p += 1 << node_level(p, end)) ++nn;
      const int pos = warp_inclusive_sum(nn) - nn;
      if (i >= 0) {
        const double* nodes =
            P.nodes + J.node_base + j * node_stride + (long long)k * kChunk + loc;
#pragma unroll 4
        for (int t = 0; t < nn; ++t) buf[warp][pos + t] = nodes[t];
      }
      wr0[warp][lane] = r0;
      wcnt[warp][lane] = cnt;
      wpos[warp][lane] = pos;
      __syncwarp();
      if (lane == 0) {
        const int n_here = min(kMergeChunks, J.n_chunks - k0);
        for (int kk = 0; kk < n_here; ++kk) {
          int p = wr0[warp][kk];
          const int e = p + wcnt[warp][kk];
          for (int t = wpos[warp][kk]; p < e; ++t) {
            const int l = node_level(p, e);
            push(st, p, l, buf[warp][t]);
            p += 1 << l;
          }
        }
      }
      __syncwarp();
      r += __shfl_sync(kFull, incl, 31);
    }
    for (int off = 16; off > 0; off >>= 1) {
      c += __shfl_xor_sync(kFull, c, off);
      mn = dmin(mn, __shfl_xor_sync(kFull, mn, off));
      mx = dmax(mx, __shfl_xor_sync(kFull, mx, off));
    }
    if (lane == 0) {
      double acc = 0.0;
      bool have = false;
      for (int l = 0; (r >> l) != 0; ++l) {
        if ((r >> l) & 1) {
          acc = have ? st[l] + acc : st[l];
          have = true;
        }
      }
      long long* part = P.out + J.out_off + (long long)(1 + 4 * j) * J.nbp;
      part[b] = __double_as_longlong(have ? acc + 0.0 : 0.0);
      part[J.nbp + b] = c;
      part[2 * J.nbp + b] = __double_as_longlong(mn);
      part[3 * J.nbp + b] = __double_as_longlong(mx);
    }
  }
  QPHASE(7);
}

long long count_smem(int n_edges_smem, int dense_cols) {
  return 8LL * n_edges_smem + 4LL * (kChunk + 1 + 2 * kThreads + kWarps + 1 + dense_cols);
}

long long reduce_smem(int rec_stride_max) {
  return 32LL * kChunk + 4LL * (2LL * rec_stride_max + 1);
}

}  // namespace

#ifdef AGG_OLD_ROUTE
#include "aggs_old_route.cuh"
#endif

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// Dynamic shared memory of a count (which = 0) or reduce (which = 1)
// block; ops/cuda_aggs.py `smem_bytes` mirrors it.
long long agg_smem_bytes(int which, int n_edges_smem, int dense_cols, int rec_stride_max) {
  return which == 0 ? count_smem(n_edges_smem, dense_cols) : reduce_smem(rec_stride_max);
}

// The kernels' entries a block takes (AGG_CHUNK) and their threads.
int agg_chunk() { return kChunk; }

// One call over every job of `table` (device memory, layout above); the
// host words `w` (ops/cuda_aggs.py builds them, `CALL_WORDS` of them):
//   0 jobs, 1 job words, 2 chunk items, 3 scan items, 4 merge items,
//   5 mode, 6 sub_f64, 7 edges, 8 n_edges, 9 edges in shared memory,
//   10 dense columns, 11 record stride, 12 out, 13 rec_n, 14 rec_bucket,
//   15 rec_cnt, 16 rec_loc, 17 rec_r0, 18 dense_idx, 19 perm, 20 nodes,
//   21 sub_cnt, 22 sub_min, 23 sub_max.
// Launches count and scan, then reduce and merge where a job has a
// sub-column (merge items > 0).  Returns the CUDA error of the launches
// (0 on success); faults surface at the caller's next sync.
int agg_collect_launch(const long long* table, const long long* w, void* stream) {
  Params p;
  p.table = table;
  p.n_jobs = static_cast<int>(w[0]);
  p.job_words = static_cast<int>(w[1]);
  p.n_chunk_items = w[2];
  p.n_scan_items = w[3];
  const long long n_merge = w[4];
  p.mode = static_cast<int>(w[5]);
  p.sub_f64 = static_cast<unsigned>(w[6]);
  p.edges = reinterpret_cast<const double*>(w[7]);
  p.n_edges = static_cast<int>(w[8]);
  p.edges_smem = static_cast<int>(w[9]);
  p.dense_cols = static_cast<int>(w[10]);
  p.rec_stride_max = static_cast<int>(w[11]);
  p.out = reinterpret_cast<long long*>(w[12]);
  p.rec_n = reinterpret_cast<int*>(w[13]);
  p.rec_bucket = reinterpret_cast<int*>(w[14]);
  p.rec_cnt = reinterpret_cast<int*>(w[15]);
  p.rec_loc = reinterpret_cast<int*>(w[16]);
  p.rec_r0 = reinterpret_cast<int*>(w[17]);
  p.dense_idx = reinterpret_cast<int*>(w[18]);
  p.perm = reinterpret_cast<unsigned short*>(w[19]);
  p.nodes = reinterpret_cast<double*>(w[20]);
  p.sub_cnt = reinterpret_cast<long long*>(w[21]);
  p.sub_min = reinterpret_cast<double*>(w[22]);
  p.sub_max = reinterpret_cast<double*>(w[23]);
  if (p.mode < 0 || p.mode > 2 || p.job_words < kHeadWords ||
      (p.mode == kEdges && (p.edges == nullptr || p.n_edges < 1)) || p.dense_cols > kChunk ||
      p.rec_stride_max > kChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long smem_c = count_smem(p.edges_smem ? p.n_edges : 0, p.dense_cols);
  cudaError_t err = cudaFuncSetAttribute(agg_count_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_c));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.n_chunk_items > 0)
    agg_count_kernel<<<static_cast<unsigned>(p.n_chunk_items), kThreads,
                       static_cast<size_t>(smem_c), s>>>(p);
  if (p.n_scan_items > 0)
    agg_scan_kernel<<<static_cast<unsigned>(p.n_scan_items), kLineThreads, 0, s>>>(p);
  if (n_merge > 0) {
    const long long smem_r = reduce_smem(p.rec_stride_max);
    err = cudaFuncSetAttribute(agg_reduce_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem_r));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (p.n_chunk_items > 0)
      agg_reduce_kernel<<<static_cast<unsigned>(p.n_chunk_items), kThreads,
                          static_cast<size_t>(smem_r), s>>>(p);
    agg_merge_kernel<<<static_cast<unsigned>(n_merge), kMergeWarps * 32, 0, s>>>(
        p, (long long)p.n_jobs * p.job_words + p.n_chunk_items + p.n_scan_items);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
