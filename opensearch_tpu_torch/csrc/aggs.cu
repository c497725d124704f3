// K5: the bucket collector of aggregations on Hopper.
//
// Replaces the JAX package's XLA scatters of opensearch_tpu/ops/aggs.py
// (`ordinal_counts` :58, `bucketed_counts` :67, `masked_metrics` :80,
// `per_doc_partials` :92 and `scatter_partials_to_buckets` :107), as the
// collect phase of opensearch_tpu/search/aggs.py calls them per segment:
// each bucket's doc count and, per metric sub-column, each bucket's
// (sum f64, count i64, min f64, max f64), for every segment of a request
// in ONE launch.  The plain version is ops/aggs.py `bucket_collect_plain`.
//
// Modes (the bucket of entry e of the key column):
//   0 ordinal  keys[e] (int32 ordinal; < 0 is no value); ordinals are
//              deduplicated per doc, so every entry counts;
//   1 edges    upper_bound(edges, double(keys[e])) - 1, valid in
//              [0, n_buckets); only the first (doc, bucket) entry of a doc
//              counts, for its doc count and its metrics alike;
//   2 single   bucket 0 (an int32 key column counts ordinals >= 0).  With
//              self_metric the key column's own values are the one metric
//              (an entry's partial is its value), duplicates included.
// A valid entry also needs matched[doc].  A sub-column's partial for a
// valid entry is its doc's (sum, count, min, max): the doc's values
// offsets[d] .. offsets[d + 1] in column order, summed from 0.0.
//
// Summation order (the trap): counts, min and max do not depend on it;
// float64 sums do.  Each bucket's sum is the PAIRWISE TREE over the
// bucket's valid entries in entry order (ops/aggs.py `pairwise_sums`):
// the node of rank r at level l (r a multiple of 2^(l+1)) takes the node
// of rank r + 2^l.  No float atomics: the tree is built streaming, as a
// binary counter of complete nodes per bucket in shared memory (`push`),
// and the incomplete tail is folded from the lowest level up at the end,
// which is exactly the plain tree's right-nested remainder.  So the card
// equals the plain version on the CPU and on the card, byte for byte,
// and two launches give the same bytes.
//
// Bound on the card: bytes.  Each key entry is read once (4 or 8 bytes,
// 4 for its doc, 1 for matched) and, per sub-column, its doc's offsets and
// values; outputs are (1 + 4 S) words per bucket.  About 21 bytes per
// entry with one sub-column: ~6 us per 1M entries at 3.35 TB/s.
//
// Design (right first, one launch; not tuned):
// - One block of 256 threads per (segment, tile of `tile` buckets), from
//   a flat work list beside a per-segment table of pointers, both in one
//   small int64 buffer the host copies per call.  The block streams its
//   segment's entries in order, 256 at a time; entries outside its tile
//   are skipped (a block of a tile past n_buckets only writes its
//   outputs).
// - Per chunk: each thread computes its entry's bucket (edges searched in
//   shared memory when they fit, else in global memory) and validity
//   (the previous entry's (doc, bucket) from shared memory, across chunks
//   too).  __match_any_sync groups a warp's entries by bucket; a group's
//   ranks in the bucket's run are the bucket's count so far, plus the
//   earlier warps' group sizes, plus the rank in the group.  The group's
//   partials are compacted into shared memory and reduced in the tree's
//   complete nodes (levels 0-4, __syncwarp between levels); the group's
//   leader then pushes its maximal complete nodes, in rank order, into
//   the bucket's counter, warp after warp (the counter is sequential).
// - Min, max and counts ride the same nodes.  Outputs: per segment, at
//   its output offset, [counts | sum_0, count_0, min_0, max_0 | ...],
//   n_buckets_pad words each (float64 as bits); buckets without entries
//   (the dead bucket n_buckets_pad - 1 among them) get (0, 0.0, 0, +inf,
//   -inf), as the plain version's scatters leave them.
//
// The table's layout (ops/cuda_aggs.py `launch_table`): per segment
// kHeadWords words {matched, keys, key_docs, n_entries, n_buckets,
// n_buckets_pad, output offset, 0}, then 2 words {values, offsets} per
// sub-column (0 where the segment lacks it); then one word per block,
// segment << 32 | tile.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadWords = 8;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kOrdinal = 0, kEdges = 1, kSingle = 2 };
enum Dtype { kI32 = 0, kI64 = 1, kF64 = 2 };

struct Params {
  const long long* table;
  int seg_words;
  int n_segs;
  int mode;
  int key_dtype;
  int n_subs;
  unsigned sub_f64;      // bit j: sub-column j holds float64 (else int64)
  int self_metric;
  int tile;
  int levels;            // counter levels: bit length of the longest run
  const double* edges;
  int n_edges;
  int edges_smem;
  long long* out;
};

__device__ __forceinline__ double key_value(const void* keys, int dtype, long long e) {
  if (dtype == kI64) return static_cast<double>(static_cast<const long long*>(keys)[e]);
  if (dtype == kF64) return static_cast<const double*>(keys)[e];
  return static_cast<double>(static_cast<const int*>(keys)[e]);
}

__device__ __forceinline__ double sub_value(const void* vals, bool f64, long long k) {
  return f64 ? static_cast<const double*>(vals)[k]
             : static_cast<double>(static_cast<const long long*>(vals)[k]);
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

// Adds a complete node of 2^l entries, whose first entry has rank p (a
// multiple of 2^l), to the counter `st` of a bucket holding p entries.
__device__ __forceinline__ void push(double* st, long long p, int l, double v) {
  double carry = v;
  while ((p >> l) & 1) {
    carry = st[l] + carry;
    ++l;
  }
  st[l] = carry;
}

__global__ void __launch_bounds__(kThreads) agg_collect_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = P.tile, S = P.n_subs, L = P.levels;
  const long long work = P.table[(long long)P.n_segs * P.seg_words + blockIdx.x];
  const int seg = static_cast<int>(work >> 32);
  const int b0 = static_cast<int>(work & 0xffffffff) * tile;
  const long long* head = P.table + (long long)seg * P.seg_words;
  const unsigned char* matched = reinterpret_cast<const unsigned char*>(head[0]);
  const void* keys = reinterpret_cast<const void*>(head[1]);
  const int* key_docs = reinterpret_cast<const int*>(head[2]);
  const long long n = head[3];
  const int nb = static_cast<int>(head[4]);
  const int nbp = static_cast<int>(head[5]);
  long long* out = P.out + head[6];

  // shared memory: doubles, then 64-bit counts, then ints
  double* stack = reinterpret_cast<double*>(smem);                 // [S][tile][L]
  double* smin = stack + (size_t)S * tile * L;                     // [S][tile]
  double* smax = smin + (size_t)S * tile;                          // [S][tile]
  double* xs = smax + (size_t)S * tile;                            // [kThreads]
  double* xmn = xs + kThreads;
  double* xmx = xmn + kThreads;
  double* sedges = xmx + kThreads;                                 // [n_edges] or none
  long long* scnt = reinterpret_cast<long long*>(
      sedges + (P.edges_smem ? P.n_edges : 0));                    // [S][tile]
  long long* bcount = scnt + (size_t)S * tile;                     // [tile]
  long long* xc = bcount + tile;                                   // [kThreads]
  int* cnt_w = reinterpret_cast<int*>(xc + kThreads);              // [kWarps][tile]
  int* dsh = cnt_w + kWarps * tile;                                // [kThreads]
  int* bsh = dsh + kThreads;                                       // [kThreads]
  int* prev = bsh + kThreads;                                      // {doc, bucket}

  for (int i = tid; i < tile; i += kThreads) bcount[i] = 0;
  for (int i = tid; i < S * tile; i += kThreads) {
    scnt[i] = 0;
    smin[i] = __longlong_as_double(0x7ff0000000000000LL);   // +inf
    smax[i] = __longlong_as_double((long long)0xfff0000000000000ULL);  // -inf
  }
  const double* edges = P.edges;
  if (P.mode == kEdges && P.edges_smem) {
    for (int i = tid; i < P.n_edges; i += kThreads) sedges[i] = P.edges[i];
    edges = sedges;
  }
  if (tid == 0) { prev[0] = -1; prev[1] = -1; }
  __syncthreads();

  const unsigned lt_mask = (1u << lane) - 1u;
  const long long stream_n = b0 < nb ? n : 0;   // a tile past n_buckets has no entries
  for (long long base = 0; base < stream_n; base += kThreads) {
    const long long e = base + tid;
    const bool in = e < n;
    int d = -1, b = -1;
    if (in) {
      d = key_docs[e];
      if (P.mode == kOrdinal) {
        b = static_cast<const int*>(keys)[e];
      } else if (P.mode == kEdges) {
        b = upper_bound(edges, P.n_edges, key_value(keys, P.key_dtype, e)) - 1;
      } else {
        b = (P.key_dtype == kI32 && static_cast<const int*>(keys)[e] < 0) ? -1 : 0;
      }
    }
    dsh[tid] = d;
    bsh[tid] = b;
    for (int i = tid; i < kWarps * tile; i += kThreads) cnt_w[i] = 0;
    __syncthreads();
    const int pd = tid ? dsh[tid - 1] : prev[0];
    const int pb = tid ? bsh[tid - 1] : prev[1];
    bool valid = in && b >= 0 && b < nb && matched[d];
    if (P.mode == kEdges) valid = valid && !(pd == d && pb == b);
    const int key = (valid && b >= b0 && b < b0 + tile) ? b - b0 : -1;
    const unsigned mask = __match_any_sync(kFull, key);
    const int rank_in = __popc(mask & lt_mask);
    const int gsize = __popc(mask);
    const int leader = __ffs(mask) - 1;
    const bool lead = key >= 0 && rank_in == 0;
    if (lead) cnt_w[warp * tile + key] = gsize;
    // where the group's partials sit in the warp's compacted slots
    const int lead_size = lead ? gsize : 0;
    int incl = lead_size;
    for (int off = 1; off < 32; off <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += t;
    }
    const int gbase = __shfl_sync(kFull, incl - lead_size, leader);
    __syncthreads();
    if (tid == kThreads - 1) { prev[0] = d; prev[1] = b; }
    long long r0 = 0;
    if (key >= 0) {
      r0 = bcount[key];
      for (int w = 0; w < warp; ++w) r0 += cnt_w[w * tile + key];
    }
    const long long r = r0 + rank_in, rend = r0 + gsize;
    const int q = warp * 32 + gbase + rank_in;
    for (int j = 0; j < S; ++j) {
      if (key >= 0) {
        double s = 0.0, mn, mx;
        long long c;
        if (P.self_metric) {
          s = key_value(keys, P.key_dtype, e);
          mn = mx = s;
          c = 1;
        } else {
          const void* vals = reinterpret_cast<const void*>(head[kHeadWords + 2 * j]);
          const int* offs = reinterpret_cast<const int*>(head[kHeadWords + 2 * j + 1]);
          mn = __longlong_as_double(0x7ff0000000000000LL);
          mx = __longlong_as_double((long long)0xfff0000000000000ULL);
          c = 0;
          if (vals != nullptr) {
            const bool f64 = (P.sub_f64 >> j) & 1u;
            const int lo = offs[d], hi = offs[d + 1];
            for (int k = lo; k < hi; ++k) {
              const double v = sub_value(vals, f64, k);
              s = s + v;
              mn = v < mn ? v : mn;
              mx = v > mx ? v : mx;
            }
            c = hi - lo;
          }
        }
        xs[q] = s;
        xc[q] = c;
        xmn[q] = mn;
        xmx[q] = mx;
      }
      __syncwarp();
      for (int step = 1; step < 32; step <<= 1) {
        if (key >= 0 && (r % (2 * step)) == 0 && r + 2 * step <= rend) {
          xs[q] = xs[q] + xs[q + step];
          xc[q] += xc[q + step];
          xmn[q] = xmn[q + step] < xmn[q] ? xmn[q + step] : xmn[q];
          xmx[q] = xmx[q + step] > xmx[q] ? xmx[q + step] : xmx[q];
        }
        __syncwarp();
      }
      for (int w = 0; w < kWarps; ++w) {
        if (warp == w && lead) {
          double* st = stack + ((size_t)j * tile + key) * L;
          const int acc = j * tile + key;
          long long p = r0;
          while (p < rend) {
            int l = 0;
            while (l < 5 && (p % (2LL << l)) == 0 && p + (2LL << l) <= rend) ++l;
            const int slot = warp * 32 + gbase + static_cast<int>(p - r0);
            push(st, p, l, xs[slot]);
            scnt[acc] += xc[slot];
            smin[acc] = xmn[slot] < smin[acc] ? xmn[slot] : smin[acc];
            smax[acc] = xmx[slot] > smax[acc] ? xmx[slot] : smax[acc];
            p += 1LL << l;
          }
        }
        __syncthreads();
      }
    }
    __syncthreads();
    if (lead)   // one leader per (warp, bucket): an integer sum, any order
      atomicAdd(reinterpret_cast<unsigned long long*>(&bcount[key]),
                static_cast<unsigned long long>(gsize));
    __syncthreads();
  }

  // outputs of the tile's buckets
  for (int k = tid; k < tile; k += kThreads) {
    const int bucket = b0 + k;
    if (bucket >= nbp) continue;
    const long long c = bcount[k];
    out[bucket] = c;
    for (int j = 0; j < S; ++j) {
      const double* st = stack + ((size_t)j * tile + k) * L;
      double acc = 0.0;
      bool have = false;
      for (int l = 0; l < L; ++l) {
        if ((c >> l) & 1) {
          acc = have ? st[l] + acc : st[l];
          have = true;
        }
      }
      long long* part = out + (long long)(1 + 4 * j) * nbp;
      part[bucket] = __double_as_longlong(have ? acc + 0.0 : 0.0);
      part[nbp + bucket] = scnt[j * tile + k];
      part[2 * nbp + bucket] = __double_as_longlong(smin[j * tile + k]);
      part[3 * nbp + bucket] = __double_as_longlong(smax[j * tile + k]);
    }
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// Dynamic shared memory of one block (ops/cuda_aggs.py mirrors it to
// pick the tile).
long long agg_smem_bytes(int tile, int n_subs, int levels, int n_edges_smem) {
  return 8LL * ((long long)n_subs * tile * levels + 2LL * n_subs * tile + 3LL * kThreads
                + n_edges_smem)
         + 8LL * ((long long)n_subs * tile + tile + kThreads)
         + 4LL * ((long long)kWarps * tile + 2 * kThreads + 2);
}

// One launch over every segment of `table` (device memory, layout above).
// Returns the CUDA error of the launch (0 on success); faults surface at
// the caller's next sync.
int agg_collect_launch(const long long* table, int n_segs, int n_blocks, int seg_words,
                       int mode, int key_dtype, int n_subs, unsigned sub_f64,
                       int self_metric, int tile, int levels, const double* edges,
                       int n_edges, int edges_smem, long long* out, void* stream) {
  if (n_blocks <= 0) return 0;
  if (mode < 0 || mode > 2 || tile < 1 || levels < 1 || levels > 62 || n_subs < 0 ||
      n_subs > 32 || (mode == kEdges && (edges == nullptr || n_edges < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = agg_smem_bytes(tile, n_subs, levels, edges_smem ? n_edges : 0);
  cudaError_t err = cudaFuncSetAttribute(agg_collect_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{table, seg_words, n_segs, mode, key_dtype, n_subs, sub_f64, self_metric,
           tile, levels, edges, n_edges, edges_smem, out};
  agg_collect_kernel<<<n_blocks, kThreads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
