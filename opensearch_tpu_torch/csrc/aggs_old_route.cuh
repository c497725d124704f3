// The bucket collector K5 replaced (one block per (segment, tile of at
// most 64 buckets) streaming its segment's every entry in 256-entry
// chunks, the tree built as a binary counter per bucket in shared memory),
// kept only as the yardstick of testing/k5_sweep.py: csrc/aggs.cu includes
// this file only under -DAGG_OLD_ROUTE, which no path of the port builds.
// The next change to K5 deletes it.  Its table: per segment 8 words
// {matched, keys, key_docs, n_entries, n_buckets, n_buckets_pad, output
// offset, 0}, then 2 words {values, offsets} per sub-column; then one word
// per block, segment << 32 | tile.
#pragma once

namespace old_route {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeadWords = 8;

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

__global__ void __launch_bounds__(kThreads) agg_old_kernel(Params P) {
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

}  // namespace old_route

extern "C" {

long long agg_old_smem_bytes(int tile, int n_subs, int levels, int n_edges_smem) {
  return 8LL * ((long long)n_subs * tile * levels + 2LL * n_subs * tile + 3LL * old_route::kThreads
                + n_edges_smem)
         + 8LL * ((long long)n_subs * tile + tile + old_route::kThreads)
         + 4LL * ((long long)old_route::kWarps * tile + 2 * old_route::kThreads + 2);
}

int agg_old_launch(const long long* table, int n_segs, int n_blocks, int seg_words,
                       int mode, int key_dtype, int n_subs, unsigned sub_f64,
                       int self_metric, int tile, int levels, const double* edges,
                       int n_edges, int edges_smem, long long* out, void* stream) {
  if (n_blocks <= 0) return 0;
  if (mode < 0 || mode > 2 || tile < 1 || levels < 1 || levels > 62 || n_subs < 0 ||
      n_subs > 32 || (mode == kEdges && (edges == nullptr || n_edges < 1)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = agg_old_smem_bytes(tile, n_subs, levels, edges_smem ? n_edges : 0);
  cudaError_t err = cudaFuncSetAttribute(old_route::agg_old_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  old_route::Params p{table, seg_words, n_segs, mode, key_dtype, n_subs, sub_f64, self_metric,
           tile, levels, edges, n_edges, edges_smem, out};
  old_route::agg_old_kernel<<<n_blocks, old_route::kThreads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
