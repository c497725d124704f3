// K10, the cross-shard merge on Hopper: the global top k of R sorted rows
// in one launch.
//
// Replaces the JAX package's `sharded_topk_merge`
// (opensearch_tpu/parallel/dist_search.py:170): `lax.top_k` of the
// all-gathered [S, k] shard lists, flattened, which the reference also
// runs inside `sharded_impact_topk` (:513) and `MeshSearcher.search`.
// Input: vals [R, w] float32, each row sorted in descending order with
// -inf as padding (a shard's, or a (shard, segment)'s, top-k list as the
// port's top-k kernels write it).  Output: the k largest of the R * w
// values and their flat indices r * w + c, the lower flat index first
// on ties (-inf ties included): exactly `lax.top_k(vals.reshape(-1), k)`,
// which is the coordinator's (score desc, shard asc, local rank asc)
// order.  The port's plain version is a stable descending sort of the
// flat values (ops/mesh.py mesh_merge_plain); -0.0 and +0.0 compare
// equal here as they do in that sort.
//
// Design: every row is sorted, so an entry (r, c) finds its rank in the
// flat stable order without any shared state: c entries of its own row
// come before it, and of every other row r' the entries >= v (r' < r) or
// > v (r' > r), each count one binary search.  A thread owns one entry of
// the first min(w, k) columns (an entry past column k - 1 ranks at least
// k) and writes it at its rank when that is below k; the ranks are a
// permutation, so the k outputs are written once each, in any order, and
// the result does not depend on scheduling.  Work: R * min(w, k) * (R - 1)
// * log2(w) comparisons; a thread stops counting once its rank reaches k.
//
// Bound on the card: memory and launch.  It reads R * w * 4 bytes and
// writes k * 12; at the mesh's shapes (R <= 64, k <= 1,000) that is well
// under a microsecond of bandwidth, so the launch itself bounds it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// entries of row[0, w) (sorted descending) that are >= v (or > v)
__device__ __forceinline__ int count_above(const float* __restrict__ row, int w, float v,
                                           bool inclusive) {
  int lo = 0, hi = w;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const float x = __ldg(row + mid);
    const bool before = inclusive ? (x >= v) : (x > v);
    if (before) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads)
mesh_merge_kernel(const float* __restrict__ vals, int rows, int w, int k, int cols,
                  float* __restrict__ out_vals, long long* __restrict__ out_idx) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)rows * cols) return;
  const int r = (int)(e / cols);
  const int c = (int)(e % cols);
  const float v = __ldg(vals + (long long)r * w + c);
  int rank = c;
  for (int o = 0; o < rows && rank < k; ++o) {
    if (o == r) continue;
    rank += count_above(vals + (long long)o * w, w, v, o < r);
  }
  if (rank < k) {
    out_vals[rank] = v;
    out_idx[rank] = (long long)r * w + c;
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// The top k of vals [rows, w] (device memory, each row sorted descending)
// into out_vals [k] and out_idx [k] (flat indices).  Needs 1 <= k <=
// rows * w.  Returns the CUDA error of the launch (0 on success); faults
// surface at the caller's next sync.
int mesh_merge_launch(const float* vals, int rows, int w, int k, float* out_vals,
                      long long* out_idx, void* stream) {
  if (rows < 1 || w < 1 || k < 1 || (long long)k > (long long)rows * w)
    return static_cast<int>(cudaErrorInvalidValue);
  const int cols = w < k ? w : k;
  const long long n = (long long)rows * cols;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffll) return static_cast<int>(cudaErrorInvalidValue);
  mesh_merge_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      vals, rows, w, k, cols, out_vals, out_idx);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
