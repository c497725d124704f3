// K1: exact k-NN scoring on Hopper.
//
// Replaces the JAX package's Pallas kernel `knn_scores_pallas`
// (opensearch_tpu/ops/pallas_knn.py:62, bodies `_score_kernel_l2`,
// `_score_kernel_cosine`, `_score_kernel_ip`): the score of every row of
// vectors[n, d] (float32) against query[d], translated per space
//   l2:           1 / (1 + max(|v|^2 - 2 v.q + |q|^2, 0))
//   cosinesimil:  (1 + cos) / 2, norm product floored at 1e-30
//   innerproduct: v.q >= 0 ? v.q + 1 : 1 / (1 - v.q)
// and -inf on rows whose `valid` byte is 0.
//
// Bound on the card: memory.  The kernel reads n*d*4 bytes of vectors
// (plus n valid bytes) and writes n*4 bytes of scores, and does 4*d
// flops per row: at d = 128 that is 1 flop per byte, far below the
// H100's ~20 fp32 flops per byte of HBM bandwidth.  1M x 128 is 512 MB,
// about 0.15 ms at 3.35 TB/s.
//
// Design for that bound: one warp per row, rows handed out grid-stride.
// Each lane loads 16 bytes at a time (float4) of its row, so a warp reads
// 512 contiguous bytes per step — fully coalesced — and computes v.q and
// |v|^2 in the same pass with fp32 FMAs, then reduces both over the warp
// with shuffles.  The query is read through the read-only cache (every
// warp reads the same d floats).  |q|^2 comes from the wrapper, computed
// once per launch.  No shared memory and no tensor cores: the kernel
// streams each byte once, which is all the bound asks for.  Top-k stays
// in PyTorch (ops/knn.py).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int SPACE>
__device__ __forceinline__ float translate(float dot, float v2, float q2) {
  if (SPACE == 0) {  // l2
    float d2 = fmaxf(v2 - 2.0f * dot + q2, 0.0f);
    return 1.0f / (1.0f + d2);
  } else if (SPACE == 1) {  // cosinesimil
    float cosv = dot / fmaxf(sqrtf(v2) * sqrtf(q2), 1e-30f);
    return (1.0f + cosv) / 2.0f;
  } else {  // innerproduct
    return dot >= 0.0f ? dot + 1.0f : 1.0f / (1.0f - dot);
  }
}

template <int SPACE, bool VEC4>
__global__ void __launch_bounds__(kThreads)
knn_scores_kernel(const float* __restrict__ vectors,
                  const uint8_t* __restrict__ valid,
                  const float* __restrict__ query,
                  const float* __restrict__ q2_ptr,
                  float* __restrict__ out, long long n, int d) {
  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarpsPerBlock;
  const float q2 = __ldg(q2_ptr);
  for (long long row = first; row < n; row += stride) {
    float dot = 0.0f, v2 = 0.0f;
    if (VEC4) {
      const float4* v = reinterpret_cast<const float4*>(vectors + row * d);
      const float4* q = reinterpret_cast<const float4*>(query);
      for (int j = lane; j < (d >> 2); j += 32) {
        const float4 a = __ldcs(v + j);  // streamed once: evict-first
        const float4 b = __ldg(q + j);
        dot = fmaf(a.x, b.x, dot); v2 = fmaf(a.x, a.x, v2);
        dot = fmaf(a.y, b.y, dot); v2 = fmaf(a.y, a.y, v2);
        dot = fmaf(a.z, b.z, dot); v2 = fmaf(a.z, a.z, v2);
        dot = fmaf(a.w, b.w, dot); v2 = fmaf(a.w, a.w, v2);
      }
    } else {
      const float* v = vectors + row * d;
      for (int j = lane; j < d; j += 32) {
        const float a = __ldcs(v + j);
        dot = fmaf(a, __ldg(query + j), dot);
        v2 = fmaf(a, a, v2);
      }
    }
    dot = warp_sum(dot);
    v2 = warp_sum(v2);
    if (lane == 0) out[row] = valid[row] ? translate<SPACE>(dot, v2, q2) : -INFINITY;
  }
}

template <int SPACE>
cudaError_t launch(const float* vectors, const uint8_t* valid, const float* query,
                   const float* q2, float* out, long long n, int d, int grid,
                   cudaStream_t stream) {
  const bool vec4 = (d % 4 == 0) && (reinterpret_cast<uintptr_t>(vectors) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(query) % 16 == 0);
  if (vec4)
    knn_scores_kernel<SPACE, true><<<grid, kThreads, 0, stream>>>(vectors, valid, query, q2, out, n, d);
  else
    knn_scores_kernel<SPACE, false><<<grid, kThreads, 0, stream>>>(vectors, valid, query, q2, out, n, d);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// space: 0 = l2, 1 = cosinesimil, 2 = innerproduct.  Returns the CUDA
// error of the launch (0 on success); asynchronous faults surface at
// the caller's next synchronize.
int knn_scores_launch(const float* vectors, const uint8_t* valid, const float* query,
                      const float* q2, float* out, long long n, int d, int space,
                      void* stream) {
  if (n <= 0) return 0;
  long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int grid = static_cast<int>(blocks < 132 * 64 ? blocks : 132 * 64);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (space) {
    case 0: return launch<0>(vectors, valid, query, q2, out, n, d, grid, s);
    case 1: return launch<1>(vectors, valid, query, q2, out, n, d, grid, s);
    case 2: return launch<2>(vectors, valid, query, q2, out, n, d, grid, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
