// One row's v.q and |v|^2 in float64, the query's |q|^2, and the score
// made of them, in the one order the port's vector kernels share: K1
// (knn.cu) and K6 (ivf.cu).
//
// A group of L lanes (L = row_lanes(d), a power of two, at most 32)
// reduces one row: lane j adds the units j, j + L, ... in turn -- a unit
// is a float4 when d % 4 == 0, else one float -- each value by an fma in
// float64 (a product of two floats is exact there), then `group_sum`'s
// xor tree over the L lanes.  |q|^2 is summed by the 32 lanes of a warp
// (lane j adds q[j], q[j + 32], ...) and the same tree.  ops/knn.py
// `row_sums` sums in this very order, so the kernels equal their plain
// versions byte for byte.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace rowsum {

// Lanes that reduce one row of width d: each lane about four units
// (float4s, or floats when d % 4 != 0) of it (ops/knn.py `row_lanes`).
__host__ __device__ inline int row_lanes(int d) {
  const int units = (d & 3) == 0 ? d / 4 : d;
  int lanes = 1;
  while (lanes < 32 && lanes * 4 < units) lanes *= 2;
  return lanes;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// |q|^2 over the 32 lanes of a warp from the float64 query in shared
// memory: lane j adds q[j], q[j + 32], ..., then the xor tree.
__device__ __forceinline__ double query_norm2(const double* q_s, int d, int lane) {
  double q2 = 0.0;
  for (int j = lane; j < d; j += 32) q2 = fma(q_s[j], q_s[j], q2);
  return warp_sum(q2);
}

// The lanes' xor tree over a group of L lanes (every lane of the warp
// takes part).
__device__ __forceinline__ void group_sum(double& dot, double& v2, int L) {
  for (int off = L >> 1; off > 0; off >>= 1) {
    dot += __shfl_xor_sync(0xffffffffu, dot, off);
    v2 += __shfl_xor_sync(0xffffffffu, v2, off);
  }
}

// Lane `sub`'s share of a row: units sub, sub + L, ... of `row` (a unit
// W = 4 floats, read as one 16-byte load: `row` 16-byte aligned; or
// W = 1 float) against the float64 query q_s, added to dot and v2.
template <int W>
__device__ __forceinline__ void row_accumulate(const float* __restrict__ row, const double* q_s,
                                               int d, int L, int sub, double& dot, double& v2) {
  const int units = d / W;
  for (int j = sub; j < units; j += L) {
    if (W == 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(row) + j);
      const double ax = a.x, ay = a.y, az = a.z, aw = a.w;
      dot = fma(ax, q_s[4 * j], dot); v2 = fma(ax, ax, v2);
      dot = fma(ay, q_s[4 * j + 1], dot); v2 = fma(ay, ay, v2);
      dot = fma(az, q_s[4 * j + 2], dot); v2 = fma(az, az, v2);
      dot = fma(aw, q_s[4 * j + 3], dot); v2 = fma(aw, aw, v2);
    } else {
      const double a = __ldg(row + j);
      dot = fma(a, q_s[j], dot);
      v2 = fma(a, a, v2);
    }
  }
}

// The function `FN` of a row's sums, rounded once (ops/knn.py
// `FUNCTIONS`: 0 l2, 1 cosinesimil, 2 innerproduct, 3 dotProduct,
// 4 l2Squared, 5 cosineSimilarity).
template <int FN>
__device__ __forceinline__ float translate(double dot, double v2, double q2) {
  double sc;
  if (FN == 0) {  // l2
    const double d2 = fmax(v2 - 2.0 * dot + q2, 0.0);
    sc = 1.0 / (1.0 + d2);
  } else if (FN == 1) {  // cosinesimil
    const double cosv = dot / fmax(sqrt(v2) * sqrt(q2), 1e-30);
    sc = (1.0 + cosv) / 2.0;
  } else if (FN == 2) {  // innerproduct
    sc = dot >= 0.0 ? dot + 1.0 : 1.0 / (1.0 - dot);
  } else if (FN == 3) {  // dotProduct
    sc = dot;
  } else if (FN == 4) {  // l2Squared
    sc = fmax(v2 - 2.0 * dot + q2, 0.0);
  } else {  // cosineSimilarity
    sc = dot / fmax(sqrt(v2) * sqrt(q2), 1e-30);
  }
  return __double2float_rn(sc);
}

}  // namespace rowsum
