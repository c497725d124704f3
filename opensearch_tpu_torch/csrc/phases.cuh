// Where a kernel's cycles go: a library built with -DQUANT_PHASES has
// thread 0 of each block add the SM cycles from one mark to the next into
// quant_phase_cycles, an array of that library's own; quant_phases(out)
// copies the sums to out[0, 8) and zeroes them.  Without the macro every
// mark is empty and nothing is exported.  The slots:
//   K4 (quant_topk.cu, testing/k4_sweep.py):
//   0 table, live load and zeroing    4 key build (and the total / max atomics)
//   1 the row searches                5 select_top
//   2 copy issue and wait             6 the post and the last block's merge
//   3 scatter                         7 slots scattered (a count, not cycles)
//   K5 (aggs.cu, testing/k5_sweep.py):
//   0 count: load, buckets, validity  4 reduce: partials
//   1 count: the block's sort         5 reduce: the tree's levels
//   2 count: the records              6 reduce: the maximal nodes
//   3 scan                            7 merge
//   K6 / K7 (ivf.cu, testing/k6_sweep.py; scan marks from the end of
//   the grid dependency wait):
//   0 probe: score                    4 scan: score (K6: the stages' sums,
//   1 probe: select                     then the translations)
//   2 table pass (K7)                 5 scan: tile select
//   3 scan: row / code, id and live   6 scan: post and merge
//     load (the copies' waits)        7 scan blocks with rows (a count)
//   K8 / K9 (positions.cu, testing/k8_sweep.py):
//   0 the job: lookup and words       4 each other slot's window and its
//   1 the window of entries: its        entries' intersection
//     copy's wait, the search in it   5 each other slot's merge walks
//   2 the positions' copy (a search   6 the counts
//     of the row when the window      7 the writes (and entries over blocks)
//     missed)
//   3 each thread's positions and their entries
// (K3's union_topk.cu keeps its own -DUNION_PHASES marks.)
#pragma once

#include <cuda_runtime.h>

#ifdef QUANT_PHASES
__device__ unsigned long long quant_phase_cycles[8];
#define QPHASE_START() long long qphase_t = clock64()
#define QPHASE(i)                                                                  \
  do {                                                                             \
    if (threadIdx.x == 0) {                                                        \
      const long long now = clock64();                                             \
      atomicAdd(&quant_phase_cycles[i], (unsigned long long)(now - qphase_t));     \
      qphase_t = now;                                                              \
    }                                                                              \
  } while (0)
#define QPHASE_COUNT(i)                                          \
  do {                                                           \
    if (threadIdx.x == 0) atomicAdd(&quant_phase_cycles[i], 1ull); \
  } while (0)

extern "C" int quant_phases(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, quant_phase_cycles, sizeof(unsigned long long) * 8);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(quant_phase_cycles, zero, sizeof(zero)));
}
#else
#define QPHASE_START() \
  do {                 \
  } while (0)
#define QPHASE(i) \
  do {            \
  } while (0)
#define QPHASE_COUNT(i) \
  do {                  \
  } while (0)
#endif
