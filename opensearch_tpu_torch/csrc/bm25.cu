// K2: term-bag impact scoring on Hopper.
//
// Replaces the JAX package's `gather_postings` + `impact_scores` /
// `impact_score_count` / `match_count` (opensearch_tpu/ops/bm25.py:83,
// :191, :206, :225).  Those are XLA ops there, not Pallas kernels: a
// searchsorted flatten of the query terms' CSR rows into `budget` lanes,
// then a scatter-add of w[slot] * (idf[slot] * imp[p]) into dense float32
// scores[n_pad] and of 1 into int32 counts[n_pad].
//
// Bound on the card: memory.  Per posting of an active term the work
// reads a 4-byte doc id and a 4-byte impact and does 2 multiplies and an
// add; the outputs are n_pad*4 bytes per column, written once.  The
// bound is (8 * postings + 4 * n_pad * columns) / 3.35 TB/s.
//
// Design: the kernel walks one active term's CSR row
// offsets[tid]..offsets[tid+1] directly (no searchsorted over a lane
// budget), one posting per thread, grid-stride.  The wrapper launches it
// once per query-term slot, in slot order, on one stream, into buffers
// it zeroes first.  Doc ids are unique within a row, so within a launch
// no two threads touch one doc and a plain read-modify-write is exact,
// and across launches the stream order makes every doc's sum add in slot
// order from 0.0 — the reference's per-doc accumulation order, so the
// scores match it byte for byte.  (A float atomicAdd across slots would
// race and break that.)  The arithmetic is spelled with __fmul_rn /
// __fadd_rn in the order w * (idf * imp) and the library is built with
// -fmad=false: no FMA contraction, which would round differently.
// Reads of doc ids and impacts are coalesced; the score updates are
// scattered, as the postings are.  Launching once per slot costs T
// launches per call (T is usually 2-8); fusing them is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
term_bag_slot_kernel(const int32_t* __restrict__ offsets,
                     const int32_t* __restrict__ doc_ids,
                     const float* __restrict__ impacts,
                     const int32_t* __restrict__ term_ids,
                     const uint8_t* __restrict__ term_active,
                     const float* __restrict__ idfs,
                     const float* __restrict__ weights, int slot,
                     float* __restrict__ scores, int32_t* __restrict__ counts) {
  if (!term_active[slot]) return;
  const int32_t tid = term_ids[slot];
  const int32_t start = offsets[tid];
  const int32_t end = offsets[tid + 1];
  const float idf = scores != nullptr ? idfs[slot] : 0.0f;
  const float w = scores != nullptr ? weights[slot] : 0.0f;
  for (int32_t p = start + blockIdx.x * blockDim.x + threadIdx.x; p < end;
       p += gridDim.x * blockDim.x) {
    const int32_t doc = doc_ids[p];
    if (scores != nullptr)
      scores[doc] = __fadd_rn(scores[doc], __fmul_rn(w, __fmul_rn(idf, impacts[p])));
    if (counts != nullptr) counts[doc] += 1;
  }
}

}  // namespace

extern "C" {

const char* error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

// One launch per slot 0..t_pad-1, in order (inactive slots return at
// once).  `grid` blocks per launch, grid-stride over the row.  `scores`
// or `counts` may be null to skip that column.  Returns the first launch
// error (0 on success).
int term_bag_launch(const int32_t* offsets, const int32_t* doc_ids, const float* impacts,
                    const int32_t* term_ids, const uint8_t* term_active, const float* idfs,
                    const float* weights, int t_pad, int grid, float* scores,
                    int32_t* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int slot = 0; slot < t_pad; ++slot) {
    term_bag_slot_kernel<<<grid, kThreads, 0, s>>>(offsets, doc_ids, impacts, term_ids,
                                                   term_active, idfs, weights, slot, scores,
                                                   counts);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"
