// Bulk asynchronous copies from device memory into shared memory on
// mbarriers (cp.async.bulk), shared by the kernels that stage runs of
// staged columns: K6 / K7 (ivf.cu) and K8 / K9 (positions.cu).
//
// A copy moves whole 16-byte units: the window [floor16(src),
// ceil16(src + bytes)) of device memory.  The caller's arrays start on
// 16 bytes and span whole 16-byte units (or keep 16 bytes of slack past
// their end), so the window stays inside them.
#pragma once

#include <stdint.h>

namespace bulk {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One arrival (the thread that posts the bytes) completes a phase.
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

// One thread: `bar` expects `bytes` more before its phase completes.
__device__ __forceinline__ void bar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// The size of the 16-byte window of `bytes` bytes at `src`.
__device__ __forceinline__ int window_bytes(const void* src, long long bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  return (int)(((a + bytes + 15) & ~(uintptr_t)15) - (a & ~(uintptr_t)15));
}

// That window into dst (16-byte aligned), completing on `bar`.
__device__ __forceinline__ void copy_window(void* dst, const void* src, int window, uint64_t* bar) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src) & ~(uintptr_t)15;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"((uint64_t)a), "r"(window), "r"(smem_u32(bar))
      : "memory");
}

// Where an element starts inside its window.
__device__ __forceinline__ int window_skip(const void* src) {
  return (int)(reinterpret_cast<uintptr_t>(src) & 15);
}

}  // namespace bulk
