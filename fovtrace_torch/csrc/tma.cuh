// Hopper (sm_90a) TMA plumbing shared by the port's kernels: mbarriers in
// shared memory and 1-D bulk copies (cp.async.bulk) from device memory
// into shared memory that complete on one of them.
//
// A copy's source and destination must be 16-byte aligned and its size
// a multiple of 16; one barrier phase may expect at most 2^20 - 1 bytes.

#pragma once

#include <stdint.h>

static __device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void mbar_init(unsigned bar,
                                                 unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// arrive on the barrier (release: this thread's earlier writes are seen
// by whoever waits on the phase)
static __device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// arrive on the barrier and expect `bytes` of copies to complete on it
static __device__ __forceinline__ void mbar_expect_tx(unsigned bar,
                                                      unsigned bytes) {
  asm volatile(
      "{\n .reg .b64 st;\n"
      " mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

// wait until the barrier's phase with this parity has completed (acquire)
static __device__ __forceinline__ void mbar_wait(unsigned bar,
                                                 unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// 1-D bulk copy global -> shared that completes on barrier `bar`
static __device__ __forceinline__ void bulk_g2s(unsigned dst, const void* src,
                                                unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// order this thread's earlier shared-memory accesses before later
// accesses by the async (TMA) proxy
static __device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
