// Thin wrappers over the Hopper (sm_90) PTX that a kernel needs to stream
// contiguous runs of bytes from device memory into shared memory without
// spending threads on the copy: shared-memory barriers (`mbarrier`) that
// count bytes, and the 1-D bulk asynchronous copy that reports to them.
//
// A bulk copy needs source, destination and size to be multiples of 16
// bytes; the caller checks that and takes ordinary loads otherwise.

#pragma once

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises a barrier that `count` arrivals complete.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// After mbar_init and before the first copy that names the barrier: makes
// the initialised barrier visible to the copy engine (the async proxy).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One arrival, and the number of bytes the phase still has to receive.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Spins until the phase of the given parity has completed (the first
// phase after mbar_init has parity 0, the next 1, and so on). The copied
// bytes are visible to the caller when it returns.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// Copies `bytes` from device memory to this block's shared memory and
// subtracts them from the barrier's expected count as they land.
__device__ __forceinline__ void bulk_load(void* dst_smem,
                                          const void* src_gmem,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst_smem)),
      "l"(src_gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace hopper
