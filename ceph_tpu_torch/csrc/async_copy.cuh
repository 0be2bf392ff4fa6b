// Asynchronous staging helpers shared by the region kernels on Hopper:
// mbarriers in shared memory, the 1-D bulk copy (TMA) from device memory
// into shared memory that completes on one of them, and the bulk copy
// back out, which completes in the issuing thread's bulk groups.
//
// A ring stage has a `full` barrier, on which the producer's bulk copies
// (or its plain stores, one arrival per lane) complete, and an `empty`
// barrier, on which every consumer thread arrives when it is done with
// the stage.  Waits take the parity of the stage's current use.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// `bytes` (a multiple of 16) from `src` (16-byte aligned) into `dst`,
// completing on `bar`.  The copy asks L2 to evict the source first: the
// region kernels read each input byte once, which leaves L2 to the
// outputs being written.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(policy));
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint "
      "[%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)), "l"(policy) : "memory");
}

// The other direction: `bytes` (a multiple of 16) from shared memory
// `src` to `dst` in device memory (both 16-byte aligned), stored, or
// XORed into what is there with `reduce_xor`.  The copy joins the
// issuing thread's open bulk group; bulk_commit() closes it.
__device__ __forceinline__ void bulk_store(void* dst, const void* src, uint32_t bytes,
                                           bool reduce_xor) {
  if (reduce_xor)
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.xor.b32 [%0], [%1], %2;" ::"l"(
            dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  else
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
                 "r"(smem_addr(src)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until the issuing thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Until the issuing thread's bulk stores are complete.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Makes this thread's shared-memory writes visible to bulk copies.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
