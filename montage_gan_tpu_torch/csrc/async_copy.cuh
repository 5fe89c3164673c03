// Hopper's asynchronous bulk copy (the Tensor Memory Accelerator's 1-D
// form) from device memory into shared memory, completing on an mbarrier
// in shared memory: the barrier's phase ends when its arrivals are in and
// the bytes it was told to expect have landed.  PTX for sm_90.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t mgt_smem(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A barrier that expects `count` arrivals per phase; then, once by the
// initialising thread, mgt_mbar_init_fence before any other thread or the
// copy engine uses it.
__device__ __forceinline__ void mgt_mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(mgt_smem(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mgt_mbar_init_fence() {
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Arrive on the barrier and tell it to expect `bytes` more (0: a plain
// arrival).
__device__ __forceinline__ void mgt_mbar_arrive_expect(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(mgt_smem(bar)),
                 "r"(bytes)
                 : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mgt_mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done = 0;
    do {
        asm volatile(
            "{\n\t.reg .pred p;\n\t"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
            "selp.u32 %0, 1, 0, p;\n\t}"
            : "=r"(done)
            : "r"(mgt_smem(bar)), "r"(parity)
            : "memory");
    } while (!done);
}

// Order this thread's earlier accesses to shared memory (and, after a
// barrier, the block's) before the copy engine's later ones, e.g. a stage's
// reads before the copy that refills it.
__device__ __forceinline__ void mgt_fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device memory to shared memory; the bytes complete on `bar`.
__device__ __forceinline__ void mgt_bulk_load(void* dst, const void* src, uint32_t bytes,
                                              uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(mgt_smem(dst)), "l"(src), "r"(bytes), "r"(mgt_smem(bar))
        : "memory");
}
