// Shared helpers of the port's CUDA kernels: element conversion between the
// storage types (float32, bfloat16) and the float32 the kernels compute in,
// a 16-byte vector type for coalesced loads, and the error-string entry point
// that every library exports for its Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Storage type codes shared with the Python wrappers.
enum MgtDtype { MGT_FLOAT32 = 0, MGT_BFLOAT16 = 1 };

__device__ __forceinline__ float mgt_to_float(float v) { return v; }
__device__ __forceinline__ float mgt_to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T mgt_from_float(float v);
template <> __device__ __forceinline__ float mgt_from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 mgt_from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}

// VEC elements of T loaded or stored as one aligned access (16 bytes when
// sizeof(T) * VEC == 16).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) MgtVec {
    T v[VEC];
};

// A float32 value rounded to the storage type T (host side), e.g. a clamp
// bound: in bfloat16 the reference clamps at the bound as that type holds it.
template <typename T> static inline float mgt_round_to(float v);
template <> inline float mgt_round_to<float>(float v) { return v; }
template <> inline float mgt_round_to<__nv_bfloat16>(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

static inline bool mgt_aligned(const void* p, size_t bytes) {
    return (reinterpret_cast<uintptr_t>(p) % bytes) == 0;
}

static inline unsigned int mgt_grid(int64_t work_items, int threads) {
    // Grid-stride loops: enough blocks to fill 132 SMs many times over, capped
    // so that huge tensors loop instead of exceeding the grid limit.
    int64_t blocks = (work_items + threads - 1) / threads;
    const int64_t cap = 132 * 64;
    if (blocks > cap) blocks = cap;
    if (blocks < 1) blocks = 1;
    return static_cast<unsigned int>(blocks);
}

extern "C" const char* mgt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
