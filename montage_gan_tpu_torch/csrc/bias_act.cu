// K1' bias_act: y = clamp(gain * act(x + b), -clamp, clamp) over a
// channels-last [rows, C] view, with the bias along C.
//
// Replaces: montage_gan_tpu/ops/pallas/bias_act_kernel.py::bias_act_pallas
// (a Pallas TPU kernel over (256, C) row blocks in VMEM).
//
// What bounds it on the H100: memory. Each element is read once and written
// once, with at most a few dozen flops in between (tanh/exp for the smooth
// activations), far below the ~20 flop/byte at which an H100 stops being
// bandwidth-bound in float32.  So the design only has to move bytes well:
//   * every thread handles one 16-byte vector (4 float32 or 8 bfloat16
//     values), neighbouring threads on neighbouring vectors, so each warp
//     issues fully coalesced 512-byte transactions;
//   * the activation is an integer code switched per element in registers
//     (uniform across the grid, so the branch never diverges);
//   * all arithmetic is float32 in registers with one rounding to the
//     storage type on store (the JAX reference rounds bfloat16 after each
//     step; the two agree to 2 bfloat16 ulps);
//   * the bias (already in x's dtype) is read through the read-only cache;
//     it is C values, reused by every row.
// Rows whose length is not a multiple of the vector width, or unaligned
// pointers, take the same kernel with a vector width of 1.
#include "common.cuh"

enum MgtAct {
    ACT_LINEAR = 0, ACT_RELU = 1, ACT_LRELU = 2, ACT_TANH = 3, ACT_SIGMOID = 4,
    ACT_ELU = 5, ACT_SELU = 6, ACT_SOFTPLUS = 7, ACT_SWISH = 8, ACT_COUNT = 9
};

__device__ __forceinline__ float mgt_sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// The 9 activations of montage_gan_tpu/ops/bias_act.py:31-50, written as the
// jax.nn functions compute them.
__device__ __forceinline__ float mgt_act(float x, int act, float alpha) {
    switch (act) {
        case ACT_RELU: return fmaxf(x, 0.0f);
        case ACT_LRELU: return x >= 0.0f ? x : alpha * x;
        case ACT_TANH: return tanhf(x);
        case ACT_SIGMOID: return mgt_sigmoid(x);
        case ACT_ELU: return x > 0.0f ? x : expm1f(x);
        case ACT_SELU:
            return 1.0507009873554804934193349852946f
                   * (x > 0.0f ? x : 1.6732632423543772848170429916717f * expm1f(x));
        case ACT_SOFTPLUS: return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
        case ACT_SWISH: return mgt_sigmoid(x) * x;
        default: return x;
    }
}

template <typename T, int VEC>
__global__ void bias_act_kernel(const T* __restrict__ x, const T* __restrict__ b,
                                T* __restrict__ y, int64_t n_vec, int C, int act,
                                float alpha, float gain, float clamp) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_vec;
         i += stride) {
        const MgtVec<T, VEC> xv = reinterpret_cast<const MgtVec<T, VEC>*>(x)[i];
        MgtVec<T, VEC> yv;
        // C % VEC == 0 whenever VEC > 1 and a bias is given, so the VEC
        // channels of one vector are consecutive and never wrap.
        const int c0 = b != nullptr ? static_cast<int>((i * VEC) % C) : 0;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            float v = mgt_to_float(xv.v[k]);
            if (b != nullptr) v += mgt_to_float(__ldg(b + c0 + k));
            v = mgt_act(v, act, alpha) * gain;
            if (clamp >= 0.0f) v = fminf(fmaxf(v, -clamp), clamp);
            yv.v[k] = mgt_from_float<T>(v);
        }
        reinterpret_cast<MgtVec<T, VEC>*>(y)[i] = yv;
    }
}

template <typename T>
static cudaError_t launch(const void* x, const void* b, void* y, int64_t n, int C, int act,
                          float alpha, float gain, float clamp, cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int THREADS = 256;
    const T* xp = static_cast<const T*>(x);
    const T* bp = static_cast<const T*>(b);
    T* yp = static_cast<T*>(y);
    const bool vec_ok = n % VEC == 0 && (bp == nullptr || C % VEC == 0) && mgt_aligned(x, 16)
                        && mgt_aligned(y, 16);
    if (vec_ok) {
        const int64_t n_vec = n / VEC;
        bias_act_kernel<T, VEC><<<mgt_grid(n_vec, THREADS), THREADS, 0, stream>>>(
            xp, bp, yp, n_vec, C, act, alpha, gain, clamp);
    } else {
        bias_act_kernel<T, 1><<<mgt_grid(n, THREADS), THREADS, 0, stream>>>(
            xp, bp, yp, n, C, act, alpha, gain, clamp);
    }
    return cudaGetLastError();
}

// x, y: n elements of `dtype` (MgtDtype), contiguous; b: C elements of the same
// dtype or null; clamp < 0 means no clamp.  Returns a cudaError_t code.
extern "C" int mgt_bias_act(const void* x, const void* b, void* y, long long n, int C,
                            int dtype, int act, float alpha, float gain, float clamp,
                            void* stream) {
    if (n <= 0 || C <= 0 || act < 0 || act >= ACT_COUNT || (b != nullptr && n % C != 0))
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case MGT_FLOAT32: return launch<float>(x, b, y, n, C, act, alpha, gain, clamp, s);
        case MGT_BFLOAT16:
            return launch<__nv_bfloat16>(x, b, y, n, C, act, alpha, gain, clamp, s);
        default: return cudaErrorInvalidValue;
    }
}
