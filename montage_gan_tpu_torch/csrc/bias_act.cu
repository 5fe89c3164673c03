// K1' bias_act: y = clamp(gain * act(x + b), -clamp, clamp) over a
// channels-last [rows, C] view, with the bias along C; and its gradient
// (mgt_bias_act_grad), orders 1 and 2.
//
// Replaces: montage_gan_tpu/ops/pallas/bias_act_kernel.py::bias_act_pallas
// (a Pallas TPU kernel over (256, C) row blocks in VMEM; JAX differentiated
// the plain op instead, so the gradient replaces no TPU kernel of its own).
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
//     step; the two agree to 2 bfloat16 ulps); the clamp bound is the one
//     the storage type holds, as in the reference (jnp.clip casts it);
//   * the bias (already in x's dtype) is read through the read-only cache;
//     it is C values, reused by every row.
// Rows whose length is not a multiple of the vector width, or unaligned
// pointers, take the same kernel with a vector width of 1.
//
// The gradient kernel is memory bound the same way: it reads the incoming
// gradient and one or two saved tensors and writes one, 16 bytes per thread
// per tensor.  As the reference plugin's `ref` argument does, it reads the
// saved output y where the activation's derivative is a function of y
// (relu, lrelu, tanh, sigmoid, elu, selu, softplus) and the saved input x
// (plus bias) for swish, and y for the clamp mask.  Order 1 gives
// g * gain * act'(z) where |y| < clamp, else 0 (z = x + b); order 2, the
// derivative of order 1 with respect to z, g * dy * gain * act''(z) under
// the same mask (dy: the order-1 input).
#include <initializer_list>

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

constexpr float kSeluScale = 1.0507009873554804934193349852946f;
constexpr float kSeluAlpha = 1.6732632423543772848170429916717f;

// act'(z) (order 1) or act''(z) (order 2).  yy = y / gain is the
// activation's value, from which all but swish are computed; swish takes
// z = x + b.  Branches at 0 follow PyTorch's autograd of the plain version
// (relu/lrelu: z > 0).
__device__ __forceinline__ float mgt_act_deriv(int act, int order, float yy, float z,
                                               float alpha) {
    const bool first = order == 1;
    switch (act) {
        case ACT_RELU: return first && yy > 0.0f ? 1.0f : 0.0f;
        case ACT_LRELU: return first ? (yy > 0.0f ? 1.0f : alpha) : 0.0f;
        case ACT_TANH: {
            const float d = 1.0f - yy * yy;
            return first ? d : -2.0f * yy * d;
        }
        case ACT_SIGMOID: {
            const float d = yy * (1.0f - yy);
            return first ? d : d * (1.0f - 2.0f * yy);
        }
        case ACT_ELU: return yy > 0.0f ? (first ? 1.0f : 0.0f) : yy + 1.0f;
        case ACT_SELU:
            return yy > 0.0f ? (first ? kSeluScale : 0.0f) : yy + kSeluScale * kSeluAlpha;
        case ACT_SOFTPLUS: {
            // sigmoid(z) = 1 - exp(-y); its derivative exp(-y) (1 - exp(-y))
            const float s = -expm1f(-yy);
            return first ? s : (1.0f - s) * s;
        }
        case ACT_SWISH: {
            const float s = mgt_sigmoid(z);
            return first ? s * (1.0f + z * (1.0f - s))
                         : s * (1.0f - s) * (2.0f + z * (1.0f - 2.0f * s));
        }
        default: return first ? 1.0f : 0.0f;
    }
}

template <typename T, int VEC>
__global__ void bias_act_grad_kernel(const T* __restrict__ g, const T* __restrict__ x,
                                     const T* __restrict__ b, const T* __restrict__ y,
                                     const T* __restrict__ dy, T* __restrict__ out,
                                     int64_t n_vec, int C, int act, int order, float alpha,
                                     float gain, float clamp) {
    using V = MgtVec<T, VEC>;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const float inv_gain = gain != 0.0f ? 1.0f / gain : 0.0f;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_vec;
         i += stride) {
        const V gv = reinterpret_cast<const V*>(g)[i];
        V xv, yv, dyv, ov;
        if (x != nullptr) xv = reinterpret_cast<const V*>(x)[i];
        if (y != nullptr) yv = reinterpret_cast<const V*>(y)[i];
        if (order == 2) dyv = reinterpret_cast<const V*>(dy)[i];
        const int c0 = b != nullptr ? static_cast<int>((i * VEC) % C) : 0;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
            const float yk = y != nullptr ? mgt_to_float(yv.v[k]) : 0.0f;
            float z = 0.0f;
            if (x != nullptr) {
                z = mgt_to_float(xv.v[k]);
                if (b != nullptr) z += mgt_to_float(__ldg(b + c0 + k));
            }
            float d = mgt_act_deriv(act, order, yk * inv_gain, z, alpha) * gain
                      * mgt_to_float(gv.v[k]);
            if (order == 2) d *= mgt_to_float(dyv.v[k]);
            if (clamp >= 0.0f && !(fabsf(yk) < clamp)) d = 0.0f;
            ov.v[k] = mgt_from_float<T>(d);
        }
        reinterpret_cast<V*>(out)[i] = ov;
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
    if (clamp >= 0.0f) clamp = mgt_round_to<T>(clamp);
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

template <typename T>
static cudaError_t launch_grad(const void* g, const void* x, const void* b, const void* y,
                               const void* dy, void* out, int64_t n, int C, int act, int order,
                               float alpha, float gain, float clamp, cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    constexpr int THREADS = 256;
    const T* gp = static_cast<const T*>(g);
    const T* xp = static_cast<const T*>(x);
    const T* bp = static_cast<const T*>(b);
    const T* yp = static_cast<const T*>(y);
    const T* dyp = static_cast<const T*>(dy);
    T* op = static_cast<T*>(out);
    if (clamp >= 0.0f) clamp = mgt_round_to<T>(clamp);
    bool vec_ok = n % VEC == 0 && (bp == nullptr || C % VEC == 0);
    for (const void* p : {g, x, y, dy, static_cast<const void*>(out)})
        vec_ok = vec_ok && (p == nullptr || mgt_aligned(p, 16));
    if (vec_ok) {
        const int64_t n_vec = n / VEC;
        bias_act_grad_kernel<T, VEC><<<mgt_grid(n_vec, THREADS), THREADS, 0, stream>>>(
            gp, xp, bp, yp, dyp, op, n_vec, C, act, order, alpha, gain, clamp);
    } else {
        bias_act_grad_kernel<T, 1><<<mgt_grid(n, THREADS), THREADS, 0, stream>>>(
            gp, xp, bp, yp, dyp, op, n, C, act, order, alpha, gain, clamp);
    }
    return cudaGetLastError();
}

// The gradient of mgt_bias_act.  g, out: n elements; x (the forward input,
// with b as in the forward) is read for swish, y (the forward output) for the
// other activations and for the clamp mask; dy (the order-1 gradient input)
// for order 2.  A pointer the activation does not need may be null.  All of
// `dtype`, contiguous.  Returns a cudaError_t code.
extern "C" int mgt_bias_act_grad(const void* g, const void* x, const void* b, const void* y,
                                 const void* dy, void* out, long long n, int C, int dtype,
                                 int act, int order, float alpha, float gain, float clamp,
                                 void* stream) {
    const bool needs_x = act == ACT_SWISH;
    const bool needs_y = (act != ACT_LINEAR && act != ACT_SWISH) || clamp >= 0.0f;
    if (n <= 0 || C <= 0 || act < 0 || act >= ACT_COUNT || (order != 1 && order != 2)
        || (needs_x && x == nullptr) || (needs_y && y == nullptr)
        || (order == 2 && dy == nullptr) || (b != nullptr && n % C != 0))
        return cudaErrorInvalidValue;
    if (!needs_x) x = b = nullptr;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case MGT_FLOAT32:
            return launch_grad<float>(g, x, b, y, dy, out, n, C, act, order, alpha, gain, clamp,
                                      s);
        case MGT_BFLOAT16:
            return launch_grad<__nv_bfloat16>(g, x, b, y, dy, out, n, C, act, order, alpha, gain,
                                              clamp, s);
        default: return cudaErrorInvalidValue;
    }
}
