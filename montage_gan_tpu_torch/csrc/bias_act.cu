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
// bandwidth-bound in float32.  So the design only has to move bytes well,
// and it does: at the main shape ([8,256,256,64] bf16) the vector variant
// runs at 86% of 3.35 TB/s with L2 cold, the rate a read-once, write-once
// stream reaches on this card.  A persistent grid streaming 8 KB chunks
// through shared memory with bulk copies (the Tensor Memory Accelerator)
// took 0.990-1.033 times its time from 16 to 128 MiB (1.002 at the main
// shape) and 1.04-1.17 times below, so it was taken out (PERF.md,
// Findings, PR 5).
// The forward has two variants, chosen by the Python wrapper from the
// parameters alone (ops/bias_act.py::_stream_plan) and passed in with the
// grid; a variant that does not fit them is refused:
//   * vector (bias_act_kernel<T, VEC, ACT>, VEC = 16 / sizeof(T)): one
//     16-byte vector (4 float32 or 8 bfloat16 values) per thread per
//     grid-stride step, neighbouring threads on neighbouring vectors, so
//     each warp issues fully coalesced 512-byte transactions; x loaded with
//     an L2 evict-first hint (ld.global.cs: it is read once), the bias as
//     one 16-byte vector;
//   * scalar, for rows whose length is not a multiple of the vector width
//     or unaligned pointers: the same kernel with a vector width of 1.
// Both compile in the main path's activations (linear, lrelu); the others
// switch on an integer code per element, uniform across the grid, so the
// branch never diverges.  A thread's channel advances by a fixed step with
// one wrap per grid stride instead of a 64-bit modulo per vector.  The
// arithmetic is float32 in registers with one rounding to the storage type
// on store (the JAX reference rounds bfloat16 after each step; the two
// agree to 2 bfloat16 ulps); the clamp bound is the one the storage type
// holds, as in the reference (jnp.clip casts it).
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
#include <cstring>
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

// The activation as a compile-time constant where the main path needs it
// (ACT >= 0: linear, lrelu), else the run-time switch (ACT = -1).
template <int ACT>
__device__ __forceinline__ float mgt_act_fixed(float x, int act, float alpha) {
    if constexpr (ACT == ACT_LINEAR) return x;
    else if constexpr (ACT == ACT_LRELU) return x >= 0.0f ? x : alpha * x;
    else return mgt_act(x, act, alpha);
}

// VEC elements to float32 and back; bfloat16 converts two an instruction.
template <typename T, int VEC>
__device__ __forceinline__ void mgt_unpack(const MgtVec<T, VEC>& v, float* t) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) t[e] = mgt_to_float(v.v[e]);
}
__device__ __forceinline__ void mgt_unpack(const MgtVec<__nv_bfloat16, 8>& v, float* t) {
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
        const float2 f = __bfloat1622float2(__halves2bfloat162(v.v[e], v.v[e + 1]));
        t[e] = f.x;
        t[e + 1] = f.y;
    }
}
template <typename T, int VEC>
__device__ __forceinline__ void mgt_pack(const float* t, MgtVec<T, VEC>& v) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) v.v[e] = mgt_from_float<T>(t[e]);
}
__device__ __forceinline__ void mgt_pack(const float* t, MgtVec<__nv_bfloat16, 8>& v) {
#pragma unroll
    for (int e = 0; e < 8; e += 2) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(t[e], t[e + 1]);
        v.v[e] = h.x;
        v.v[e + 1] = h.y;
    }
}

// A load of x that L2 may evict first (ld.global.cs): x is read once.
template <typename T, int VEC>
__device__ __forceinline__ MgtVec<T, VEC> mgt_load_once(const MgtVec<T, VEC>* p) {
    if constexpr (sizeof(T) * VEC == 16) {
        const uint4 r = __ldcs(reinterpret_cast<const uint4*>(p));
        MgtVec<T, VEC> v;
        memcpy(&v, &r, 16);
        return v;
    } else {
        return *p;
    }
}

// t[e] += b[c + e] for the VEC channels from c, read from global memory as
// one 16-byte vector where the bias allows it (c % VEC == 0 then).
template <typename T, int VEC>
__device__ __forceinline__ void mgt_add_bias(float* t, const T* __restrict__ b, int c,
                                             bool b_vec) {
    if constexpr (sizeof(T) * VEC == 16) {
        if (b_vec) {
            const uint4 r = __ldg(reinterpret_cast<const uint4*>(b + c));
            MgtVec<T, VEC> bv;
            memcpy(&bv, &r, 16);
            float f[VEC];
            mgt_unpack(bv, f);
#pragma unroll
            for (int e = 0; e < VEC; ++e) t[e] += f[e];
            return;
        }
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) t[e] += mgt_to_float(__ldg(b + c + e));
}

// Activation, gain and clamp of VEC values, in place.
template <int ACT, int VEC>
__device__ __forceinline__ void mgt_transform(float* t, int act, float alpha, float gain,
                                              float clamp) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
        t[e] = mgt_act_fixed<ACT>(t[e], act, alpha) * gain;
        if (clamp >= 0.0f) t[e] = fminf(fmaxf(t[e], -clamp), clamp);
    }
}

constexpr int BIAS_ACT_THREADS = 256;

// Variants vector (VEC = 16 / sizeof(T)) and scalar (VEC = 1): a grid-stride
// loop, one VEC-element vector per thread per step, neighbouring threads on
// neighbouring vectors.  The channel of a thread's first element is taken
// once in 64-bit and then advances by a fixed step with one wrap per grid
// stride; C % VEC == 0 whenever VEC > 1 and a bias is given, so the VEC
// channels of one vector are consecutive and never wrap.
template <typename T, int VEC, int ACT>
__global__ void bias_act_kernel(const T* __restrict__ x, const T* __restrict__ b,
                                T* __restrict__ y, int64_t n_vec, int C, int act,
                                float alpha, float gain, float clamp) {
    using V = MgtVec<T, VEC>;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const int step = static_cast<int>((stride * VEC) % C);
    int c = static_cast<int>((i * VEC) % C);
    const bool b_vec = (reinterpret_cast<uintptr_t>(b) & 15) == 0;
    for (; i < n_vec; i += stride) {
        float t[VEC];
        mgt_unpack(mgt_load_once(reinterpret_cast<const V*>(x) + i), t);
        if (b != nullptr) mgt_add_bias<T, VEC>(t, b, c, b_vec);
        mgt_transform<ACT, VEC>(t, act, alpha, gain, clamp);
        V yv;
        mgt_pack(t, yv);
        reinterpret_cast<V*>(y)[i] = yv;
        c += step;
        if (c >= C) c -= C;
    }
}

enum MgtBiasActVariant { BIAS_ACT_SCALAR = 0, BIAS_ACT_VECTOR = 1 };

// Launch `variant` on `grid` blocks with the activation ACT compiled in.
template <typename T, int ACT>
static void launch_act(const T* x, const T* b, T* y, int64_t n, int C, int act, float alpha,
                       float gain, float clamp, int variant, int grid, cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    if (variant == BIAS_ACT_VECTOR)
        bias_act_kernel<T, VEC, ACT><<<grid, BIAS_ACT_THREADS, 0, stream>>>(
            x, b, y, n / VEC, C, act, alpha, gain, clamp);
    else
        bias_act_kernel<T, 1, ACT><<<grid, BIAS_ACT_THREADS, 0, stream>>>(
            x, b, y, n, C, act, alpha, gain, clamp);
}

template <typename T>
static cudaError_t launch(const void* x, const void* b, void* y, int64_t n, int C, int act,
                          float alpha, float gain, float clamp, int variant, int grid,
                          cudaStream_t stream) {
    constexpr int VEC = 16 / sizeof(T);
    const T* xp = static_cast<const T*>(x);
    const T* bp = static_cast<const T*>(b);
    T* yp = static_cast<T*>(y);
    if (clamp >= 0.0f) clamp = mgt_round_to<T>(clamp);
    const bool vec_ok = n % VEC == 0 && (bp == nullptr || C % VEC == 0) && mgt_aligned(x, 16)
                        && mgt_aligned(y, 16);
    if ((variant != BIAS_ACT_SCALAR && variant != BIAS_ACT_VECTOR)
        || (variant == BIAS_ACT_VECTOR && !vec_ok) || grid < 1)
        return cudaErrorInvalidValue;
    if (bp == nullptr) C = 1;
    switch (act) {
        case ACT_LINEAR:
            launch_act<T, ACT_LINEAR>(xp, bp, yp, n, C, act, alpha, gain, clamp, variant, grid,
                                      stream);
            break;
        case ACT_LRELU:
            launch_act<T, ACT_LRELU>(xp, bp, yp, n, C, act, alpha, gain, clamp, variant, grid,
                                     stream);
            break;
        default:
            launch_act<T, -1>(xp, bp, yp, n, C, act, alpha, gain, clamp, variant, grid, stream);
    }
    return cudaGetLastError();
}

// x, y: n elements of `dtype` (MgtDtype), contiguous; b: C elements of the same
// dtype or null; clamp < 0 means no clamp.  `variant` (MgtBiasActVariant) and
// `grid` (blocks of BIAS_ACT_THREADS threads striding over the vectors) as
// ops/bias_act.py::_stream_plan chooses them.  Returns a cudaError_t code.
extern "C" int mgt_bias_act(const void* x, const void* b, void* y, long long n, int C,
                            int dtype, int act, float alpha, float gain, float clamp,
                            int variant, int grid, void* stream) {
    if (n <= 0 || C <= 0 || act < 0 || act >= ACT_COUNT || (b != nullptr && n % C != 0))
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case MGT_FLOAT32:
            return launch<float>(x, b, y, n, C, act, alpha, gain, clamp, variant, grid, s);
        case MGT_BFLOAT16:
            return launch<__nv_bfloat16>(x, b, y, n, C, act, alpha, gain, clamp, variant, grid,
                                         s);
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
