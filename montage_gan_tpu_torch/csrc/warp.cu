// K3' warp forward and K4' warp transpose: the ADA geometric warp,
//   out = grid_sample(upsample2d(x, f, up), affine_grid(theta, out_h, out_w))
// (bilinear, align_corners=False, zeros padding) over NHWC float32, and its
// exact adjoint with respect to x.
//
// Replaces: montage_gan_tpu/ops/pallas/warp_kernel.py::warp_forward_pallas
// (K3) and ::warp_transpose_pallas (K4).  The TPU kernels build dense
// per-tile weight matrices and contract them on the MXU (banded matmuls,
// [N, H, W*C] lane packing, 0/1 expander and selector matrices, a
// double-buffered window DMA).  None of that carries over: on the card the
// op is a gather.
//
// The upsample is never built.  Per axis, an output pixel maps through theta
// to a coordinate s on the virtual up*L plane; its two bilinear taps
// m0 = floor(s) and m0 + 1 (a tap outside [0, up*L) is zero: upfirdn2d's
// border crop) are themselves sums over the stored samples,
//   up2[m] = sum_l up * f[m - up*l + k0] * x[l],   k0 = T - 1 - p0,
// with p0 = (T + up - 1) / 2 the leading pad of upsample2d and `up` its
// per-axis gain.  For the 12-tap sym6 filter and up = 2 that is at most 7
// stored samples per axis, so each output reads a <= 7x7 window of x with
// weights wy[a] * wx[b]; one routine (mgt_axis_weights) computes them for
// both kernels, which makes K4' the adjoint of K3' by construction.
//
// What bounds them on the H100: memory.  At the main shape ([16, 396, 396, 4]
// -> [16, 524, 524, 4]) K3' moves 110.4 MB (33 us at 3.35 TB/s) against
// ~1.7 GFLOP of taps (26 us at 67 TFLOP/s float32).  The design:
//   * K3': one thread per output pixel; the 4 channels load and store as one
//     float4 (16 bytes); the window's rows are neighbouring pixels, mostly
//     cached across the neighbouring threads of a warp, which sample
//     neighbouring source points; accumulation in float32 registers;
//   * K4': one thread per cotangent pixel, scattering w * g into its window
//     with float32 atomicAdd into an output the wrapper zeroed (for C = 4
//     the float4 form of sm_90, one 16-byte atomic per pixel and tap; each
//     channel is still added as one float32 atomic).  The order of the
//     atomic additions changes from run to run, so K4' is not
//     deterministic: two runs differ by float32 rounding.
// The TPU ran the contractions in bfloat16; these kernels compute in
// float32, as the JAX package's CPU oracle does.
#include "common.cuh"

// Stored samples per axis an output can touch: at most T / up + 2.
constexpr int kMaxL = 8;

struct MgtWarpAxis {
    const float* f;  // T taps, float32, on the device
    int taps;        // T
    int up;
    int k0;          // T - 1 - p0
    int len;         // stored length L
};

// Weights of the stored samples l0 .. l0 + n - 1 (all inside [0, L)) for a
// virtual coordinate s.  Returns n (0 when the two taps are off the plane).
__device__ __forceinline__ int mgt_axis_weights(const MgtWarpAxis& ax, float s, float* w,
                                                int* l0_out) {
    const float m0f = floorf(s);
    const float t = s - m0f;
    const int m0 = static_cast<int>(m0f);
    const int virt = ax.up * ax.len;
    // l with a tap of m0 or m0 + 1 inside the filter: 0 <= m - up*l + k0 < T
    int lo = m0 + ax.k0 - ax.taps + 1;
    lo = lo >= 0 ? (lo + ax.up - 1) / ax.up : -((-lo) / ax.up);  // ceil division
    int hi = m0 + 1 + ax.k0;
    hi = hi >= 0 ? hi / ax.up : -((-hi + ax.up - 1) / ax.up);    // floor division
    if (lo < 0) lo = 0;
    if (hi > ax.len - 1) hi = ax.len - 1;
    const int n = hi - lo + 1;
    *l0_out = lo;
    if (n <= 0) return 0;
    const float gain = static_cast<float>(ax.up);
#pragma unroll
    for (int a = 0; a < kMaxL; ++a) {
        float acc = 0.0f;
        if (a < n) {
            const int l = lo + a;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int m = m0 + e;
                const int j = m - ax.up * l + ax.k0;
                if (m >= 0 && m < virt && j >= 0 && j < ax.taps)
                    acc += (e == 0 ? 1.0f - t : t) * gain * __ldg(ax.f + j);
            }
        }
        w[a] = acc;
    }
    return n;
}

// Virtual-plane coordinates (x, y) of output pixel (i, j) of sample n:
// align_corners=False over the up*W x up*H plane.  Each step rounds as the
// plain version's elementwise PyTorch ops do (ops/grid_sample.py:
// affine_grid, grid_sample); the _rn intrinsics keep nvcc from contracting
// them into fused multiply-adds, so both compute the same coordinates.
__device__ __forceinline__ float mgt_norm_coord(int i, int n) {
    return __fsub_rn(__fdiv_rn(__fadd_rn(__fmul_rn(2.0f, static_cast<float>(i)), 1.0f),
                               static_cast<float>(n)),
                     1.0f);
}

__device__ __forceinline__ float mgt_pixel_coord(float g, int extent) {
    return __fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), static_cast<float>(extent) * 0.5f), 0.5f);
}

__device__ __forceinline__ void mgt_source(const float* theta, int n, int i, int j, int out_h,
                                           int out_w, int virt_h, int virt_w, float* sx,
                                           float* sy) {
    const float* th = theta + 6 * n;
    const float xo = mgt_norm_coord(j, out_w);
    const float yo = mgt_norm_coord(i, out_h);
    const float gx = __fadd_rn(__fadd_rn(__fmul_rn(th[0], xo), __fmul_rn(th[1], yo)), th[2]);
    const float gy = __fadd_rn(__fadd_rn(__fmul_rn(th[3], xo), __fmul_rn(th[4], yo)), th[5]);
    *sx = mgt_pixel_coord(gx, virt_w);
    *sy = mgt_pixel_coord(gy, virt_h);
}

struct MgtWarpShape {
    int N, H, W, C, out_h, out_w;
};

// K3': out[n, i, j, :] = sum_{a,b} wy[a] wx[b] x[n, ly0 + a, lx0 + b, :]
template <bool VEC4>
__global__ void warp_forward_kernel(const float* __restrict__ x, const float* __restrict__ theta,
                                    float* __restrict__ out, MgtWarpShape s, MgtWarpAxis ax_y,
                                    MgtWarpAxis ax_x) {
    const int64_t total = static_cast<int64_t>(s.N) * s.out_h * s.out_w;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < total;
         p += stride) {
        const int j = static_cast<int>(p % s.out_w);
        const int i = static_cast<int>((p / s.out_w) % s.out_h);
        const int n = static_cast<int>(p / (static_cast<int64_t>(s.out_w) * s.out_h));
        float sx, sy;
        mgt_source(theta, n, i, j, s.out_h, s.out_w, ax_y.up * s.H, ax_x.up * s.W, &sx, &sy);
        float wy[kMaxL], wx[kMaxL];
        int ly0, lx0;
        const int ny = mgt_axis_weights(ax_y, sy, wy, &ly0);
        const int nx = mgt_axis_weights(ax_x, sx, wx, &lx0);
        const float* xn = x + static_cast<int64_t>(n) * s.H * s.W * s.C;
        float* o = out + p * s.C;
        if (VEC4) {
            float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
            for (int a = 0; a < kMaxL; ++a) {
                if (a >= ny) break;
                const float* row = xn + (static_cast<int64_t>(ly0 + a) * s.W + lx0) * s.C;
#pragma unroll
                for (int b = 0; b < kMaxL; ++b) {
                    if (b >= nx) break;
                    const float w = wy[a] * wx[b];
                    const float4 v = __ldg(reinterpret_cast<const float4*>(row + b * 4));
                    acc.x += w * v.x;
                    acc.y += w * v.y;
                    acc.z += w * v.z;
                    acc.w += w * v.w;
                }
            }
            *reinterpret_cast<float4*>(o) = acc;
        } else {
            for (int c = 0; c < s.C; ++c) {
                float acc = 0.0f;
                for (int a = 0; a < ny; ++a) {
                    const float* row = xn + (static_cast<int64_t>(ly0 + a) * s.W + lx0) * s.C + c;
                    for (int b = 0; b < nx; ++b) acc += wy[a] * wx[b] * __ldg(row + b * s.C);
                }
                o[c] = acc;
            }
        }
    }
}

// K4': dx[n, ly0 + a, lx0 + b, :] += wy[a] wx[b] g[n, i, j, :] for every
// cotangent pixel (n, i, j): the transpose of K3' with the same weights.
template <bool VEC4>
__global__ void warp_transpose_kernel(const float* __restrict__ g,
                                      const float* __restrict__ theta, float* __restrict__ dx,
                                      MgtWarpShape s, MgtWarpAxis ax_y, MgtWarpAxis ax_x) {
    const int64_t total = static_cast<int64_t>(s.N) * s.out_h * s.out_w;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t p = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; p < total;
         p += stride) {
        const int j = static_cast<int>(p % s.out_w);
        const int i = static_cast<int>((p / s.out_w) % s.out_h);
        const int n = static_cast<int>(p / (static_cast<int64_t>(s.out_w) * s.out_h));
        float sx, sy;
        mgt_source(theta, n, i, j, s.out_h, s.out_w, ax_y.up * s.H, ax_x.up * s.W, &sx, &sy);
        float wy[kMaxL], wx[kMaxL];
        int ly0, lx0;
        const int ny = mgt_axis_weights(ax_y, sy, wy, &ly0);
        const int nx = mgt_axis_weights(ax_x, sx, wx, &lx0);
        if (ny == 0 || nx == 0) continue;
        float* dn = dx + static_cast<int64_t>(n) * s.H * s.W * s.C;
        const float* gp = g + p * s.C;
        if (VEC4) {
            const float4 gv = __ldg(reinterpret_cast<const float4*>(gp));
#pragma unroll
            for (int a = 0; a < kMaxL; ++a) {
                if (a >= ny) break;
                float* row = dn + (static_cast<int64_t>(ly0 + a) * s.W + lx0) * s.C;
#pragma unroll
                for (int b = 0; b < kMaxL; ++b) {
                    if (b >= nx) break;
                    const float w = wy[a] * wx[b];
                    if (w == 0.0f) continue;
                    // sm_90's vector atomic: one 16-byte add per pixel
                    atomicAdd(reinterpret_cast<float4*>(row + b * 4),
                              make_float4(w * gv.x, w * gv.y, w * gv.z, w * gv.w));
                }
            }
        } else {
            for (int a = 0; a < ny; ++a) {
                float* row = dn + (static_cast<int64_t>(ly0 + a) * s.W + lx0) * s.C;
                for (int b = 0; b < nx; ++b) {
                    const float w = wy[a] * wx[b];
                    if (w == 0.0f) continue;
                    for (int c = 0; c < s.C; ++c) atomicAdd(row + b * s.C + c, w * __ldg(gp + c));
                }
            }
        }
    }
}

static bool make_axes(const float* f, int taps, int up, int H, int W, MgtWarpAxis* ay,
                      MgtWarpAxis* ax) {
    if (f == nullptr || taps < 1 || up < 1 || taps / up + 2 > kMaxL) return false;
    const int p0 = (taps + up - 1) / 2;
    *ay = MgtWarpAxis{f, taps, up, taps - 1 - p0, H};
    *ax = MgtWarpAxis{f, taps, up, taps - 1 - p0, W};
    return true;
}

static bool shape_ok(const MgtWarpShape& s) {
    return s.N > 0 && s.H > 0 && s.W > 0 && s.C > 0 && s.out_h > 0 && s.out_w > 0;
}

// x: [N, H, W, C] float32; theta: [N, 2, 3] float32; out: [N, out_h, out_w, C]
// float32; f: `taps` float32 filter taps (pass [1] with up = 1 for a plain
// bilinear warp).  All contiguous, on the device.  Returns a cudaError_t code.
extern "C" int mgt_warp_forward(const float* x, const float* theta, const float* f, float* out,
                                int N, int H, int W, int C, int out_h, int out_w, int taps,
                                int up, void* stream) {
    MgtWarpShape s{N, H, W, C, out_h, out_w};
    MgtWarpAxis ay, ax;
    if (!shape_ok(s) || !make_axes(f, taps, up, H, W, &ay, &ax)) return cudaErrorInvalidValue;
    constexpr int THREADS = 256;
    const int64_t total = static_cast<int64_t>(N) * out_h * out_w;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (C == 4 && mgt_aligned(x, 16) && mgt_aligned(out, 16))
        warp_forward_kernel<true><<<mgt_grid(total, THREADS), THREADS, 0, st>>>(x, theta, out, s,
                                                                              ay, ax);
    else
        warp_forward_kernel<false><<<mgt_grid(total, THREADS), THREADS, 0, st>>>(x, theta, out, s,
                                                                               ay, ax);
    return cudaGetLastError();
}

// g: [N, out_h, out_w, C]; dx: [N, H, W, C], zeroed by the caller; the rest as
// in mgt_warp_forward.  Returns a cudaError_t code.
extern "C" int mgt_warp_transpose(const float* g, const float* theta, const float* f, float* dx,
                                  int N, int H, int W, int C, int out_h, int out_w, int taps,
                                  int up, void* stream) {
    MgtWarpShape s{N, H, W, C, out_h, out_w};
    MgtWarpAxis ay, ax;
    if (!shape_ok(s) || !make_axes(f, taps, up, H, W, &ay, &ax)) return cudaErrorInvalidValue;
    constexpr int THREADS = 256;
    const int64_t total = static_cast<int64_t>(N) * out_h * out_w;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (C == 4 && mgt_aligned(g, 16) && mgt_aligned(dx, 16))
        warp_transpose_kernel<true><<<mgt_grid(total, THREADS), THREADS, 0, st>>>(g, theta, dx, s,
                                                                                ay, ax);
    else
        warp_transpose_kernel<false><<<mgt_grid(total, THREADS), THREADS, 0, st>>>(g, theta, dx,
                                                                                 s, ay, ax);
    return cudaGetLastError();
}
