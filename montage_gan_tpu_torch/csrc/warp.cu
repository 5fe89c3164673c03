// K3' warp forward and K4' warp transpose: the ADA geometric warp,
//   out = grid_sample(upsample2d(x, f, up), affine_grid(theta, out_h, out_w))
// (bilinear, align_corners=False, zeros padding) over NHWC float32, and its
// exact adjoint with respect to x.
//
// Replaces: montage_gan_tpu/ops/pallas/warp_kernel.py::warp_forward_pallas
// (K3) and ::warp_transpose_pallas (K4).  The TPU kernels build dense
// per-tile weight matrices and contract them on the MXU (banded matmuls,
// [N, H, W*C] lane packing, 0/1 expander and selector matrices, a
// double-buffered window DMA, and for K4 a per-sample cotangent plane that
// the sequential grid accumulates into).  None of that carries over: blocks
// run in no order here, so K4' gathers where K4 accumulated.
//
// The virtual plane.  upsample2d(x, f, up) is a plane of up*L samples per
// axis, v[m] = sum_l up * f[m - up*l + k0] * x[l] with k0 = T - 1 - p0 and
// p0 = (T + up - 1) / 2 (upsample2d's leading pad), zero outside [0, up*L)
// (its crop).  Per axis an output's source point s (mgt_source, rounded step
// by step as the plain version rounds it) has the bilinear taps floor(s)
// and floor(s) + 1 on that plane.  For the 12-tap sym6 filter at up = 2 an
// output thus reads at most 7x7 stored samples.
//
// The bound on the H100 is memory: at the main shape ([16, 396, 396, 4] ->
// [16, 524, 524, 4]) each kernel moves 110.4 MB, 33 us at 3.35 TB/s,
// against ~1.7 GFLOP of taps.  A thread per output reading its <= 7x7
// window from global memory issues ~215 M 16-byte loads through L1 for
// 40 MB of input, and the transpose of that, a scatter, needs float32
// atomics (non-deterministic) through L2's atomic units.  Here both are
// tiled in shared memory, one block per tile of one sample (blockIdx.z =
// n), 256 threads, with no 64-bit division per pixel and no floating-point
// atomics:
//
//   * K3' (variant tiled): a block takes an output tile.  Thread 0 maps the
//     tile's four corners through theta, widens their hull by the rounding
//     margin (mgt_margin), and bounds the virtual region its bilinear taps
//     read and the stored region that feeds it.  The block stages the stored
//     region (16-byte pixels), builds the virtual region in shared memory by
//     the separable polyphase filter (x, then y: T / up taps per virtual
//     sample, each column's taps in registers), and each output then reads
//     its 2x2 taps from it: 4 shared loads per output in place of up to 49
//     global ones.  K2''s tiles take 2-D filters of at most 4x4; this
//     12-tap filter is separable, so the warp has passes of its own.
//   * K4' (variant tiled): a deterministic gather, the adjoint of the above.
//     A block takes a tile of dx.  It bounds the virtual region its stored
//     pixels feed, and through theta's inverse (double precision, per
//     block, with the margin) the box of outputs whose taps can land there.
//     Each virtual sample m gathers sum_p w(p, m) g[p] over its own
//     candidate outputs (rows from the inverse, and per row the columns
//     where both coordinates can fall within a pixel of m, in float32
//     relative to the block: MgtGather), in raster order; membership is
//     decided by recomputing each candidate's coordinates exactly as K3'
//     computes them (from per-row and per-column tables of the products
//     theta * coordinate), never by the inverse.  The transposed polyphase
//     filter (x, then y) then writes each dx pixel once.  Two runs give the
//     same bits; dx needs no zeroing.
//   * A block whose footprint does not fit its shared memory (strong zoom:
//     K3''s region, or K4''s candidate box beyond WARP_TABLE rows or
//     columns), or whose theta is not finite (K4': or singular), takes the
//     direct path inside the same launch: per output (K3') the <= 7x7
//     window, per dx pixel (K4') its candidate outputs, with the weights of
//     mgt_axis_weights, reading global memory, still without atomics.  Such
//     blocks add 1 to an optional counter (an integer atomic per block).
//     The variant direct (C != 4, an unaligned tensor, up != 2 or more than
//     WARP_TILED_TAPS taps, chosen by the wrapper) sends every block there.
//
// What bounds them now (NVIDIA H100 80GB HBM3 at 700 W, L2 cold, the main
// shape with the pipe's own theta, timed with one phase taken out at a
// time): K3' takes 0.135 ms, of which the two filter passes ~0.047, the
// bilinear reads ~0.022, the staging loads ~0.012 and the per-block plan
// and launch ~0.030; K4' takes 0.30 ms, of which the gather's loads of g
// (dependent on the candidate tests, through L1) ~0.09, the candidate tests
// ~0.07, the per-row candidate ranges ~0.03, the plan and launch ~0.026 and
// the transposed passes ~0.02.  Both are bound by instruction issue and
// latency in shared memory and L1, not by HBM.
//
// The geometry (regions, margins, candidate boxes, shared-memory sizes) is
// mirrored by ops/affine_warp.py (forward_tile, transpose_tile,
// candidate_rows, candidate_cols, gather_rows, gather_cols), which the CPU
// tests hold to the plain version.  The TPU ran the contractions in
// bfloat16; these kernels compute in float32, as the JAX package's CPU
// oracle does.
#include "common.cuh"

// Stored samples per axis an output can touch: at most T / up + 2.
constexpr int kMaxL = 8;
constexpr int WARP_THREADS = 256;
constexpr int WARP_MAX_SMEM = 232448;   // 227 KB, the H100's per-block limit
constexpr int WARP_TILED_TAPS = 16;     // the most taps the tiled variant stages
constexpr int WARP_HEADER = 320;        // bytes: the block's plan, then its taps
constexpr int WARP_TABLE = 256;         // K4': candidate rows, and columns, at most

enum MgtWarpVariant { WARP_DIRECT = 0, WARP_TILED = 1 };
enum MgtWarpMode { MODE_DIRECT = 0, MODE_TILED = 1, MODE_EMPTY = 2 };

struct MgtWarpAxis {
    const float* f;  // T taps, float32, on the device
    int taps;        // T
    int up;
    int k0;          // T - 1 - p0
    int len;         // stored length L
};

struct MgtWarpShape {
    int N, H, W, C, out_h, out_w;
};

__device__ __forceinline__ void mgt_fma4(float4& acc, float w, const float4& v) {
    acc.x += w * v.x;
    acc.y += w * v.y;
    acc.z += w * v.z;
    acc.w += w * v.w;
}

// floor(s) as an int; a coordinate far off the plane is clamped to -2 or
// virt + 1, where both of its taps are still off the plane.
__device__ __forceinline__ int mgt_floor_tap(float m0f, int virt) {
    return static_cast<int>(fminf(fmaxf(m0f, -2.0f), static_cast<float>(virt + 1)));
}

// Weights of the stored samples l0 .. l0 + n - 1 (all inside [0, L)) for a
// virtual coordinate s.  Returns n (0 when the two taps are off the plane).
__device__ __forceinline__ int mgt_axis_weights(const MgtWarpAxis& ax, float s, float* w,
                                                int* l0_out) {
    const float m0f = floorf(s);
    const float t = s - m0f;
    const int virt = ax.up * ax.len;
    const int m0 = mgt_floor_tap(m0f, virt);
    // l with a tap of m0 or m0 + 1 inside the filter: 0 <= m - up*l + k0 < T
    int lo = mgt_ceildiv(m0 + ax.k0 - ax.taps + 1, ax.up);
    int hi = mgt_floordiv(m0 + 1 + ax.k0, ax.up);
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

// The weight of stored sample l for the virtual coordinate s: the entry of
// mgt_axis_weights' w for l (0 where it has none), by the same operations.
__device__ __forceinline__ float mgt_axis_weight_at(const MgtWarpAxis& ax, float s, int l) {
    const float m0f = floorf(s);
    const float t = s - m0f;
    const int virt = ax.up * ax.len;
    const int m0 = mgt_floor_tap(m0f, virt);
    const float gain = static_cast<float>(ax.up);
    float acc = 0.0f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int m = m0 + e;
        const int j = m - ax.up * l + ax.k0;
        if (m >= 0 && m < virt && j >= 0 && j < ax.taps)
            acc += (e == 0 ? 1.0f - t : t) * gain * __ldg(ax.f + j);
    }
    return acc;
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

// A bound, in virtual pixels, on how far mgt_source's rounded coordinate
// can lie from the exact affine map of the same theta: twice the bound
// 2.7e-7 * extent * (|t0| + |t1| + |t2| + 1) of its float32 steps, with a
// factor 7 to spare, plus 1/64.  th: the theta row of this axis.
__device__ __forceinline__ float mgt_margin(const float* th, int extent) {
    return 0.015625f + 3.8e-6f * static_cast<float>(extent) *
                           (fabsf(th[0]) + fabsf(th[1]) + fabsf(th[2]) + 1.0f);
}

// Virtual samples [v0, v1] that the taps of every coordinate in [lo, hi]
// read, clipped to the plane [0, virt); false if none lies on it.
__device__ __forceinline__ bool mgt_virtual_span(float lo, float hi, int virt, int* v0,
                                                 int* v1) {
    // taps floor(s) and floor(s) + 1: both off the plane for s < -1 or s >= virt
    if (hi < -1.0f || lo >= static_cast<float>(virt)) return false;
    *v0 = max(static_cast<int>(floorf(fmaxf(lo, -1.0f))), 0);
    *v1 = min(static_cast<int>(floorf(fminf(hi, static_cast<float>(virt)))) + 1, virt - 1);
    return *v0 <= *v1;
}

// Stored samples [l0, l1] that virtual samples [v0, v1] read, clipped to
// [0, L); false if none.
__device__ __forceinline__ bool mgt_stored_span(const MgtWarpAxis& ax, int v0, int v1, int* l0,
                                                int* l1) {
    *l0 = max(mgt_ceildiv(v0 + ax.k0 - ax.taps + 1, ax.up), 0);
    *l1 = min(mgt_floordiv(v1 + ax.k0, ax.up), ax.len - 1);
    return *l0 <= *l1;
}

// ---------------------------------------------------------------------------
// K3': the forward
// ---------------------------------------------------------------------------

struct MgtForwardPlan {
    int mode;                // MgtWarpMode
    int vy0, vx0, vh, vw;    // virtual region: rows, columns (inside the plane)
    int sy0, sx0, sh, sw;    // stored region that feeds it
};

// The plan of the output tile rows [i0, i1] x columns [j0, j1] of sample n
// (ops/affine_warp.py::forward_tile).  `budget`: float4 slots of shared
// memory for the stored region (aliased by the virtual one) and the x pass.
__device__ MgtForwardPlan mgt_forward_plan(const float* theta, const MgtWarpShape& s,
                                           const MgtWarpAxis& ay, const MgtWarpAxis& ax, int n,
                                           int i0, int i1, int j0, int j1, int budget) {
    MgtForwardPlan p{};
    p.mode = MODE_DIRECT;
    const int virt_h = ay.up * s.H, virt_w = ax.up * s.W;
    float xlo = 0.0f, xhi = 0.0f, ylo = 0.0f, yhi = 0.0f;
    for (int c = 0; c < 4; ++c) {
        float sx, sy;
        mgt_source(theta, n, c < 2 ? i0 : i1, (c & 1) ? j1 : j0, s.out_h, s.out_w, virt_h,
                   virt_w, &sx, &sy);
        if (!isfinite(sx) || !isfinite(sy)) return p;
        xlo = c == 0 ? sx : fminf(xlo, sx);
        xhi = c == 0 ? sx : fmaxf(xhi, sx);
        ylo = c == 0 ? sy : fminf(ylo, sy);
        yhi = c == 0 ? sy : fmaxf(yhi, sy);
    }
    const float* th = theta + 6 * n;
    const float mx = mgt_margin(th, virt_w), my = mgt_margin(th + 3, virt_h);
    int vx0, vx1, vy0, vy1, sx0, sx1, sy0, sy1;
    if (!mgt_virtual_span(xlo - mx, xhi + mx, virt_w, &vx0, &vx1)
        || !mgt_virtual_span(ylo - my, yhi + my, virt_h, &vy0, &vy1)
        || !mgt_stored_span(ax, vx0, vx1, &sx0, &sx1)
        || !mgt_stored_span(ay, vy0, vy1, &sy0, &sy1)) {
        p.mode = MODE_EMPTY;       // every tap of every output is zero
        return p;
    }
    p.vy0 = vy0;
    p.vx0 = vx0;
    p.vh = vy1 - vy0 + 1;
    p.vw = vx1 - vx0 + 1;
    p.sy0 = sy0;
    p.sx0 = sx0;
    p.sh = sy1 - sy0 + 1;
    p.sw = sx1 - sx0 + 1;
    const int64_t stored = static_cast<int64_t>(p.sh) * p.sw;
    const int64_t virt = static_cast<int64_t>(p.vh) * p.vw;
    const int64_t need = (stored > virt ? stored : virt) + static_cast<int64_t>(p.sh) * p.vw;
    if (need <= budget) p.mode = MODE_TILED;
    return p;
}

// The direct path of one output: the <= 7x7 window of stored samples.
template <bool VEC4>
__device__ __forceinline__ void warp_forward_pixel(const float* __restrict__ x,
                                                   const float* __restrict__ theta,
                                                   float* __restrict__ out, const MgtWarpShape& s,
                                                   const MgtWarpAxis& ay, const MgtWarpAxis& ax,
                                                   int n, int i, int j) {
    float sx, sy;
    mgt_source(theta, n, i, j, s.out_h, s.out_w, ay.up * s.H, ax.up * s.W, &sx, &sy);
    float wy[kMaxL], wx[kMaxL];
    int ly0, lx0;
    const int ny = mgt_axis_weights(ay, sy, wy, &ly0);
    const int nx = mgt_axis_weights(ax, sx, wx, &lx0);
    const float* xn = x + static_cast<int64_t>(n) * s.H * s.W * s.C;
    float* o = out + ((static_cast<int64_t>(n) * s.out_h + i) * s.out_w + j) * s.C;
    if (VEC4) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int a = 0; a < kMaxL; ++a) {
            if (a >= ny) break;
            const float* row = xn + (static_cast<int64_t>(ly0 + a) * s.W + lx0) * 4;
#pragma unroll
            for (int b = 0; b < kMaxL; ++b) {
                if (b >= nx) break;
                mgt_fma4(acc, wy[a] * wx[b], __ldg(reinterpret_cast<const float4*>(row + b * 4)));
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

// Thread t of a tiled block's pass over a region `width` columns wide takes
// column t % width and every mgt_groups(width)-th row from t / width (the
// column's index arithmetic done once); a region wider than the block loops.
__device__ __forceinline__ int mgt_groups(int width) {
    return width < WARP_THREADS ? WARP_THREADS / width : 1;
}

// out[n, i, j, :] = sum over the 2x2 taps of the virtual plane (tiled), or
// over the <= 7x7 stored window (direct).  budget: see mgt_forward_plan (0:
// every block direct).  The tiled path runs at up = 2 (MgtWarpAxis.up).
template <bool VEC4>
__global__ void __launch_bounds__(WARP_THREADS)
warp_forward_kernel(const float* __restrict__ x, const float* __restrict__ theta,
                    float* __restrict__ out, MgtWarpShape s, MgtWarpAxis ay, MgtWarpAxis ax,
                    int tile_h, int tile_w, int budget, int* __restrict__ direct_blocks) {
    extern __shared__ float4 mgt_warp_smem[];
    MgtForwardPlan* plan = reinterpret_cast<MgtForwardPlan*>(mgt_warp_smem);
    float* taps = reinterpret_cast<float*>(mgt_warp_smem) + (WARP_HEADER / 4 - WARP_TILED_TAPS);
    const int tid = threadIdx.x;
    const int n = blockIdx.z;
    const int i0 = blockIdx.y * tile_h, j0 = blockIdx.x * tile_w;
    const int rows = min(tile_h, s.out_h - i0), cols = min(tile_w, s.out_w - j0);
    if (tid == 0) {
        if (VEC4 && budget > 0)
            *plan = mgt_forward_plan(theta, s, ay, ax, n, i0, i0 + rows - 1, j0, j0 + cols - 1,
                                     budget);
        else
            plan->mode = MODE_DIRECT;
        if (plan->mode == MODE_DIRECT && direct_blocks != nullptr) atomicAdd(direct_blocks, 1);
    }
    // the taps with the gain folded in (both axes share the filter)
    if (tid < ax.taps && tid < WARP_TILED_TAPS)
        taps[tid] = static_cast<float>(ax.up) * __ldg(ax.f + tid);
    __syncthreads();
    const MgtForwardPlan p = *plan;
    if (p.mode == MODE_DIRECT) {
        for (int e = tid; e < rows * cols; e += WARP_THREADS) {
            const int r = e / cols;
            warp_forward_pixel<VEC4>(x, theta, out, s, ay, ax, n, i0 + r, j0 + e - r * cols);
        }
        return;
    }
    if constexpr (VEC4) {
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4* o = reinterpret_cast<float4*>(out)
                    + (static_cast<int64_t>(n) * s.out_h + i0) * s.out_w + j0;
        const int go = mgt_groups(tile_w);
        if (p.mode == MODE_EMPTY) {
            for (int k = tid; k < go * tile_w; k += WARP_THREADS) {
                const int c = k % tile_w;
                if (c >= cols) continue;
                for (int r = k / tile_w; r < rows; r += go) o[r * s.out_w + c] = zero;
            }
            return;
        }
        float4* region = mgt_warp_smem + WARP_HEADER / 16;   // stored, then virtual
        float4* xpass = region + max(p.sh * p.sw, p.vh * p.vw);
        const float4* xn = reinterpret_cast<const float4*>(x) + static_cast<int64_t>(n) * s.H * s.W;
        const int gs = mgt_groups(p.sw), gv = mgt_groups(p.vw);
        for (int k = tid; k < gs * p.sw; k += WARP_THREADS) {
            const int c = k % p.sw;
            const float4* src = xn + static_cast<int64_t>(p.sy0) * s.W + p.sx0 + c;
            for (int r = k / p.sw; r < p.sh; r += gs)
                region[r * p.sw + c] = __ldg(src + static_cast<int64_t>(r) * s.W);
        }
        __syncthreads();
        // along x: xpass[r][c] = sum_l tap(m - 2l + k0) * stored[r][l], m = vx0 + c,
        // over the stored columns l that feed m: their taps sit in registers
        for (int k = tid; k < gv * p.vw; k += WARP_THREADS) {
            const int c = k % p.vw;
            const int m = p.vx0 + c;
            const int l0 = max((m + ax.k0 - ax.taps + 2) >> 1, p.sx0);    // ceil(/ 2)
            const int nl = min((m + ax.k0) >> 1, p.sx0 + p.sw - 1) - l0 + 1;
            float w[kMaxL];
#pragma unroll
            for (int a = 0; a < kMaxL; ++a) w[a] = a < nl ? taps[m - 2 * (l0 + a) + ax.k0] : 0.0f;
            const float4* src = region + (l0 - p.sx0);
            for (int r = k / p.vw; r < p.sh; r += gv) {
                float4 acc = zero;
#pragma unroll
                for (int a = 0; a < kMaxL; ++a)
                    if (a < nl) mgt_fma4(acc, w[a], src[r * p.sw + a]);
                xpass[r * p.vw + c] = acc;
            }
        }
        __syncthreads();
        // along y: virtual[r][c] = sum_l tap(m - 2l + k0) * xpass[l][c], m = vy0 + r;
        // it overwrites the stored region, which the x pass has consumed
        for (int k = tid; k < gv * p.vw; k += WARP_THREADS) {
            const int c = k % p.vw;
            for (int r = k / p.vw; r < p.vh; r += gv) {
                const int m = p.vy0 + r;
                const int l0 = max((m + ay.k0 - ay.taps + 2) >> 1, p.sy0);
                const int nl = min((m + ay.k0) >> 1, p.sy0 + p.sh - 1) - l0 + 1;
                const float4* src = xpass + (l0 - p.sy0) * p.vw + c;
                const int j = m - 2 * l0 + ay.k0;
                float4 acc = zero;
#pragma unroll
                for (int a = 0; a < kMaxL; ++a)
                    if (a < nl) mgt_fma4(acc, taps[j - 2 * a], src[a * p.vw]);
                region[r * p.vw + c] = acc;
            }
        }
        __syncthreads();
        // bilinear: the 2x2 taps of each output; a tap outside the region is
        // off the plane (the region holds every tap on it).  mgt_source's
        // steps, the column's products computed once.
        const int virt_h = ay.up * s.H, virt_w = ax.up * s.W;
        const float* th = theta + 6 * n;
        for (int k = tid; k < go * tile_w; k += WARP_THREADS) {
            const int c = k % tile_w;
            if (c >= cols) continue;
            const float xo = mgt_norm_coord(j0 + c, s.out_w);
            const float px = __fmul_rn(th[0], xo), py = __fmul_rn(th[3], xo);
            for (int r = k / tile_w; r < rows; r += go) {
                const float yo = mgt_norm_coord(i0 + r, s.out_h);
                const float sx =
                    mgt_pixel_coord(__fadd_rn(__fadd_rn(px, __fmul_rn(th[1], yo)), th[2]), virt_w);
                const float sy =
                    mgt_pixel_coord(__fadd_rn(__fadd_rn(py, __fmul_rn(th[4], yo)), th[5]), virt_h);
                const float fx = floorf(sx), fy = floorf(sy);
                const float tx = sx - fx, ty = sy - fy;
                const int mx = mgt_floor_tap(fx, virt_w) - p.vx0;
                const int my = mgt_floor_tap(fy, virt_h) - p.vy0;
                float4 acc = zero;
#pragma unroll
                for (int a = 0; a < 2; ++a) {
                    const int yy = my + a;
                    if (yy < 0 || yy >= p.vh) continue;
                    const float wy = a == 0 ? 1.0f - ty : ty;
#pragma unroll
                    for (int b = 0; b < 2; ++b) {
                        const int xx = mx + b;
                        if (xx < 0 || xx >= p.vw) continue;
                        mgt_fma4(acc, wy * (b == 0 ? 1.0f - tx : tx), region[yy * p.vw + xx]);
                    }
                }
                o[r * s.out_w + c] = acc;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// K4': the transpose
// ---------------------------------------------------------------------------

// The exact affine map from output (j, i) to virtual (sx, sy) that
// mgt_source rounds, in double: sx = axj j + axi i + cx (sy likewise), its
// inverse j = ijx (sx - cx) + ijy (sy - cy), i = iix (sx - cx) + iiy (sy -
// cy), the reciprocals rx = 1 / axj and ry = 1 / ayj (0 where infinite),
// and mgt_margin per axis.
struct MgtAffine {
    double axj, axi, cx, ayj, ayi, cy;
    double ijx, ijy, iix, iiy;
    double rx, ry, hx, hy;
};

// False when theta is not finite or the map is singular.
__device__ bool mgt_affine(const float* theta, int n, const MgtWarpShape& s, int virt_h,
                           int virt_w, MgtAffine* q) {
    const float* th = theta + 6 * n;
    q->hx = mgt_margin(th, virt_w);
    q->hy = mgt_margin(th + 3, virt_h);
    const double kx = 0.5 * virt_w, ky = 0.5 * virt_h;
    const double ox = 1.0 / s.out_w - 1.0, oy = 1.0 / s.out_h - 1.0;
    q->axj = th[0] * (2.0 / s.out_w) * kx;
    q->axi = th[1] * (2.0 / s.out_h) * kx;
    q->cx = (th[0] * ox + th[1] * oy + th[2] + 1.0) * kx - 0.5;
    q->ayj = th[3] * (2.0 / s.out_w) * ky;
    q->ayi = th[4] * (2.0 / s.out_h) * ky;
    q->cy = (th[3] * ox + th[4] * oy + th[5] + 1.0) * ky - 0.5;
    const double det = q->axj * q->ayi - q->axi * q->ayj;
    const double size = fabs(q->axj * q->ayi) + fabs(q->axi * q->ayj);
    if (!isfinite(det) || !isfinite(q->cx) || !isfinite(q->cy) || !(fabs(det) > 1e-9 * size))
        return false;
    q->ijx = q->ayi / det;
    q->ijy = -q->axi / det;
    q->iix = -q->ayj / det;
    q->iiy = q->axj / det;
    const double rx = 1.0 / q->axj, ry = 1.0 / q->ayj;
    q->rx = isfinite(rx) ? rx : 0.0;
    q->ry = isfinite(ry) ? ry : 0.0;
    return isfinite(q->ijx) && isfinite(q->ijy) && isfinite(q->iix) && isfinite(q->iiy);
}

// ceil(v) and floor(v) clamped to [lo, hi], v a double (the plan) or a
// float (the gather); NaN gives the bound that widens the range.
template <typename T>
__device__ __forceinline__ int mgt_ceil_in(T v, int lo, int hi) {
    if (!(v > static_cast<T>(lo))) return lo;
    if (v >= static_cast<T>(hi)) return hi;
    return static_cast<int>(ceil(v));
}

template <typename T>
__device__ __forceinline__ int mgt_floor_in(T v, int lo, int hi) {
    if (!(v < static_cast<T>(hi))) return hi;
    if (v <= static_cast<T>(lo)) return lo;
    return static_cast<int>(floor(v));
}

// Rows [r0, r1] within [lo, hi] of the outputs whose exact source point
// can lie in the box (sx +- hx, sy +- hy).
__device__ __forceinline__ void mgt_candidate_rows(const MgtAffine& q, double sx, double sy,
                                                   double hx, double hy, int lo, int hi,
                                                   int* r0, int* r1) {
    const double ic = q.iix * (sx - q.cx) + q.iiy * (sy - q.cy);
    const double ri = fabs(q.iix) * hx + fabs(q.iiy) * hy;
    *r0 = mgt_ceil_in(ic - ri, lo, hi + 1);
    *r1 = mgt_floor_in(ic + ri, lo - 1, hi);
}

// Columns [c0, c1] within [lo, hi] of row i's outputs whose exact source
// point can lie in that box: the columns where each coordinate falls within
// its half-width (an axis whose coordinate does not move along the row
// bounds nothing).
__device__ __forceinline__ void mgt_candidate_cols(const MgtAffine& q, double sx, double sy,
                                                   double hx, double hy, int i, int lo, int hi,
                                                   int* c0, int* c1) {
    double a = lo, b = hi;
    if (q.rx != 0.0) {
        const double u = sx - q.cx - q.axi * i;
        const double e0 = (u - hx) * q.rx, e1 = (u + hx) * q.rx;
        a = fmax(a, fmin(e0, e1));
        b = fmin(b, fmax(e0, e1));
    }
    if (q.ry != 0.0) {
        const double u = sy - q.cy - q.ayi * i;
        const double e0 = (u - hy) * q.ry, e1 = (u + hy) * q.ry;
        a = fmax(a, fmin(e0, e1));
        b = fmin(b, fmax(e0, e1));
    }
    *c0 = mgt_ceil_in(a, lo, hi + 1);
    *c1 = mgt_floor_in(b, lo - 1, hi);
}

// The tiled gather's candidates of virtual sample (vx0 + dx, vy0 + dy), in
// float32 relative to the region's origin and the candidate box's (gi0,
// gj0): rows gi0 + [ceil(ic - ri), floor(ic + ri)] with ic = ic0 + icx dx +
// icy dy, and in row gi0 + di the columns gj0 + [ceil(a), floor(b)] where
// each coordinate's strip jc +- hj, jc = j0 + jm d - ji di, overlaps.  The
// half-widths carry the margin, and 1e-3 plus 1e-5 of the terms' size for
// float32's own rounding; an axis whose coordinate does not move along a
// row has hj = infinity.
struct MgtGather {
    float ic0, icx, icy, ri;
    float jx0, jxm, jxi, hjx;
    float jy0, jym, jyi, hjy;
};

struct MgtTransposePlan {
    MgtAffine q;
    MgtGather gather;
    int affine_ok;
    int mode;                // MgtWarpMode
    int vy0, vx0, vh, vw;    // virtual region the dx tile feeds (inside the plane)
    int gi0, gj0, gh, gw;    // candidate box: output rows, columns
};

// The plans sit in the header of shared memory, before the taps.
static_assert(sizeof(MgtForwardPlan) <= WARP_HEADER - 4 * WARP_TILED_TAPS, "plan too large");
static_assert(sizeof(MgtTransposePlan) <= WARP_HEADER - 4 * WARP_TILED_TAPS, "plan too large");

// One coordinate's strip of MgtGather: r = 1 / its change per output
// column (0: it does not move along a row), per_row its change per output
// row, u0 the region's origin less its value at output (0, 0), half the
// half-width in virtual pixels, width the region's extent along it.
__device__ void mgt_strip(double r, double per_row, double u0, double half, int width, int r0,
                          int c0, int gh, float* j0, float* jm, float* ji, float* hj) {
    if (r == 0.0) {
        *j0 = *jm = *ji = 0.0f;
        *hj = INFINITY;
        return;
    }
    const double a = r * (u0 - per_row * r0) - c0, b = r * per_row;
    *j0 = static_cast<float>(a);
    *jm = static_cast<float>(r);
    *ji = static_cast<float>(b);
    *hj = static_cast<float>(fabs(r) * half + 1e-3
                             + 1e-5 * (fabs(a) + fabs(r) * width + fabs(b) * gh));
}

// The plan of the dx tile rows [l0y, l1y] x columns [l0x, l1x] of sample n
// (ops/affine_warp.py::transpose_tile); `tiled`: the launch's variant.
__device__ void mgt_transpose_plan(const float* theta, const MgtWarpShape& s,
                                   const MgtWarpAxis& ay, const MgtWarpAxis& ax, int n, int l0y,
                                   int l1y, int l0x, int l1x, bool tiled, MgtTransposePlan* p) {
    const int virt_h = ay.up * s.H, virt_w = ax.up * s.W;
    p->affine_ok = mgt_affine(theta, n, s, virt_h, virt_w, &p->q);
    p->mode = MODE_DIRECT;
    // stored l feeds virtual up*l - k0 .. up*l - k0 + T - 1
    const int vy0 = max(ay.up * l0y - ay.k0, 0);
    const int vy1 = min(ay.up * l1y - ay.k0 + ay.taps - 1, virt_h - 1);
    const int vx0 = max(ax.up * l0x - ax.k0, 0);
    const int vx1 = min(ax.up * l1x - ax.k0 + ax.taps - 1, virt_w - 1);
    p->vy0 = vy0;
    p->vx0 = vx0;
    p->vh = vy1 - vy0 + 1;
    p->vw = vx1 - vx0 + 1;
    if (!tiled || !p->affine_ok) return;
    if (p->vh <= 0 || p->vw <= 0) {
        p->mode = MODE_EMPTY;
        return;
    }
    // outputs whose source point can lie within a pixel (and the margin) of
    // the region: rows from the inverse, columns the inverse image's extent
    const MgtAffine& q = p->q;
    const double cx = 0.5 * (vx0 + vx1), cy = 0.5 * (vy0 + vy1);
    const double hx = 0.5 * (vx1 - vx0) + 1.0 + q.hx, hy = 0.5 * (vy1 - vy0) + 1.0 + q.hy;
    int r0, r1;
    mgt_candidate_rows(q, cx, cy, hx, hy, 0, s.out_h - 1, &r0, &r1);
    const double jc = q.ijx * (cx - q.cx) + q.ijy * (cy - q.cy);
    const double rj = fabs(q.ijx) * hx + fabs(q.ijy) * hy;
    int c0 = mgt_ceil_in(jc - rj, 0, s.out_w), c1 = mgt_floor_in(jc + rj, -1, s.out_w - 1);
    if (r0 > r1 || c0 > c1) {
        p->mode = MODE_EMPTY;      // no output reaches the tile: dx is zero
        return;
    }
    // one more row and column each side, so that the box holds every
    // candidate of the per-sample ranges whatever their rounding
    r0 = max(r0 - 1, 0);
    r1 = min(r1 + 1, s.out_h - 1);
    c0 = max(c0 - 1, 0);
    c1 = min(c1 + 1, s.out_w - 1);
    p->gi0 = r0;
    p->gj0 = c0;
    p->gh = r1 - r0 + 1;
    p->gw = c1 - c0 + 1;
    if (p->gh > WARP_TABLE || p->gw > WARP_TABLE) return;
    p->mode = MODE_TILED;
    // each virtual sample's candidates: within a pixel (and the margin)
    MgtGather& gp = p->gather;
    const double ux = 1.0 + q.hx, uy = 1.0 + q.hy;
    const double ox = vx0 - q.cx, oy = vy0 - q.cy;
    const double ic0 = q.iix * ox + q.iiy * oy - r0;
    gp.ic0 = static_cast<float>(ic0);
    gp.icx = static_cast<float>(q.iix);
    gp.icy = static_cast<float>(q.iiy);
    gp.ri = static_cast<float>(fabs(q.iix) * ux + fabs(q.iiy) * uy + 1e-3
                               + 1e-5 * (fabs(ic0) + fabs(q.iix) * p->vw + fabs(q.iiy) * p->vh));
    mgt_strip(q.rx, q.axi, ox, ux, p->vw, r0, c0, p->gh, &gp.jx0, &gp.jxm, &gp.jxi, &gp.hjx);
    mgt_strip(q.ry, q.ayi, oy, uy, p->vh, r0, c0, p->gh, &gp.jy0, &gp.jym, &gp.jyi, &gp.hjy);
}

// The direct path of one dx pixel: every output whose taps reach a virtual
// sample the pixel feeds (all outputs where theta is singular or not
// finite), in raster order, with mgt_axis_weights' weights.
template <bool VEC4>
__device__ void warp_transpose_pixel(const float* __restrict__ g, const float* __restrict__ theta,
                                     float* __restrict__ dx, const MgtWarpShape& s,
                                     const MgtWarpAxis& ay, const MgtWarpAxis& ax,
                                     const MgtTransposePlan& p, int n, int ly, int lx) {
    const int virt_h = ay.up * s.H, virt_w = ax.up * s.W;
    const int my0 = max(ay.up * ly - ay.k0, 0);
    const int my1 = min(ay.up * ly - ay.k0 + ay.taps - 1, virt_h - 1);
    const int mx0 = max(ax.up * lx - ax.k0, 0);
    const int mx1 = min(ax.up * lx - ax.k0 + ax.taps - 1, virt_w - 1);
    const double cx = 0.5 * (mx0 + mx1), cy = 0.5 * (my0 + my1);
    const double hx = 0.5 * (mx1 - mx0) + 1.0 + p.q.hx, hy = 0.5 * (my1 - my0) + 1.0 + p.q.hy;
    int r0 = 0, r1 = s.out_h - 1;
    if (p.affine_ok) mgt_candidate_rows(p.q, cx, cy, hx, hy, 0, s.out_h - 1, &r0, &r1);
    const float* gn = g + static_cast<int64_t>(n) * s.out_h * s.out_w * s.C;
    float* o = dx + ((static_cast<int64_t>(n) * s.H + ly) * s.W + lx) * s.C;
    for (int c0 = 0; c0 < s.C; c0 += 4) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int i = r0; i <= r1; ++i) {
            int j0 = 0, j1 = s.out_w - 1;
            if (p.affine_ok) mgt_candidate_cols(p.q, cx, cy, hx, hy, i, 0, s.out_w - 1, &j0, &j1);
            for (int j = j0; j <= j1; ++j) {
                float sx, sy;
                mgt_source(theta, n, i, j, s.out_h, s.out_w, virt_h, virt_w, &sx, &sy);
                const float wy = mgt_axis_weight_at(ay, sy, ly);
                if (wy == 0.0f) continue;
                const float wx = mgt_axis_weight_at(ax, sx, lx);
                if (wx == 0.0f) continue;
                const float w = wy * wx;
                const float* gp = gn + (static_cast<int64_t>(i) * s.out_w + j) * s.C + c0;
                if (VEC4) {
                    const float4 v = __ldg(reinterpret_cast<const float4*>(gp));
                    acc[0] += w * v.x;
                    acc[1] += w * v.y;
                    acc[2] += w * v.z;
                    acc[3] += w * v.w;
                } else {
                    for (int k = 0; k < 4 && c0 + k < s.C; ++k) acc[k] += w * __ldg(gp + k);
                }
            }
        }
        if (VEC4) {
            *reinterpret_cast<float4*>(o) = make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else {
            for (int k = 0; k < 4 && c0 + k < s.C; ++k) o[c0 + k] = acc[k];
        }
    }
}

// dx[n, ly, lx, :] = sum over outputs p of the weight of (ly, lx) in p's
// window times g[n, p, :]: each dx pixel written once, by one thread.  The
// tiled path runs at up = 2.
template <bool VEC4>
__global__ void __launch_bounds__(WARP_THREADS)
warp_transpose_kernel(const float* __restrict__ g, const float* __restrict__ theta,
                      float* __restrict__ dx, MgtWarpShape s, MgtWarpAxis ay, MgtWarpAxis ax,
                      int tile_h, int tile_w, int tiled, int* __restrict__ direct_blocks) {
    extern __shared__ float4 mgt_warp_smem[];
    MgtTransposePlan* plan = reinterpret_cast<MgtTransposePlan*>(mgt_warp_smem);
    float* taps = reinterpret_cast<float*>(mgt_warp_smem) + (WARP_HEADER / 4 - WARP_TILED_TAPS);
    const int tid = threadIdx.x;
    const int n = blockIdx.z;
    const int ly0 = blockIdx.y * tile_h, lx0 = blockIdx.x * tile_w;
    const int rows = min(tile_h, s.H - ly0), cols = min(tile_w, s.W - lx0);
    if (tid == 0) {
        mgt_transpose_plan(theta, s, ay, ax, n, ly0, ly0 + rows - 1, lx0, lx0 + cols - 1,
                           VEC4 && tiled, plan);
        if (plan->mode == MODE_DIRECT && direct_blocks != nullptr) atomicAdd(direct_blocks, 1);
    }
    if (tid < ax.taps && tid < WARP_TILED_TAPS)
        taps[tid] = static_cast<float>(ax.up) * __ldg(ax.f + tid);
    __syncthreads();
    const int mode = plan->mode;
    if (mode == MODE_DIRECT) {
        for (int e = tid; e < rows * cols; e += WARP_THREADS) {
            const int r = e / cols;
            warp_transpose_pixel<VEC4>(g, theta, dx, s, ay, ax, *plan, n, ly0 + r,
                                       lx0 + e - r * cols);
        }
        return;
    }
    if constexpr (VEC4) {
        const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        float4* d = reinterpret_cast<float4*>(dx) + (static_cast<int64_t>(n) * s.H + ly0) * s.W
                    + lx0;
        const int gd = mgt_groups(tile_w);
        if (mode == MODE_EMPTY) {
            for (int k = tid; k < gd * tile_w; k += WARP_THREADS) {
                const int c = k % tile_w;
                if (c >= cols) continue;
                for (int r = k / tile_w; r < rows; r += gd) d[r * s.W + c] = zero;
            }
            return;
        }
        const MgtTransposePlan& p = *plan;
        const int vy0 = p.vy0, vx0 = p.vx0, vh = p.vh, vw = p.vw;
        // per candidate row (theta[1] * y, theta[4] * y) and column
        // (theta[0] * x, theta[3] * x), x and y the normalized coordinates
        float2* trow = reinterpret_cast<float2*>(mgt_warp_smem + WARP_HEADER / 16);
        float2* tcol = trow + WARP_TABLE;
        float4* dv = mgt_warp_smem + WARP_HEADER / 16 + WARP_TABLE;   // [vh][vw]
        float4* xpass = dv + vh * vw;                                 // [vh][cols]
        const float* thn = theta + 6 * n;
        const float t0 = thn[0], t1 = thn[1], t2 = thn[2], t3 = thn[3], t4 = thn[4],
                    t5 = thn[5];
        for (int e = tid; e < p.gh; e += WARP_THREADS) {
            const float yo = mgt_norm_coord(p.gi0 + e, s.out_h);
            trow[e] = make_float2(__fmul_rn(t1, yo), __fmul_rn(t4, yo));
        }
        for (int e = tid; e < p.gw; e += WARP_THREADS) {
            const float xo = mgt_norm_coord(p.gj0 + e, s.out_w);
            tcol[e] = make_float2(__fmul_rn(t0, xo), __fmul_rn(t3, xo));
        }
        __syncthreads();
        // the gather: dv[m] = sum over m's candidate outputs p, in raster
        // order, of the bilinear weight of m in p's 2x2 taps times g[p].
        // p's taps are floor(s) and floor(s) + 1, so m is one of them where
        // m - 1 <= s < m + 1: tap 0 (weight 1 - (s - m)) where s >= m, else
        // tap 1 (weight s - (m - 1)); the same operations as K3''s s -
        // floor(s), so the same weights.
        const float4* gn = reinterpret_cast<const float4*>(g)
                           + (static_cast<int64_t>(n) * s.out_h + p.gi0) * s.out_w + p.gj0;
        const int virt_h = ay.up * s.H, virt_w = ax.up * s.W;
        const MgtGather q = p.gather;
        const int gv = mgt_groups(vw);
        for (int k = tid; k < gv * vw; k += WARP_THREADS) {
            const int c = k % vw;
            const float fmx = static_cast<float>(vx0 + c);
            const float jx = q.jx0 + q.jxm * static_cast<float>(c);
            for (int r = k / vw; r < vh; r += gv) {
                const float fmy = static_cast<float>(vy0 + r);
                const float ic = q.ic0 + q.icx * static_cast<float>(c) + q.icy * static_cast<float>(r);
                const int r0 = mgt_ceil_in(ic - q.ri, 0, p.gh);
                const int r1 = mgt_floor_in(ic + q.ri, -1, p.gh - 1);
                const float jy = q.jy0 + q.jym * static_cast<float>(r);
                float4 acc = zero;
                for (int di = r0; di <= r1; ++di) {
                    const float cx = jx - q.jxi * static_cast<float>(di);
                    const float cy = jy - q.jyi * static_cast<float>(di);
                    const int c0 = mgt_ceil_in(fmaxf(cx - q.hjx, cy - q.hjy), 0, p.gw);
                    const int c1 = mgt_floor_in(fminf(cx + q.hjx, cy + q.hjy), -1, p.gw - 1);
                    const float2 row_t = trow[di];
                    const float4* grow = gn + static_cast<int64_t>(di) * s.out_w;
                    for (int dj = c0; dj <= c1; ++dj) {
                        const float2 col_t = tcol[dj];
                        // mgt_source's steps, from the tables
                        const float sy = mgt_pixel_coord(
                            __fadd_rn(__fadd_rn(col_t.y, row_t.y), t5), virt_h);
                        if (!(sy >= fmy - 1.0f && sy < fmy + 1.0f)) continue;
                        const float sx = mgt_pixel_coord(
                            __fadd_rn(__fadd_rn(col_t.x, row_t.x), t2), virt_w);
                        if (!(sx >= fmx - 1.0f && sx < fmx + 1.0f)) continue;
                        const float wy = sy >= fmy ? 1.0f - (sy - fmy) : sy - (fmy - 1.0f);
                        const float wx = sx >= fmx ? 1.0f - (sx - fmx) : sx - (fmx - 1.0f);
                        mgt_fma4(acc, wy * wx, __ldg(grow + dj));
                    }
                }
                dv[r * vw + c] = acc;
            }
        }
        __syncthreads();
        // along x, transposed: xpass[r][c] = sum_m tap(m - 2 lx + k0) * dv[r][m]
        // over the virtual columns m that stored column lx = lx0 + c feeds
        for (int k = tid; k < gd * tile_w; k += WARP_THREADS) {
            const int c = k % tile_w;
            if (c >= cols) continue;
            const int lx = lx0 + c;
            const int m0 = max(2 * lx - ax.k0, vx0);
            const int nm = min(2 * lx - ax.k0 + ax.taps - 1, vx0 + vw - 1) - m0 + 1;
            float w[WARP_TILED_TAPS];
#pragma unroll
            for (int a = 0; a < WARP_TILED_TAPS; ++a)
                w[a] = a < nm ? taps[m0 + a - 2 * lx + ax.k0] : 0.0f;
            const float4* src = dv + (m0 - vx0);
            for (int r = k / tile_w; r < vh; r += gd) {
                float4 acc = zero;
#pragma unroll
                for (int a = 0; a < WARP_TILED_TAPS; ++a)
                    if (a < nm) mgt_fma4(acc, w[a], src[r * vw + a]);
                xpass[r * cols + c] = acc;
            }
        }
        __syncthreads();
        // along y, transposed: dx[ly][c] = sum_m tap(m - 2 ly + k0) * xpass[m][c]
        for (int k = tid; k < gd * tile_w; k += WARP_THREADS) {
            const int c = k % tile_w;
            if (c >= cols) continue;
            for (int r = k / tile_w; r < rows; r += gd) {
                const int ly = ly0 + r;
                const int m0 = max(2 * ly - ay.k0, vy0);
                const int nm = min(2 * ly - ay.k0 + ay.taps - 1, vy0 + vh - 1) - m0 + 1;
                const float4* src = xpass + (m0 - vy0) * cols + c;
                const int j = m0 - 2 * ly + ay.k0;
                float4 acc = zero;
#pragma unroll
                for (int a = 0; a < WARP_TILED_TAPS; ++a)
                    if (a < nm) mgt_fma4(acc, taps[j + a], src[a * cols]);
                d[r * s.W + c] = acc;
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

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

// Shared memory of K4''s tiled blocks (ops/affine_warp.py::transpose_smem):
// the header, the candidate tables, the virtual region and the y pass.
static int64_t transpose_smem(int tile_h, int tile_w, int taps, int up) {
    const int64_t vh = static_cast<int64_t>(up) * (tile_h - 1) + taps;
    const int64_t vw = static_cast<int64_t>(up) * (tile_w - 1) + taps;
    return WARP_HEADER + 16 * WARP_TABLE + 16 * (vh * vw + vh * tile_w);
}

// Launches `kernel` on the tile grid, after allowing it (once per device)
// up to 227 KB of dynamic shared memory and the most shared memory in the
// carveout.
template <typename Kernel, typename... Args>
static cudaError_t launch_tiles(Kernel kernel, bool* ready, int tile_h, int tile_w, int rows,
                                int cols, int N, int smem_bytes, cudaStream_t stream,
                                Args... args) {
    const dim3 grid((cols + tile_w - 1) / tile_w, (rows + tile_h - 1) / tile_h, N);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (!ready[dev]) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 WARP_MAX_SMEM);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     cudaSharedmemCarveoutMaxShared);
        if (e != cudaSuccess) return e;
        ready[dev] = true;
    }
    kernel<<<grid, WARP_THREADS, smem_bytes, stream>>>(args...);
    return cudaGetLastError();
}

static bool tiles_ok(int tile_h, int tile_w) {
    return tile_h >= 1 && tile_w >= 1 && tile_h <= 1024 && tile_w <= 1024;
}

// x: [N, H, W, C] float32; theta: [N, 2, 3] float32; out: [N, out_h, out_w, C]
// float32; f: `taps` float32 filter taps (pass [1] with up = 1 for a plain
// bilinear warp).  All contiguous, on the device.  variant: MgtWarpVariant;
// tile_h x tile_w outputs per block; smem_bytes: the tiled blocks' dynamic
// shared memory (WARP_HEADER for the direct variant); direct_blocks: null,
// or a device int that each block taking the direct path adds 1 to.
// Returns a cudaError_t code.
extern "C" int mgt_warp_forward(const float* x, const float* theta, const float* f, float* out,
                                int N, int H, int W, int C, int out_h, int out_w, int taps,
                                int up, int variant, int tile_h, int tile_w, int smem_bytes,
                                int* direct_blocks, void* stream) {
    MgtWarpShape s{N, H, W, C, out_h, out_w};
    MgtWarpAxis ay, ax;
    if (!shape_ok(s) || !make_axes(f, taps, up, H, W, &ay, &ax) || !tiles_ok(tile_h, tile_w))
        return cudaErrorInvalidValue;
    const bool vec4 = C == 4 && mgt_aligned(x, 16) && mgt_aligned(out, 16);
    int budget = 0;
    if (variant == WARP_TILED) {
        if (!vec4 || up != 2 || taps > WARP_TILED_TAPS || smem_bytes <= WARP_HEADER
            || smem_bytes > WARP_MAX_SMEM)
            return cudaErrorInvalidValue;
        budget = (smem_bytes - WARP_HEADER) / 16;
    } else if (variant != WARP_DIRECT || smem_bytes != WARP_HEADER) {
        return cudaErrorInvalidValue;
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    static bool ready[2][64] = {};
    if (vec4)
        return launch_tiles(warp_forward_kernel<true>, ready[1], tile_h, tile_w, out_h, out_w, N,
                            smem_bytes, st, x, theta, out, s, ay, ax, tile_h, tile_w, budget,
                            direct_blocks);
    return launch_tiles(warp_forward_kernel<false>, ready[0], tile_h, tile_w, out_h, out_w, N,
                        smem_bytes, st, x, theta, out, s, ay, ax, tile_h, tile_w, budget,
                        direct_blocks);
}

// g: [N, out_h, out_w, C]; dx: [N, H, W, C], every element written (no
// zeroing needed); tile_h x tile_w dx pixels per block; smem_bytes: exactly
// transpose_smem for the tiled variant, WARP_HEADER for the direct one; the
// rest as in mgt_warp_forward.  Returns a cudaError_t code.
extern "C" int mgt_warp_transpose(const float* g, const float* theta, const float* f, float* dx,
                                  int N, int H, int W, int C, int out_h, int out_w, int taps,
                                  int up, int variant, int tile_h, int tile_w, int smem_bytes,
                                  int* direct_blocks, void* stream) {
    MgtWarpShape s{N, H, W, C, out_h, out_w};
    MgtWarpAxis ay, ax;
    if (!shape_ok(s) || !make_axes(f, taps, up, H, W, &ay, &ax) || !tiles_ok(tile_h, tile_w))
        return cudaErrorInvalidValue;
    const bool vec4 = C == 4 && mgt_aligned(g, 16) && mgt_aligned(dx, 16);
    if (variant == WARP_TILED) {
        if (!vec4 || up != 2 || taps > WARP_TILED_TAPS || smem_bytes > WARP_MAX_SMEM
            || smem_bytes != transpose_smem(tile_h, tile_w, taps, up))
            return cudaErrorInvalidValue;
    } else if (variant != WARP_DIRECT || smem_bytes != WARP_HEADER) {
        return cudaErrorInvalidValue;
    }
    const int tiled = variant == WARP_TILED;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    static bool ready[2][64] = {};
    if (vec4)
        return launch_tiles(warp_transpose_kernel<true>, ready[1], tile_h, tile_w, H, W, N,
                            smem_bytes, st, g, theta, dx, s, ay, ax, tile_h, tile_w, tiled,
                            direct_blocks);
    return launch_tiles(warp_transpose_kernel<false>, ready[0], tile_h, tile_w, H, W, N,
                        smem_bytes, st, g, theta, dx, s, ay, ax, tile_h, tile_w, tiled,
                        direct_blocks);
}
