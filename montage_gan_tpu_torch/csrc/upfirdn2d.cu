// K2' upfirdn2d: pad -> zero-upsample -> FIR filter -> downsample, fused,
// over NHWC images, with a 2-D [fh, fw] filter or a 1-D separable one.
//
// Replaces: montage_gan_tpu/ops/pallas/upfirdn2d_kernel.py::upfirdn2d_pallas
// (two 1-D Pallas passes, _pass_h and _pass_v, over row blocks in VMEM).  The
// TPU kernel took only 1-D filters, so the [4, 4] filter of the synthesis
// ToRGB skip never reached it; this kernel takes both forms.
//
// Three variants, chosen by the Python wrapper from the parameters alone
// (ops/upfirdn2d.py::kernel_variant) and passed in as `variant`; a variant
// that does not fit the parameters is refused, never swapped for another:
//
//   * up2 (up 2, down 1) and down2 (up 1, down 2), a filter of at most 4x4
//     (2-D, or 1-D with at most 4 taps): the main path.  up2 is the
//     synthesis ToRGB skip (upsample2d of the [B, h, w, 4] float32 image)
//     and the second order of its gradient; down2 is the gradient of the
//     skip.  upfirdn2d_tiled_kernel, below.
//   * generic: any up, down, filter size and padding (crops included), one
//     thread per output element; upfirdn2d_kernel, at the end of the file.
//
// What bounds it on the H100.  Each output of the main path sums 4 of the
// 16 taps, about 1 flop per byte moved, so the bound is bytes (10.5 MB at
// [8,128,128,4] up 2: 3.1 us at 3.35 TB/s).  The generic kernel, one
// thread per element, reached 6% of that (0.052 ms on the card with L2
// cold, PERF.md, Findings, PR 5): its time went to 64-bit
// index decoding, a modulo and a division per tap, taps re-read through
// __ldg with run-time loop bounds, and 4-byte accesses (a 16-byte pixel
// split over 4 threads).  The tiled kernel removes each of these:
//
//   * one block takes one output tile (TILE_H x TILE_W pixels) of one image
//     with all C channels; its input footprint (the tile's rows and columns
//     divided by `up`, plus the filter's halo, pads and crops included) is
//     staged once in shared memory as float32, out-of-image samples as
//     zeros.  The zero-upsampled image is never built.  A pixel of 16 bytes
//     (C = 4 float32, the main path) is one 16-byte load.  cp.async is not
//     used: the stage converts bfloat16 to float32 and writes the zero pad,
//     and 256 threads with 4-6 resident blocks per SM already keep the
//     footprint's few loads per thread in flight;
//   * the filter is staged once per block, flipped and scaled by the gain,
//     from the device tensor (no host copy, no synchronisation);
//   * each thread owns one output column and every ROW_STEP-th row of the
//     tile.  ROW_STEP is even, so for up 2 the thread's phase (oy mod 2,
//     ox mod 2) is fixed, its first tap is computed once, and the tap loop
//     (UP, DOWN and the taps per phase are template parameters) is
//     unrolled; a whole pixel (all C channels) accumulates in float32
//     registers and rounds once;
//   * stores are 16 bytes a pixel where C * sizeof(T) == 16, neighbouring
//     threads on neighbouring pixels; index arithmetic is 32-bit from the
//     block's origin, per-image offsets 64-bit.
//
// What bounds the tiled kernel now: latency.  It runs at 34% (up2) and 27%
// (down2) of the byte bound with L2 cold (PERF.md, Findings, PR 5): a
// launch is one wave of 512 or 256 blocks, each loading, computing and
// storing its tile in turn with nothing overlapped, and 10.5 MB is too
// little traffic for the memory system to reach its rate.
//
// The footprint formulas are mirrored by ops/upfirdn2d.py::_tile_plan, whose
// shared-memory size the wrapper passes in; the launcher recomputes it and
// refuses a mismatch.  The TPU kernel's two 1-D passes over row blocks (for
// VMEM tiling) are not carried over.
#include "common.cuh"

enum MgtUpfirdnVariant { UPFIRDN_GENERIC = 0, UPFIRDN_UP2 = 1, UPFIRDN_DOWN2 = 2 };

// The tiled variants: output tile, threads, the largest filter side.
constexpr int TILED_THREADS = 256;
constexpr int TILED_FMAX = 4;
constexpr int TILED_MAX_SMEM = 232448;          // 227 KB, the H100's per-block limit
template <int UP, int DOWN> struct MgtTile;
template <> struct MgtTile<2, 1> { static constexpr int H = 32, W = 32; };
template <> struct MgtTile<1, 2> { static constexpr int H = 16, W = 32; };

__device__ __forceinline__ int mgt_mod(int a, int m) {
    const int r = a % m;
    return r < 0 ? r + m : r;
}

// Footprint side of a tile of `tile` outputs: the most multiples of `up` in
// the (tile - 1) * down + f consecutive upsampled samples the tile reads.
static inline int mgt_footprint(int tile, int up, int down, int f) {
    return ((tile - 1) * down + f + up - 1) / up;
}

template <int UP, int DOWN>
static inline int tiled_smem_bytes(int C, int fh, int fw) {
    const int fph = mgt_footprint(MgtTile<UP, DOWN>::H, UP, DOWN, fh);
    const int fpw = mgt_footprint(MgtTile<UP, DOWN>::W, UP, DOWN, fw);
    return (TILED_FMAX * TILED_FMAX + fph * fpw * C) * static_cast<int>(sizeof(float));
}

// VEC16: C * sizeof(T) == 16 and x, y 16-byte aligned, so a pixel is one
// 16-byte access and CT (= C) channels sit in registers; otherwise channels
// go in groups of CT with a guard.
template <typename T, int UP, int DOWN, bool VEC16>
__global__ void __launch_bounds__(TILED_THREADS)
upfirdn2d_tiled_kernel(const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ f,
                       int H, int W, int C, int outH, int outW, int padx0, int pady0, int fh,
                       int fw, int separable, int flip, float gain, int fph, int fpw) {
    constexpr int TH = MgtTile<UP, DOWN>::H, TW = MgtTile<UP, DOWN>::W;
    constexpr int ROW_STEP = TILED_THREADS / TW;
    constexpr int ROWS = TH / ROW_STEP;
    constexpr int TAPS = (TILED_FMAX + UP - 1) / UP;      // taps per phase, one axis
    constexpr int CT = 16 / sizeof(T);                    // channels per register group
    static_assert(ROW_STEP % UP == 0, "a thread's rows must share a phase");

    extern __shared__ float smem[];
    float* filt = smem;                                   // [FMAX][FMAX]
    float* tile = smem + TILED_FMAX * TILED_FMAX;         // [fph][fpw][C]
    const int tid = threadIdx.x;
    const int n = blockIdx.z;
    const int ty0 = blockIdx.y * TH, tx0 = blockIdx.x * TW;
    // First input row / column any output of the tile reads.
    const int iy0 = mgt_ceildiv(ty0 * DOWN - pady0, UP);
    const int ix0 = mgt_ceildiv(tx0 * DOWN - padx0, UP);

    if (tid < TILED_FMAX * TILED_FMAX) {
        const int i = tid / TILED_FMAX, j = tid % TILED_FMAX;
        float v = 0.0f;
        if (i < fh && j < fw) {
            // correlation with the flipped filter == convolution with f
            const int fi = flip ? i : fh - 1 - i;
            const int fj = flip ? j : fw - 1 - j;
            v = separable ? (f[fi] * gain) * (f[fj] * gain) : f[fi * fw + fj] * gain;
        }
        filt[tid] = v;
    }
    const T* xn = x + static_cast<int64_t>(n) * H * W * C;
    if constexpr (VEC16) {
        for (int p = tid; p < fph * fpw; p += TILED_THREADS) {
            const int r = p / fpw, q = p - r * fpw;
            const int iy = iy0 + r, ix = ix0 + q;
            float4* dst = reinterpret_cast<float4*>(tile + p * CT);
            if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
                const MgtVec<T, CT> u = *reinterpret_cast<const MgtVec<T, CT>*>(
                    xn + (static_cast<int64_t>(iy) * W + ix) * CT);
#pragma unroll
                for (int k = 0; k < CT; k += 4)
                    dst[k / 4] = make_float4(mgt_to_float(u.v[k]), mgt_to_float(u.v[k + 1]),
                                             mgt_to_float(u.v[k + 2]), mgt_to_float(u.v[k + 3]));
            } else {
#pragma unroll
                for (int k = 0; k < CT; k += 4) dst[k / 4] = make_float4(0.f, 0.f, 0.f, 0.f);
            }
        }
    } else {
        // A footprint row is fpw * C consecutive elements of x.
        const int row = fpw * C;
        for (int e = tid; e < fph * row; e += TILED_THREADS) {
            const int r = e / row, q = e - r * row;
            const int iy = iy0 + r, ix = ix0 + q / C;
            float v = 0.0f;
            if (iy >= 0 && iy < H && ix >= 0 && ix < W)
                v = mgt_to_float(xn[(static_cast<int64_t>(iy) * W + ix0) * C + q]);
            tile[e] = v;
        }
    }
    __syncthreads();

    const int lx = tid % TW, ly = tid / TW;
    const int ox = tx0 + lx;
    if (ox >= outW) return;
    // Tap j reads upsampled column xs + j, a real sample where it divides
    // by UP; the thread's first such tap, and its footprint column.
    const int xs = ox * DOWN - padx0;
    const int j0 = mgt_mod(-xs, UP);
    const int cx = (xs + j0) / UP - ix0;
    T* yn = y + static_cast<int64_t>(n) * outH * outW * C;
#pragma unroll 1
    for (int k = 0; k < ROWS; ++k) {
        const int oy = ty0 + ly + k * ROW_STEP;
        if (oy >= outH) break;
        const int ys = oy * DOWN - pady0;
        const int i0 = mgt_mod(-ys, UP);
        const int cy = (ys + i0) / UP - iy0;
        T* out = yn + (static_cast<int64_t>(oy) * outW + ox) * C;
        for (int c0 = 0; c0 < C; c0 += CT) {
            float acc[CT];
#pragma unroll
            for (int c = 0; c < CT; ++c) acc[c] = 0.0f;
#pragma unroll
            for (int a = 0; a < TAPS; ++a) {
                const int i = i0 + a * UP;
                if (i >= fh) continue;
#pragma unroll
                for (int b = 0; b < TAPS; ++b) {
                    const int j = j0 + b * UP;
                    if (j >= fw) continue;
                    const float tap = filt[i * TILED_FMAX + j];
                    const float* px = tile + ((cy + a) * fpw + cx + b) * C + c0;
                    if constexpr (VEC16) {
#pragma unroll
                        for (int c = 0; c < CT; c += 4) {
                            const float4 v = *reinterpret_cast<const float4*>(px + c);
                            acc[c] += tap * v.x;
                            acc[c + 1] += tap * v.y;
                            acc[c + 2] += tap * v.z;
                            acc[c + 3] += tap * v.w;
                        }
                    } else {
#pragma unroll
                        for (int c = 0; c < CT; ++c)
                            if (c0 + c < C) acc[c] += tap * px[c];
                    }
                }
            }
            if constexpr (VEC16) {
                MgtVec<T, CT> o;
#pragma unroll
                for (int c = 0; c < CT; ++c) o.v[c] = mgt_from_float<T>(acc[c]);
                *reinterpret_cast<MgtVec<T, CT>*>(out) = o;
            } else {
#pragma unroll
                for (int c = 0; c < CT; ++c)
                    if (c0 + c < C) out[c0 + c] = mgt_from_float<T>(acc[c]);
            }
        }
    }
}

template <typename T, int UP, int DOWN>
static cudaError_t launch_tiled(const void* x, void* y, const float* f, int N, int H, int W,
                                int C, int outH, int outW, int padx0, int pady0, int fh, int fw,
                                int separable, int flip, float gain, int smem_bytes,
                                cudaStream_t stream) {
    constexpr int TH = MgtTile<UP, DOWN>::H, TW = MgtTile<UP, DOWN>::W;
    if (fh > TILED_FMAX || fw > TILED_FMAX || smem_bytes != tiled_smem_bytes<UP, DOWN>(C, fh, fw)
        || smem_bytes > TILED_MAX_SMEM)
        return cudaErrorInvalidValue;
    const int fph = mgt_footprint(TH, UP, DOWN, fh), fpw = mgt_footprint(TW, UP, DOWN, fw);
    const dim3 grid((outW + TW - 1) / TW, (outH + TH - 1) / TH, N);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
    const bool vec16 = C * static_cast<int>(sizeof(T)) == 16 && mgt_aligned(x, 16)
                       && mgt_aligned(y, 16);
    // Once per device and kernel: allow up to 227 KB of dynamic shared
    // memory (needed above 48 KB) and prefer the most shared memory in the
    // carveout, so that as many blocks are resident as their footprints
    // allow (6 of down2's 36 KB blocks on an SM).
    static bool ready[2][64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    auto run = [&](auto kernel) -> cudaError_t {
        if (!ready[vec16][dev]) {
            e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     TILED_MAX_SMEM);
            if (e == cudaSuccess)
                e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                         cudaSharedmemCarveoutMaxShared);
            if (e != cudaSuccess) return e;
            ready[vec16][dev] = true;
        }
        kernel<<<grid, TILED_THREADS, smem_bytes, stream>>>(
            static_cast<const T*>(x), static_cast<T*>(y), f, H, W, C, outH, outW, padx0, pady0,
            fh, fw, separable, flip, gain, fph, fpw);
        return cudaGetLastError();
    };
    return vec16 ? run(upfirdn2d_tiled_kernel<T, UP, DOWN, true>)
                 : run(upfirdn2d_tiled_kernel<T, UP, DOWN, false>);
}

// The generic variant: one thread per output element, channel fastest, so
// neighbouring threads read neighbouring input addresses and write
// neighbouring outputs (coalesced for any C).  A thread starts at the first
// tap whose sample lands on a real input pixel and steps by `up`, so it
// touches only the non-zero samples; negative padding (a crop) is an offset
// in the same index algebra.
template <typename T>
__global__ void upfirdn2d_kernel(const T* __restrict__ x, T* __restrict__ y,
                                 const float* __restrict__ f, int N, int H, int W, int C,
                                 int outH, int outW, int upx, int upy, int downx, int downy,
                                 int padx0, int pady0, int fh, int fw, int separable, int flip,
                                 float gain) {
    const int64_t total = static_cast<int64_t>(N) * outH * outW * C;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    for (int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; idx < total;
         idx += stride) {
        const int c = static_cast<int>(idx % C);
        int64_t t = idx / C;
        const int ox = static_cast<int>(t % outW);
        t /= outW;
        const int oy = static_cast<int>(t % outH);
        const int n = static_cast<int>(t / outH);

        // Tap (i, j) reads the padded, zero-upsampled image at
        // (y0 + i, x0 + j); it is non-zero only on multiples of `up`.
        const int y0 = oy * downy - pady0;
        const int x0 = ox * downx - padx0;
        const int i0 = mgt_mod(-y0, upy);
        const int j0 = mgt_mod(-x0, upx);
        const T* xn = x + static_cast<int64_t>(n) * H * W * C + c;

        float acc = 0.0f;
        for (int i = i0; i < fh; i += upy) {
            const int yy = y0 + i;
            if (yy < 0 || yy >= H * upy) continue;
            const int iy = yy / upy;
            // correlation with the flipped filter == convolution with f
            const int fi = flip ? i : fh - 1 - i;
            for (int j = j0; j < fw; j += upx) {
                const int xx = x0 + j;
                if (xx < 0 || xx >= W * upx) continue;
                const int ix = xx / upx;
                const int fj = flip ? j : fw - 1 - j;
                const float tap = separable ? (__ldg(f + fi) * gain) * (__ldg(f + fj) * gain)
                                            : __ldg(f + fi * fw + fj) * gain;
                acc += tap * mgt_to_float(xn[(static_cast<int64_t>(iy) * W + ix) * C]);
            }
        }
        y[idx] = mgt_from_float<T>(acc);
    }
}

template <typename T>
static cudaError_t launch(const void* x, void* y, const float* f, int N, int H, int W, int C,
                          int outH, int outW, int upx, int upy, int downx, int downy,
                          int padx0, int pady0, int fh, int fw, int separable, int flip,
                          float gain, int variant, int smem_bytes, cudaStream_t stream) {
    const bool square_up2 = upx == 2 && upy == 2 && downx == 1 && downy == 1;
    const bool square_down2 = upx == 1 && upy == 1 && downx == 2 && downy == 2;
    switch (variant) {
        case UPFIRDN_UP2:
            if (!square_up2) return cudaErrorInvalidValue;
            return launch_tiled<T, 2, 1>(x, y, f, N, H, W, C, outH, outW, padx0, pady0, fh, fw,
                                         separable, flip, gain, smem_bytes, stream);
        case UPFIRDN_DOWN2:
            if (!square_down2) return cudaErrorInvalidValue;
            return launch_tiled<T, 1, 2>(x, y, f, N, H, W, C, outH, outW, padx0, pady0, fh, fw,
                                         separable, flip, gain, smem_bytes, stream);
        case UPFIRDN_GENERIC: {
            constexpr int THREADS = 256;
            const int64_t total = static_cast<int64_t>(N) * outH * outW * C;
            upfirdn2d_kernel<T><<<mgt_grid(total, THREADS), THREADS, 0, stream>>>(
                static_cast<const T*>(x), static_cast<T*>(y), f, N, H, W, C, outH, outW, upx,
                upy, downx, downy, padx0, pady0, fh, fw, separable, flip, gain);
            return cudaGetLastError();
        }
        default: return cudaErrorInvalidValue;
    }
}

// x: [N, H, W, C] and y: [N, outH, outW, C], contiguous, of `dtype`
// (MgtDtype).  f: float32 on the device, [fh, fw] row-major, or, with
// `separable`, [fh] taps used along both axes (fh == fw); each separable tap
// is scaled by `gain` (pass sqrt of the total gain), a 2-D tap by `gain`.
// `variant` (MgtUpfirdnVariant) and, for the tiled ones, their dynamic
// shared memory in bytes, as ops/upfirdn2d.py::_tile_plan gives it.
// Returns a cudaError_t code.
extern "C" int mgt_upfirdn2d(const void* x, void* y, const float* f, int dtype, int N, int H,
                             int W, int C, int outH, int outW, int upx, int upy, int downx,
                             int downy, int padx0, int pady0, int fh, int fw, int separable,
                             int flip, float gain, int variant, int smem_bytes, void* stream) {
    if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || outH <= 0 || outW <= 0 || upx < 1 || upy < 1
        || downx < 1 || downy < 1 || fh < 1 || fw < 1 || (separable && fh != fw))
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case MGT_FLOAT32:
            return launch<float>(x, y, f, N, H, W, C, outH, outW, upx, upy, downx, downy, padx0,
                                 pady0, fh, fw, separable, flip, gain, variant, smem_bytes, s);
        case MGT_BFLOAT16:
            return launch<__nv_bfloat16>(x, y, f, N, H, W, C, outH, outW, upx, upy, downx,
                                         downy, padx0, pady0, fh, fw, separable, flip, gain,
                                         variant, smem_bytes, s);
        default: return cudaErrorInvalidValue;
    }
}
