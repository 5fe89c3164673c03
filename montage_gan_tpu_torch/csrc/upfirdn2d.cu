// K2' upfirdn2d: pad -> zero-upsample -> FIR filter -> downsample, fused,
// over NHWC images, with a 2-D [fh, fw] filter or a 1-D separable one.
//
// Replaces: montage_gan_tpu/ops/pallas/upfirdn2d_kernel.py::upfirdn2d_pallas
// (two 1-D Pallas passes, _pass_h and _pass_v, over row blocks in VMEM).  The
// TPU kernel took only 1-D filters, so the [4, 4] filter of the synthesis
// ToRGB skip never reached it; this kernel takes both forms.
//
// What bounds it on the H100: memory and launch overhead.  On the main path
// (the ToRGB skip upsample2d, [B, h, w, 4] float32, up 2, a 4x4 filter) each
// output sums 4 of the 16 taps, about 1 flop per byte moved.  The design:
//   * one thread per output element, channel fastest, so neighbouring
//     threads read neighbouring input addresses and write neighbouring
//     outputs (coalesced for any C);
//   * the zero-upsampled, padded image is never built: a thread starts at the
//     first tap whose sample lands on a real input pixel and steps by `up`,
//     so it touches only the non-zero samples (1/up^2 of the taps);
//   * negative padding (a crop) is just an offset in the same index algebra;
//   * taps are read from the small filter through the read-only cache and
//     accumulated in float32; the output rounds once to the storage type.
// The TPU kernel's row-block and phase-select structure (for VMEM tiling) is
// not carried over.
#include "common.cuh"

__device__ __forceinline__ int mgt_mod(int a, int m) {
    const int r = a % m;
    return r < 0 ? r + m : r;
}

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
                          float gain, cudaStream_t stream) {
    constexpr int THREADS = 256;
    const int64_t total = static_cast<int64_t>(N) * outH * outW * C;
    upfirdn2d_kernel<T><<<mgt_grid(total, THREADS), THREADS, 0, stream>>>(
        static_cast<const T*>(x), static_cast<T*>(y), f, N, H, W, C, outH, outW, upx, upy,
        downx, downy, padx0, pady0, fh, fw, separable, flip, gain);
    return cudaGetLastError();
}

// x: [N, H, W, C] and y: [N, outH, outW, C], contiguous, of `dtype`
// (MgtDtype).  f: float32 on the device, [fh, fw] row-major, or, with
// `separable`, [fh] taps used along both axes (fh == fw); each separable tap
// is scaled by `gain` (pass sqrt of the total gain), a 2-D tap by `gain`.
// Returns a cudaError_t code.
extern "C" int mgt_upfirdn2d(const void* x, void* y, const float* f, int dtype, int N, int H,
                             int W, int C, int outH, int outW, int upx, int upy, int downx,
                             int downy, int padx0, int pady0, int fh, int fw, int separable,
                             int flip, float gain, void* stream) {
    if (N <= 0 || H <= 0 || W <= 0 || C <= 0 || outH <= 0 || outW <= 0 || upx < 1 || upy < 1
        || downx < 1 || downy < 1 || fh < 1 || fw < 1 || (separable && fh != fw))
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (dtype) {
        case MGT_FLOAT32:
            return launch<float>(x, y, f, N, H, W, C, outH, outW, upx, upy, downx, downy, padx0,
                                 pady0, fh, fw, separable, flip, gain, s);
        case MGT_BFLOAT16:
            return launch<__nv_bfloat16>(x, y, f, N, H, W, C, outH, outW, upx, upy, downx,
                                         downy, padx0, pady0, fh, fw, separable, flip, gain, s);
        default: return cudaErrorInvalidValue;
    }
}
