// K5' translate and composite: per layer a bilinear translate by
// clip(t, -1, 1) * extent / 2 pixels (fill `pad_value` outside the image),
// then the straight-alpha A-over-B composite of the L layers, layer 0 at the
// bottom, over a canvas that starts at zeros.  [B, L, H, W, 4] float32 RGBA
// in [0, 1] and [B, L, 2] float32 (dx, dy) -> [B, H, W, 4] float32.
//
// Replaces: montage_gan_tpu/ops/pallas/composite_kernel.py::
// translate_and_composite_pallas (K5).  The TPU kernel pads every layer on
// the host, DMAs a (tile_h + 1) x (W + 1) window per layer into VMEM and
// lerps whole tiles; its grid needs H to be a multiple of tile_h.  None of
// that carries over.  Here one thread owns one output pixel, for any H and
// W: the layer loop runs in registers, in layer order; each layer reads its
// <= 4 bilinear neighbours as float4s, and a neighbour outside the image
// gives `pad_value`, so no padded copy is made.  The A-over-B step is the
// TPU kernel's formula, with its 0/0 -> 0 rule:
//     ao = la + ca (1 - la),   co = (c la + cc ca (1 - la)) / ao.
//
// The sampling coordinate is computed per pixel with the float32 steps of
// the plain version (ops/grid_sample.py: affine_grid of the translation,
// then grid_sample's unnormalisation), each rounded as PyTorch's elementwise
// ops round (`__f*_rn`, which nvcc does not contract into fused
// multiply-adds), and split into its integer and fractional parts.  So the
// taps and lerp weights are the plain version's, bit for bit; the TPU
// kernel splits the shift once per layer, which in exact arithmetic is the
// same, but rounds otherwise by up to ~6e-5 px at 256 px, and that moves a
// value at a sharp alpha edge by as much.
//
// What bounds it on the H100: memory.  At the main shape [8, 9, 256, 256, 4]
// it must read 75.5 MB and write 8.4 MB (25 us at 3.35 TB/s) against about
// 70 float32 operations per pixel and layer (0.33 GFLOP, 5 us at 67 TFLOP/s).
// The neighbours of a warp's 32 pixels are neighbouring pixels of the same
// rows, so the 4 taps are mostly served by L1/L2 and each input byte comes
// from device memory about once.
#include "common.cuh"

struct MgtCompositeShape {
    int B, L, H, W;
};

__device__ __forceinline__ float4 mgt_load4(const float* p, bool vec4) {
    if (vec4) return __ldg(reinterpret_cast<const float4*>(p));
    return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

// a + (b - a) * t, each step rounded.
__device__ __forceinline__ float mgt_lerp(float a, float b, float t) {
    return __fadd_rn(a, __fmul_rn(__fsub_rn(b, a), t));
}

__device__ __forceinline__ float4 mgt_lerp4(float4 a, float4 b, float t) {
    return make_float4(mgt_lerp(a.x, b.x, t), mgt_lerp(a.y, b.y, t), mgt_lerp(a.z, b.z, t),
                       mgt_lerp(a.w, b.w, t));
}

// The pixel-space source coordinate of output index i along an axis of
// extent n, translated by t (normalised units): affine_grid's
// ((2 i + 1) / n - 1) + t, then grid_sample's (g + 1) * (n / 2) - 0.5.
__device__ __forceinline__ float mgt_source_coord(int i, int n, float t) {
    const float g = __fadd_rn(__fsub_rn(__fdiv_rn(2.0f * i + 1.0f, static_cast<float>(n)), 1.0f), t);
    return __fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), 0.5f * n), 0.5f);
}

template <bool VEC4>
__global__ void composite_kernel(const float* __restrict__ layers, const float* __restrict__ shifts,
                                 float* __restrict__ out, MgtCompositeShape s, float pad_value) {
    const int64_t total = static_cast<int64_t>(s.B) * s.H * s.W;
    const float4 pad = make_float4(pad_value, pad_value, pad_value, pad_value);
    for (int64_t p = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; p < total;
         p += static_cast<int64_t>(gridDim.x) * blockDim.x) {
        const int x = static_cast<int>(p % s.W);
        const int y = static_cast<int>((p / s.W) % s.H);
        const int b = static_cast<int>(p / (static_cast<int64_t>(s.W) * s.H));
        float4 canvas = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int l = 0; l < s.L; ++l) {
            const int bl = b * s.L + l;
            const float tx = fminf(fmaxf(__ldg(shifts + 2 * bl), -1.0f), 1.0f);
            const float ty = fminf(fmaxf(__ldg(shifts + 2 * bl + 1), -1.0f), 1.0f);
            const float ix = mgt_source_coord(x, s.W, tx);
            const float iy = mgt_source_coord(y, s.H, ty);
            const float ix0f = floorf(ix), iy0f = floorf(iy);
            const float fx = __fsub_rn(ix, ix0f), fy = __fsub_rn(iy, iy0f);
            const int ix0 = static_cast<int>(ix0f), iy0 = static_cast<int>(iy0f);
            const float* img = layers + static_cast<int64_t>(bl) * s.H * s.W * 4;
            float4 v[2][2];
#pragma unroll
            for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
                for (int dx = 0; dx < 2; ++dx) {
                    const int yy = iy0 + dy, xx = ix0 + dx;
                    const bool inside = yy >= 0 && yy < s.H && xx >= 0 && xx < s.W;
                    v[dy][dx] = inside
                        ? mgt_load4(img + (static_cast<int64_t>(yy) * s.W + xx) * 4, VEC4)
                        : pad;
                }
            }
            const float4 top = mgt_lerp4(v[0][0], v[0][1], fx);
            const float4 bot = mgt_lerp4(v[1][0], v[1][1], fx);
            const float4 c = mgt_lerp4(top, bot, fy);
            // layer OVER canvas, straight alpha
            const float la = c.w, ca = canvas.w;
            const float keep = __fmul_rn(ca, __fsub_rn(1.0f, la));
            const float ao = __fadd_rn(la, keep);
            if (ao == 0.0f) {
                canvas = make_float4(0.0f, 0.0f, 0.0f, ao);
            } else {
                canvas = make_float4(
                    __fdiv_rn(__fadd_rn(__fmul_rn(c.x, la), __fmul_rn(canvas.x, keep)), ao),
                    __fdiv_rn(__fadd_rn(__fmul_rn(c.y, la), __fmul_rn(canvas.y, keep)), ao),
                    __fdiv_rn(__fadd_rn(__fmul_rn(c.z, la), __fmul_rn(canvas.z, keep)), ao), ao);
            }
        }
        float* o = out + p * 4;
        if (VEC4) {
            *reinterpret_cast<float4*>(o) = canvas;
        } else {
            o[0] = canvas.x;
            o[1] = canvas.y;
            o[2] = canvas.z;
            o[3] = canvas.w;
        }
    }
}

// layers: [B, L, H, W, 4] float32; shifts: [B, L, 2] float32 (dx, dy), not
// yet clamped; out: [B, H, W, 4] float32.  All contiguous, on the device.
// Returns a cudaError_t code.
extern "C" int mgt_translate_composite(const float* layers, const float* shifts, float* out,
                                       int B, int L, int H, int W, float pad_value,
                                       void* stream) {
    if (B <= 0 || L <= 0 || H <= 0 || W <= 0) return cudaErrorInvalidValue;
    const MgtCompositeShape s{B, L, H, W};
    constexpr int THREADS = 256;
    const int64_t total = static_cast<int64_t>(B) * H * W;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (mgt_aligned(layers, 16) && mgt_aligned(out, 16))
        composite_kernel<true><<<mgt_grid(total, THREADS), THREADS, 0, st>>>(layers, shifts, out, s,
                                                                            pad_value);
    else
        composite_kernel<false><<<mgt_grid(total, THREADS), THREADS, 0, st>>>(layers, shifts, out,
                                                                             s, pad_value);
    return cudaGetLastError();
}
