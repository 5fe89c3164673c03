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
// that carries over.
//
// What bounds it on the H100: memory.  At the main shape [8, 9, 256, 256, 4]
// it must read 75.5 MB and write 8.4 MB (25 us at 3.35 TB/s) against a few
// dozen float32 operations per pixel and layer.  The design:
//
//  * Row tiles.  A block owns R output rows (a template parameter, 8 or 4)
//    by tile_w = min(256, W) columns of one sample; a thread owns one
//    column and all R rows,
//    so its canvas (R float4s) stays in registers over the layer loop.  Any
//    H and W: a tile past the edge is masked.
//  * Tap tables per (tile, layer) in shared memory: the columns' (ix0, fx)
//    and the rows' (iy0, fy), each from the plain version's rounded steps
//    (mgt_centre, then mgt_tap), so the taps and lerp weights are its own,
//    bit for bit.  The division of a coordinate does not depend on the
//    layer and runs once per block for a thread's column and row.  Warp 0
//    builds the row table and votes whether it is regular (row r reads
//    source rows base + r and base + r + 1).  A tap outside the image takes
//    `pad_value` in registers.
//  * Staging by bulk copy in a ring over the layers.  Layer l's source
//    window is the image pixels its tile's taps read: rows [iy0(first row),
//    iy0(last row) + 1] and columns [ix0(first), ix0(last) + 1], clipped to
//    the image (the coordinates are monotonic in the index, so the ends
//    bound the window).  Each window row is one contiguous run of 16-byte
//    pixels, and a full-width window is one run; warp 0 issues one
//    cp.async.bulk per run, completing on the stage's mbarrier with its byte
//    count, two layers ahead of the compositing, so the next layer's window
//    is in flight while one composites.  Rounding can move floor() by 0 or
//    2 between neighbours, so a window has at most R + 2 rows and tile_w + 2
//    columns (the stage's size; tests/test_torch_composite_plans.py holds
//    the bound, and a window past it traps).
//  * Each source row once.  A regular layer (nearly all) loads the R + 1
//    source rows of its column with no branch, so the loads issue together,
//    and lerps each row horizontally once; an irregular one loads a row's
//    taps where they differ from the last row's.
//  * A premultiplied canvas: P <- c la + P (1 - la), A <- la + A (1 - la),
//    divided once per pixel at the end, 0/0 -> 0.  In exact arithmetic this
//    is the TPU kernel's per-layer recurrence (P = co ao; ao = 0 forces
//    la = ca = 0), with three divisions per pixel instead of per layer.
//  * One coalesced float4 store per pixel, with the streaming hint.
//
// R = 8 by 256 columns and two stages (86.8 KB of shared memory, 128
// registers a thread: two blocks an SM, the 256 tiles of the main shape in
// one wave) were the fastest of the plans tools/warp_phases.py times (it
// builds the others by changing COMPOSITE_STAGES, COMPOSITE_TILE_W or the
// rows of the 8-row instance); deeper rings or larger tiles leave fewer
// blocks per SM or a second wave.  A launch of fewer 8-row tiles than the
// card has SMs takes R = 4 (more blocks; the plan in ops/composite.py).  A
// persistent grid with the ring running across tiles was slower (more
// registers, fewer blocks an SM).
//
// Two variants of the same kernel, chosen by the Python wrapper
// (ops/composite.py::composite_plan) and counted there: `tiled` (the ring;
// a 16-byte aligned layer tensor) and `direct` (no staging: taps from
// device memory with 4-byte loads, for a base pointer off 16-byte
// alignment).  Both share the tiles, the tables and the arithmetic.
#include <climits>

#include "async_copy.cuh"
#include "common.cuh"

enum MgtCompositeVariant { COMPOSITE_DIRECT = 0, COMPOSITE_TILED = 1 };

constexpr int COMPOSITE_STAGES = 2;     // the ring's depth
constexpr int COMPOSITE_TILE_W = 256;   // a tile's columns at most: one thread each

struct MgtCompositeShape {
    int B, L, H, W;
};

// The integer and fractional parts of a source coordinate.
struct MgtTap {
    int i0;
    float f;
};

// A layer's source window for one tile: image rows [y0, y0 + rows) by
// columns [x0, x0 + cols), stored row-major with pitch cols.  rows = 0: no
// tap of the tile lies in the image.  base is the
// first row's iy0; regular: row r's is base + r for every row of the tile
// (the rule: rounding breaks it only where a coordinate lies within a few
// ulps of an integer).
struct MgtWindow {
    int y0, x0, rows, cols, base, regular;
};

// Image pixels a stage holds: the largest window of an R x tile_w tile.
__host__ __device__ constexpr int composite_capacity(int R, int tile_w) {
    return (R + 2) * (tile_w + 2);
}

// A stage's shared memory: its window (tiled only), column table, row
// table, window header and mbarrier; every part a multiple of 8 bytes, the
// windows first (16-byte aligned for the bulk copies).
__host__ __device__ constexpr int composite_stage_bytes(int R, int tile_w, bool tiled) {
    return (tiled ? 16 * composite_capacity(R, tile_w) : 0) + 8 * tile_w + 8 * R +
           static_cast<int>(sizeof(MgtWindow)) + 8;
}

// A pixel of a layer tensor off 16-byte alignment, by 4-byte loads.
__device__ __forceinline__ float4 mgt_load4(const float* p) {
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
// ((2 i + 1) / n - 1) + t, then grid_sample's (g + 1) * (n / 2) - 0.5, each
// step rounded as PyTorch's elementwise ops round (`__f*_rn`, which nvcc
// does not contract into fused multiply-adds).  mgt_centre is the part
// without t, the same for every layer.
__device__ __forceinline__ float mgt_centre(int i, int n) {
    return __fsub_rn(__fdiv_rn(2.0f * i + 1.0f, static_cast<float>(n)), 1.0f);
}

__device__ __forceinline__ MgtTap mgt_tap(float centre, int n, float t) {
    const float g = __fadd_rn(centre, t);
    const float c = __fsub_rn(__fmul_rn(__fadd_rn(g, 1.0f), 0.5f * n), 0.5f);
    const float c0 = floorf(c);
    return {static_cast<int>(c0), __fsub_rn(c, c0)};
}

// A shift clamped to [-1, 1] (NaN gives -1).
__device__ __forceinline__ float mgt_shift(const float* shifts, int i) {
    return fminf(fmaxf(__ldg(shifts + i), -1.0f), 1.0f);
}

// The image pixels that the taps of a tile read, translated by (tx, ty):
// `ends` holds the centres of its first and last row and of its first and
// last column.
__device__ __forceinline__ MgtWindow mgt_window(const float (&ends)[4], int H, int W, float tx,
                                                float ty) {
    const int r0 = max(mgt_tap(ends[0], H, ty).i0, 0);
    const int r1 = min(mgt_tap(ends[1], H, ty).i0 + 1, H - 1);
    const int c0 = max(mgt_tap(ends[2], W, tx).i0, 0);
    const int c1 = min(mgt_tap(ends[3], W, tx).i0 + 1, W - 1);
    if (r1 < r0 || c1 < c0) return {0, 0, 0, 0, 0, 0};
    return {r0, c0, r1 - r0 + 1, c1 - c0 + 1, 0, 0};
}

// Layer (colour c, alpha c.w) over the premultiplied canvas p.
__device__ __forceinline__ float4 mgt_over(float4 p, float4 c) {
    const float la = c.w, keep = __fsub_rn(1.0f, la);
    return make_float4(__fadd_rn(__fmul_rn(c.x, la), __fmul_rn(p.x, keep)),
                       __fadd_rn(__fmul_rn(c.y, la), __fmul_rn(p.y, keep)),
                       __fadd_rn(__fmul_rn(c.z, la), __fmul_rn(p.z, keep)),
                       __fadd_rn(la, __fmul_rn(p.w, keep)));
}

// Straight colour of a premultiplied pixel, 0/0 -> 0.
__device__ __forceinline__ float4 mgt_straight(float4 p) {
    if (p.w == 0.0f) return make_float4(0.0f, 0.0f, 0.0f, p.w);
    return make_float4(__fdiv_rn(p.x, p.w), __fdiv_rn(p.y, p.w), __fdiv_rn(p.z, p.w), p.w);
}

// The horizontal lerp, at this thread's column (tap cx), of source row yy:
// from the staged window `win` (STAGED) or the layer's image `img` in
// device memory.  A tap outside the image is `pad`; its load reads a safe
// address and is discarded, so the loads of many rows issue together.
template <bool STAGED>
__device__ __forceinline__ float4 mgt_hrow(int yy, MgtTap cx, bool left, bool right,
                                           const MgtWindow& w, const float4* win,
                                           const float* img, int H, int W, float4 pad) {
    const bool in = yy >= 0 && yy < H;
    const bool a_ok = in && left, b_ok = in && right;
    float4 a, b;
    if (STAGED) {
        const int i = (yy - w.y0) * w.cols + (cx.i0 - w.x0);
        a = win[a_ok ? i : 0];
        b = win[b_ok ? i + 1 : 0];
    } else {
        const int64_t i = (static_cast<int64_t>(yy) * W + cx.i0) * 4;
        a = mgt_load4(img + (a_ok ? i : 0));
        b = mgt_load4(img + (b_ok ? i + 4 : 0));
    }
    return mgt_lerp4(a_ok ? a : pad, b_ok ? b : pad, cx.f);
}

// One layer of one thread's column (tap cx) over its R rows' canvas.
// `row` is the stage's row table (nrows entries), `w` its window header.
// A regular layer reads source rows base .. base + R, each once, with no
// branch; otherwise a row's taps are loaded where they differ from the
// last row's.
template <int R, bool STAGED>
__device__ __forceinline__ void mgt_layer_over(float4 (&acc)[R], MgtTap cx, const MgtTap* row,
                                               int nrows, const MgtWindow& w, const float4* win,
                                               const float* img, int H, int W, float4 pad) {
    const bool left = cx.i0 >= 0 && cx.i0 < W;
    const bool right = cx.i0 >= -1 && cx.i0 < W - 1;
    if (w.regular) {
        // rows past the tile's last (nrows < R) stay inside the stage and
        // are discarded
        float4 h[R + 1];
#pragma unroll
        for (int j = 0; j <= R; ++j)
            h[j] = mgt_hrow<STAGED>(w.base + j, cx, left, right, w, win, img, H, W, pad);
#pragma unroll
        for (int r = 0; r < R; ++r)
            if (r < nrows) acc[r] = mgt_over(acc[r], mgt_lerp4(h[r], h[r + 1], row[r].f));
        return;
    }
    int seen = INT_MIN;                // the source row of `top`
    float4 top = pad, bot = pad;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (r < nrows) {               // uniform across the block
            const MgtTap cy = row[r];
            if (cy.i0 != seen) {
                top = cy.i0 == seen + 1
                          ? bot
                          : mgt_hrow<STAGED>(cy.i0, cx, left, right, w, win, img, H, W, pad);
                bot = mgt_hrow<STAGED>(cy.i0 + 1, cx, left, right, w, win, img, H, W, pad);
                seen = cy.i0;
            }
            acc[r] = mgt_over(acc[r], mgt_lerp4(top, bot, cy.f));
        }
    }
}

// One block per tile: rows [blockIdx.y R, + R) by columns [blockIdx.x
// tile_w, + tile_w) of sample blockIdx.z; one thread per column.  TILED:
// the windows come through the ring; else the taps are read from device
// memory with 4-byte loads (the ring then holds the tables only).
template <int R, bool TILED>
__global__ void __launch_bounds__(COMPOSITE_TILE_W)
composite_kernel(const float* __restrict__ layers, const float* __restrict__ shifts,
                 float* __restrict__ out, MgtCompositeShape s, float pad_value, int tile_w) {
    constexpr int stages = COMPOSITE_STAGES;
    extern __shared__ __align__(128) unsigned char mgt_composite_smem[];
    const int cap = TILED ? composite_capacity(R, tile_w) : 0;
    float4* ring = reinterpret_cast<float4*>(mgt_composite_smem);
    MgtTap* col_tab = reinterpret_cast<MgtTap*>(ring + stages * cap);        // [stages][tile_w]
    MgtTap* row_tab = col_tab + stages * tile_w;                             // [stages][R]
    MgtWindow* window = reinterpret_cast<MgtWindow*>(row_tab + stages * R);  // [stages]
    uint64_t* full = reinterpret_cast<uint64_t*>(window + stages);           // [stages]

    const int tid = threadIdx.x;
    const int b = blockIdx.z;
    const int x0 = blockIdx.x * tile_w, y0 = blockIdx.y * R;
    const int ncols = min(tile_w, s.W - x0), nrows = min(R, s.H - y0);
    const int64_t plane = static_cast<int64_t>(s.H) * s.W * 4;
    const float* sample = layers + static_cast<int64_t>(b) * s.L * plane;
    // the layer-free part of the coordinates: this thread's column and row
    // (one division each per block), and, for warp 0, the tile's ends
    const float u_col = mgt_centre(x0 + min(tid, ncols - 1), s.W);
    const float u_row = mgt_centre(y0 + min(tid, nrows - 1), s.H);
    float u_end[4] = {};
    if (tid < 32) {
        u_end[0] = mgt_centre(y0, s.H);
        u_end[1] = mgt_centre(y0 + nrows - 1, s.H);
        u_end[2] = mgt_centre(x0, s.W);
        u_end[3] = mgt_centre(x0 + ncols - 1, s.W);
    }

    // Layer l into stage st: warp 0 finds its window and issues its copies;
    // every thread fills its entries of the tables.
    auto prepare = [&](int l, int st) {
        const int bl = b * s.L + l;
        const float tx = mgt_shift(shifts, 2 * bl), ty = mgt_shift(shifts, 2 * bl + 1);
        if (tid < 32) {
            MgtWindow w = mgt_window(u_end, s.H, s.W, tx, ty);
            const MgtTap cy = mgt_tap(u_row, s.H, ty);
            if (tid < nrows) row_tab[st * R + tid] = cy;
            w.base = __shfl_sync(0xffffffffu, cy.i0, 0);
            w.regular = __all_sync(0xffffffffu, tid >= nrows || cy.i0 == w.base + tid);
            if (TILED) {
                if (w.rows > R + 2 || w.cols > tile_w + 2) __trap();   // past the stage
                const uint32_t bytes = 16u * w.rows * w.cols;
                if (tid == 0) mgt_mbar_arrive_expect(full + st, bytes);
                __syncwarp();
                if (bytes) {
                    mgt_fence_proxy_async();
                    const float* img = sample + l * plane;
                    float4* dst = ring + st * cap;
                    if (w.cols == s.W) {   // the window is one run
                        if (tid == 0)
                            mgt_bulk_load(dst, img + static_cast<int64_t>(w.y0) * s.W * 4, bytes,
                                          full + st);
                    } else {
                        for (int r = tid; r < w.rows; r += 32)
                            mgt_bulk_load(dst + r * w.cols,
                                          img + (static_cast<int64_t>(w.y0 + r) * s.W + w.x0) * 4,
                                          16u * w.cols, full + st);
                    }
                }
            }
            if (tid == 0) window[st] = w;
        }
        if (tid < ncols) col_tab[st * tile_w + tid] = mgt_tap(u_col, s.W, tx);
    };

    if (TILED && tid == 0) {
        for (int i = 0; i < stages; ++i) mgt_mbar_init(full + i, 1);
        mgt_mbar_init_fence();
    }
    __syncthreads();
    for (int l = 0; l < stages && l < s.L; ++l) prepare(l, l);
    __syncthreads();

    const float4 pad = make_float4(pad_value, pad_value, pad_value, pad_value);
    float4 acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int st = 0;
    uint32_t parity = 0;
    for (int l = 0; l < s.L; ++l) {
        if (TILED) mgt_mbar_wait(full + st, parity);
        if (tid < ncols) {
            const MgtWindow w = window[st];
            const MgtTap cx = col_tab[st * tile_w + tid];
            const float* img = sample + l * plane;
            mgt_layer_over<R, TILED>(acc, cx, row_tab + st * R, nrows, w, ring + st * cap, img,
                                     s.H, s.W, pad);
        }
        if (l + 1 < s.L) {
            // every thread is done with stage st: refill it `stages` layers
            // ahead (the tables written here are read after at least one
            // more barrier, since stages >= 2)
            __syncthreads();
            if (l + stages < s.L) prepare(l + stages, st);
        }
        if (++st == stages) {
            st = 0;
            parity ^= 1u;
        }
    }
    if (tid < ncols) {
        float* o = out + ((static_cast<int64_t>(b) * s.H + y0) * s.W + x0 + tid) * 4;
#pragma unroll
        for (int r = 0; r < R; ++r)
            if (r < nrows)
                __stcs(reinterpret_cast<float4*>(o + static_cast<int64_t>(r) * s.W * 4),
                       mgt_straight(acc[r]));
    }
}

static_assert(COMPOSITE_STAGES >= 2, "a stage is refilled a barrier before it is read");

template <int R, bool TILED>
static cudaError_t launch_composite(const float* layers, const float* shifts, float* out,
                                    MgtCompositeShape s, float pad_value, cudaStream_t stream) {
    constexpr int max_smem = COMPOSITE_STAGES * composite_stage_bytes(R, COMPOSITE_TILE_W, TILED);
    static_assert(max_smem <= 232448, "227 KB, an H100 block's shared memory");
    static bool ready[64] = {};
    const int tile_w = s.W < COMPOSITE_TILE_W ? s.W : COMPOSITE_TILE_W;
    const dim3 grid((s.W + tile_w - 1) / tile_w, (s.H + R - 1) / R, s.B);
    if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
    if (!ready[dev]) {   // once per instance and device: past the default 48 KB
        e = cudaFuncSetAttribute(composite_kernel<R, TILED>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
        if (e != cudaSuccess) return e;
        ready[dev] = true;
    }
    const int smem = COMPOSITE_STAGES * composite_stage_bytes(R, tile_w, TILED);
    const int threads = (tile_w + 31) / 32 * 32;
    composite_kernel<R, TILED><<<grid, threads, smem, stream>>>(layers, shifts, out, s, pad_value,
                                                                tile_w);
    return cudaGetLastError();
}

template <bool TILED>
static cudaError_t launch_rows(int rows, const float* layers, const float* shifts, float* out,
                               MgtCompositeShape s, float pad_value, cudaStream_t stream) {
    if (rows == 8) return launch_composite<8, TILED>(layers, shifts, out, s, pad_value, stream);
    if (rows == 4) return launch_composite<4, TILED>(layers, shifts, out, s, pad_value, stream);
    return cudaErrorInvalidValue;
}

// layers: [B, L, H, W, 4] float32; shifts: [B, L, 2] float32 (dx, dy), not
// yet clamped; out: [B, H, W, 4] float32, 16-byte aligned.  All contiguous,
// on the device.  variant: MgtCompositeVariant (tiled needs `layers`
// 16-byte aligned); rows: R of a tile, 8 or 4.  A tile has min(256, W)
// columns.  Returns a cudaError_t code.
extern "C" int mgt_translate_composite(const float* layers, const float* shifts, float* out,
                                       int B, int L, int H, int W, float pad_value, int variant,
                                       int rows, void* stream) {
    if (B <= 0 || L <= 0 || H <= 0 || W <= 0 || !mgt_aligned(out, 16))
        return cudaErrorInvalidValue;
    const MgtCompositeShape s{B, L, H, W};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (variant == COMPOSITE_TILED) {
        if (!mgt_aligned(layers, 16)) return cudaErrorInvalidValue;
        return launch_rows<true>(rows, layers, shifts, out, s, pad_value, st);
    }
    if (variant != COMPOSITE_DIRECT) return cudaErrorInvalidValue;
    return launch_rows<false>(rows, layers, shifts, out, s, pad_value, st);
}
