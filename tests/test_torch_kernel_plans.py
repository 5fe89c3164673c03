"""The geometry the port's redesigned kernels are built on, held on the CPU.

K2' (``csrc/upfirdn2d.cu``) stages, per output tile, an input footprint
that ``ops/upfirdn2d.py::_tile_plan`` describes; K1' (``csrc/bias_act.cu``)
walks its vectors in a grid-stride loop that ``ops/bias_act.py::_stream_plan``
sizes, deriving each vector's channel as ``_vector_channels`` here mirrors
it.  The kernels run only on the card; these tests hold the formulas they
share with the wrappers:

(a) the output rebuilt tile by tile, each tile by the plain version on its
    footprint alone with the tile's local pads, equals the plain version on
    the whole image (float64, so only the order of a few sums differs);
(b) the grid-stride plan covers every 16-byte vector exactly once, the
    threads' shares balanced;
(c) the bias applied vector by vector, from each thread's channel stepped
    per grid stride with one wrap, reproduces the plain version exactly
    (the same operations).

Torch only, no JAX; the whole file runs in about a second.
"""

import pytest
import torch

from montage_gan_tpu_torch.ops import bias_act as tba
from montage_gan_tpu_torch.ops import filters as tfilters
from montage_gan_tpu_torch.ops import upfirdn2d as tup

F2D = [1, 3, 3, 1]                       # setup_filter → [4, 4]
F8 = [1, 2, 3, 4, 4, 3, 2, 1]            # 1-D, 8 taps
F1D4 = 'separable [1, 3, 3, 1]'          # 1-D, 4 taps


def _filter(taps):
    if taps == F1D4:
        return tfilters.setup_filter([1, 3, 3, 1], separable=True)
    return tfilters.setup_filter(taps)


def _params(kw, f):
    fh, fw = tup._filter_size(f)
    return (tup._parse_scaling(kw.get('up', 1)),
            tup._parse_scaling(kw.get('down', 1)),
            tup._parse_padding(kw.get('padding', 0)), fh, fw)


def _rebuild(x, f, tile, **kw):
    """The output of ``upfirdn2d_ref(x, f, **kw)`` computed tile by tile
    from each tile's footprint."""
    (upx, upy), (downx, downy), pad, fh, fw = _params(kw, f)
    padx0, padx1, pady0, pady1 = pad
    n, h, w, c = x.shape
    out_h = (h * upy + pady0 + pady1 - fh) // downy + 1
    out_w = (w * upx + padx0 + padx1 - fw) // downx + 1
    plan = tup._tile_plan(h, w, out_h, out_w, (upx, upy), (downx, downy),
                          pad, fh, fw, tile, c)
    y = torch.full((n, out_h, out_w, c), float('nan'), dtype=x.dtype)
    for ty, tx in plan.tiles():
        y0, y1, x0, x1 = plan.tile_box(ty, tx)
        iy0, iy1, ix0, ix1 = plan.footprint_of(ty, tx)
        assert iy1 - iy0 <= plan.footprint[0]
        assert ix1 - ix0 <= plan.footprint[1]
        # the slice inside the image; the rest of the footprint is zeros
        a0, a1, b0, b1 = max(iy0, 0), min(iy1, h), max(ix0, 0), min(ix1, w)
        if a1 <= a0 or b1 <= b0:
            y[:, y0:y1, x0:x1] = 0
            continue
        py0 = pady0 - y0 * downy + a0 * upy
        py1 = (y1 - y0 - 1) * downy + fh - (a1 - a0) * upy - py0
        px0 = padx0 - x0 * downx + b0 * upx
        px1 = (x1 - x0 - 1) * downx + fw - (b1 - b0) * upx - px0
        y[:, y0:y1, x0:x1] = tup.upfirdn2d_ref(
            x[:, a0:a1, b0:b1], f, up=(upx, upy), down=(downx, downy),
            padding=[px0, px1, py0, py1],
            flip_filter=kw.get('flip_filter', False),
            gain=kw.get('gain', 1.0))
    return y


UP2 = dict(up=2, padding=[2, 1, 2, 1], gain=4.0)           # upsample2d
DOWN2 = dict(down=2, padding=[1, 1, 1, 1], gain=4.0,       # its gradient
             flip_filter=True)
# (name, input [h, w, c], filter, kw, variant the wrapper picks)
TILED_CASES = [
    *[(f'up2 {s}px', (s // 2, s // 2, 4), F2D, UP2, 'up2')
      for s in (256, 128, 64)],
    ('up2 37x23 (not a multiple of the tile)', (37, 23, 4), F2D, UP2, 'up2'),
    ('up2 C=3 flip', (33, 31, 3), F2D, {**UP2, 'flip_filter': True}, 'up2'),
    ('up2 1-D 4 taps', (20, 9, 5), F1D4, UP2, 'up2'),
    *[(f'down2 {s}px', (s, s, 4), F2D, DOWN2, 'down2')
      for s in (256, 128, 64)],
    ('down2 74x46 (not a multiple of the tile)', (74, 46, 4), F2D, DOWN2,
     'down2'),
    ('down2 C=5 pad 1', (17, 13, 5), F2D, dict(down=2, padding=1), 'down2'),
]
# chip_smoke.py's odd cases (phase_upfirdn2d), which go to the generic
# variant; the footprint formulas hold for them all the same.
ODD_CASES = [
    ('down 2 pad 1', (17, 13, 5), F2D, dict(down=2, padding=1), 'down2'),
    ('1-D 8 taps up 2 pad 3 gain 2', (9, 11, 3), F8,
     dict(up=2, padding=3, gain=2.0), 'generic'),
    ('1-D up [2,1] down [1,2] flip', (9, 11, 3), F8,
     dict(up=[2, 1], down=[1, 2], padding=[3, 4, -1, 2], flip_filter=True),
     'generic'),
    ('crop pad [-1,2,0,-2]', (10, 7, 6), F2D, dict(padding=[-1, 2, 0, -2]),
     'generic'),
    ('upsample2d flip', (33, 31, 3), F2D, {**UP2, 'flip_filter': True},
     'up2'),
]


@pytest.mark.parametrize('name,shape,taps,kw,variant', TILED_CASES,
                         ids=[c[0] for c in TILED_CASES])
def test_tile_plan_rebuilds_main_path(name, shape, taps, kw, variant):
    gen = torch.Generator().manual_seed(len(name))
    x = torch.randn(1, *shape, generator=gen, dtype=torch.float64)
    f = _filter(taps)
    (up, down, _, fh, fw) = _params(kw, f)
    assert tup.kernel_variant(up, down, fh, fw, shape[-1]) == variant
    got = _rebuild(x, f, tup.TILES[variant], **kw)
    torch.testing.assert_close(got, tup.upfirdn2d_ref(x, f, **kw), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize('tile', [(4, 4), (3, 5), (32, 32)])
@pytest.mark.parametrize('name,shape,taps,kw,variant', ODD_CASES,
                         ids=[c[0] for c in ODD_CASES])
def test_tile_plan_rebuilds_odd_cases(name, shape, taps, kw, variant, tile):
    gen = torch.Generator().manual_seed(len(name))
    x = torch.randn(2, *shape, generator=gen, dtype=torch.float64)
    f = _filter(taps)
    (up, down, _, fh, fw) = _params(kw, f)
    assert tup.kernel_variant(up, down, fh, fw, shape[-1]) == variant
    got = _rebuild(x, f, tile, **kw)
    torch.testing.assert_close(got, tup.upfirdn2d_ref(x, f, **kw), rtol=0,
                               atol=1e-12)


def test_tile_plan_shared_memory():
    """The main path's blocks: 5,248 bytes (up2) and 35,968 (down2), both
    under 48 KB; a footprint that no longer fits 227 KB goes generic."""
    up2 = tup._tile_plan(128, 128, 256, 256, (2, 2), (1, 1), (2, 1, 2, 1),
                         4, 4, tup.TILES['up2'], 4)
    down2 = tup._tile_plan(256, 256, 128, 128, (1, 1), (2, 2), (1, 1, 1, 1),
                           4, 4, tup.TILES['down2'], 4)
    assert (up2.footprint, up2.smem_bytes, up2.grid) == ((18, 18), 5248,
                                                         (8, 8))
    assert (down2.footprint, down2.smem_bytes, down2.grid) == ((34, 66),
                                                               35968, (4, 8))
    assert tup.kernel_variant((1, 1), (2, 2), 4, 4, 25) == 'down2'
    assert tup.kernel_variant((1, 1), (2, 2), 4, 4, 26) == 'generic'
    assert tup.kernel_variant((2, 2), (1, 1), 5, 5, 4) == 'generic'


# (n elements, C, itemsize, 16-byte aligned, bias) → variant
PLAN_CASES = [
    ((8 * 256 * 256 * 64, 64, 2, True, True), 'vector'),   # the main shape
    ((8 * 128 * 128 * 128, 128, 2, True, True), 'vector'),
    ((8 * 4608, 4608, 4, True, True), 'vector'),
    ((8 * 512, 512, 4, True, True), 'vector'),
    ((3 * 5 * 7 * 13, 13, 4, True, True), 'scalar'),        # C % 4 != 0
    ((2 * 3 * 8, 8, 4, False, True), 'scalar'),             # unaligned view
    ((2 * 9 * 11 * 6, 6, 2, True, True), 'scalar'),         # C % 8 != 0
    ((4 * 1000, 1, 2, True, False), 'vector'),
    ((1 << 20, 1, 4, True, False), 'vector'),
    (((1 << 20) + 2, 1, 4, True, False), 'scalar'),         # n % 4 != 0
    ((300_000 * 12, 12, 4, True, True), 'vector'),
    ((64 << 20, 64, 2, True, True), 'vector'),      # several grid strides
]


@pytest.mark.parametrize('args,variant', PLAN_CASES,
                         ids=[f'{a[0]}x{a[2]}B C{a[1]}' for a, _ in
                              PLAN_CASES])
def test_stream_plan_covers_every_byte_once(args, variant):
    """Thread t of the grid takes vectors t, t + stride, ...: every vector
    (16 bytes, or one element for the scalar variant) once, the threads'
    shares within one of each other, at most csrc/common.cuh's cap of
    blocks."""
    n, C, itemsize, aligned, bias = args
    plan = tba._stream_plan(n, C, itemsize, aligned, bias)
    assert plan.variant == variant
    assert plan.code == tba.VARIANT_CODES[variant]
    assert plan.moved == (2 * n + bias * C) * itemsize
    assert plan.vec * itemsize == 16 if variant == 'vector' else plan.vec == 1
    assert n % plan.vec == 0
    n_vec = n // plan.vec
    assert 1 <= plan.grid <= tba.MAX_BLOCKS
    assert plan.grid == tba.MAX_BLOCKS or plan.stride >= n_vec
    assert plan.stride - tba.THREADS < n_vec or plan.grid == 1
    owner = torch.arange(n_vec) % plan.stride
    share = torch.bincount(owner, minlength=min(plan.stride, n_vec))
    assert int(share.sum()) == n_vec
    assert int(share.max()) - int(share.min()) <= 1


def _vector_channels(n_vec, C, vec, stride):
    """The channel of each vector's first element as csrc/bias_act.cu's
    kernel derives it: thread ``t`` starts at ``(t * vec) % C`` in 64-bit,
    then adds ``(stride * vec) % C`` per grid stride with one wrap."""
    step = stride * vec % C
    c = torch.arange(stride) * vec % C
    first = torch.empty(n_vec, dtype=torch.long)
    for j in range(0, n_vec, stride):
        take = min(stride, n_vec - j)
        first[j:j + take] = c[:take]
        c = c + step
        c = torch.where(c >= C, c - C, c)
    return first


# (shape, dtype, act, clamp, threads in the grid); the grids are small, so
# that every thread steps its channel several times
BIAS_CASES = [
    ((8, 16, 16, 64), torch.float32, 'lrelu', 256.0, 768),
    ((8, 4608), torch.float32, 'lrelu', None, 256),      # C above a stride
    ((3, 40, 96), torch.float32, 'tanh', 0.5, 500),      # C wraps mid-stride
    ((300, 12, 12), torch.float32, 'linear', None, 1024),  # step 4096 % 12
    ((7, 9, 9, 24), torch.bfloat16, 'swish', 1.0, 256),  # step 2048 % 24 = 8
    ((2, 64, 64, 128), torch.bfloat16, 'lrelu', 256.0, 2560),
]


@pytest.mark.parametrize('shape,dtype,act,clamp,stride', BIAS_CASES,
                         ids=[f'{list(c[0])} {c[1]} {c[2]}'
                              for c in BIAS_CASES])
def test_vector_channels_reproduce_bias_act(shape, dtype, act, clamp,
                                            stride):
    """The bias added vector by vector from each thread's stepped channel
    reproduces the plain version exactly."""
    gen = torch.Generator().manual_seed(sum(shape))
    C = shape[-1]
    x = (torch.randn(*shape, generator=gen) * 2).to(dtype)
    b = torch.randn(C, generator=gen).to(dtype)
    vec = 16 // x.element_size()
    n_vec = x.numel() // vec
    assert n_vec > 2 * stride
    ch = (_vector_channels(n_vec, C, vec, stride)[:, None]
          + torch.arange(vec)).reshape(-1)
    out = tba.bias_act_ref(x.reshape(-1) + b[ch], None, act=act, clamp=clamp)
    ref = tba.bias_act_ref(x, b, act=act, clamp=clamp)
    assert torch.equal(out.reshape(shape), ref)


# (vectors, C, elements a vector, threads in the grid)
VECTOR_CASES = [
    (4096, 64, 8, 1024),            # bf16, a stride of whole rows
    (3000, 24, 8, 640),             # bf16, the stride wraps mid-row
    (2500, 4608, 4, 768),           # f32, C above a stride
    (700, 13, 1, 96),               # scalar, C not a multiple of 4
    (999, 12, 4, 100),              # f32, step 400 % 12 = 4
]


@pytest.mark.parametrize('n_vec,C,vec,stride', VECTOR_CASES,
                         ids=[f'C{c[1]} vec{c[2]} stride{c[3]}'
                              for c in VECTOR_CASES])
def test_vector_channels_step_with_one_wrap(n_vec, C, vec, stride):
    got = _vector_channels(n_vec, C, vec, stride)
    assert torch.equal(got, torch.arange(n_vec) * vec % C)


# ---------------------------------------------------------------------------
# The current device: every wrapper launches on it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('device,current,ok', [
    ('cuda:0', 0, True), ('cuda:1', 1, True), ('cuda:1', 0, False),
    ('cuda:0', 3, False), ('cpu', 0, False)])
def test_launch_needs_the_tensors_card_current(device, current, ok):
    """``ops/cuda.py::check_current``, which each wrapper's
    ``launch_device`` applies before a launch: a tensor's card must be the
    current device (a rank of a data-parallel run makes its card current);
    another card raises instead of launching there."""
    from montage_gan_tpu_torch.ops.cuda import check_current
    dev = torch.device(device)
    if ok:
        assert check_current(dev, current) == dev.index
    else:
        with pytest.raises(RuntimeError, match='current device'):
            check_current(dev, current)


def test_every_wrapper_launches_through_the_device_check():
    """Each kernel wrapper module passes its launch's device through
    ``launch_device`` and reads no device index around it."""
    import inspect
    from montage_gan_tpu_torch.ops import (affine_warp, bias_act, composite,
                                           upfirdn2d)
    for mod, n in ((bias_act, 2), (upfirdn2d, 1), (affine_warp, 1),
                   (composite, 1)):
        src = inspect.getsource(mod)
        assert src.count('stream_handle(launch_device(') == n, mod.__name__
        assert 'stream_handle(' not in src.replace(
            'stream_handle(launch_device(', '').replace(
            'import (CudaKernel, launch_device, stream_handle,', ''), \
            mod.__name__
