"""The tiles, tap tables and staged windows of K5' (``csrc/composite.cu``),
held on the CPU through their Python twin in
``montage_gan_tpu_torch.ops.composite``.

Over a sweep of shifts (0, ±1, beyond ±1 and clamped, random ones, and every
shift where t·n/2 lies on an integer or one float32 ulp either side of it,
where ``floor`` jumps), extents that are not multiples of the tile, n = 1 and
one layer:

(a) the tables' taps and lerp weights are the plain version's, bit for bit
    (``affine_grid`` of the translation, then ``grid_sample``'s
    unnormalisation);
(b) every window holds every in-image tap of its tile, only image pixels,
    and fits the stage: at most R + 2 rows and min(tile_w + 2, W) columns;
(c) the output rebuilt tile by tile from the staged windows alone, by the
    kernel's two paths (the regular one and the per-row one), equals the
    emulated kernel (``emulated_composite``, also used by
    ``test_torch_grads`` and ``test_torch_composite``) bit for bit.

Both tile heights run: 8 rows, and 4 on a launch of fewer 8-row tiles than
the card's SMs (an H100's 132 here).  Torch and numpy only, no JAX.
"""

import numpy as np
import pytest
import torch

from montage_gan_tpu_torch.ops import composite as tcomp
from montage_gan_tpu_torch.ops.grid_sample import (affine_grid,
                                                   translate_sample,
                                                   translate_to_theta)

F32 = np.float32
H100_SMS = 132
# the tile heights: the plan's default (8 rows) and 4 rows, by the SMs
# that make a launch take them
PLANS = {'default': 1, '4 rows': 10 ** 6}
EXTENTS = (1, 2, 5, 19, 45, 67, 256, 257, 513, 1000)


def emulated_composite(layers, translations, pad_value=0.0):
    """What K5' computes: the plain version's taps and lerp weights, then
    the A-over-B recurrence in layer order on a premultiplied canvas (P <-
    c·la + P·(1 - la), A <- la + A·(1 - la)), each step rounded, divided
    once at the end with 0/0 -> 0; counted under the variant the wrapper's
    plan picks on an H100."""
    b, l, h, w, c = layers.shape
    plan = tcomp.composite_plan(b, h, w, H100_SMS,
                                layers.data_ptr() % 16 == 0)
    tcomp.kernel.count(plan.variant, sum(
        t.numel() * t.element_size() for t in (layers, translations))
        + b * h * w * c * layers.element_size())
    moved = translate_sample(
        layers.reshape(b * l, h, w, c),
        translations.clamp(-1, 1).reshape(b * l, 2),
        pad_value=pad_value).reshape(b, l, h, w, c)
    canvas = torch.zeros(b, h, w, c, dtype=layers.dtype)
    for i in range(l):
        la = moved[:, i, ..., 3:]
        keep = 1.0 - la
        canvas = torch.cat([moved[:, i, ..., :3] * la + canvas[..., :3] * keep,
                            la + canvas[..., 3:] * keep], -1)
    alpha = canvas[..., 3:]
    color = canvas[..., :3] / torch.where(alpha == 0, torch.ones_like(alpha),
                                          alpha)
    return torch.cat([torch.where(alpha == 0, 0.0, color), alpha], -1)


def _shifts(n, seed=0):
    """The sweep of one axis: float32 shifts, unclamped."""
    rng = np.random.RandomState(seed + n)
    half = max(n // 2, 1)
    k = np.arange(-half, half + 1, dtype=np.float64)
    if k.size > 301:                          # n = 1000: every 7th integer
        k = k[::7]
    on = (k / (n / 2)).astype(F32)
    near = np.concatenate([on, np.nextafter(on, F32(2)),
                           np.nextafter(on, F32(-2))])
    fixed = np.array([0, 1, -1, 1.7, -2.3, 0.5, -0.31, 0.77], F32)
    return np.concatenate([near, fixed,
                           rng.uniform(-1.2, 1.2, 40).astype(F32)])


def _plain_taps(n, shifts, axis):
    """(i0, f) [S, n] of the plain version along an axis (0: x, 1: y) of
    extent n: ``affine_grid`` of each translation, then grid_sample's ``(g
    + 1) · (n / 2) − 0.5``, floor and fraction."""
    zero = np.zeros_like(shifts)
    t = torch.from_numpy(np.stack([shifts, zero] if axis == 0
                                  else [zero, shifts], -1))
    theta = translate_to_theta(t)
    grid = (affine_grid(theta, 1, n)[:, 0, :, 0] if axis == 0
            else affine_grid(theta, n, 1)[:, :, 0, 1])          # [S, n]
    ix = (grid + 1.0) * (n * 0.5) - 0.5
    i0 = torch.floor(ix)
    return i0.long().numpy(), (ix - i0).numpy()


def test_plan_variants_and_shared_memory():
    main = tcomp.composite_plan(8, 256, 256, H100_SMS)
    assert (main.variant, main.rows, main.tile_w) == ('tiled', 8, 256)
    assert main.grid == (1, 32, 8) and main.threads == 256
    # two stages in an H100 block's 227 KB, two blocks to an SM
    assert main.smem_bytes == 2 * tcomp.stage_bytes(8, 256, True) == 86848
    assert tcomp.capacity(8, 256) == 10 * 258
    q = tcomp.composite_plan(2, 64, 1000, 1)
    assert q.grid == (4, 8, 2) and q.tile_box(7, 3) == (56, 64, 768, 1000)
    # fewer 8-row tiles than SMs: 4-row tiles
    for b, h, w in ((2, 64, 1000), (3, 67, 45), (1, 8, 8), (16, 64, 64),
                    (4, 256, 256)):
        p = tcomp.composite_plan(b, h, w, H100_SMS)
        assert (p.variant, p.rows) == ('tiled', 4)
        assert p.smem_bytes == 2 * tcomp.stage_bytes(4, min(w, 256), True)
    assert tcomp.composite_plan(17, 64, 64, H100_SMS).rows == 8
    assert tcomp.composite_plan(5, 256, 256, H100_SMS).rows == 8
    assert tcomp.composite_plan(5, 256, 256, 161).rows == 4
    # off 16-byte alignment: direct, the ring holding the tables only
    d = tcomp.composite_plan(3, 67, 45, H100_SMS, aligned=False)
    assert d.variant == 'direct' and d.tile_w == 45 and d.threads == 64
    assert d.smem_bytes == 2 * tcomp.stage_bytes(4, 45, False)
    with pytest.raises(ValueError):
        tcomp.composite_plan(70000, 8, 8, H100_SMS)
    # the kernel clamps with fminf(fmaxf(t, -1), 1): NaN gives -1
    np.testing.assert_array_equal(
        tcomp.clamp_shift([np.nan, 2.5, -7.0, 0.25]),
        np.array([-1, 1, -1, 0.25], F32))


@pytest.mark.parametrize('axis', [0, 1])
@pytest.mark.parametrize('n', EXTENTS)
def test_tables_are_the_plain_taps_bit_for_bit(n, axis):
    shifts = tcomp.clamp_shift(_shifts(n))
    i0, f = _plain_taps(n, shifts, axis)
    for s, (pi, pf) in enumerate(zip(i0, f)):
        ti, tf = tcomp.axis_taps(n, shifts[s])
        np.testing.assert_array_equal(ti, pi)
        assert tf.dtype == F32
        np.testing.assert_array_equal(tf.view(np.int32), pf.view(np.int32))


def _axis_windows(n, tile, shift):
    """Per tile along an axis: (first, count) of its window, as
    csrc/composite.cu::mgt_window takes it from the tile's ends, and the
    tile's taps."""
    i0, _ = tcomp.axis_taps(n, shift)
    out = []
    for start in range(0, n, tile):
        t = i0[start:start + tile]
        lo, hi = max(int(t[0]), 0), min(int(t[-1]) + 1, n - 1)
        out.append((lo, hi - lo + 1, t))
    return out


@pytest.mark.parametrize('plan', list(PLANS))
@pytest.mark.parametrize('n', EXTENTS)
def test_windows_hold_every_tap_and_fit_the_stage(n, plan):
    rows = tcomp.composite_plan(1, n, n, PLANS[plan]).rows
    tile_w = min(tcomp.TILE_W, n)
    worst = 0
    for shift in tcomp.clamp_shift(_shifts(n, seed=1)):
        for axis, tile, limit in (('rows', rows, rows + 2),
                                  ('cols', tile_w, min(tile_w + 2, n))):
            for lo, count, taps in _axis_windows(n, tile, shift):
                inside = np.concatenate([taps, taps + 1])
                inside = inside[(inside >= 0) & (inside < n)]
                if inside.size == 0:
                    assert count <= 0, (axis, shift)
                    continue
                assert 0 <= lo and lo + count <= n
                assert inside.min() >= lo and inside.max() < lo + count
                assert count <= limit, (axis, n, shift, count)
                worst = max(worst, count - tile)
    assert worst <= 2


@pytest.mark.parametrize('plan', list(PLANS))
def test_tile_window_is_the_twin_of_the_axis_windows(plan):
    h, w = 67, 300
    p = tcomp.composite_plan(1, h, w, PLANS[plan])
    rng = np.random.RandomState(3)
    shifts = list(zip(_shifts(w, seed=5)[::9], _shifts(h, seed=6)[::9]))
    shifts += [(rng.uniform(-1.2, 1.2), rng.uniform(-1.2, 1.2))
               for _ in range(5)]
    for sx, sy in shifts:
        sx, sy = tcomp.clamp_shift([sx, sy])
        rows_w = _axis_windows(h, p.rows, sy)
        cols_w = _axis_windows(w, p.tile_w, sx)
        for ty, tx in p.tiles():
            win = tcomp.tile_window(p, (sx, sy), ty, tx)
            (r0, nr, rt), (c0, nc, _) = rows_w[ty], cols_w[tx]
            if nr <= 0 or nc <= 0:
                assert (win.rows, win.cols) == (0, 0)
            else:
                assert (win.y0, win.rows, win.x0, win.cols) == (r0, nr, c0,
                                                               nc)
            assert win.fits
            assert win.base == rt[0]
            assert win.regular == bool(
                (rt == rt[0] + np.arange(rt.size)).all())


def _tiled_rebuild(layers, shifts, pad, plan):
    """The kernel's algorithm on the CPU: per tile and layer, the window
    alone (surrounded by NaN, so a tap outside it would show), the tables,
    then the regular path (each source row once) or the per-row one, over a
    premultiplied canvas; float32, each step rounded as the kernel rounds
    it."""
    b, l, h, w, _ = layers.shape
    out = torch.empty(b, h, w, 4)
    padv = torch.full((4,), pad)
    ys = tcomp.clamp_shift(shifts.numpy().reshape(b, l, 2))

    def lerp(a, c, t):
        return a + (c - a) * t

    for bi in range(b):
        for ty, tx in plan.tiles():
            y0, y1, x0, x1 = plan.tile_box(ty, tx)
            acc = torch.zeros(y1 - y0, x1 - x0, 4)
            for li in range(l):
                sx, sy = ys[bi, li]
                win = tcomp.tile_window(plan, (sx, sy), ty, tx)
                assert win.fits
                stage = torch.full((h + 4, w + 4, 4), float('nan'))
                stage[win.y0 + 2:win.y0 + 2 + win.rows,
                      win.x0 + 2:win.x0 + 2 + win.cols] = layers[
                    bi, li, win.y0:win.y0 + win.rows,
                    win.x0:win.x0 + win.cols]
                cx, fx = tcomp.axis_taps(w, sx, np.arange(x0, x1))
                cy, fy = tcomp.axis_taps(h, sy, np.arange(y0, y1))
                cx = torch.from_numpy(cx)
                fx = torch.from_numpy(fx)[:, None]

                def hrow(yy):
                    if not 0 <= yy < h:
                        return lerp(padv.expand(x1 - x0, 4),
                                    padv.expand(x1 - x0, 4), fx)
                    taps = []
                    for c in (cx, cx + 1):
                        ok = ((c >= 0) & (c < w))[:, None]
                        v = stage[yy + 2, (c + 2).clamp(0, w + 3)]
                        taps.append(torch.where(ok, v, padv))
                    return lerp(taps[0], taps[1], fx)

                if win.regular:
                    hs = [hrow(win.base + j) for j in range(y1 - y0 + 1)]
                    rows = [(hs[r], hs[r + 1]) for r in range(y1 - y0)]
                else:
                    rows, seen, top, bot = [], None, None, None
                    for r in range(y1 - y0):
                        if cy[r] != seen:
                            top = bot if seen is not None and \
                                cy[r] == seen + 1 else hrow(int(cy[r]))
                            bot = hrow(int(cy[r]) + 1)
                            seen = cy[r]
                        rows.append((top, bot))
                for r, (top, bot) in enumerate(rows):
                    c = lerp(top, bot, float(fy[r]))
                    la = c[:, 3:]
                    keep = 1.0 - la
                    acc[r] = torch.cat([c[:, :3] * la + acc[r, :, :3] * keep,
                                        la + acc[r, :, 3:] * keep], -1)
            alpha = acc[..., 3:]
            color = acc[..., :3] / torch.where(alpha == 0,
                                               torch.ones_like(alpha), alpha)
            out[bi, y0:y1, x0:x1] = torch.cat(
                [torch.where(alpha == 0, 0.0, color), alpha], -1)
    return out


CASES = {
    'odd 2x3x19x13, near-integer shifts': ((2, 3, 19, 13), 'near', 0.0),
    'one pixel, one layer': ((2, 1, 1, 1), 'fixed', 0.3),
    '2 column tiles': ((1, 2, 9, 300), 'random', 0.0),
    'exact shifts, pad 0.3': ((1, 4, 16, 16), 'fixed', 0.3),
}


@pytest.mark.parametrize('plan', list(PLANS))
@pytest.mark.parametrize('case', list(CASES))
def test_rebuild_from_windows_matches_the_emulated_kernel(case, plan):
    (b, l, h, w), kind, pad = CASES[case]
    rng = np.random.RandomState(11)
    layers = rng.rand(b, l, h, w, 4).astype(F32)
    if l > 2:
        layers[:, 1, ..., 3] = 0.0
    if kind == 'near':              # on integers and one ulp off them
        kx = rng.randint(-w // 2, w // 2 + 1, (b, l)) / (w / 2)
        ky = rng.randint(-h // 2, h // 2 + 1, (b, l)) / (h / 2)
        shifts = np.stack([kx, ky], -1).astype(F32)
        shifts[:, ::2, 0] = np.nextafter(shifts[:, ::2, 0], F32(2))
        shifts[:, 1::2, 1] = np.nextafter(shifts[:, 1::2, 1], F32(-2))
    elif kind == 'fixed':
        shifts = np.resize(np.array([1, -1, -1.7, 1, 0, 0, 0.5, -2.3], F32),
                           (b, l, 2))
    else:
        shifts = rng.uniform(-1.2, 1.2, (b, l, 2)).astype(F32)
    lt, st = torch.from_numpy(layers), torch.from_numpy(shifts)
    plan_ = tcomp.composite_plan(b, h, w, PLANS[plan])
    got = _tiled_rebuild(lt, st, pad, plan_)
    ref = emulated_composite(lt, st, pad)
    assert torch.equal(got, ref)
    if kind == 'near' and plan == 'default':    # both paths ran
        regular = {tcomp.tile_window(plan_, s, ty, tx).regular
                   for s in tcomp.clamp_shift(shifts.reshape(-1, 2))
                   for ty, tx in plan_.tiles()}
        assert regular == {True, False}


def test_needed_bytes_counts_the_pixels_some_tap_reads():
    b, l, h, w = 2, 3, 11, 7
    rng = np.random.RandomState(2)
    shifts = rng.uniform(-1.5, 1.5, (b, l, 2)).astype(F32)
    shifts[0, 0] = 0.0
    total = 0
    for sx, sy in tcomp.clamp_shift(shifts.reshape(-1, 2)):
        cx, _ = tcomp.axis_taps(w, sx)
        cy, _ = tcomp.axis_taps(h, sy)
        xs = {c for c in np.concatenate([cx, cx + 1]) if 0 <= c < w}
        ys = {c for c in np.concatenate([cy, cy + 1]) if 0 <= c < h}
        total += len(xs) * len(ys) * 16
    out = b * h * w * 16
    assert tcomp.needed_bytes((b, l, h, w, 4), shifts) == \
        total + b * l * 8 + out
    assert tcomp.needed_bytes((b, l, h, w, 4), np.zeros((b, l, 2))) == \
        b * l * h * w * 16 + b * l * 8 + out
