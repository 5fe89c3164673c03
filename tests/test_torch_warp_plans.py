"""The geometry of the tiled warp kernels K3' and K4' (``csrc/warp.cu``), held
on the CPU through its Python twin in ``montage_gan_tpu_torch.ops.affine_warp``.

K3' stages, per output tile, a stored and a virtual (×2) region
(``forward_tile``); K4' gathers, per dx tile, over a candidate box of outputs
and, per virtual sample, over candidate rows and columns (``transpose_tile``,
``gather_rows``, ``gather_cols``; the direct path's ``candidate_rows``,
``candidate_cols``).  On micro planes ([2, 20, 18, 4] → [2, 26, 24, 4]) and
thetas drawn by ``sample_warp_theta`` at p = 1, the identity, ``off_plane``
(×1.3, shifted), a 45° rotation and zooms 0.5 and 2:

(a) every stored sample that any output of a tile reads, and every virtual
    tap on the plane, lies in the tile's planned footprint (checked output
    by output with the numpy mirror of ``mgt_axis_weights``);
(b) the forward rebuilt tile by tile from each footprint alone
    (``upsample2d_ref`` on it, then bilinear; the direct tiles by the
    window formula) equals ``affine_warp_ref``, in float64;
(c) every output whose window touches a dx tile lies in the tile's
    candidate box, and every output with a tap on a virtual sample among
    that sample's gather candidates;
(d) dx rebuilt tile by tile by the gather (and by the direct path), in
    float64, equals the autograd of ``affine_warp_ref``.

Coordinates are float32, rounded as the kernels round them; sums are
float64, so the rebuilt tensors agree with the plain version to 1e-12.
Torch and numpy only, no JAX.
"""

import math

import numpy as np
import pytest
import torch

from montage_gan_tpu_torch.ops import affine_warp as taw
from montage_gan_tpu_torch.ops import upfirdn2d as tup
from montage_gan_tpu_torch.training import augment as taug
from montage_gan_tpu_torch.training.draws import Draws

F = taug._HZ_GEOM.numpy().astype(np.float32)          # 12-tap sym6
TAPS = len(F)
UP = 2
K0 = TAPS - 1 - (TAPS + UP - 1) // 2
N, H, W = 2, 20, 18
OUT = (26, 24)
VIRT = (UP * H, UP * W)
KINDS = ['sampled-0', 'sampled-1', 'sampled-2', 'identity', 'off_plane',
         'rot45', 'zoom0.5', 'zoom2']
# K3' plans: the wrapper's tile and budget, small tiles, and a budget so
# small that some tiles take the direct path
FORWARD_PLANS = {'main': dict(), 'tile 8x8': dict(tile=(8, 8)),
                 'budget 200': dict(tile=(8, 8),
                                    forward_smem=taw.HEADER_BYTES + 16 * 200)}
TRANSPOSE_PLANS = {'main': dict(), 'tile 5x7': dict(tile=(5, 7))}


def _theta(kind):
    """[N, 2, 3] float32 theta of a case."""
    if kind.startswith('sampled'):
        gen = torch.Generator().manual_seed(int(kind.split('-')[1]))
        theta, *_ = taug.sample_warp_theta(
            Draws(gen), 1.0, taug.make_augment_config('bgcfnc'), N, 16, 16,
            device='cpu')
        return theta.numpy().astype(np.float32)
    t = np.tile(np.eye(2, 3, dtype=np.float32), (N, 1, 1))
    if kind == 'off_plane':
        t = t * np.float32(1.3)
        t[:, :, 2] = [0.7, -0.6]
    elif kind == 'rot45':
        c = math.cos(math.pi / 4)
        t[:] = [[c, -c, 0.1], [c, c, -0.05]]
    elif kind.startswith('zoom'):
        t = t * np.float32(float(kind[4:]))
        t[:, :, 2] = [0.3, -0.2]
    return t.astype(np.float32)


def _inputs(kind):
    rng = np.random.RandomState(len(kind))
    x = rng.uniform(-1, 1, (N, H, W, 4))
    g = rng.randn(N, *OUT, 4)
    return x, g


def _coords(theta_n):
    """float32 (sx, sy) [out_h, out_w] of every output (mgt_source)."""
    i, j = np.meshgrid(np.arange(OUT[0]), np.arange(OUT[1]), indexing='ij')
    return taw.source_coords(theta_n, i, j, OUT, VIRT)


def _axis_weights(s, length):
    """numpy mirror of csrc/warp.cu::mgt_axis_weights for one coordinate:
    {stored index l: weight}."""
    m0 = int(np.floor(s))
    t = float(np.float32(s) - np.float32(m0))
    lo = max(-((-(m0 + K0 - TAPS + 1)) // UP), 0)      # ceil division
    hi = min((m0 + 1 + K0) // UP, length - 1)          # floor division
    out = {}
    for l in range(lo, hi + 1):
        acc = 0.0
        for e, bw in ((0, 1.0 - t), (1, t)):
            m = m0 + e
            j = m - UP * l + K0
            if 0 <= m < UP * length and 0 <= j < TAPS:
                acc += bw * UP * float(F[j])
        out[l] = acc
    assert len(out) <= taw.MAX_STORED
    return out


def _nonzero(weights):
    return [l for l, w in weights.items() if w != 0.0]


def _plan(kind, channels=4, **kw):
    return taw.warp_plan(kind, N, (H, W), OUT, channels, TAPS, UP, True,
                         **kw)


def _filter_matrix(v0, v1, l0, l1):
    """[v1 - v0, l1 - l0]: the upsample's taps up·f[m - up·l + k0] from
    stored samples [l0, l1) to virtual [v0, v1)."""
    m = np.arange(v0, v1)[:, None]
    j = m - UP * np.arange(l0, l1)[None, :] + K0
    ok = (j >= 0) & (j < TAPS)
    return np.where(ok, UP * F.astype(np.float64)[np.clip(j, 0, TAPS - 1)],
                    0.0)


def _bilinear_taps(s):
    """float32 s → (m0, w0 = 1 - t, w1 = t) with t = s - floor(s) rounded
    in float32, then float64 weights (the plain version's)."""
    f = np.floor(s)
    t = (s - f).astype(np.float32).astype(np.float64)
    return f.astype(np.int64), 1.0 - t, t


# ---------------------------------------------------------------------------
# K3'
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('plan_name', list(FORWARD_PLANS))
@pytest.mark.parametrize('kind', KINDS)
def test_forward_footprint_holds_every_read(kind, plan_name):
    """(a) Output by output: its in-plane virtual taps lie in the tile's
    virtual region and its stored samples of non-zero weight in the stored
    region; an 'empty' tile's outputs read nothing."""
    theta = _theta(kind)
    plan = _plan('forward', **FORWARD_PLANS[plan_name])
    modes = set()
    for n in range(N):
        sx, sy = _coords(theta[n])
        for ty, tx in plan.tiles():
            tile = taw.forward_tile(plan, theta[n], ty, tx)
            modes.add(tile.mode)
            if tile.mode == 'direct':
                continue
            y0, y1, x0, x1 = plan.tile_box(ty, tx)
            for i in range(y0, y1):
                for j in range(x0, x1):
                    wy = _nonzero(_axis_weights(sy[i, j], H))
                    wx = _nonzero(_axis_weights(sx[i, j], W))
                    if tile.mode == 'empty':
                        assert not (wy and wx), (ty, tx, i, j)
                        continue
                    if not (wy and wx):
                        continue
                    vy0, vy1, vx0, vx1 = tile.virtual
                    ly0, ly1, lx0, lx1 = tile.stored
                    for m in (int(np.floor(sy[i, j])) + e for e in (0, 1)):
                        assert not 0 <= m < VIRT[0] or vy0 <= m < vy1
                    for m in (int(np.floor(sx[i, j])) + e for e in (0, 1)):
                        assert not 0 <= m < VIRT[1] or vx0 <= m < vx1
                    assert ly0 <= min(wy) and max(wy) < ly1
                    assert lx0 <= min(wx) and max(wx) < lx1
    if plan_name == 'budget 200' and kind != 'zoom0.5':
        assert 'direct' in modes          # (b) rebuilds those by the window


def _forward_rebuilt(x, theta, plan):
    """The forward, tile by tile, from each tile's footprint alone."""
    out = np.full((N, *OUT, 4), np.nan)
    for n in range(N):
        sx, sy = _coords(theta[n])
        for ty, tx in plan.tiles():
            tile = taw.forward_tile(plan, theta[n], ty, tx)
            y0, y1, x0, x1 = plan.tile_box(ty, tx)
            ts = (slice(y0, y1), slice(x0, x1))
            if tile.mode == 'empty':
                out[n][ts] = 0.0
            elif tile.mode == 'direct':            # the <= 7x7 window
                for i in range(y0, y1):
                    for j in range(x0, x1):
                        wy, wx = _axis_weights(sy[i, j], H), \
                            _axis_weights(sx[i, j], W)
                        out[n, i, j] = sum(a * b * x[n, ly, lx]
                                           for ly, a in wy.items()
                                           for lx, b in wx.items())
            else:
                vy0, vy1, vx0, vx1 = tile.virtual
                ly0, ly1, lx0, lx1 = tile.stored
                # upsample2d_ref on the stored footprint, with the local
                # pads that give exactly the virtual region
                pady0 = UP * ly0 - vy0 + (TAPS + UP - 1) // 2
                padx0 = UP * lx0 - vx0 + (TAPS + UP - 1) // 2
                pady1 = vy1 - vy0 - 1 + TAPS - UP * (ly1 - ly0) - pady0
                padx1 = vx1 - vx0 - 1 + TAPS - UP * (lx1 - lx0) - padx0
                v = tup.upfirdn2d_ref(
                    torch.from_numpy(x[n:n + 1, ly0:ly1, lx0:lx1]),
                    torch.from_numpy(F), up=UP,
                    padding=[padx0, padx1, pady0, pady1],
                    gain=UP * UP)[0].numpy()
                assert v.shape[:2] == (vy1 - vy0, vx1 - vx0)
                my, wy0, wy1 = _bilinear_taps(sy[ts])
                mx, wx0, wx1 = _bilinear_taps(sx[ts])
                acc = 0.0
                for dy, wy in ((0, wy0), (1, wy1)):
                    for dxx, wx in ((0, wx0), (1, wx1)):
                        r, c = my + dy - vy0, mx + dxx - vx0
                        inside = (r >= 0) & (r < v.shape[0]) & (c >= 0) \
                            & (c < v.shape[1])
                        vals = v[np.clip(r, 0, v.shape[0] - 1),
                                 np.clip(c, 0, v.shape[1] - 1)]
                        acc = acc + np.where(inside[..., None],
                                             (wy * wx)[..., None] * vals, 0.0)
                out[n][ts] = acc
    return out


@pytest.mark.parametrize('plan_name', list(FORWARD_PLANS))
@pytest.mark.parametrize('kind', KINDS)
def test_forward_rebuilt_from_footprints(kind, plan_name):
    """(b) Each tile from its own footprint: the plain version, float64."""
    theta = _theta(kind)
    x, _ = _inputs(kind)
    got = _forward_rebuilt(x, theta, _plan('forward', **FORWARD_PLANS[plan_name]))
    ref = taw.affine_warp_ref(torch.from_numpy(x), torch.from_numpy(theta),
                              *OUT, UP, F).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# K4'
# ---------------------------------------------------------------------------

def _windows(theta_n):
    """Per output: (stored rows, stored columns) of non-zero weight."""
    sx, sy = _coords(theta_n)
    return [[(_nonzero(_axis_weights(sy[i, j], H)),
              _nonzero(_axis_weights(sx[i, j], W)))
             for j in range(OUT[1])] for i in range(OUT[0])]


@pytest.mark.parametrize('plan_name', list(TRANSPOSE_PLANS))
@pytest.mark.parametrize('kind', KINDS)
def test_transpose_candidates_hold_every_output(kind, plan_name):
    """(c) Every output whose window touches a dx tile lies in the tile's
    candidate box (an 'empty' tile has none), and every output with a tap
    on a virtual sample of the tile's region is among that sample's
    gather candidates."""
    theta = _theta(kind)
    plan = _plan('transpose', **TRANSPOSE_PLANS[plan_name])
    for n in range(N):
        windows = _windows(theta[n])
        sx, sy = _coords(theta[n])
        for ty, tx in plan.tiles():
            tile = taw.transpose_tile(plan, theta[n], ty, tx)
            assert tile.mode in ('tiled', 'empty')
            y0, y1, x0, x1 = plan.tile_box(ty, tx)
            for i in range(OUT[0]):
                for j in range(OUT[1]):
                    rows, cols = windows[i][j]
                    touches = any(y0 <= l < y1 for l in rows) and \
                        any(x0 <= l < x1 for l in cols)
                    if not touches:
                        continue
                    assert tile.mode == 'tiled', (ty, tx, i, j)
                    b = tile.box
                    assert b[0] <= i < b[1] and b[2] <= j < b[3], (i, j, b)
            if tile.mode != 'tiled':
                continue
            # each output's in-plane taps that fall in the region
            vy0, vy1, vx0, vx1 = tile.virtual
            gi0, gi1, gj0, gj1 = tile.box
            i, j = np.meshgrid(np.arange(OUT[0]), np.arange(OUT[1]),
                               indexing='ij')
            for ey in (0, 1):
                for ex in (0, 1):
                    my = np.floor(sy).astype(np.int64) + ey
                    mx = np.floor(sx).astype(np.int64) + ex
                    hit = (my >= vy0) & (my < vy1) & (mx >= vx0) & (mx < vx1)
                    ii, jj = i[hit], j[hit]
                    dy, dx = my[hit] - vy0, mx[hit] - vx0
                    r0, r1 = taw.gather_rows(tile.gather, dx, dy, gi1 - gi0)
                    assert ((ii - gi0 >= r0) & (ii - gi0 <= r1)).all()
                    c0, c1 = taw.gather_cols(tile.gather, dx, dy, ii - gi0,
                                             gj1 - gj0)
                    assert ((jj - gj0 >= c0) & (jj - gj0 <= c1)).all()


def _weight_at(s, l, length):
    """numpy mirror of csrc/warp.cu::mgt_axis_weight_at (arrays)."""
    m0 = np.floor(s).astype(np.int64)
    t = (s - np.floor(s)).astype(np.float32).astype(np.float64)
    acc = np.zeros(s.shape)
    for e, bw in ((0, 1.0 - t), (1, t)):
        m = m0 + e
        j = m - UP * l + K0
        ok = (m >= 0) & (m < UP * length) & (j >= 0) & (j < TAPS)
        acc = acc + np.where(ok, bw * UP * F.astype(np.float64)[
            np.clip(j, 0, TAPS - 1)], 0.0)
    return acc


def _dx_tiled(tile, g_n, sx, sy, y0, y1, x0, x1):
    """dx of a tiled block: the gather over each virtual sample's
    candidates, then the transposed filter."""
    vy0, vy1, vx0, vx1 = tile.virtual
    gi0, gi1, gj0, gj1 = tile.box
    dy, dx = np.meshgrid(np.arange(vy1 - vy0), np.arange(vx1 - vx0),
                         indexing='ij')
    fmy, fmx = (vy0 + dy).astype(np.float32), (vx0 + dx).astype(np.float32)
    dv = np.zeros((*dy.shape, 4))
    r0, r1 = taw.gather_rows(tile.gather, dx, dy, gi1 - gi0)
    for k in range(int((r1 - r0).max(initial=-1)) + 1):
        di = r0 + k
        c0, c1 = taw.gather_cols(tile.gather, dx, dy, di, gj1 - gj0)
        for q in range(int((c1 - c0).max(initial=-1)) + 1):
            dj = c0 + q
            ii = np.clip(gi0 + di, 0, OUT[0] - 1)
            jj = np.clip(gj0 + dj, 0, OUT[1] - 1)
            py, px = sy[ii, jj], sx[ii, jj]
            on = (di <= r1) & (dj <= c1) & (py >= fmy - 1) & (py < fmy + 1) \
                & (px >= fmx - 1) & (px < fmx + 1)
            # K3''s t = s - floor(s), rounded in float32
            ty = np.where(py >= fmy, py - fmy, py - (fmy - 1))
            tx = np.where(px >= fmx, px - fmx, px - (fmx - 1))
            ty, tx = (t.astype(np.float32).astype(np.float64) for t in (ty, tx))
            wy = np.where(py >= fmy, 1.0 - ty, ty)
            wx = np.where(px >= fmx, 1.0 - tx, tx)
            dv += np.where(on[..., None], (wy * wx)[..., None] * g_n[ii, jj],
                           0.0)
    uy = _filter_matrix(vy0, vy1, y0, y1)
    ux = _filter_matrix(vx0, vx1, x0, x1)
    return np.einsum('ml,mkc,kq->lqc', uy, dv, ux)


def _dx_direct(tile, g_n, sx, sy, y0, y1, x0, x1):
    """dx of a direct block: per dx pixel, its candidate outputs (all of
    them where theta is singular) with mgt_axis_weight_at's weights; all
    the tile's pixels at once."""
    ly, lx = np.meshgrid(np.arange(y0, y1), np.arange(x0, x1), indexing='ij')
    my0, my1 = np.maximum(UP * ly - K0, 0), np.minimum(
        UP * ly - K0 + TAPS - 1, VIRT[0] - 1)
    mx0, mx1 = np.maximum(UP * lx - K0, 0), np.minimum(
        UP * lx - K0 + TAPS - 1, VIRT[1] - 1)
    cx, cy = 0.5 * (mx0 + mx1), 0.5 * (my0 + my1)
    q = tile.q
    full = (np.zeros(ly.shape, np.int64), np.full(ly.shape, OUT[0] - 1))
    if q is not None:
        hx = 0.5 * (mx1 - mx0) + 1.0 + q.hx
        hy = 0.5 * (my1 - my0) + 1.0 + q.hy
    r0, r1 = full if q is None else taw.candidate_rows(q, cx, cy, hx, hy, 0,
                                                       OUT[0] - 1)
    out = np.zeros((*ly.shape, 4))
    for k in range(int((r1 - r0).max(initial=-1)) + 1):
        i = r0 + k
        c0, c1 = (np.zeros(ly.shape, np.int64), np.full(ly.shape, OUT[1] - 1)) \
            if q is None else taw.candidate_cols(q, cx, cy, hx, hy, i, 0,
                                                 OUT[1] - 1)
        for m in range(int((c1 - c0).max(initial=-1)) + 1):
            j = c0 + m
            live = (i <= r1) & (j <= c1)
            ii, jj = np.clip(i, 0, OUT[0] - 1), np.clip(j, 0, OUT[1] - 1)
            w = _weight_at(sy[ii, jj], ly, H) * _weight_at(sx[ii, jj], lx, W)
            out += np.where(live[..., None], w[..., None] * g_n[ii, jj], 0.0)
    return out


def _dx_rebuilt(g, theta, plan):
    dx = np.full((N, H, W, 4), np.nan)
    for n in range(N):
        sx, sy = _coords(theta[n])
        for ty, tx in plan.tiles():
            tile = taw.transpose_tile(plan, theta[n], ty, tx)
            y0, y1, x0, x1 = plan.tile_box(ty, tx)
            if tile.mode == 'empty':
                dx[n, y0:y1, x0:x1] = 0.0
            elif tile.mode == 'tiled':
                dx[n, y0:y1, x0:x1] = _dx_tiled(tile, g[n], sx, sy, y0, y1,
                                                x0, x1)
            else:
                dx[n, y0:y1, x0:x1] = _dx_direct(tile, g[n], sx, sy, y0, y1,
                                                 x0, x1)
    return dx


@pytest.mark.parametrize('path', ['tiled', 'direct'])
@pytest.mark.parametrize('kind', KINDS)
def test_transpose_rebuilt_by_gather(kind, path):
    """(d) dx by the tiled gather (tile 5x7: several tiles a sample, odd
    regions) and by
    the direct path (the variant of C != 4): the autograd of the plain
    version, float64."""
    theta = _theta(kind)
    x, g = _inputs(kind)
    plan = _plan('transpose', **TRANSPOSE_PLANS['tile 5x7']) \
        if path == 'tiled' else _plan('transpose', channels=3)
    assert plan.variant == path
    got = _dx_rebuilt(g, theta, plan)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = taw.affine_warp_ref(xt, torch.from_numpy(theta), *OUT, UP, F)
    ref, = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-12)


def test_transpose_direct_covers_a_singular_theta():
    """Where theta is singular the direct path takes every output of the
    sample as a candidate; dx still equals the plain autograd."""
    theta = np.tile(np.float32([[0.8, 0.2, 0.0], [0.4, 0.1, 0.2]]),
                    (N, 1, 1))
    x, g = _inputs('singular')
    plan = _plan('transpose', tile=(H, W))
    assert all(taw.transpose_tile(plan, theta[0], ty, tx).mode == 'direct'
               for ty, tx in plan.tiles())
    got = _dx_rebuilt(g, theta, plan)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = taw.affine_warp_ref(xt, torch.from_numpy(theta), *OUT, UP, F)
    ref, = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_allclose(got, ref.numpy(), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# The launch plans
# ---------------------------------------------------------------------------

def test_warp_plans_at_the_main_shape():
    """The variants come from the parameters alone; the main shape's
    blocks, grids and shared memory; a filter reaching more than 8 stored
    samples per axis is refused."""
    fwd = taw.warp_plan('forward', 16, (396, 396), (524, 524), 4, 12, 2)
    adj = taw.warp_plan('transpose', 16, (396, 396), (524, 524), 4, 12, 2)
    assert (fwd.variant, fwd.tile, fwd.smem_bytes) == (
        'tiled', taw.FORWARD_TILE, taw.FORWARD_SMEM)
    assert fwd.grid == (-(-524 // fwd.tile[1]), -(-524 // fwd.tile[0]), 16)
    assert (adj.variant, adj.tile) == ('tiled', taw.TRANSPOSE_TILE)
    assert adj.grid == (-(-396 // adj.tile[1]), -(-396 // adj.tile[0]), 16)
    vh, vw = (2 * (t - 1) + 12 for t in adj.tile)
    assert adj.smem_bytes == (taw.HEADER_BYTES + 16 * taw.TABLE
                              + 16 * (vh * vw + vh * adj.tile[1]))
    assert adj.smem_bytes <= taw.MAX_SMEM
    for args, variant in (((3, 12, 2, True), 'direct'),
                          ((4, 12, 2, False), 'direct'),
                          ((4, 4, 1, True), 'direct'),
                          ((4, 1, 2, True), 'tiled'),
                          ((4, 13, 2, True), 'tiled')):
        assert taw.warp_variant(*args) == variant
        plan = taw.warp_plan('forward', 2, (20, 18), OUT, args[0], args[1],
                             args[2], args[3])
        assert plan.variant == variant
        assert plan.smem_bytes == (taw.HEADER_BYTES if variant == 'direct'
                                   else taw.FORWARD_SMEM)
    with pytest.raises(ValueError, match='8 stored samples'):
        taw.warp_plan('forward', 2, (20, 18), OUT, 4, 14, 2)
