"""The ADA geometric warp: an affine bilinear resample of a virtual ``up``×
FIR upsample.

Port of the contract of ``montage_gan_tpu/ops/affine_warp.py::affine_warp``:

    affine_warp(x, theta, out_h, out_w, up, up_filter)
        == grid_sample(upsample2d(x, up_filter, up), affine_grid(theta))

with bilinear sampling, ``align_corners=False`` and zeros padding, on NHWC
float32.  ``theta`` ``[N, 2, 3]`` maps output coordinates to input
coordinates over the virtual ``[up·H, up·W]`` plane and gets no gradient
(every caller draws it at random).

Two paths, chosen by the device of ``x``:
  * a CPU tensor takes the plain version (``affine_warp_ref``), which is the
    JAX package's CPU oracle ``_gather_warp`` (``training/augment.py:461-464``):
    ``upsample2d_ref`` and then the gather ``grid_sample``; autograd gives
    its transpose;
  * a CUDA tensor goes through the mutually adjoint autograd Functions
    ``_Warp`` (kernel K3', ``csrc/warp.cu``) and ``_WarpT`` (kernel K4', the
    exact adjoint of K3' with respect to ``x``): the backward of each is the
    other, so R1's grad-of-grad runs K3' again (JAX
    ``ops/affine_warp.py:636-680``).  Both kernels are deterministic: K4' is
    a gather that writes each element of ``dx`` once, with no atomics.

Both kernels have two variants, chosen from the parameters alone
(``warp_plan``) and counted on ``kernel.variants``: ``tiled`` (C = 4,
16-byte aligned, up 2, at most ``TILED_TAPS`` taps: a block per tile of one
sample, its footprint in shared memory) and ``direct`` (anything else).  A
tiled launch still sends a block whose footprint does not fit (strong zoom)
down the direct path; ``forward_tile`` and ``transpose_tile`` give each
block's geometry as the kernels compute it, and the CPU tests hold it.

The TPU tiling knobs of the JAX engines (``tile``, ``block``, ``chunk``,
``MGT_WARP_*``) have no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .cuda import CudaKernel, stream_handle, takes_plain, tensor_bytes
from .grid_sample import affine_grid, grid_sample
from .upfirdn2d import upsample2d_ref

_SIGNATURE = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 12
              + [ctypes.c_void_p] * 2)
forward_kernel = CudaKernel('warp', 'mgt_warp_forward', _SIGNATURE)
transpose_kernel = CudaKernel('warp', 'mgt_warp_transpose', _SIGNATURE)

# csrc/warp.cu's constants and variant codes.
VARIANT_CODES = {'direct': 0, 'tiled': 1}
MAX_STORED = 8              # kMaxL: stored samples per axis an output reads
TILED_TAPS = 16             # the most taps the tiled variant stages
HEADER_BYTES = 320          # a block's plan and taps
TABLE = 256                 # K4': candidate rows, and columns, at most
MAX_SMEM = 232448           # 227 KB, an H100 block's shared memory
# The tiled variants' tiles (rows, columns): K3' outputs, K4' dx pixels;
# and K3''s shared memory per block.
FORWARD_TILE = (16, 32)
TRANSPOSE_TILE = (32, 16)
FORWARD_SMEM = 48 * 1024


def _taps(up: int, up_filter, device) -> torch.Tensor:
    """The 1-D filter as a float32 tensor on ``device`` ([1] for up = 1)."""
    if up == 1:
        if up_filter is not None:
            raise ValueError('up_filter requires up > 1')
        return torch.ones(1, device=device)
    if up_filter is None:
        raise ValueError('up > 1 requires up_filter taps')
    f = torch.as_tensor(np.asarray(up_filter, np.float32)
                        if not isinstance(up_filter, torch.Tensor)
                        else up_filter, dtype=torch.float32).to(device)
    if f.ndim != 1:
        raise ValueError('the fused upsample takes a separable 1-D filter')
    return f.contiguous()


def affine_warp_ref(x: torch.Tensor, theta: torch.Tensor, out_h: int,
                    out_w: int, up: int = 2, up_filter=None) -> torch.Tensor:
    """The plain version, on any device: the upsample is built, then
    sampled."""
    theta = theta.detach().float()
    if up > 1:
        x = upsample2d_ref(x, _taps(up, up_filter, x.device), up=up)
    return grid_sample(x, affine_grid(theta, out_h, out_w))


# ---------------------------------------------------------------------------
# The plan of a launch, and each block's geometry (csrc/warp.cu's twins)
# ---------------------------------------------------------------------------

def transpose_smem(tile: Tuple[int, int], taps: int, up: int) -> int:
    """Shared memory of K4''s tiled blocks: the header, the candidate
    tables, the virtual region of a ``tile`` of dx and its x pass."""
    vh = up * (tile[0] - 1) + taps
    vw = up * (tile[1] - 1) + taps
    return HEADER_BYTES + 16 * TABLE + 16 * (vh * vw + vh * tile[1])


@dataclass(frozen=True)
class WarpPlan:
    """One launch of K3' (``kind`` 'forward', tiles of the output) or K4'
    ('transpose', tiles of dx): its variant, tile (rows, columns), grid
    (tiles along x, along y, samples) and dynamic shared memory."""
    kind: str
    variant: str
    tile: Tuple[int, int]
    grid: Tuple[int, int, int]
    smem_bytes: int
    in_hw: Tuple[int, int]
    out_hw: Tuple[int, int]
    taps: int
    up: int

    def tile_box(self, ty: int, tx: int) -> Tuple[int, int, int, int]:
        """Rows ``[y0, y1)`` and columns ``[x0, x1)`` of tile (ty, tx):
        outputs for K3', dx pixels for K4'."""
        h, w = self.out_hw if self.kind == 'forward' else self.in_hw
        y0, x0 = ty * self.tile[0], tx * self.tile[1]
        return y0, min(y0 + self.tile[0], h), x0, min(x0 + self.tile[1], w)

    def tiles(self):
        for ty in range(self.grid[1]):
            for tx in range(self.grid[0]):
                yield ty, tx


def warp_variant(channels: int, taps: int, up: int,
                 aligned: bool = True) -> str:
    """``tiled`` for 16-byte float4 pixels, up 2 and at most ``TILED_TAPS``
    taps, else ``direct``."""
    return 'tiled' if (channels == 4 and aligned and up == 2
                       and taps <= TILED_TAPS) else 'direct'


@functools.lru_cache(maxsize=256)
def warp_plan(kind: str, n: int, in_hw: Tuple[int, int],
              out_hw: Tuple[int, int], channels: int, taps: int, up: int,
              aligned: bool = True, tile: Optional[Tuple[int, int]] = None,
              forward_smem: Optional[int] = None) -> WarpPlan:
    """The launch of K3' (``kind`` 'forward') or K4' ('transpose') on ``n``
    samples of ``in_hw`` stored and ``out_hw`` output pixels (``tile`` and
    ``forward_smem`` default to ``FORWARD_TILE`` or ``TRANSPOSE_TILE`` and
    ``FORWARD_SMEM``)."""
    if taps // up + 2 > MAX_STORED:
        raise ValueError(f'{taps} taps at up {up}: the warp kernels read at '
                         f'most {MAX_STORED} stored samples per axis')
    variant = warp_variant(channels, taps, up, aligned)
    if tile is None:
        tile = FORWARD_TILE if kind == 'forward' else TRANSPOSE_TILE
    if variant == 'direct':
        smem = HEADER_BYTES
    elif kind == 'forward':
        smem = FORWARD_SMEM if forward_smem is None else forward_smem
    else:
        smem = transpose_smem(tile, taps, up)
        if smem > MAX_SMEM:
            raise ValueError(f'K4\' tile {tile} needs {smem} bytes of shared '
                             f'memory, above {MAX_SMEM}')
    h, w = out_hw if kind == 'forward' else in_hw
    return WarpPlan(kind=kind, variant=variant, tile=tuple(tile),
                    grid=(-(-w // tile[1]), -(-h // tile[0]), n),
                    smem_bytes=smem, in_hw=tuple(in_hw), out_hw=tuple(out_hw),
                    taps=taps, up=up)


_F32 = np.float32


def _k0(taps: int, up: int) -> int:
    return taps - 1 - (taps + up - 1) // 2


def source_coords(theta_n: np.ndarray, i, j, out_hw, virt_hw):
    """csrc/warp.cu::mgt_source: the float32 virtual coordinates (sx, sy)
    of outputs (i, j) (integer arrays that broadcast), each step rounded."""
    t = np.asarray(theta_n, _F32).reshape(2, 3)

    def norm(k, size):
        return (_F32(2) * np.asarray(k, _F32) + _F32(1)) / _F32(size) - _F32(1)
    xo, yo = norm(j, out_hw[1]), norm(i, out_hw[0])
    gx = (t[0, 0] * xo + t[0, 1] * yo) + t[0, 2]
    gy = (t[1, 0] * xo + t[1, 1] * yo) + t[1, 2]
    return ((gx + _F32(1)) * _F32(virt_hw[1] * 0.5) - _F32(0.5),
            (gy + _F32(1)) * _F32(virt_hw[0] * 0.5) - _F32(0.5))


def margin(theta_row, extent: int) -> np.float32:
    """csrc/warp.cu::mgt_margin: a bound, in virtual pixels, on how far a
    rounded coordinate lies from the exact affine map."""
    a = np.abs(np.asarray(theta_row, _F32))
    return _F32(0.015625) + _F32(3.8e-6) * _F32(extent) * (
        ((a[0] + a[1]) + a[2]) + _F32(1))


def _virtual_span(lo, hi, virt):
    """mgt_virtual_span: virtual samples [v0, v1) that the taps of every
    coordinate in [lo, hi] read on the plane, or None."""
    if hi < -1 or lo >= virt:
        return None
    v0 = max(int(np.floor(max(lo, _F32(-1)))), 0)
    v1 = min(int(np.floor(min(hi, _F32(virt)))) + 1, virt - 1)
    return (v0, v1 + 1) if v0 <= v1 else None


def _stored_span(v0, v1, taps, up, length):
    """mgt_stored_span: stored samples [l0, l1) that virtual [v0, v1)
    read, or None."""
    k0 = _k0(taps, up)
    l0 = max(-((taps - 1 - k0 - v0) // up), 0)          # ceil((v0+k0-T+1)/up)
    l1 = min((v1 - 1 + k0) // up, length - 1)
    return (l0, l1 + 1) if l0 <= l1 else None


class ForwardTile(NamedTuple):
    """A K3' block: ``mode`` ('tiled', 'direct' or 'empty': every tap off
    the plane), its virtual region and stored region as half-open ``(y0,
    y1, x0, x1)`` (None unless tiled)."""
    mode: str
    virtual: Optional[Tuple[int, int, int, int]]
    stored: Optional[Tuple[int, int, int, int]]


def forward_tile(plan: WarpPlan, theta_n: np.ndarray, ty: int,
                 tx: int) -> ForwardTile:
    """csrc/warp.cu::mgt_forward_plan for tile (ty, tx) of a K3' launch."""
    if plan.variant == 'direct':
        return ForwardTile('direct', None, None)
    (h, w), up, taps = plan.in_hw, plan.up, plan.taps
    virt_h, virt_w = up * h, up * w
    y0, y1, x0, x1 = plan.tile_box(ty, tx)
    sx, sy = source_coords(theta_n, np.array([y0, y0, y1 - 1, y1 - 1]),
                           np.array([x0, x1 - 1, x0, x1 - 1]), plan.out_hw,
                           (virt_h, virt_w))
    if not (np.isfinite(sx).all() and np.isfinite(sy).all()):
        return ForwardTile('direct', None, None)
    t = np.asarray(theta_n, _F32).reshape(2, 3)
    mx, my = margin(t[0], virt_w), margin(t[1], virt_h)
    vx = _virtual_span(sx.min() - mx, sx.max() + mx, virt_w)
    vy = _virtual_span(sy.min() - my, sy.max() + my, virt_h)
    lx = vx and _stored_span(*vx, taps, up, w)
    ly = vy and _stored_span(*vy, taps, up, h)
    if not (lx and ly):
        return ForwardTile('empty', None, None)
    sh, sw = ly[1] - ly[0], lx[1] - lx[0]
    vh, vw = vy[1] - vy[0], vx[1] - vx[0]
    need = max(sh * sw, vh * vw) + sh * vw
    mode = 'tiled' if need <= (plan.smem_bytes - HEADER_BYTES) // 16 \
        else 'direct'
    return ForwardTile(mode, (*vy, *vx), (*ly, *lx))


class Affine(NamedTuple):
    """csrc/warp.cu::MgtAffine: the exact map ``sx = axj·j + axi·i + cx``
    (sy likewise) from output (j, i) to the virtual plane, its inverse,
    the reciprocals of axj and ayj (0 where infinite) and the margins."""
    axj: float
    axi: float
    cx: float
    ayj: float
    ayi: float
    cy: float
    ijx: float
    ijy: float
    iix: float
    iiy: float
    rx: float
    ry: float
    hx: float
    hy: float


def affine(theta_n: np.ndarray, out_hw, virt_hw) -> Optional[Affine]:
    """csrc/warp.cu::mgt_affine, in float64; None where theta is not
    finite or the map is singular."""
    t = [float(v) for v in np.asarray(theta_n, _F32).reshape(6)]
    out_h, out_w = out_hw
    kx, ky = 0.5 * virt_hw[1], 0.5 * virt_hw[0]
    ox, oy = 1.0 / out_w - 1.0, 1.0 / out_h - 1.0
    with np.errstate(all='ignore'):
        axj, axi = t[0] * (2.0 / out_w) * kx, t[1] * (2.0 / out_h) * kx
        cx = (t[0] * ox + t[1] * oy + t[2] + 1.0) * kx - 0.5
        ayj, ayi = t[3] * (2.0 / out_w) * ky, t[4] * (2.0 / out_h) * ky
        cy = (t[3] * ox + t[4] * oy + t[5] + 1.0) * ky - 0.5
        det = axj * ayi - axi * ayj
        size = abs(axj * ayi) + abs(axi * ayj)
        if not (np.isfinite([det, cx, cy]).all() and abs(det) > 1e-9 * size):
            return None
        inv = (ayi / det, -axi / det, -ayj / det, axj / det)
        rx = np.float64(1.0) / axj if axj != 0 else np.inf
        ry = np.float64(1.0) / ayj if ayj != 0 else np.inf
    if not np.isfinite(inv).all():
        return None
    return Affine(axj, axi, cx, ayj, ayi, cy, *inv,
                  float(rx) if np.isfinite(rx) else 0.0,
                  float(ry) if np.isfinite(ry) else 0.0,
                  float(margin(t[0:3], virt_hw[1])),
                  float(margin(t[3:6], virt_hw[0])))


def _ceil_in(v, lo, hi, dtype=np.float64):
    """mgt_ceil_in: ceil(v) clamped to [lo, hi] in ``dtype`` (NaN gives
    lo)."""
    v = np.asarray(v, dtype)
    with np.errstate(invalid='ignore'):
        inner = np.ceil(np.where(np.isfinite(v), v, 0)).astype(np.int64)
        return np.where(v > dtype(lo), np.where(v >= dtype(hi), hi, inner),
                        lo)


def _floor_in(v, lo, hi, dtype=np.float64):
    """mgt_floor_in: floor(v) clamped to [lo, hi] in ``dtype`` (NaN gives
    hi)."""
    v = np.asarray(v, dtype)
    with np.errstate(invalid='ignore'):
        inner = np.floor(np.where(np.isfinite(v), v, 0)).astype(np.int64)
        return np.where(v < dtype(hi), np.where(v <= dtype(lo), lo, inner),
                        hi)


def candidate_rows(q: Affine, sx, sy, hx, hy, lo: int, hi: int):
    """csrc/warp.cu::mgt_candidate_rows: rows [r0, r1] within [lo, hi] of
    the outputs whose exact source point can lie in the box (sx ± hx, sy ±
    hy); arrays broadcast."""
    sx, sy = np.asarray(sx, np.float64), np.asarray(sy, np.float64)
    ic = q.iix * (sx - q.cx) + q.iiy * (sy - q.cy)
    ri = abs(q.iix) * hx + abs(q.iiy) * hy
    return _ceil_in(ic - ri, lo, hi + 1), _floor_in(ic + ri, lo - 1, hi)


def candidate_cols(q: Affine, sx, sy, hx, hy, i, lo: int, hi: int):
    """csrc/warp.cu::mgt_candidate_cols: columns [c0, c1] within [lo, hi]
    of row ``i``'s outputs whose exact source point can lie in that box."""
    sx, sy = np.asarray(sx, np.float64), np.asarray(sy, np.float64)
    i = np.asarray(i, np.float64)
    a = np.full(np.broadcast(sx, sy, i).shape, float(lo))
    b = np.full(a.shape, float(hi))
    if q.rx != 0.0:
        u = sx - q.cx - q.axi * i
        e0, e1 = (u - hx) * q.rx, (u + hx) * q.rx
        a = np.maximum(a, np.minimum(e0, e1))
        b = np.minimum(b, np.maximum(e0, e1))
    if q.ry != 0.0:
        u = sy - q.cy - q.ayi * i
        e0, e1 = (u - hy) * q.ry, (u + hy) * q.ry
        a = np.maximum(a, np.minimum(e0, e1))
        b = np.minimum(b, np.maximum(e0, e1))
    return _ceil_in(a, lo, hi + 1), _floor_in(b, lo - 1, hi)


class Gather(NamedTuple):
    """csrc/warp.cu::MgtGather: the tiled gather's candidates of virtual
    sample (x0 + dx, y0 + dy) of a K4' block's region, in float32 relative
    to the region's origin and the candidate box's: box rows ``[ceil(ic -
    ri), floor(ic + ri)]`` with ``ic = ic0 + icx·dx + icy·dy``, and in box
    row ``di`` the columns where both strips ``jc ± hj``, ``jc = j0 + jm·d -
    ji·di``, overlap."""
    ic0: np.float32
    icx: np.float32
    icy: np.float32
    ri: np.float32
    jx0: np.float32
    jxm: np.float32
    jxi: np.float32
    hjx: np.float32
    jy0: np.float32
    jym: np.float32
    jyi: np.float32
    hjy: np.float32


def _strip(r, per_row, u0, half, width, r0, c0, gh):
    """csrc/warp.cu::mgt_strip: (j0, jm, ji, hj) of one coordinate."""
    if r == 0.0:
        return _F32(0), _F32(0), _F32(0), _F32(np.inf)
    a = r * (u0 - per_row * r0) - c0
    b = r * per_row
    return (_F32(a), _F32(r), _F32(b),
            _F32(abs(r) * half + 1e-3 + 1e-5 * (abs(a) + abs(r) * width
                                                 + abs(b) * gh)))


def _gather(q: Affine, virtual, box) -> Gather:
    """The float32 gather parameters of a tiled K4' block."""
    vy0, vy1, vx0, vx1 = virtual
    r0, r1, c0, _ = box
    ux, uy = 1.0 + q.hx, 1.0 + q.hy
    ox, oy = vx0 - q.cx, vy0 - q.cy
    ic0 = q.iix * ox + q.iiy * oy - r0
    ri = (abs(q.iix) * ux + abs(q.iiy) * uy + 1e-3
          + 1e-5 * (abs(ic0) + abs(q.iix) * (vx1 - vx0)
                    + abs(q.iiy) * (vy1 - vy0)))
    return Gather(_F32(ic0), _F32(q.iix), _F32(q.iiy), _F32(ri),
                  *_strip(q.rx, q.axi, ox, ux, vx1 - vx0, r0, c0, r1 - r0),
                  *_strip(q.ry, q.ayi, oy, uy, vy1 - vy0, r0, c0, r1 - r0))


def gather_rows(gp: Gather, dx, dy, gh: int):
    """Box rows [r0, r1] of the candidates of region sample (dx, dy), as
    the tiled K4' gather computes them (arrays broadcast)."""
    ic = (gp.ic0 + gp.icx * np.asarray(dx, _F32)) + gp.icy * np.asarray(dy, _F32)
    return (_ceil_in(ic - gp.ri, 0, gh, _F32),
            _floor_in(ic + gp.ri, -1, gh - 1, _F32))


def gather_cols(gp: Gather, dx, dy, di, gw: int):
    """Box columns [c0, c1] of those candidates in box row ``di``."""
    with np.errstate(invalid='ignore', over='ignore'):
        cx = (gp.jx0 + gp.jxm * np.asarray(dx, _F32)) - gp.jxi * np.asarray(di, _F32)
        cy = (gp.jy0 + gp.jym * np.asarray(dy, _F32)) - gp.jyi * np.asarray(di, _F32)
        lo = np.fmax(cx - gp.hjx, cy - gp.hjy)
        hi = np.fmin(cx + gp.hjx, cy + gp.hjy)
    return _ceil_in(lo, 0, gw, _F32), _floor_in(hi, -1, gw - 1, _F32)


class TransposeTile(NamedTuple):
    """A K4' block: ``mode`` ('tiled', 'direct', or 'empty': no output
    reaches the tile), its virtual region and candidate box of outputs as
    half-open ``(y0, y1, x0, x1)``, the affine map (None where singular)
    and, where tiled, the gather's parameters."""
    mode: str
    virtual: Tuple[int, int, int, int]
    box: Optional[Tuple[int, int, int, int]]
    q: Optional[Affine]
    gather: Optional[Gather] = None


def transpose_tile(plan: WarpPlan, theta_n: np.ndarray, ty: int,
                   tx: int) -> TransposeTile:
    """csrc/warp.cu::mgt_transpose_plan for tile (ty, tx) of a K4'
    launch."""
    (h, w), up, taps = plan.in_hw, plan.up, plan.taps
    out_h, out_w = plan.out_hw
    k0 = _k0(taps, up)
    y0, y1, x0, x1 = plan.tile_box(ty, tx)
    vy0, vy1 = max(up * y0 - k0, 0), min(up * (y1 - 1) - k0 + taps - 1,
                                         up * h - 1)
    vx0, vx1 = max(up * x0 - k0, 0), min(up * (x1 - 1) - k0 + taps - 1,
                                         up * w - 1)
    virtual = (vy0, vy1 + 1, vx0, vx1 + 1)
    q = affine(theta_n, plan.out_hw, (up * h, up * w))
    if plan.variant == 'direct' or q is None:
        return TransposeTile('direct', virtual, None, q)
    if vy1 < vy0 or vx1 < vx0:
        return TransposeTile('empty', virtual, None, q)
    cx, cy = 0.5 * (vx0 + vx1), 0.5 * (vy0 + vy1)
    hx = 0.5 * (vx1 - vx0) + 1.0 + q.hx
    hy = 0.5 * (vy1 - vy0) + 1.0 + q.hy
    r0, r1 = (int(v) for v in candidate_rows(q, cx, cy, hx, hy, 0,
                                             out_h - 1))
    jc = q.ijx * (cx - q.cx) + q.ijy * (cy - q.cy)
    rj = abs(q.ijx) * hx + abs(q.ijy) * hy
    c0, c1 = int(_ceil_in(jc - rj, 0, out_w)), int(_floor_in(jc + rj, -1,
                                                            out_w - 1))
    if r0 > r1 or c0 > c1:
        return TransposeTile('empty', virtual, None, q)
    box = (max(r0 - 1, 0), min(r1 + 1, out_h - 1) + 1, max(c0 - 1, 0),
           min(c1 + 1, out_w - 1) + 1)
    if box[1] - box[0] > TABLE or box[3] - box[2] > TABLE:
        return TransposeTile('direct', virtual, box, q)
    return TransposeTile('tiled', virtual, box, q, _gather(q, virtual, box))


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def _check(t: torch.Tensor, name: str) -> None:
    if t.device.type != 'cuda':
        raise ValueError(f'warp kernel needs CUDA tensors, got {name} on '
                         f'{t.device}')
    if t.dtype != torch.float32:
        raise TypeError(f'warp kernel takes float32, got {name} {t.dtype}')
    if not t.is_contiguous():
        raise ValueError(f'warp kernel needs a contiguous {name}')


def _launch(kern: CudaKernel, kind: str, src: torch.Tensor,
            theta: torch.Tensor, taps: torch.Tensor, dst: torch.Tensor,
            in_hw, out_hw, up: int,
            direct_blocks: Optional[torch.Tensor]) -> None:
    for t, name in ((src, 'input'), (theta, 'theta'), (taps, 'taps'),
                    (dst, 'output')):
        _check(t, name)
    n, c = src.shape[0], src.shape[-1]
    if theta.shape != (n, 2, 3):
        raise ValueError(f'theta {tuple(theta.shape)} is not [{n}, 2, 3]')
    counter = 0
    if direct_blocks is not None:
        if (direct_blocks.dtype != torch.int32 or direct_blocks.device
                != src.device or direct_blocks.numel() != 1):
            raise ValueError('direct_blocks must be one int32 on the card')
        counter = direct_blocks.data_ptr()
    aligned = src.data_ptr() % 16 == 0 and dst.data_ptr() % 16 == 0
    plan = warp_plan(kind, n, tuple(in_hw), tuple(out_hw), c,
                     taps.shape[0], up, aligned)
    kern.launch(src.data_ptr(), theta.data_ptr(), taps.data_ptr(),
                dst.data_ptr(), n, in_hw[0], in_hw[1], c, out_hw[0],
                out_hw[1], taps.shape[0], up, VARIANT_CODES[plan.variant],
                plan.tile[0], plan.tile[1], plan.smem_bytes, counter,
                stream_handle(src.get_device()), variant=plan.variant,
                nbytes=tensor_bytes(src, theta, taps, dst))


def warp_forward_cuda(x: torch.Tensor, theta: torch.Tensor, out_h: int,
                      out_w: int, up: int, taps: torch.Tensor,
                      direct_blocks: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Kernel K3' (no autograd): ``x`` ``[N, H, W, C]`` → ``[N, out_h,
    out_w, C]``.  ``direct_blocks``: an int32 on the card that each block
    taking the direct path adds 1 to."""
    n, h, w, c = x.shape
    out = torch.empty(n, out_h, out_w, c, dtype=x.dtype, device=x.device)
    _launch(forward_kernel, 'forward', x, theta, taps, out, (h, w),
            (out_h, out_w), up, direct_blocks)
    return out


def warp_transpose_cuda(g: torch.Tensor, theta: torch.Tensor, h: int, w: int,
                        up: int, taps: torch.Tensor,
                        direct_blocks: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Kernel K4' (no autograd): the adjoint of K3', ``g`` ``[N, out_h,
    out_w, C]`` → ``[N, h, w, C]``; every element is written once."""
    n, out_h, out_w, c = g.shape
    dx = torch.empty(n, h, w, c, dtype=g.dtype, device=g.device)
    _launch(transpose_kernel, 'transpose', g, theta, taps, dx, (h, w),
            (out_h, out_w), up, direct_blocks)
    return dx


class _Warp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, theta, taps, out_h, out_w, up):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(theta, taps)
        ctx.params = (x.shape[1], x.shape[2], out_h, out_w, up)
        return warp_forward_cuda(x, theta, out_h, out_w, up, taps)

    @staticmethod
    def backward(ctx, g):
        if g is None:
            return (None,) * 6
        theta, taps = ctx.saved_tensors
        h, w, out_h, out_w, up = ctx.params
        dx = _WarpT.apply(g.float().contiguous(), theta, taps, h, w, up)
        return dx, None, None, None, None, None


class _WarpT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, theta, taps, h, w, up):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(theta, taps)
        ctx.params = (g.shape[1], g.shape[2], up)
        return warp_transpose_cuda(g, theta, h, w, up, taps)

    @staticmethod
    def backward(ctx, dd):
        if dd is None:
            return (None,) * 6
        theta, taps = ctx.saved_tensors
        out_h, out_w, up = ctx.params
        dg = _Warp.apply(dd.float().contiguous(), theta, taps, out_h, out_w,
                         up)
        return dg, None, None, None, None, None


def affine_warp(x: torch.Tensor, theta: torch.Tensor, out_h: int, out_w: int,
                up: int = 2, up_filter: Optional[object] = None) -> torch.Tensor:
    """Bilinear-sample NHWC ``x`` (through a virtual ``up``× upsample with
    the 1-D ``up_filter`` when ``up > 1``) on the affine grid of ``theta``.

    Args:
        x: ``[N, H, W, C]`` float32.
        theta: ``[N, 2, 3]`` inverse transforms in the normalized
            ``affine_grid`` convention, over the virtual ``[up·H, up·W]``
            plane; no gradient flows to it.
        out_h, out_w: output size.
        up, up_filter: the virtual upsample (``upsample2d`` with its gain
            ``up²`` and padding).
    Returns:
        ``[N, out_h, out_w, C]``.
    """
    if takes_plain(x):
        return affine_warp_ref(x, theta, out_h, out_w, up, up_filter)
    return _Warp.apply(x.float().contiguous(),
                       theta.detach().float().contiguous(),
                       _taps(up, up_filter, x.device), out_h, out_w, up)
