"""The serving composition: z → (placed layers, montage), and its frozen
artifact.

Port of ``montage_gan_tpu/utils/serving.py``: ``build_inference_fn``
(mapping → per-layer synthesis → STN placement → clip → the alpha composite
or the learned renderer) and the export half (``export_generator``,
``load_exported``, ``export_file``, ``load_file``).  The JAX package lowers
the composition to StableHLO with ``jax.export``; the port traces it with
``torch.export`` on one device (the batch symbolic unless pinned) and saves
the program with ``torch.export.save``, its metadata in the file's
``extra_files``.  K1' and K2' stay in the program as ``mgt::bias_act`` and
``mgt::upfirdn2d`` nodes (``ops/bias_act.py``, ``ops/upfirdn2d.py``), which
launch the kernels on the card and run the plain versions on the CPU.

Noise is a pure function of the call's seed: with ``noise_mode='random'``
the synthesis noise comes from ``SeedDraws`` (a counter-based hash of the
seed, the draw and the element), so the exported program takes the seed as
an input and gives the same images as direct execution; ``'const'`` and
``'none'`` ignore it.
"""

from __future__ import annotations

import io
import json
import math
import zipfile
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import set_fp32_precision
from ..models.ensemble import MontageConfig, MontageEnsemble
from ..ops.composite import alpha_composite
from .image_utils import normalize_zero1

# The artifact's extra files: a magic/version entry and the metadata.
MAGIC_FILE, MAGIC = 'mgt_serving_magic', 'MGTSERVE torch 1'
META_FILE = 'mgt_serving.json'
COMPOSITES = ('alpha', 'renderer')

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """``x * m mod 2**32`` for int64 ``x`` in [0, 2**32), in 16-bit halves
    so that no product leaves int64."""
    return ((x & 0xFFFF) * m + (((x >> 16) * m) & 0xFFFF) * 65536) & _M32


def _hash32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mix (lowbias32) of int64 ``x`` in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


class SeedDraws:
    """N(0, 1) float32 draws that are a pure function of an int64 ``seed``
    tensor: draw ``k`` of a call takes, for element ``i``, two uniforms from
    a hash of (seed, 2k or 2k + 1, i) and one Box-Muller normal.  Passed to
    the synthesis nets as their ``generator`` (they call ``normal(shape,
    kind)``); integer arithmetic only up to the uniforms, so the CPU and the
    card draw the same numbers up to the rounding of ``log`` and ``cos``."""

    def __init__(self, seed: torch.Tensor):
        self.seed = seed.to(torch.int64) & _M32
        self.device = seed.device
        self.calls = 0

    def _uniform(self, stream: int, idx: torch.Tensor) -> torch.Tensor:
        key = _hash32(self.seed ^ ((stream * 0x9E3779B9) & _M32))
        bits = _hash32(key ^ _hash32(idx))
        return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))   # (0, 1)

    def normal(self, shape: Sequence[int], kind: str) -> torch.Tensor:
        k = self.calls
        self.calls += 1
        idx = torch.arange(math.prod(shape), dtype=torch.int64,
                           device=self.device) & _M32
        u1, u2 = self._uniform(2 * k, idx), self._uniform(2 * k + 1, idx)
        r = torch.sqrt(-2.0 * torch.log(u1))
        return (r * torch.cos((2.0 * math.pi) * u2)).reshape(tuple(shape))


class InferenceModule(nn.Module):
    """The composition as a module, ``forward(z, seed) → (placed, img)``:
    what ``build_inference_fn`` runs under ``inference_mode`` and what
    ``export_generator`` traces under ``no_grad``.  ``seed`` is an int64
    scalar tensor on z's device."""

    def __init__(self, cfg: MontageConfig, model: MontageEnsemble, *,
                 truncation_psi: float = 1.0, noise_mode: str = 'const',
                 composite: str = 'alpha'):
        super().__init__()
        if composite not in COMPOSITES:
            raise ValueError(f'composite={composite!r}: one of {COMPOSITES}')
        self.cfg = cfg
        self.model = model
        self.truncation_psi = truncation_psi
        self.noise_mode = noise_mode
        # a model without a renderer (a snapshot saved without one) falls
        # back to the alpha composite, as the JAX function does
        self.use_renderer = (composite == 'renderer'
                             and model.renderer is not None)

    def forward(self, z: torch.Tensor, seed: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        generator = SeedDraws(seed) if self.noise_mode == 'random' else None
        model = self.model
        if self.cfg.train_global:
            placed, _ = model.run_global_g(
                z, noise_mode=self.noise_mode,
                truncation_psi=self.truncation_psi, generator=generator)
        else:
            ws = model.mapping(z, truncation_psi=self.truncation_psi)
            placed = model.synthesize_layers(ws, noise_mode=self.noise_mode,
                                             generator=generator)
        placed = placed.clamp(-1, 1)
        if self.use_renderer:
            img = normalize_zero1(model.renderer(placed))
        else:
            img = alpha_composite(normalize_zero1(placed))
        return placed, img


def _seed_tensor(seed, device) -> torch.Tensor:
    return torch.as_tensor(int(seed), dtype=torch.int64, device=device)


def build_inference_fn(cfg: MontageConfig, model: MontageEnsemble, *,
                       truncation_psi: float = 1.0,
                       noise_mode: str = 'const',
                       composite: str = 'alpha') -> Callable:
    """``fn(z, seed) → (placed, img)`` on the device of ``z``.

    ``placed``: ``[B, L, H, W, 4]`` per-layer RGBA in [-1, 1] after STN
    placement; ``img``: ``[B, H, W, 4]`` montage in [0, 1] (the alpha
    composite, or with ``composite='renderer'`` the renderer's output where
    the model has a renderer).  ``seed`` (an int) seeds the synthesis noise
    when ``noise_mode='random'`` and is ignored otherwise."""
    set_fp32_precision()
    module = InferenceModule(cfg, model, truncation_psi=truncation_psi,
                             noise_mode=noise_mode, composite=composite)

    def fn(z: torch.Tensor, seed: int = 0) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
        with torch.inference_mode():
            return module(z, _seed_tensor(seed, z.device))

    return fn


def export_generator(cfg: MontageConfig, model: MontageEnsemble, *,
                     truncation_psi: float = 1.0,
                     noise_mode: str = 'const',
                     composite: str = 'alpha',
                     batch: Optional[int] = None) -> bytes:
    """Trace the composition with ``torch.export`` on the model's device
    and serialize it (``torch.export.save``).

    ``batch=None`` exports a symbolic batch dimension (one artifact, any
    batch size); a concrete int pins it.  The program takes ``(z [B,
    z_dim] float32, seed int64 scalar)`` and returns ``(placed, img)``."""
    set_fp32_precision()
    module = InferenceModule(cfg, model.eval(), truncation_psi=truncation_psi,
                             noise_mode=noise_mode, composite=composite)
    device = next(model.parameters()).device
    z = torch.zeros(batch or 2, cfg.z_dim, device=device)
    dynamic = None if batch else (
        {0: torch.export.Dim('batch', min=1)}, None)
    with torch.no_grad():
        program = torch.export.export(module, (z, _seed_tensor(0, device)),
                                      dynamic_shapes=dynamic)
    meta = {
        'z_dim': cfg.z_dim,
        'layer_names': list(cfg.layer_names),
        'base_resolution': cfg.base_resolution,
        'truncation_psi': truncation_psi,
        'noise_mode': noise_mode,
        'composite': composite,
        'device': device.type,
        'batch': batch,
        'outputs': ['placed [B,L,H,W,4] in [-1,1]', 'img [B,H,W,4] in [0,1]'],
    }
    buf = io.BytesIO()
    torch.export.save(program, buf, extra_files={
        MAGIC_FILE: MAGIC, META_FILE: json.dumps(meta)})
    return buf.getvalue()


def _extra_file(data: bytes, name: str) -> str:
    """An extra file of a ``torch.export.save`` archive; raises
    ``ValueError`` where ``data`` is not one that holds it."""
    try:
        with zipfile.ZipFile(io.BytesIO(data)) as zf:
            for entry in zf.namelist():
                if entry.endswith(f'/extra/{name}'):
                    return zf.read(entry).decode()
    except zipfile.BadZipFile:
        pass
    raise ValueError('not a montage_gan_tpu_torch serving artifact (no '
                     f'{name})')


def load_meta(data: bytes) -> dict:
    """The metadata of an artifact, without loading its program; raises
    ``ValueError`` on a file that is not one."""
    magic = _extra_file(data, MAGIC_FILE)
    if magic != MAGIC:
        raise ValueError('not a montage_gan_tpu_torch serving artifact '
                         f'(magic {magic[:32]!r}, expected {MAGIC!r})')
    return json.loads(_extra_file(data, META_FILE))


def load_exported(data: bytes):
    """(metadata dict, callable) from an artifact produced by
    :func:`export_generator`; ``call(z, seed=0) → (placed, img)`` runs on
    the device the artifact was exported on, and holds the loaded
    ``torch.export.ExportedProgram`` as ``call.program``.  Raises
    ``ValueError`` on a file that is not one.

    The program's kernel nodes are the ``mgt::*`` operators that
    ``montage_gan_tpu_torch.ops.bias_act`` and ``ops.upfirdn2d`` register
    when imported; this function imports them before loading."""
    from ..ops import bias_act, upfirdn2d  # noqa: F401  (registers mgt::*)

    meta = load_meta(data)
    program = torch.export.load(io.BytesIO(data))
    module = program.module()

    def call(z: torch.Tensor, seed: int = 0):
        with torch.no_grad():
            return tuple(module(z, _seed_tensor(seed, z.device)))

    call.program = program
    return meta, call


def export_file(path: str, *args, **kwargs) -> dict:
    """export_generator → file; returns the artifact metadata."""
    blob = export_generator(*args, **kwargs)
    with open(path, 'wb') as f:
        f.write(blob)
    return load_meta(blob)


def load_file(path: str):
    with open(path, 'rb') as f:
        return load_exported(f.read())
