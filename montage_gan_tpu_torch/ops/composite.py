"""Alpha compositing of RGBA layer stacks.

Port of ``montage_gan_tpu/ops/composite.py``: the straight-alpha A-over-B
recurrence (layer l over the canvas of layers < l) in closed form, with an
exclusive reverse cumulative product of transmittances —

    A_out           = 1 - Π_l (1 - a_l)
    C_out · A_out   = Σ_l c_l · a_l · Π_{k>l} (1 - a_k)

and 0/0 colour divisions resolving to 0.

``translate_and_composite_fused`` is the port of the TPU composite kernel
(``ops/pallas/composite_kernel.py``, forward only, shifts clamped to ±1):
a CPU tensor takes its plain version, ``translate_and_composite`` of the
clamped shifts; a CUDA tensor launches kernel K5' (``csrc/composite.cu``),
which runs the recurrence itself, layer by layer, in registers.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda import CudaKernel, stream_handle, takes_plain
from .grid_sample import translate_sample

kernel = CudaKernel('composite', 'mgt_translate_composite',
                    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                    + [ctypes.c_float, ctypes.c_void_p])


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den with 0/0 → 0."""
    den_safe = torch.where(den == 0, torch.ones_like(den), den)
    return torch.where(den == 0, torch.zeros_like(num), num / den_safe)


def alpha_composite(layers: torch.Tensor, layer_axis: int = 1) -> torch.Tensor:
    """Straight-alpha composite over the layer axis of ``[..., L, H, W, 4]``
    RGBA in [0, 1] (higher ``l`` on top); returns the layer axis removed."""
    layers = torch.movedim(layers, layer_axis, 0)               # [L, ..., 4]
    color = layers[..., :3]
    alpha = layers[..., 3:4]

    # transmittance above layer l: T_l = Π_{k>l} (1 - a_k) (exclusive, reversed)
    one_minus = 1.0 - alpha
    rev = torch.flip(one_minus, [0])
    t_above = torch.flip(
        torch.cat([torch.ones_like(rev[:1]), torch.cumprod(rev, 0)[:-1]], 0),
        [0])

    weight = alpha * t_above
    alpha_out = 1.0 - torch.prod(one_minus, 0)
    color_out = _safe_div(torch.sum(color * weight, 0), alpha_out)
    return torch.cat([color_out, alpha_out], -1)


def translate_and_composite(layers: torch.Tensor, translations: torch.Tensor,
                            pad_value: float = 0.0,
                            input_range: str = 'zero1') -> torch.Tensor:
    """Per-layer translation + alpha composite of ``[B, L, H, W, 4]`` by
    ``[B, L, 2]`` normalized (dx, dy), differentiable; the shifts are not
    clamped."""
    b, l, h, w, c = layers.shape
    moved = translate_sample(layers.reshape(b * l, h, w, c),
                             translations.reshape(b * l, 2),
                             pad_value=pad_value).reshape(b, l, h, w, c)
    if input_range == 'minus11':
        return alpha_composite((moved + 1.0) * 0.5) * 2.0 - 1.0
    return alpha_composite(moved)


def translate_and_composite_ref(layers: torch.Tensor,
                                translations: torch.Tensor,
                                pad_value: float = 0.0) -> torch.Tensor:
    """The plain version of K5': the shifts clamped to ±1, then
    ``translate_and_composite`` of ``[0, 1]`` RGBA."""
    return translate_and_composite(layers, translations.clamp(-1.0, 1.0),
                                   pad_value, 'zero1')


def translate_and_composite_cuda(layers: torch.Tensor,
                                 translations: torch.Tensor,
                                 pad_value: float = 0.0) -> torch.Tensor:
    """Kernel K5' (no autograd): ``[B, L, H, W, 4]`` float32 RGBA in
    [0, 1] and ``[B, L, 2]`` float32 shifts → ``[B, H, W, 4]``."""
    for t, name in ((layers, 'layers'), (translations, 'translations')):
        if t.device.type != 'cuda':
            raise ValueError(f'composite kernel needs CUDA tensors, got {name}'
                             f' on {t.device}')
        if t.dtype != torch.float32:
            raise TypeError(f'composite kernel takes float32, got {name} '
                            f'{t.dtype}')
    if layers.ndim != 5 or layers.shape[-1] != 4:
        raise ValueError(f'layers {tuple(layers.shape)} is not [B, L, H, W, 4]')
    b, l, h, w, _ = layers.shape
    if tuple(translations.shape) != (b, l, 2):
        raise ValueError(f'translations {tuple(translations.shape)} is not '
                         f'[{b}, {l}, 2]')
    layers = layers.contiguous()
    translations = translations.contiguous()
    out = torch.empty(b, h, w, 4, dtype=torch.float32, device=layers.device)
    kernel.launch(layers.data_ptr(), translations.data_ptr(), out.data_ptr(),
                  b, l, h, w, float(pad_value), stream_handle(layers.device))
    return out


def translate_and_composite_fused(layers: torch.Tensor,
                                  translations: torch.Tensor,
                                  pad_value: float = 0.0) -> torch.Tensor:
    """Translate each layer of ``[B, L, H, W, 4]`` RGBA in [0, 1] by its
    ``[B, L, 2]`` normalized (dx, dy), clamped to ±1 (content from outside
    the image is ``pad_value``), and alpha-composite the layers: ``[B, H,
    W, 4]``.  Forward only, like the TPU kernel: a CUDA tensor that requires
    grad raises (``translate_and_composite`` is the differentiable op)."""
    if takes_plain(layers):
        return translate_and_composite_ref(layers, translations, pad_value)
    if layers.requires_grad or translations.requires_grad:
        raise RuntimeError('translate_and_composite_fused is forward only; '
                           'use translate_and_composite for gradients')
    return translate_and_composite_cuda(layers, translations, pad_value)
