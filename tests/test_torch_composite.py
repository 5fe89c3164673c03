"""K5' (translate and composite) on the CPU: its plain version against the
TPU kernel in interpret mode, as ``tests/test_pallas_kernels.py`` runs it,
and the kernel's arithmetic (emulated: the plain version's taps, then the
A-over-B recurrence in layer order on a premultiplied canvas) against both.

Tolerances: against the TPU kernel ``rtol 1e-4, atol 1e-5``, the JAX
package's own for that kernel; the emulated kernel against the plain
version as ``chip_smoke.py`` holds the card (``TOL_COMPOSITE``, the colour
premultiplied by alpha: the plain version's closed form divides by
1 - Π(1 - a), which loses digits where alpha is small, shown below).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from montage_gan_tpu.ops.pallas.composite_kernel import \
    translate_and_composite_pallas
from montage_gan_tpu_torch.ops import composite as tcomp

import chip_smoke
from test_torch_composite_plans import emulated_composite
from test_torch_grads import emulate_kernels

torch.set_num_threads(1)

TOL_PALLAS = dict(rtol=1e-4, atol=1e-5)


def _case(name):
    rng = np.random.RandomState(0)
    if name == 'pallas_test':          # the JAX package's own case
        layers = rng.rand(2, 5, 64, 64, 4).astype(np.float32)
        layers[:, 0, ..., 3] = 0.0
        return layers, rng.uniform(-0.9, 0.9, (2, 5, 2)).astype(np.float32), \
            0.0, 32
    # odd sizes, shifts of exactly ±1 and beyond (clamped), an alpha-0
    # layer, a non-zero fill; one tile of 67 rows
    layers = rng.rand(3, 5, 67, 45, 4).astype(np.float32)
    layers[:, 2, ..., 3] = 0.0
    t = np.array([[1.0, -1.0], [-1.0, 1.0], [1.7, -2.3], [0.0, 0.0],
                  [-0.31, 0.77]], np.float32)
    return layers, np.repeat(t[None], 3, 0), 0.3, 67


@pytest.mark.parametrize('name', ['pallas_test', 'odd'])
def test_fused_matches_pallas_interpret(name, monkeypatch):
    layers, t, pad, tile_h = _case(name)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(translate_and_composite_pallas(
            jnp.asarray(layers), jnp.asarray(t), pad_value=pad,
            tile_h=tile_h))
    lt, tt = torch.from_numpy(layers), torch.from_numpy(t)
    plain = tcomp.translate_and_composite_fused(lt, tt, pad)
    np.testing.assert_allclose(plain.numpy(), ref, **TOL_PALLAS)
    kernels = emulate_kernels(monkeypatch)
    out = tcomp.translate_and_composite_fused(lt, tt, pad)
    assert kernels['composite'].launches == 1
    assert dict(kernels['composite'].variants) == {'tiled': 1}
    np.testing.assert_allclose(out.numpy(), ref, **TOL_PALLAS)
    torch.testing.assert_close(chip_smoke.premultiplied(out),
                               chip_smoke.premultiplied(plain),
                               **chip_smoke.TOL_COMPOSITE)


def test_fused_is_forward_only_and_premultiplied_check(monkeypatch):
    """On the kernel path a tensor that requires grad raises; and where
    alpha is small the plain version's straight colour is off by far more
    than the recurrence's, which the premultiplied comparison absorbs."""
    layers = torch.zeros(1, 3, 8, 8, 4)     # one layer: colour 0.9, alpha 1e-5
    layers[:, 1, ..., :3] = 0.9
    layers[:, 1, ..., 3] = 1e-5
    t = torch.zeros(1, 3, 2)
    plain = tcomp.translate_and_composite_fused(layers, t)
    emulate_kernels(monkeypatch)
    with pytest.raises(RuntimeError, match='forward only'):
        tcomp.translate_and_composite_fused(layers.requires_grad_(True), t)
    out = tcomp.translate_and_composite_fused(layers.detach(), t)
    truth = emulated_composite(layers.detach().double(), t.double())
    assert (out.double() - truth).abs().max() < 1e-6
    assert (plain.double() - truth).abs().max() > 1e-4
    torch.testing.assert_close(chip_smoke.premultiplied(out),
                               chip_smoke.premultiplied(plain),
                               **chip_smoke.TOL_COMPOSITE)
