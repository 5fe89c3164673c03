"""The port's networks (``montage_gan_tpu_torch.models``) against the JAX
package's on the CPU: JAX variables from a seeded init (with the zero-init
biases, noise strengths and w_avg given random values so every term is
exercised) cross into the port through ``utils.weights``; the same numpy
inputs go through both.

Tolerances: float32 ``atol 1e-4`` (convolutions and matmuls sum in another
order); bfloat16 blocks ``atol 3e-2`` (bfloat16 rounds at other places in
the two frameworks).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from montage_gan_tpu.models import layers as jlayers
from montage_gan_tpu.models import mapping as jmapping
from montage_gan_tpu.models import stn as jstn
from montage_gan_tpu.models import synthesis as jsyn
from montage_gan_tpu.utils.calc_res import calc_init_res as j_calc_init_res
from montage_gan_tpu_torch.models import layers as tlayers
from montage_gan_tpu_torch.models import mapping as tmapping
from montage_gan_tpu_torch.models import stn as tstn
from montage_gan_tpu_torch.models import synthesis as tsyn
from montage_gan_tpu_torch.utils import weights
from montage_gan_tpu_torch.utils.calc_res import calc_init_res

from test_torch_train import FAST_COMPILE

torch.set_num_threads(1)

ATOL = 1e-4
ATOL_BF16 = 3e-2


def _jit(fn, **static):
    return jax.jit(functools.partial(fn, **static),
                   compiler_options=FAST_COMPILE)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _perturb(variables, names, seed, scale=0.1):
    """Give the leaves called ``names`` random values (a copy)."""
    rng = np.random.RandomState(seed)

    def f(path, leaf):
        if getattr(path[-1], 'key', None) in names:
            return jnp.asarray(np.asarray(rng.randn(*np.shape(leaf)) * scale,
                                          np.float32))
        return leaf
    return jax.tree_util.tree_map_with_path(f, variables)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(port.detach().float().numpy(),
                               np.asarray(ref, np.float32), rtol=0, atol=atol)


def test_calc_init_res_matches_jax():
    for shape in [(256, 256), (160, 224), (96, 160), (64, 96), (64, 32),
                  (64, 160), (16, 8), (32, 32), (48, 200)]:
        for cci in (2, 3):
            assert calc_init_res(list(shape), conv_config_index=cci) == \
                j_calc_init_res(list(shape), conv_config_index=cci)


@pytest.mark.parametrize('global_mapping', [False, True])
def test_mapping_with_truncation_matches_jax(global_mapping):
    kw = dict(z_dim=16, w_dim=8, num_ws=5, num_layers=2)
    if global_mapping:
        jnet = jmapping.GlobalMappingNetwork(num_splits=3, **kw)
        tnet = tmapping.GlobalMappingNetwork(num_splits=3, **kw)
    else:
        jnet = jmapping.MappingNetwork(**kw)
        tnet = tmapping.MappingNetwork(**kw)
    z = np.random.RandomState(0).randn(4, 16).astype(np.float32)
    variables = _jit(jnet.init)({'params': jax.random.PRNGKey(0)},
                                jnp.asarray(z))
    variables = _perturb(variables, ('bias', 'w_avg'), seed=1)
    ref = _jit(jnet.apply, truncation_psi=0.7)(variables, jnp.asarray(z))
    tnet.load_state_dict(weights.mapping_state_dict(_np_tree(variables)))
    out = tnet(torch.from_numpy(z), truncation_psi=0.7)
    assert out.shape == ref.shape
    _close(out, ref, atol=1e-5)


@pytest.mark.parametrize('num_fp16_res,atol', [(0, ATOL), (2, ATOL_BF16)])
def test_nonsquare_synthesis_matches_jax(num_fp16_res, atol):
    init_res, res, _ = calc_init_res([16, 8], conv_config_index=2)
    kw = dict(img_resolution=res, img_channels=4, w_dim=16,
              init_res=tuple(init_res), conv_config_index=2, channel_base=256,
              channel_max=32, num_fp16_res=num_fp16_res, conv_clamp=256)
    jnet = jsyn.SynthesisNetwork(**kw)
    tnet = tsyn.SynthesisNetwork(**kw)
    ws = np.random.RandomState(0).randn(2, tnet.num_ws, 16).astype(np.float32)
    variables = _jit(jnet.init, noise_mode='const')(
        {'params': jax.random.PRNGKey(0), 'noise': jax.random.PRNGKey(1)},
        jnp.asarray(ws))
    variables = _perturb(variables, ('bias', 'noise_strength'), seed=2)
    tnet.load_state_dict(weights.synthesis_state_dict(_np_tree(variables)))
    for mode in ('const', 'none'):
        ref = _jit(jnet.apply, noise_mode=mode)(variables, jnp.asarray(ws))
        out = tnet(torch.from_numpy(ws), noise_mode=mode)
        assert out.shape == ref.shape == (2, 16, 8, 4)
        assert out.dtype == torch.float32
        _close(out, ref, atol=atol)


def test_stn_with_translation_matches_jax():
    jnet = jstn.STN(img_resolution=32, img_channels=4, img_layers=3,
                    num_stages=2)
    tnet = tstn.STN(img_resolution=32, img_channels=4, img_layers=3,
                    num_stages=2)
    x = np.random.RandomState(0).uniform(-1, 1, (2, 3, 32, 32, 4)) \
        .astype(np.float32)
    variables = _jit(jnet.init)({'params': jax.random.PRNGKey(0)},
                                jnp.asarray(x))
    # a non-zero translation head (it is zero-initialised)
    variables = _perturb(variables, ('bias',), seed=3, scale=0.3)
    variables = jax.tree_util.tree_map_with_path(
        lambda p, a: a + 0.01 if 'Dense_1' in str(p) and 'kernel' in str(p)
        else a, variables)
    ref_moved, ref_theta = _jit(jnet.apply)(variables, jnp.asarray(x))
    assert float(jnp.abs(ref_theta[..., 2]).max()) > 0.05
    tnet.load_state_dict(weights.stn_state_dict(_np_tree(variables)))
    moved, theta = tnet(torch.from_numpy(x))
    _close(theta, ref_theta, atol=1e-5)
    _close(moved, ref_moved, atol=ATOL)


def test_conv2d_layer_down_matches_jax():
    jnet = jlayers.Conv2dLayer(out_channels=6, kernel_size=3,
                               activation='lrelu', down=2, conv_clamp=256)
    tnet = tlayers.Conv2dLayer(5, 6, kernel_size=3, activation='lrelu',
                               down=2, conv_clamp=256)
    x = np.random.RandomState(0).randn(2, 8, 10, 5).astype(np.float32)
    variables = _perturb(_jit(jnet.init)({'params': jax.random.PRNGKey(0)},
                                         jnp.asarray(x)), ('bias',), seed=4)
    p = _np_tree(variables)['params']
    tnet.load_state_dict({'weight': torch.from_numpy(
                              p['weight'].transpose(3, 2, 0, 1).copy()),
                          'bias': torch.from_numpy(p['bias']),
                          'resample_filter': tnet.resample_filter},
                         strict=True)
    ref = _jit(jnet.apply)(variables, jnp.asarray(x))
    _close(tnet(torch.from_numpy(x)), ref)
