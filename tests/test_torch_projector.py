"""The port's projector against the JAX package's, on the CPU.

One JAX ``projector`` CLI run of 4 steps with ``--optimize-noise`` and the
random-feature distance (no VGG16 weights are found) on the small ensemble
of ``test_torch_tools.py``; the port's CLI takes the same target and steps
with JAX's draws injected (``ProjectorDraws``: the 10,000 z of the w
statistics, each noise buffer's start, each step's w noise) and the JAX
feature pyramid's weights.  The target is 10×12, so both CLIs resize it
(the port's resize is PIL's LANCZOS, bit for bit, checked here too).  Each
JAX step's result (w, Adam's moments, the distance) is read from its jitted
step function, the port's from ``Projector.step``.

Tolerances: each step's distance within 1e-4 relative (measured 1.4e-5);
step 0's gradients (Adam's first moment, 0.1 g) of w and of every noise
buffer within 1e-4 of their largest entry (measured 4.2e-6 for w);
``projected_w.npz`` within 1e-4 of its largest entry (measured 3.3e-6);
``proj.png`` within 1 of 255 (measured 0); the resized ``target.png``
exactly.

The comparison is well-posed on this ensemble, not on every one: Adam moves
each entry of w by about the learning rate (0.1) whatever its gradient's
size, so where the gradient is ill-conditioned the float32 summation order
of the two frameworks grows step by step.  On ``test_torch_slice``'s micro
ensemble (three layers of 32 px) a 1e-6 relative nudge of the target moves
the port's own w by 2.8e-6, 4.8e-5 and 2.2e-4 after steps 1-3, and JAX's
and the port's w end 2.3e-3 of its largest entry apart; here the same nudge
moves w by at most 1.6e-6 of its largest entry.
"""

import numpy as np
import pytest

import jax
import torch

from montage_gan_tpu.metrics import features as jfeat
from montage_gan_tpu_torch.cli import projector as tproj
from montage_gan_tpu_torch.tools.launches import expected_projector_launches
from montage_gan_tpu_torch.utils import checkpoint as tckpt
from montage_gan_tpu_torch.utils.image_utils import resize_lanczos_rgba
from montage_gan_tpu_torch.utils.png import read_png_rgba, write_png_rgba
from montage_gan_tpu_torch.utils.weights import random_features_from_jax

from test_torch_grads import emulate_kernels
from montage_gan_tpu.models.ensemble import MontageEnsemble as JaxEnsemble
from montage_gan_tpu.models.stn import STN as JaxSTN
from test_torch_slice import _shaped_snapshot_template
from test_torch_tools import (fast_jit, jit_eager, port_model,  # noqa: F401
                              run_jax_cli, small, snapshot)

torch.set_num_threads(1)

SEED = 5
STEPS = 4


def jax_draws(model, seed):
    """The JAX projector's draws for ``model``'s shapes: z from
    ``PRNGKey(seed)``, each noise buffer from ``fold_in(PRNGKey(seed + 7),
    its size)``, step i's w noise from ``fold_in(PRNGKey(seed + 1), i)``."""
    cfg = model.cfg
    z = jax.random.normal(jax.random.PRNGKey(seed),
                          (tproj.W_STAT_SAMPLES, cfg.z_dim))
    key_n, key_w = jax.random.PRNGKey(seed + 7), jax.random.PRNGKey(seed + 1)
    noise = {name: torch.from_numpy(np.array(jax.random.normal(
                 jax.random.fold_in(key_n, buf.numel()), tuple(buf.shape))))
             for name, buf in tproj.noise_buffers(model).items()}
    w_shape = (1, cfg.num_layers, model.num_ws, cfg.w_dim)
    return tproj.ProjectorDraws(
        torch.from_numpy(np.array(z)), noise,
        lambda i: torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(key_w, i), w_shape))))


_PYRAMIDS = {}


def jax_extractor(monkeypatch=None):
    """The JAX projector's distance features, ``RandomFeatures(seed=1)``,
    with the weights it builds for RGB.  With ``monkeypatch``, every JAX
    ``RandomFeatures`` of these parameters reuses them (their eager build
    draws each weight on its own, seconds a pyramid)."""
    build = jfeat.RandomFeatures._build

    def cached(self, channels):
        key = (self.seed, self.num_stages, self.width, self.feature_dim,
               channels)
        if key not in _PYRAMIDS:
            build(self, channels)
            _PYRAMIDS[key] = (self._params, self._apply)
        self._params, self._apply = _PYRAMIDS[key]
    if monkeypatch is not None:
        monkeypatch.setattr(jfeat.RandomFeatures, '_build', cached)
    ex = jfeat.RandomFeatures(seed=1)
    cached(ex, 3)
    return ex


@pytest.fixture
def target(tmp_path):
    rng = np.random.RandomState(3)
    u8 = rng.randint(0, 256, (12, 10, 4)).astype(np.uint8)
    u8[..., 3] = np.where(rng.uniform(size=(12, 10)) < 0.3, 255,
                          u8[..., 3])
    path = str(tmp_path / 'target.png')
    write_png_rgba(path, u8)
    return path


def jax_noise_leaves(tree):
    """A JAX per-layer noise tuple (``tree['local_g'][i]['noise']``-shaped)
    → {the port's buffer name: array}."""
    out = {}
    for i, t in enumerate(tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(t)[0]:
            keys = '.'.join(p.key for p in path)
            out[f'local_g.{i}.{keys}'] = np.asarray(leaf)
    return out


def test_projector_cli_matches_jax(snapshot, target, tmp_path, monkeypatch):
    from montage_gan_tpu.cli.projector import main as jax_main

    monkeypatch.setenv('MGT_WEIGHTS_DIR', str(tmp_path / 'no-weights'))
    monkeypatch.delenv('MGT_VGG16_WEIGHTS', raising=False)
    ex = jax_extractor(monkeypatch)
    _shaped_snapshot_template(monkeypatch)
    jax_steps = []
    fast_jit(monkeypatch, record=jax_steps)
    jit_eager(monkeypatch, JaxEnsemble, 'synthesize_layers')
    jit_eager(monkeypatch, JaxSTN, 'apply')
    args = ['--network', snapshot, '--target', target, '--num-steps',
            str(STEPS), '--seed', str(SEED), '--optimize-noise']
    run_jax_cli(jax_main, args + ['--outdir', str(tmp_path / 'jax')])
    jax_steps = [r for r in jax_steps if isinstance(r, tuple) and len(r) == 3]
    assert len(jax_steps) == STEPS

    model = tckpt.load_network(snapshot, device='cpu')[1]
    draws = jax_draws(model, SEED)
    monkeypatch.setattr(tproj, 'projector_extractor',
                        lambda device: ex_port(ex))
    monkeypatch.setattr(tproj, 'default_draws', lambda model, seed: draws)
    port_steps = []
    step = tproj.Projector.step

    def record(self, i, num_steps):
        loss = step(self, i, num_steps)
        state = self.optimizer.state
        port_steps.append((self.w.detach().clone(), loss,
                           {name: state[t]['exp_avg'].clone() for name, t
                            in [('w', self.w), *self.noise.items()]}))
        return loss
    monkeypatch.setattr(tproj.Projector, 'step', record)
    result = tproj.main(args + ['--outdir', str(tmp_path / 'port'),
                                '--device', 'cpu'])
    assert len(port_steps) == STEPS and len(result.noise) == 6

    # each step's distance; step 0's gradients
    for (jp, jopt, jloss), (w, loss, _) in zip(jax_steps, port_steps):
        assert abs(loss.item() - float(jloss)) <= 1e-4 * abs(float(jloss))
    mu = jax_steps[0][1][0].mu
    ref_mu = {'w': np.asarray(mu['w']), **jax_noise_leaves(mu['noise'])}
    assert sorted(ref_mu) == sorted(port_steps[0][2])
    for name, ref in ref_mu.items():
        np.testing.assert_allclose(port_steps[0][2][name].numpy(), ref,
                                   rtol=0, atol=1e-4 * np.abs(ref).max(),
                                   err_msg=name)

    ref_w = np.load(tmp_path / 'jax' / 'projected_w.npz')['w']
    w = np.load(tmp_path / 'port' / 'projected_w.npz')['w']
    assert w.shape == ref_w.shape == (1, 2, 4, 16)
    np.testing.assert_allclose(w, ref_w, rtol=0,
                               atol=1e-4 * np.abs(ref_w).max())
    with torch.no_grad():                     # w moved from its start
        w_avg = model.mapping(draws.z).mean(0).numpy()
    assert np.abs(w - w_avg).max() > 1e-2
    for name in ('proj.png', 'target.png'):
        ref = read_png_rgba(str(tmp_path / 'jax' / name)).astype(np.int16)
        out = read_png_rgba(str(tmp_path / 'port' / name)).astype(np.int16)
        assert out.shape == ref.shape == (8, 8, 4)
        assert np.abs(out - ref).max() <= (1 if name == 'proj.png' else 0)


def ex_port(ex):
    return random_features_from_jax(ex._params, device='cpu')


def test_lanczos_resize_matches_pil():
    from PIL import Image
    rng = np.random.RandomState(0)
    for (h, w), (oh, ow) in (((36, 40), (32, 32)), ((17, 50), (61, 9)),
                             ((8, 8), (256, 256)), ((300, 7), (299, 7))):
        u8 = rng.randint(0, 256, (h, w, 4)).astype(np.uint8)
        u8[..., 3] = rng.choice([0, 7, 128, 255], (h, w))
        ref = np.asarray(Image.fromarray(u8, 'RGBA').resize(
            (ow, oh), Image.LANCZOS))
        np.testing.assert_array_equal(resize_lanczos_rgba(u8, ow, oh), ref)
    same = resize_lanczos_rgba(u8, 7, 300)
    assert np.array_equal(same, u8) and same is not u8


def test_projector_launches_each_kernel_as_expected(small, monkeypatch):
    """Through the kernels' autograd Functions (each kernel replaced by its
    emulation, ``test_torch_grads.emulate_kernels``): the launches of a
    2-step projection, with ``layer_idx`` (every net still runs its
    backward), equal ``expected_projector_launches``; the model's buffers
    are left as they were."""
    _, model = port_model(small[2])
    before = {k: v.clone() for k, v in model.state_dict().items()}
    kernels = emulate_kernels(monkeypatch)
    result = tproj.project(model, torch.rand(1, 8, 8, 4), num_steps=2,
                           seed=1, layer_idx=1,
                           extractor=ex_port(jax_extractor(monkeypatch)))
    got = {k: kernels[k].launches for k in ('bias_act', 'bias_act_grad',
                                             'upfirdn2d')}
    assert got == expected_projector_launches(model, 2)
    assert got['bias_act_grad'] > 0
    assert all(torch.equal(v, before[k]) for k, v in
               model.state_dict().items())
    assert torch.isfinite(result.losses).all()


def test_projector_noise_regularizer_and_schedule():
    n = torch.randn(16, 12, generator=torch.Generator().manual_seed(0))
    # offsets along each axis at 16×12, then 8×6 (the last, ≤ 8)
    ref = 0.0
    for x in (n, torch.nn.functional.avg_pool2d(n[None, None], 2)[0, 0]):
        ref += (x * torch.roll(x, 1, 1)).mean() ** 2
        ref += (x * torch.roll(x, 1, 0)).mean() ** 2
    torch.testing.assert_close(tproj.noise_reg([n]), ref)
    assert tproj.Projector.schedule(0, 100)[1] == 0.0
    assert tproj.Projector.schedule(50, 100) == (
        pytest.approx(0.05 * (1 - 0.5 / 0.75) ** 2), pytest.approx(0.1))


def test_projector_save_video_waits(tmp_path):
    with pytest.raises(NotImplementedError, match='item 5'):
        tproj.main(['--network', 'x.pt', '--target', 'x.png', '--outdir',
                    str(tmp_path), '--save-video', '--device', 'cpu'])
