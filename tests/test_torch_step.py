"""One local-phase training step of the port against the JAX package's, on the
CPU, and the kernels' launch counts along the step.

The micro ensemble of ``test_torch_train`` (2 layers, one non-square) runs
step 0, where all four phases run for each layer (Gmain, Greg, Dmain, Dr1),
then EMA and the ADA controller (``ada_interval=1``, so it fires), in
``MontageTrainer.train_step`` and in JAX's ``partial_step(do_global=False,
do_renderer=False)``.  The draws are injected through the port's ``Draws``
seam: z and the path-length noise of each phase are JAX's own, from the keys
``train_step.py`` folds (phase ``4·layer + 1 … 4``) and ``losses.py``
splits; the synthesis noise is the fixed per-shape field of
``test_torch_train``.  The augment pipe here is the colour stage at p = 0
(the ADA controller needs a pipe, and its target is set below every mean
sign so that it moves p; the whole pipe is held to JAX in
``test_torch_train``, and its warp-heavy program would take JAX over a
minute to compile).

Adam's first step is ``lr · sign(g)``, so an entry whose gradient is tiny
next to its tensor's largest can flip on rounding.  Entries where a phase's
gradient (the port's, recorded in the step; the loss tests hold it to
JAX's) is below 1e-6 of its tensor's largest are left out of the parameter
comparison, and counted.

Tolerances: parameters, EMA, w_avg and pl_mean ``atol 2e-5`` (one or two
Adam steps of lr 0.0025 on gradients equal to ~1e-4); stats ``rtol 1e-4``.
Step 1 is held to JAX's too (the same jitted program called again): its
parameters and EMA within ``2e-5`` per step taken, since each step's update
may differ by that much (an entry whose gradient is small next to its
tensor's largest carries a larger relative error into Adam's quotient).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from montage_gan_tpu.training import augment as jaug
from montage_gan_tpu.training import train_step as jtrain
from montage_gan_tpu_torch.training import augment as taug
from montage_gan_tpu_torch.training import train_step as ttrain
from montage_gan_tpu_torch.utils import weights

import chip_smoke
from test_torch_grads import emulate_kernels
from test_torch_train import (BATCH, FAST_COMPILE, InjectedDraws,
                              inject_jax_synthesis_noise, jax_micro,
                              port_ensemble)

torch.set_num_threads(1)

# p = 0 keeps the pipe's random gates off; the ADA target below every mean
# sign makes the controller raise p at the end of the step.
HYPER = dict(batch_size=BATCH, train_global=False, train_renderer=False,
             style_mixing_prob=0.0, augment_p_init=0.0, ada_interval=1,
             ada_target=-2.0)
ATOL = 2e-5
SMALL_GRAD = 1e-6


def _crops(cfg):
    rng = np.random.RandomState(9)
    return [rng.uniform(-1, 1, (BATCH, h, w, 4)).astype(np.float32)
            for h, w in cfg.layer_targets]


def _jax_draws(cfg, key, step=0):
    """z per phase and path-length noise per layer, in the port's order
    (step 0 runs Gmain, Greg and Dmain with a z each; step 1 Gmain and
    Dmain)."""
    z, pl = [], []
    for i, (th, tw) in enumerate(cfg.layer_targets):
        phases = (1, 2, 3) if step == 0 else (1, 3)
        for idx in (4 * i + p for p in phases):    # Gmain, Greg, Dmain
            k = jax.random.fold_in(key, idx)
            z.append(np.array(jax.random.normal(jax.random.fold_in(k, 0),
                                                (BATCH, cfg.z_dim))))
            if idx == 4 * i + 2:
                k_pl = jax.random.split(jax.random.fold_in(k, 1), 3)[2]
                pl.append(np.array(jax.random.normal(
                    k_pl, (BATCH // 2, th, tw, 4))))
    return z, pl


def record_grads(monkeypatch):
    """For each parameter, the smallest |gradient| / (tensor's largest)
    over the phases of the step, per entry."""
    ratio = {}
    orig = ttrain._apply_grads

    def apply_grads(opt, params, grads):
        # read the gradients the step computes as the optimizer takes them,
        # so that nothing is differentiated (or launched) twice
        step = opt.step

        def recording_step():
            for p in params:
                # an entry the phase does not reach (gradient exactly 0, as
                # the mapping rows of another layer's ws) does not move
                g = p.grad.abs()
                r = torch.where(g == 0, 1.0, g / g.max().clamp(min=1e-30))
                ratio[id(p)] = torch.minimum(ratio.get(id(p), r), r)
            step()
        opt.step = recording_step
        try:
            orig(opt, params, grads)
        finally:
            del opt.step
    monkeypatch.setattr(ttrain, '_apply_grads', apply_grads)
    return ratio


@pytest.fixture(scope='module')
def jax_step():
    cfg, ens, variables, np_tree = jax_micro()
    mp = pytest.MonkeyPatch()
    inject_jax_synthesis_noise(mp)
    hyper = jtrain.TrainHyper(augment=jaug.AugmentConfig(brightness=1),
                              **HYPER)
    trainer = jtrain.MontageTrainer(ens, hyper)
    state = trainer.state_from_variables(variables)
    crops = tuple(jnp.asarray(c) for c in _crops(cfg))
    stack = jnp.zeros((BATCH, cfg.num_layers, cfg.base_resolution,
                       cfg.base_resolution, 4))
    key, key1 = jax.random.PRNGKey(11), jax.random.PRNGKey(13)
    step = jax.jit(lambda s, c, k: trainer.partial_step(
        s, stack, c, k, do_global=False, do_renderer=False),
        compiler_options=FAST_COMPILE)
    new_state, stats = step(state, crops, key)
    # step 1 (Gmain and Dmain): the same program, no new compile
    state1, stats1 = step(new_state, crops, key1)
    mp.undo()
    return cfg, np_tree, (key, key1), (new_state, state1), (stats, stats1)


def _port_step(cfg, np_tree, keys, monkeypatch):
    """The port's steps 0 .. len(keys) - 1 with JAX's draws."""
    tens = port_ensemble(np_tree)
    hyper = ttrain.TrainHyper(augment=taug.AugmentConfig(brightness=1),
                              **HYPER)
    trainer = ttrain.MontageTrainer(tens, hyper, device='cpu')
    state = trainer.state_from_variables(tens.state_dict())
    ratio = record_grads(monkeypatch)
    for step, key in enumerate(keys):
        z, pl = _jax_draws(cfg, key, step)
        state, stats = trainer.train_step(state, None, _crops(cfg),
                                          InjectedDraws(z=z, pl_noise=pl))
    return tens, state, stats, ratio


def test_train_step_matches_jax(jax_step, monkeypatch):
    cfg, np_tree, keys, jstates, jstats = jax_step
    _check_step(cfg, np_tree, keys[:1], jstates[0], jstats[0], monkeypatch)


def test_train_step_1_matches_jax(jax_step, monkeypatch):
    """Step 1 (Gmain and Dmain after step 0): Adam's second step is no
    longer ``lr · sign(g)``, so this holds the second moments and the
    lazy-regularization β's (``mb_ratio``) to optax's."""
    cfg, np_tree, keys, jstates, jstats = jax_step
    _check_step(cfg, np_tree, keys, jstates[1], jstats[1], monkeypatch)


def _check_step(cfg, np_tree, keys, jstate, jstats, monkeypatch):
    tens, state, stats, ratio = _port_step(cfg, np_tree, keys, monkeypatch)
    atol = ATOL * len(keys)

    assert state.step == int(jstate.step) == len(keys)
    assert set(stats) == set(jstats)
    for k, v in stats.items():
        np.testing.assert_allclose(float(v), float(jstats[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(state.pl_mean.numpy(),
                               np.asarray(jstate.pl_mean), rtol=0, atol=atol)
    np.testing.assert_allclose(state.aug_p.numpy(), np.asarray(jstate.aug_p),
                               rtol=0, atol=1e-9)
    assert (np.asarray(jstate.aug_p)[:2] > 0).all()
    np.testing.assert_allclose(
        tens.mapping.w_avg.numpy(),
        np.asarray(jstate.variables['mapping']['moving_stats']['w_avg']),
        rtol=0, atol=1e-6)

    ref = weights.state_dict_from_jax(cfg, jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32), jstate.variables))
    ref_ema = weights.state_dict_from_jax(cfg, jax.tree_util.tree_map(
        lambda a: np.array(a, np.float32), jstate.ema))
    left_out = total = 0
    for name, p in tens.named_parameters():
        keep = ratio[id(p)] >= SMALL_GRAD
        left_out += int((~keep).sum())
        total += p.numel()
        diff = (p.detach() - ref[name]).abs()
        assert diff[keep].max() <= atol, (name, diff[keep].max())
    for name, p in state.ema.named_parameters():
        diff = (p - ref_ema[name]).abs()
        assert diff.max() <= atol, (name, diff.max())
    # the step moved every tensor, and few entries had tiny gradients
    print(f'{left_out} of {total} parameter entries left out '
          f'(|grad| < {SMALL_GRAD} of the tensor\'s largest)')
    assert left_out <= 1e-3 * total


def test_train_step_kernel_path_and_launches(monkeypatch):
    """The step through the kernels' autograd Functions (emulated kernels)
    equals the plain step, over steps 0 (all phases) and 1 (Gmain, Dmain),
    and launches each kernel as often as chip_smoke.py expects on the
    card."""
    cfg, _, _, np_tree = jax_micro()
    hyper = ttrain.TrainHyper(augment=taug.make_augment_config('bgcfnc'),
                              **{**HYPER, 'augment_p_init': 0.6,
                                 'ada_interval': 4})
    crops = _crops(cfg)

    def run():
        tens = port_ensemble(np_tree)
        trainer = ttrain.MontageTrainer(tens, hyper, device='cpu')
        state = trainer.state_from_variables(tens.state_dict())
        draws = InjectedDraws()
        for _ in range(2):
            state, _ = trainer.train_step(state, None, crops, draws)
        return tens

    plain = run()
    kernels = emulate_kernels(monkeypatch)
    ratio = record_grads(monkeypatch)
    emulated = run()
    expect = chip_smoke.expected_train_launches(emulated, hyper, 2)
    assert {k: kernels[k].launches for k in expect} == expect
    # the ToRGB skip and its gradients take K2''s tiled variants only, and
    # the ADA warp (RGBA, up 2, 12 taps) K3''s and K4''s
    assert kernels['upfirdn2d'].variants['generic'] == 0
    for k in ('warp_forward', 'warp_transpose'):
        assert kernels[k].variants['direct'] == 0
        assert kernels[k].variants['tiled'] == kernels[k].launches > 0
    ref = dict(plain.named_parameters())
    for name, p in emulated.named_parameters():
        keep = ratio[id(p)] >= SMALL_GRAD
        diff = (p - ref[name]).detach().abs()
        assert diff[keep].max() <= ATOL, (name, diff[keep].max())
