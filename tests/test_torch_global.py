"""The port's renderer, global and renderer-phase training modules against the
JAX package's, on the CPU.

A micro ensemble (2 layers, one non-square, base 8, one STN stage, the tanh
renderer and the global D) is initialised in JAX, with the zero-initialised
biases, noise strengths, w_avg and the STN's last FC given random values,
and crosses into the port through ``utils.weights.state_dict_from_jax``.
The draws are injected as in ``test_torch_train``: z is an argument (or, in
the step, JAX's own draw from the phase's key), the synthesis noise is a
fixed field per shape, style mixing is off and the augment pipe runs at
p = 0 (its gates off).

Tolerances: forwards and loss values ``rtol 1e-4, atol 1e-5`` (float32 sums
in another order); gradients per tensor within ``1e-3`` of the tensor's
largest JAX gradient, as in ``test_torch_train``; AMSGrad ``atol 1e-7`` on
parameters of order 1 moved by steps of 1e-3 (rounding of a few float32
operations); the step as in ``test_torch_step``.
"""

import functools

import numpy as np
import optax
import pytest

import jax
import jax.numpy as jnp
import torch

from montage_gan_tpu.models import renderer as jrenderer
from montage_gan_tpu.models.ensemble import MontageConfig as JaxConfig
from montage_gan_tpu.models.ensemble import MontageEnsemble as JaxEnsemble
from montage_gan_tpu.training import augment as jaug
from montage_gan_tpu.training import losses as jlosses
from montage_gan_tpu.training import train_step as jtrain
from montage_gan_tpu.utils import torch_export
from montage_gan_tpu_torch.models import renderer as trenderer
from montage_gan_tpu_torch.models.ensemble import MontageConfig, MontageEnsemble
from montage_gan_tpu_torch.training import augment as taug
from montage_gan_tpu_torch.training import losses as tlosses
from montage_gan_tpu_torch.training import train_step as ttrain
from montage_gan_tpu_torch.utils import weights

import chip_smoke
from test_torch_grads import emulate_kernels
from test_torch_step import ATOL, SMALL_GRAD, record_grads
from test_torch_train import (FAST_COMPILE, MICRO, InjectedDraws,
                              _assert_grads, _np, _perturb,
                              inject_jax_synthesis_noise)

torch.set_num_threads(1)

MICRO_GLOBAL = {**MICRO, 'train_global': True, 'renderer_type': 'tanh',
                'stn_stages': 1}
BATCH = 4
TOL = dict(rtol=1e-4, atol=1e-5)


@functools.lru_cache(maxsize=None)
def jax_micro_global():
    """(config, JAX ensemble, variables with the zero-init leaves made
    random, the same as numpy arrays); built once per process, read only."""
    cfg = JaxConfig(**MICRO_GLOBAL)
    ens = JaxEnsemble(cfg)
    init = jax.jit(lambda k: ens.init_variables(k, on_cpu=False),
                   compiler_options=FAST_COMPILE)
    variables = _perturb(init(jax.random.PRNGKey(3)), seed=4)
    # the STN's zero-initialised last kernel: shifts that depend on the input
    kernel = variables['stn']['params']['Dense_1']['kernel']
    kernel = jnp.asarray(np.random.RandomState(5).randn(*kernel.shape)
                         .astype(np.float32) * 0.1)
    variables['stn']['params']['Dense_1']['kernel'] = kernel
    return cfg, ens, variables, _np(variables)


@pytest.fixture(scope='module')
def micro():
    return jax_micro_global()


def port_ensemble(np_tree):
    cfg = MontageConfig(**MICRO_GLOBAL)
    tens = MontageEnsemble(cfg, with_d=True)
    tens.load_state_dict(weights.state_dict_from_jax(cfg, np_tree))
    return tens


def _inputs(cfg, seed):
    rng = np.random.RandomState(seed)
    z = rng.randn(BATCH, cfg.z_dim).astype(np.float32)
    stack = rng.uniform(-1, 1, (BATCH, cfg.num_layers, cfg.base_resolution,
                                cfg.base_resolution, 4)).astype(np.float32)
    return z, stack


# ---------------------------------------------------------------------------
# The renderer and the weight bridge
# ---------------------------------------------------------------------------

RENDERERS = {'tanh': (dict(img_resolution=8, img_layers=2, nf=8), 2, 8),
             'subpixel': (dict(img_resolution=6, img_layers=9, nf1=4, nf2=8),
                          9, 6)}


@pytest.mark.parametrize('kind', sorted(RENDERERS))
def test_renderer_matches_jax(kind):
    """The forward, and the bridge of the weights key for key with
    ``torch_export.renderer_state_dict``."""
    kw, layers, res = RENDERERS[kind]
    jnet = jrenderer.build_renderer(kind, **kw)
    tnet = trenderer.build_renderer(kind, **kw)
    x = np.random.RandomState(0).uniform(
        -1, 1, (2, layers, res, res, 4)).astype(np.float32)
    variables = _np(jax.jit(jnet.init, compiler_options=FAST_COMPILE)(
        jax.random.PRNGKey(1), jnp.asarray(x)))
    sd = weights.renderer_state_dict(variables, kind)
    ref_sd = torch_export.renderer_state_dict(variables, kind)
    assert list(sd) == list(ref_sd) == list(tnet.state_dict())
    for k in ref_sd:
        assert torch.equal(sd[k], ref_sd[k]), k
    tnet.load_state_dict(sd)
    ref = jax.jit(jnet.apply, compiler_options=FAST_COMPILE)(
        variables, jnp.asarray(x))
    out = tnet(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)


def test_state_dict_from_jax_carries_global_d_and_renderer(micro):
    cfg, _, _, np_tree = micro
    tens = port_ensemble(np_tree)
    sd = weights.state_dict_from_jax(cfg, np_tree)
    assert list(sd) == list(tens.state_dict())
    parts = {'global_d': torch_export.discriminator_state_dict(
        np_tree['global_d'], init_res=cfg.base_init_res),
        'renderer': torch_export.renderer_state_dict(np_tree['renderer'],
                                                     cfg.renderer_type)}
    for prefix, ref in parts.items():
        assert [k for k in sd if k.startswith(f'{prefix}.')] == [
            f'{prefix}.{k}' for k in ref]
        for k, v in ref.items():
            assert torch.equal(sd[f'{prefix}.{k}'], v), k
    # a snapshot without its renderer (the JAX EMA snapshot's default)
    no_r = {k: v for k, v in np_tree.items() if k != 'renderer'}
    assert not any(k.startswith('renderer.')
                   for k in weights.state_dict_from_jax(cfg, no_r))


def test_theta_constrain_loss_matches_jax():
    rng = np.random.RandomState(2)
    theta = rng.uniform(-1.6, 1.6, (2, 3, 2, 3)).astype(np.float32)
    ref, ref_g = jax.value_and_grad(jlosses.theta_constrain_loss)(
        jnp.asarray(theta))
    t = torch.from_numpy(theta).requires_grad_(True)
    out = tlosses.theta_constrain_loss(t)
    g, = torch.autograd.grad(out, t)
    np.testing.assert_allclose(out.item(), float(ref), **TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), **TOL)


# ---------------------------------------------------------------------------
# The global losses and the renderer loss
# ---------------------------------------------------------------------------

def _named_grads(tens, prefixes, loss):
    named = [(k, p) for k, p in tens.named_parameters()
             if k.startswith(prefixes)]
    grads = torch.autograd.grad(loss, [p for _, p in named],
                                allow_unused=True)
    return {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(named, grads)}


def _jax_named_grads(cfg, np_tree, grads):
    """JAX gradient trees, by module → the port's parameter names."""
    out = {}
    for name, g in grads.items():
        if name == 'mapping':
            sd = weights.mapping_state_dict({'params': _np(g)})
            out.update({f'mapping.{k}': v for k, v in sd.items()})
        elif name == 'local_g':
            for i, gi in enumerate(g):
                sd = weights.synthesis_state_dict(
                    {'params': _np(gi), 'noise': np_tree['local_g'][i]['noise']})
                out.update({f'local_g.{i}.{k}': v for k, v in sd.items()})
        elif name == 'stn':
            sd = weights.stn_state_dict({'params': _np(g)})
            out.update({f'stn.{k}': v for k, v in sd.items()})
        elif name == 'global_d':
            sd = weights.discriminator_state_dict({'params': _np(g)},
                                                  cfg.base_init_res)
            out.update({f'global_d.{k}': v for k, v in sd.items()})
        else:
            sd = weights.renderer_state_dict({'params': _np(g)},
                                             cfg.renderer_type)
            out.update({f'renderer.{k}': v for k, v in sd.items()})
    return out


@pytest.mark.parametrize('phase', ['gmain', 'dmain', 'dr1', 'renderer'])
def test_global_loss_matches_jax(phase, micro, monkeypatch):
    cfg, ens, variables, np_tree = micro
    tens = port_ensemble(np_tree)
    inject_jax_synthesis_noise(monkeypatch)
    z, stack = _inputs(cfg, 5)
    key = jax.random.PRNGKey(8)
    aug_j, aug_t = (m.AugmentConfig(brightness=1) for m in (jaug, taug))
    draws = InjectedDraws().scoped('global_')
    v = variables
    params = {'gmain': ('mapping', 'local_g', 'stn'), 'dmain': ('global_d',),
              'dr1': ('global_d',), 'renderer': ('renderer',)}[phase]

    def with_params(p):
        out = {k: dict(v[k]) for k in ('mapping', 'stn', 'global_d',
                                       'renderer')}
        out['local_g'] = tuple(v['local_g'])
        for name, tree in p.items():
            if name == 'local_g':
                out['local_g'] = tuple({**gv, 'params': gp} for gv, gp in
                                       zip(v['local_g'], tree))
            else:
                out[name] = {**v[name], 'params': tree}
        return out

    def jloss(p):
        w = with_params(p)
        if phase == 'gmain':
            return jlosses.global_gmain_loss(
                {k: w[k] for k in ('mapping', 'local_g', 'stn')}, ens,
                {'global_d': w['global_d'], 'renderer': w['renderer']},
                jnp.asarray(z), key, aug_j, jnp.float32(0.0),
                style_mixing_prob=0.0)
        if phase == 'dmain':
            return jlosses.global_dmain_loss(
                w['global_d'], ens, w, jnp.asarray(z), jnp.asarray(stack),
                key, aug_j, jnp.float32(0.0), style_mixing_prob=0.0)
        if phase == 'dr1':
            return jlosses.global_dr1_loss(
                w['global_d'], ens, w, jnp.asarray(stack), key, aug_j,
                jnp.float32(0.0))
        return jlosses.renderer_loss(w['renderer'], ens, w, jnp.asarray(z),
                                     jnp.asarray(stack), key,
                                     style_mixing_prob=0.0)

    p0 = {k: (tuple(g['params'] for g in v[k]) if k == 'local_g'
              else v[k]['params']) for k in params}
    (ref, aux), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True),
                                compiler_options=FAST_COMPILE)(p0)
    zt, st = torch.from_numpy(z), torch.from_numpy(stack)
    if phase == 'gmain':
        loss, stats = tlosses.global_gmain_loss(tens, zt, draws, aug_t, 0.0,
                                                style_mixing_prob=0.0)
    elif phase == 'dmain':
        loss, stats, sign = tlosses.global_dmain_loss(
            tens, zt, st, draws, aug_t, 0.0, style_mixing_prob=0.0)
    elif phase == 'dr1':
        loss, stats, sign = tlosses.global_dr1_loss(tens, st, draws, aug_t,
                                                    0.0)
    else:
        loss, stats = tlosses.renderer_loss(tens, zt, st, draws,
                                            style_mixing_prob=0.0)
    if phase in ('dmain', 'dr1'):
        assert float(sign) == float(aux['sign_real'])
    if 'moving_stats' in aux:       # Gmain and Dmain keep the new w_avg
        np.testing.assert_allclose(
            tens.mapping.w_avg.numpy(),
            np.asarray(aux['moving_stats']['w_avg']), rtol=0, atol=1e-6)
    else:                           # the renderer phase leaves it
        np.testing.assert_array_equal(
            tens.mapping.w_avg.numpy(), np_tree['mapping']['moving_stats']['w_avg'])
    assert set(stats) == set(aux['stats'])
    for k, val in stats.items():
        np.testing.assert_allclose(val.item(), float(aux['stats'][k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(loss.detach()), float(ref), **TOL)
    port = _named_grads(tens, tuple(f'{k}.' for k in params), loss)
    ref_grads = _jax_named_grads(cfg, np_tree, grads)
    _assert_grads(port, {k: ref_grads[k] for k in port})


# ---------------------------------------------------------------------------
# The renderer's optimizer
# ---------------------------------------------------------------------------

def test_amsgrad_matches_optax():
    """Three steps: optax keeps the maximum of the bias-corrected second
    moment, which ``torch.optim.Adam(amsgrad=True)`` does not (the
    gradients shrink, so the two would differ from step 2 on)."""
    rng = np.random.RandomState(6)
    p0 = rng.randn(5, 7).astype(np.float32)
    gs = [rng.randn(5, 7).astype(np.float32) * s for s in (1.0, 0.3, 0.1)]
    tx = optax.amsgrad(1e-3, b1=0.9, b2=0.999, eps=1e-8)
    p, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    t = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = ttrain.AMSGrad([t], lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    torch_adam = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    adam = torch.optim.Adam([torch_adam], lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8, amsgrad=True)
    for g in gs:
        upd, state = tx.update(jnp.asarray(g), state, p)
        p = optax.apply_updates(p, upd)
        for param, o in ((t, opt), (torch_adam, adam)):
            param.grad = torch.from_numpy(g)
            o.step()
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(p),
                                   rtol=0, atol=1e-7)
    assert np.abs(torch_adam.detach().numpy() - np.asarray(p)).max() > 1e-5


# ---------------------------------------------------------------------------
# One step of the renderer and global phases
# ---------------------------------------------------------------------------

# p = 0 keeps the pipe's random gates off; the ADA target below every mean
# sign makes the controller raise p of the global lane.
HYPER = dict(batch_size=BATCH, style_mixing_prob=0.0, augment_p_init=0.0,
             ada_interval=1, ada_target=-2.0)


def _jax_z(cfg, key):
    """z of the renderer, global Gmain and global Dmain phases: JAX's draw
    from each phase's key (phases 1, 2 and 3 without the local phases)."""
    return [np.array(jax.random.normal(jax.random.fold_in(
        jax.random.fold_in(key, idx), 0), (BATCH, cfg.z_dim)))
        for idx in (1, 2, 3)]


class _StepDraws(InjectedDraws):
    """The phase z of each scope, in phase order."""

    def __init__(self, z):
        super().__init__()
        self.queue = {'renderer_z': z[:1], 'global_z': z[1:]}


def test_global_step_matches_jax(micro, monkeypatch):
    """``partial_step(do_local=False)`` at step 0: the renderer phase, global
    Gmain, Dmain and R1, EMA (STN included) and ADA, held to JAX's."""
    cfg, ens, variables, np_tree = micro
    _, stack = _inputs(cfg, 7)
    crops = [np.zeros((BATCH, h, w, 4), np.float32)
             for h, w in cfg.layer_targets]
    key = jax.random.PRNGKey(12)
    mp = pytest.MonkeyPatch()
    inject_jax_synthesis_noise(mp)
    try:
        jhyper = jtrain.TrainHyper(augment=jaug.AugmentConfig(brightness=1),
                                   **HYPER)
        trainer = jtrain.MontageTrainer(ens, jhyper)
        jstate = trainer.state_from_variables(variables)
        step = jax.jit(lambda s, k: trainer.partial_step(
            s, jnp.asarray(stack), tuple(jnp.asarray(c) for c in crops), k,
            do_local=False), compiler_options=FAST_COMPILE)
        jstate, jstats = step(jstate, key)
    finally:
        mp.undo()

    tens = port_ensemble(np_tree)
    thyper = ttrain.TrainHyper(augment=taug.AugmentConfig(brightness=1),
                               **HYPER)
    trainer = ttrain.MontageTrainer(tens, thyper, device='cpu')
    state = trainer.state_from_variables(tens.state_dict())
    ratio = record_grads(monkeypatch)
    state, stats = trainer.partial_step(state, stack, crops,
                                        _StepDraws(_jax_z(cfg, key)),
                                        do_local=False)

    assert state.step == int(jstate.step) == 1
    assert set(stats) == set(jstats)
    for k, v in stats.items():
        np.testing.assert_allclose(float(v), float(jstats[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(state.aug_p.numpy(), np.asarray(jstate.aug_p),
                               rtol=0, atol=1e-9)
    assert np.asarray(jstate.aug_p)[-1] > 0
    np.testing.assert_allclose(
        tens.mapping.w_avg.numpy(),
        np.asarray(jstate.variables['mapping']['moving_stats']['w_avg']),
        rtol=0, atol=1e-6)
    ref = weights.state_dict_from_jax(cfg, _np(jstate.variables))
    ref_ema = weights.state_dict_from_jax(cfg, _np(jstate.ema))
    left_out = total = 0
    for name, p in tens.named_parameters():
        diff = (p.detach() - ref[name]).abs()
        if id(p) not in ratio:          # the local Ds: not trained here
            assert name.startswith('local_d.') and not diff.any(), name
            continue
        keep = ratio[id(p)] >= SMALL_GRAD
        left_out += int((~keep).sum())
        total += p.numel()
        assert diff[keep].max() <= ATOL, (name, diff[keep].max())
    assert {k for k, _ in state.ema.named_parameters()} == {
        k for k in ref_ema if k.startswith(('mapping.', 'local_g.', 'stn.'))
        and not k.endswith(('resample_filter', 'noise_const', 'w_avg'))}
    for name, p in state.ema.named_parameters():
        assert (p - ref_ema[name]).abs().max() <= ATOL, name
    # the renderer's AMSGrad moments against optax's
    jr = jstate.opt_states['renderer'][0]
    for k, p in tens.renderer.named_parameters():
        mod, leaf = k.rsplit('.', 1)
        jname = {'block.0': 'block', 'cnn.0': 'conv_in',
                 'cnn.5': 'conv_out'}[mod]
        jmu = np.asarray(jr.mu[jname]['kernel' if leaf == 'weight'
                                      else 'bias'])
        if leaf == 'weight':
            jmu = jmu.transpose(3, 2, 0, 1)
        mu = state.opt_renderer.state[p]['mu'].numpy()
        np.testing.assert_allclose(mu, jmu, rtol=1e-4,
                                   atol=1e-4 * np.abs(jmu).max())
    print(f'{left_out} of {total} parameter entries left out')
    assert left_out <= 1e-3 * total


def test_aio_step_kernel_path_and_launches(micro, monkeypatch):
    """Two AIO steps (every phase at step 0, the main phases at step 1)
    through the kernels' autograd Functions (emulated kernels) equal the
    plain steps and launch each kernel as often as chip_smoke.py expects on
    the card."""
    cfg, _, _, np_tree = micro
    hyper = ttrain.TrainHyper(augment=taug.make_augment_config('bgcfnc'),
                              **{**HYPER, 'augment_p_init': 0.6,
                                 'ada_interval': 4})
    _, stack = _inputs(cfg, 9)
    rng = np.random.RandomState(10)
    crops = [rng.uniform(-1, 1, (BATCH, h, w, 4)).astype(np.float32)
             for h, w in cfg.layer_targets]

    def run():
        tens = port_ensemble(np_tree)
        trainer = ttrain.MontageTrainer(tens, hyper, device='cpu')
        state = trainer.state_from_variables(tens.state_dict())
        draws = InjectedDraws()
        for _ in range(2):
            state, _ = trainer.train_step(state, stack, crops, draws)
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
