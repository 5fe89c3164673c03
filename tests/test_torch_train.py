"""The port's local-phase training modules against the JAX package's, on the
CPU: the discriminator, the weight bridge of the local Ds, the augment pipe
and the four local losses.

A micro ensemble (2 layers, one non-square) is initialised in JAX, with the
zero-initialised biases, noise strengths and w_avg given random values, and
crosses into the port through ``utils.weights.state_dict_from_jax``.  The
random tensors are injected: z is an argument of both; the path-length
noise is JAX's own draw, from the key its loss splits; the synthesis noise
is a fixed field per shape, handed to JAX by wrapping ``jax.random.normal``
for noise-shaped requests (``[B, h, w, 1]``) and to the port through its
``Draws`` seam.  The augment pipe runs at p = 0 (every gate off, the warp
and filters still run) in the losses and under ``debug_percentile`` alone.

Tolerances: forwards and loss values ``atol 1e-4`` (float32 sums in another
order); gradients per tensor within ``1e-3`` of the tensor's largest JAX
gradient (convolution gradients sum thousands of products); the D with a
bfloat16 block against the float32 truth, no further from it than JAX's own
bfloat16 run (see the test).
"""

import functools
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from montage_gan_tpu.models import discriminator as jdisc
from montage_gan_tpu.models.ensemble import MontageConfig as JaxConfig
from montage_gan_tpu.models.ensemble import MontageEnsemble as JaxEnsemble
from montage_gan_tpu.training import augment as jaug
from montage_gan_tpu.training import losses as jlosses
from montage_gan_tpu.utils import torch_export
from montage_gan_tpu_torch.models import discriminator as tdisc
from montage_gan_tpu_torch.models.ensemble import MontageConfig, MontageEnsemble
from montage_gan_tpu_torch.training import augment as taug
from montage_gan_tpu_torch.training import losses as tlosses
from montage_gan_tpu_torch.training.draws import Draws
from montage_gan_tpu_torch.utils import weights

torch.set_num_threads(1)

MICRO = dict(layer_names=('a', 'b'), layer_targets=((8, 8), (8, 4)),
             base_resolution=8, img_channels=4, conv_config_index=2,
             z_dim=16, w_dim=16, mapping_num_layers=2, channel_base=64,
             channel_max=16, num_fp16_res=0, conv_clamp=256,
             mbstd_group_size=2, train_global=False, renderer_type='none')
BATCH = 4
GRAD_RTOL = 1e-3
# XLA's CPU optimizations off: these programs run once, so compiling them
# fast is what counts.
FAST_COMPILE = dict(xla_backend_optimization_level=0,
                    xla_llvm_disable_expensive_passes=True)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a, np.float32), tree)


def _perturb(tree, seed, names=('bias', 'noise_strength', 'w_avg')):
    rng = np.random.RandomState(seed)

    def f(path, leaf):
        if getattr(path[-1], 'key', None) in names:
            return jnp.asarray(np.asarray(rng.randn(*np.shape(leaf)) * 0.1,
                                          np.float32))
        return leaf
    return jax.tree_util.tree_map_with_path(f, tree)


def _assert_grads(port: dict, ref: dict, rtol=GRAD_RTOL):
    """Every port gradient within ``rtol`` of its tensor's largest JAX
    gradient."""
    assert set(port) == set(ref), set(port) ^ set(ref)
    for k, g in port.items():
        r = ref[k].numpy()
        scale = max(np.abs(r).max(), 1e-8)
        err = np.abs(g.detach().numpy() - r).max()
        assert err <= rtol * scale, (k, err, scale)


# ---------------------------------------------------------------------------
# Discriminator and the bridge of its weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('num_fp16_res', [0, 1], ids=['f32', 'bf16-block'])
def test_discriminator_matches_jax(num_fp16_res):
    """2 blocks (16 → 8 → 4·init_res), non-square init_res (4, 2): logits
    and every parameter's gradient."""
    kw = dict(img_resolution=16, img_channels=4, init_res=(4, 2),
              conv_config_index=2, channel_base=128, channel_max=16,
              num_fp16_res=num_fp16_res, conv_clamp=256, mbstd_group_size=2,
              freeze_layers=1)
    jnet, tnet = jdisc.Discriminator(**kw), tdisc.Discriminator(**kw)
    rng = np.random.RandomState(0)
    img = rng.uniform(-1, 1, (4, 16, 8, 4)).astype(np.float32)
    r = rng.randn(4, 1).astype(np.float32)
    init = jax.jit(jnet.init, compiler_options=FAST_COMPILE)
    variables = _perturb(init(jax.random.PRNGKey(0), jnp.asarray(img)),
                         seed=1)
    np_vars = _np(variables)
    sd = weights.discriminator_state_dict(np_vars, (4, 2))
    ref_sd = torch_export.discriminator_state_dict(np_vars, init_res=(4, 2))
    assert list(sd) == list(ref_sd) == list(tnet.state_dict())
    for k in ref_sd:
        assert torch.equal(sd[k], ref_sd[k]), k
    tnet.load_state_dict(sd)

    def jax_grads(net):
        @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
        def run(params):
            def loss(p):
                out = net.apply({**variables, 'params': p}, jnp.asarray(img))
                return jnp.sum(out * r), out
            return jax.value_and_grad(loss, has_aux=True)(params)
        (_, out), grads = run(variables['params'])
        sd = weights.discriminator_state_dict(_np({'params': grads}), (4, 2))
        return np.asarray(out), sd

    ref, ref_grads = jax_grads(jnet)
    out = tnet(torch.from_numpy(img))
    params = dict(tnet.named_parameters())
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(),
                                list(params.values()), allow_unused=True)
    port = {k: torch.zeros_like(p) if g is None else g
            for (k, p), g in zip(params.items(), grads)}
    # Freeze-D: the first layer (fromrgb) gets no gradient in either
    assert not port['b16.fromrgb.weight'].abs().any()
    if num_fp16_res == 0:
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                                   atol=1e-4)
        _assert_grads(port, {k: ref_grads[k] for k in port})
        return
    # bfloat16 block: both frameworks round at other places, and a sign of
    # a pre-activation near 0 can differ, moving a bias gradient by the
    # lrelu slope.  Held against the float32 truth instead: the port is no
    # further from it than JAX's own bfloat16 run (1.5x slack), per tensor.
    truth, truth_grads = jax_grads(jdisc.Discriminator(
        **{**kw, 'num_fp16_res': 0}))

    def dist(a, b):
        return float(np.linalg.norm(np.asarray(a) - np.asarray(b)))

    scale = np.abs(truth).max()
    assert dist(out.detach().numpy(), truth) <= 1.5 * dist(ref, truth) \
        + 1e-3 * scale
    for k, g in port.items():
        t = truth_grads[k].numpy()
        assert dist(g.detach().numpy(), t) <= 1.5 * dist(ref_grads[k], t) \
            + 1e-3 * np.abs(t).max(), k


def port_ensemble(np_tree):
    """A fresh port ensemble with the JAX weights."""
    cfg = MontageConfig(**MICRO)
    tens = MontageEnsemble(cfg, with_d=True)
    tens.load_state_dict(weights.state_dict_from_jax(cfg, np_tree))
    return tens


@functools.lru_cache(maxsize=None)
def jax_micro():
    """(config, JAX ensemble, variables with the zero-init leaves made
    random, the same as numpy arrays); built once per process, read only."""
    cfg = JaxConfig(**MICRO)
    ens = JaxEnsemble(cfg)
    init = jax.jit(lambda k: ens.init_variables(k, on_cpu=False),
                   compiler_options=FAST_COMPILE)
    variables = _perturb(init(jax.random.PRNGKey(0)), seed=2)
    return cfg, ens, variables, _np(variables)


@pytest.fixture(scope='module')
def micro():
    return jax_micro()


def test_state_dict_from_jax_carries_local_d(micro):
    cfg, _, _, np_tree = micro
    tens = port_ensemble(np_tree)
    sd = weights.state_dict_from_jax(cfg, np_tree)
    assert list(sd) == list(tens.state_dict())
    for i, d in enumerate(np_tree['local_d']):
        init_res = cfg.layer_geometry(i)[0]
        ref = torch_export.discriminator_state_dict(d, init_res=init_res)
        for k, v in ref.items():
            assert torch.equal(sd[f'local_d.{i}.{k}'], v), k


# ---------------------------------------------------------------------------
# The augment pipe
# ---------------------------------------------------------------------------

AUG_CASES = [(spec, dp, 1.0) for spec in ('blit', 'geom', 'color', 'filter',
                                          'cutout') for dp in (0.2, 0.7)]
AUG_CASES.append(('bgcfnc', None, 0.0))


@pytest.mark.parametrize('spec,dp,p', AUG_CASES,
                         ids=[f'{s}-{d}' for s, d, _ in AUG_CASES])
def test_augment_pipe_matches_jax(spec, dp, p):
    rng = np.random.RandomState(3)
    img = rng.uniform(-1, 1, (2, 16, 12, 4)).astype(np.float32)
    ref = jaug.augment_pipe(jnp.asarray(img), jnp.float32(p),
                            jax.random.PRNGKey(0),
                            jaug.make_augment_config(spec),
                            debug_percentile=dp)
    out = taug.augment_pipe(torch.from_numpy(img), p,
                            taug.make_augment_config(spec),
                            Draws(torch.Generator().manual_seed(0)),
                            debug_percentile=dp)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)
    if spec != 'bgcfnc':          # the stage did something
        assert np.abs(out.numpy() - img).max() > 1e-2


def test_augment_noise_sigma_and_vjp():
    """The noise stage's field cannot match JAX's: its sigma is checked
    (debug percentile 0.7 → erfinv(0.7)·σ); and the pipe's gradient (the
    warp, the filters) equals JAX's under debug_percentile."""
    img = torch.zeros(2, 64, 64, 4)
    out = taug.augment_pipe(img, 1.0, taug.make_augment_config('noise'),
                            Draws(torch.Generator().manual_seed(1)),
                            debug_percentile=0.7)
    sigma = float(torch.special.erfinv(torch.tensor(0.7))) * 0.1
    assert abs(float(out.std()) - sigma) < 0.05 * sigma

    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (2, 16, 12, 4)).astype(np.float32)
    g = rng.randn(2, 16, 12, 4).astype(np.float32)
    cfg_j, cfg_t = (m.make_augment_config('bgcf') for m in (jaug, taug))
    _, vjp = jax.vjp(lambda v: jaug.augment_pipe(
        v, jnp.float32(1.0), jax.random.PRNGKey(0), cfg_j,
        debug_percentile=0.7), jnp.asarray(x))
    ref_dx, = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    out = taug.augment_pipe(xt, 1.0, cfg_t, Draws(torch.Generator()),
                            debug_percentile=0.7)
    dx, = torch.autograd.grad(out, xt, torch.from_numpy(g))
    np.testing.assert_allclose(dx.numpy(), np.asarray(ref_dx), rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# The local losses
# ---------------------------------------------------------------------------

def fixed_noise(shape):
    """A fixed N(0, 1) field per shape: the synthesis noise both frameworks
    get in these tests."""
    seed = zlib.crc32(repr(tuple(int(s) for s in shape)).encode())
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def inject_jax_synthesis_noise(monkeypatch):
    orig = jax.random.normal

    def normal(key, shape=(), dtype=jnp.float32):
        if len(shape) == 4 and shape[-1] == 1:
            return jnp.asarray(fixed_noise(shape), dtype)
        return orig(key, shape, dtype)
    monkeypatch.setattr(jax.random, 'normal', normal)


class InjectedDraws(Draws):
    """The port's draws with the synthesis noise (of every scope) and, where
    given, the latent z and the path-length noise of each phase, in phase
    order."""

    def __init__(self, z=(), pl_noise=()):
        super().__init__(torch.Generator().manual_seed(0))
        self.queue = {'z': list(z), 'pl_noise': list(pl_noise)}

    def normal(self, shape, kind):
        if kind.endswith('synthesis_noise'):
            return torch.from_numpy(fixed_noise(shape))
        if self.queue.get(kind):
            out = torch.from_numpy(np.array(self.queue[kind].pop(0)))
            assert tuple(out.shape) == tuple(shape), (kind, out.shape, shape)
            return out
        return super().normal(shape, kind)


def _g_grads_port(tens, layer, loss):
    names = [f'mapping.{k}' for k, _ in tens.mapping.named_parameters()] + [
        f'local_g.{layer}.{k}' for k, _ in
        tens.local_g[layer].named_parameters()]
    params = [dict(tens.named_parameters())[n] for n in names]
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return {n: torch.zeros_like(p) if g is None else g
            for n, p, g in zip(names, params, grads)}


def _g_grads_jax(np_tree, layer, mgrads, ggrads):
    out = {f'mapping.{k}': v for k, v in weights.mapping_state_dict(
        {'params': _np(mgrads)}).items()}
    noise = np_tree['local_g'][layer]['noise']
    out.update({f'local_g.{layer}.{k}': v for k, v in
                weights.synthesis_state_dict(
                    {'params': _np(ggrads), 'noise': noise}).items()})
    return out


def _d_grads(tens, layer, loss, np_tree, dgrads):
    d = tens.local_d[layer]
    names = [k for k, _ in d.named_parameters()]
    grads = torch.autograd.grad(loss, list(d.parameters()), allow_unused=True)
    port = {k: torch.zeros_like(p) if g is None else g
            for k, p, g in zip(names, d.parameters(), grads)}
    init_res = MontageConfig(**MICRO).layer_geometry(layer)[0]
    ref = weights.discriminator_state_dict(_np({'params': dgrads}), init_res)
    return port, {k: ref[k] for k in names}


@pytest.mark.parametrize('phase', ['gmain', 'gpl', 'dmain', 'dr1'])
def test_local_loss_matches_jax(phase, micro, monkeypatch):
    """Layer 1 of the 2-layer ensemble: the non-square one."""
    layer = 1
    cfg, ens, variables, np_tree = micro
    tens = port_ensemble(np_tree)
    inject_jax_synthesis_noise(monkeypatch)
    rng = np.random.RandomState(5 + layer)
    z = rng.randn(BATCH, cfg.z_dim).astype(np.float32)
    th, tw = cfg.layer_targets[layer]
    real = rng.uniform(-1, 1, (BATCH, th, tw, 4)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    aug_j, aug_t = (m.make_augment_config('bgcfnc') for m in (jaug, taug))
    mvars, gvars = variables['mapping'], variables['local_g'][layer]
    dvars = variables['local_d'][layer]

    if phase in ('gmain', 'gpl'):
        if phase == 'gmain':
            def jloss(m, g):
                diff = {'mapping': {**mvars, 'params': m},
                        'g': {**gvars, 'params': g}}
                return jlosses.local_gmain_loss(
                    diff, ens, layer, dvars, jnp.asarray(z), key, aug_j,
                    jnp.float32(0.0), style_mixing_prob=0.0)
            loss, _ = tlosses.local_gmain_loss(
                tens, layer, torch.from_numpy(z), InjectedDraws(), aug_t, 0.0,
                style_mixing_prob=0.0)
        else:
            pl_mean = 0.3

            def jloss(m, g):
                diff = {'mapping': {**mvars, 'params': m},
                        'g': {**gvars, 'params': g}}
                return jlosses.local_gpl_loss(
                    diff, ens, layer, jnp.asarray(z), key,
                    jnp.float32(pl_mean), style_mixing_prob=0.0)
            pl = jax.random.normal(jax.random.split(key, 3)[2],
                                   (BATCH // 2, th, tw, 4))
            loss, new_pl_mean, _ = tlosses.local_gpl_loss(
                tens, layer, torch.from_numpy(z), InjectedDraws(pl_noise=[pl]),
                torch.tensor(pl_mean), style_mixing_prob=0.0)
        (ref, aux), (mg, gg) = jax.jit(jax.value_and_grad(
            jloss, argnums=(0, 1), has_aux=True),
            compiler_options=FAST_COMPILE)(mvars['params'], gvars['params'])
        if phase == 'gpl':
            np.testing.assert_allclose(float(new_pl_mean),
                                       float(aux['pl_mean']), rtol=1e-4)
        np.testing.assert_allclose(
            tens.mapping.w_avg.numpy(),
            np.asarray(aux['moving_stats']['w_avg']), rtol=0, atol=1e-6)
        port = _g_grads_port(tens, layer, loss)
        ref_grads = _g_grads_jax(np_tree, layer, mg, gg)
        ref_grads = {k: ref_grads[k] for k in port}
    else:
        if phase == 'dmain':
            def jloss(d):
                frozen = {'mapping': mvars, 'g': gvars}
                return jlosses.local_dmain_loss(
                    {**dvars, 'params': d}, ens, layer, frozen,
                    jnp.asarray(z), jnp.asarray(real), key, aug_j,
                    jnp.float32(0.0), style_mixing_prob=0.0)
            loss, _, sign = tlosses.local_dmain_loss(
                tens, layer, torch.from_numpy(z), torch.from_numpy(real),
                InjectedDraws(), aug_t, 0.0, style_mixing_prob=0.0)
        else:
            def jloss(d):
                return jlosses.local_dr1_loss(
                    {**dvars, 'params': d}, ens, layer, jnp.asarray(real),
                    key, aug_j, jnp.float32(0.0))
            loss, _, sign = tlosses.local_dr1_loss(
                tens, layer, torch.from_numpy(real), InjectedDraws(), aug_t,
                0.0)
        (ref, aux), dg = jax.jit(jax.value_and_grad(jloss, has_aux=True),
                                 compiler_options=FAST_COMPILE)(
            dvars['params'])
        assert float(sign.detach()) == float(aux['sign_real'])
        port, ref_grads = _d_grads(tens, layer, loss, np_tree, dg)
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-4,
                               atol=1e-5)
    _assert_grads(port, ref_grads)
