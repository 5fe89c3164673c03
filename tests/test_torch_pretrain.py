"""The port's stage-0 pretraining against the JAX package's, on the CPU.

The JAX pretrainers' steps are closures inside their CLIs
(``montage_gan_tpu/cli/pretrain_renderer.py:64``, ``cli/pretrain_stn.py:
99,127``); each is composed here from the same JAX functions those closures
call and jitted with XLA's optimizations off.  The port's steps
(``training/pretrain.py``) are held to them for 2 steps, with the
translations and the pseudo-fakes injected and the JAX variables built from
the port's seeded weights: losses, PSNR, R1 term, gradients and the
parameters after each update.  The STN GAN runs with each of the three
discriminators (the SG2 one at narrow widths; the simple one at ``nf1`` 8;
V2, whose widths are fixed, at 64 px).  Then both CLIs run 2 steps, and
``pretrain-stn`` reads its renderer from a port ``.pt``, a JAX ``.msgpack``
and a reference ``.pth.tar``.

Tolerances: losses within 1e-5 relative; gradients and updated parameters
within 1e-4 of the largest entry (of the step's gradients; of the
parameters).  The updates are not compared on their own scale: Adam's first
steps move each weight by about the learning rate whatever its gradient's
size, so where a gradient entry is near Adam's eps (1e-8) float32 order
differences move that entry's update by up to 1% of the learning rate.
"""

import copy
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from montage_gan_tpu.models.discriminator import Discriminator as JaxD
from montage_gan_tpu.models.renderer import build_renderer as jax_renderer
from montage_gan_tpu.models.simple_d import (
    SimpleGlobalDiscriminator as JaxSimpleD,
    SimpleGlobalDiscriminatorV2 as JaxSimpleDV2)
from montage_gan_tpu.models.stn import STN as JaxSTN
from montage_gan_tpu.ops.composite import alpha_composite as jac
from montage_gan_tpu.ops.grid_sample import translate_sample as jts
from montage_gan_tpu.training.losses import theta_constrain_loss as jtheta
from montage_gan_tpu.utils import checkpoint as jckpt
from montage_gan_tpu.utils import image_utils as jimg
from montage_gan_tpu.utils import torch_export as jte
from montage_gan_tpu.utils import torch_import as jti
from montage_gan_tpu_torch.cli import pretrain_renderer, pretrain_stn
from montage_gan_tpu_torch.data.synthetic import (DEFAULT_SPEC,
                                                  make_synthetic_layer_dataset,
                                                  synthetic_batch)
from montage_gan_tpu_torch.models.discriminator import Discriminator
from montage_gan_tpu_torch.models.renderer import build_renderer
from montage_gan_tpu_torch.models.simple_d import (SimpleGlobalDiscriminator,
                                                  SimpleGlobalDiscriminatorV2)
from montage_gan_tpu_torch.models.stn import STN, auto_stn_stages
from montage_gan_tpu_torch.tools.launches import expected_stn_pretrain_launches
from montage_gan_tpu_torch.training import pretrain
from montage_gan_tpu_torch.training.train_step import AMSGrad
from montage_gan_tpu_torch.utils import weights
from montage_gan_tpu_torch.utils.image_utils import generate_pseudo_fake_np

from test_torch_grads import emulate_kernels
from test_torch_interop import fast, flax_params, jax_stn

torch.set_num_threads(1)

TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
STEPS = 2


def owned(tree):
    """JAX variables with buffers of their own: the JAX package's converters
    return numpy views of the torch weights, which the port's steps update
    in place while JAX, dispatching asynchronously, may still read them."""
    return jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), tree)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-12)


def assert_on_scale(got, want, tol, what):
    """Every entry of ``got`` (name → tensor) within ``tol`` of the largest
    entry of ``want``."""
    assert set(got) == set(want), what
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    worst = max(float(np.abs(got[k].detach().numpy() - np.asarray(want[k]))
                      .max()) for k in want)
    assert worst <= tol * scale, (what, worst, scale)


def grads_of(module):
    return {k: p.grad for k, p in module.named_parameters()}


def params_of(module):
    return {k: p.detach().clone() for k, p in module.named_parameters()}


def named(converted, module):
    """A converted state dict restricted to ``module``'s parameters."""
    names = dict(module.named_parameters())
    return {k: v.numpy() for k, v in converted.items() if k in names}


def seeded(module, seed, scale=0.05):
    """Seeded weights, and seeded values for the zero-initialised biases
    and the STN's last layer, so that every term does work."""
    g = torch.Generator().manual_seed(seed)
    module.reset_parameters(g)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith('bias') or name.startswith('fc_loc.2'):
                p.add_(torch.randn(p.shape, generator=g) * scale)
    return module


# ---------------------------------------------------------------------------
# The renderer
# ---------------------------------------------------------------------------

def jax_renderer_step(renderer, tx, loss_type, sigmoid_range):
    """``montage_gan_tpu/cli/pretrain_renderer.py:64-84`` with the
    translations given (``random_position``'s draw injected)."""
    @fast
    def step(params, opt_state, stack01, t):
        b, l, h, w, c = stack01.shape
        placed01 = jts(stack01.reshape(b * l, h, w, c), t,
                       pad_value=0.0).reshape(b, l, h, w, c)
        target = jax.lax.stop_gradient(jac(placed01))
        model_in = placed01 if sigmoid_range else jimg.normalize_minus11(
            placed01)

        def loss_fn(p):
            out = renderer.apply({'params': p}, model_in)
            out01 = out if sigmoid_range else (out + 1.0) / 2.0
            if loss_type == 'mse':
                loss = jnp.mean(jnp.square(out01 - target))
            else:
                loss = jnp.mean(jnp.abs(out01 - target))
            return loss, out01

        (loss, out01), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params)
        updates, opt_state = tx.update(grads, opt_state, params)
        psnr = jimg.calc_psnr(jax.lax.stop_gradient(out01), target)
        return (optax.apply_updates(params, updates), opt_state, loss, psnr,
                grads)
    return step


@pytest.mark.parametrize('rtype,loss_type', [('tanh', 'mse'),
                                             ('sigmoid', 'l1')])
def test_renderer_step_matches_jax(rtype, loss_type):
    """Two AMSGrad steps (optax's rule): losses, PSNR, gradients and the
    updated parameters."""
    res, layers, batch = 16, 2, 2
    port = seeded(build_renderer(rtype, img_resolution=res, img_channels=4,
                                 img_layers=layers), 1)
    params = owned(jti.renderer_params_from_torch(port.state_dict(),
                                                 rtype)['params'])
    jmod = jax_renderer(rtype, img_resolution=res, img_channels=4,
                        img_layers=layers)
    tx = optax.amsgrad(1e-3, b1=0.9, b2=0.999)
    opt_state = tx.init(params)
    step = jax_renderer_step(jmod, tx, loss_type, rtype == 'sigmoid')
    opt = AMSGrad(port.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    rng = np.random.RandomState(2)
    for i in range(STEPS):
        stack01 = synthetic_batch(rng, batch, layers, res)
        t = rng.uniform(-1, 1, (batch * layers, 2)).astype(np.float32)
        params, opt_state, loss_ref, psnr_ref, grads = step(
            params, opt_state, jnp.asarray(stack01), jnp.asarray(t))
        loss, psnr = pretrain.renderer_step(
            port, opt, torch.from_numpy(stack01), torch.from_numpy(t),
            loss_type, rtype == 'sigmoid')
        assert rel(loss, loss_ref) <= TOL_LOSS, (i, loss, loss_ref)
        assert rel(psnr, psnr_ref) <= TOL_LOSS, (i, psnr, psnr_ref)
        assert_on_scale(grads_of(port), named(jte.renderer_state_dict(
            {'params': grads}, rtype), port), TOL_GRAD, f'grads {i}')
        assert_on_scale(params_of(port), named(jte.renderer_state_dict(
            {'params': params}, rtype), port), TOL_GRAD, f'update {i}')


# ---------------------------------------------------------------------------
# The STN GAN
# ---------------------------------------------------------------------------

def jax_stn_steps(d_net, stn, renderer, renderer_vars, r1_gamma, tx):
    """``montage_gan_tpu/cli/pretrain_stn.py:99-146``, returning the
    gradients too."""
    softplus = jax.nn.softplus

    @fast
    def train_d(d_params, opt_d, stn_vars, real1_01, pseudo2_01):
        x_real = jimg.normalize_minus11(jac(real1_01))
        placed, _ = stn.apply(stn_vars, jimg.normalize_minus11(pseudo2_01))
        rendered = jax.lax.stop_gradient(renderer.apply(renderer_vars,
                                                        placed))

        def loss_fn(p):
            dv = {'params': p}

            def d_sum(img):
                logits = d_net.apply(dv, img)
                return jnp.sum(logits), logits

            grads_real, real_logits = jax.grad(d_sum, has_aux=True)(x_real)
            gp = 0.5 * r1_gamma * jnp.mean(
                jnp.sum(jnp.square(grads_real), axis=(1, 2, 3)))
            fake_logits = d_net.apply(dv, rendered)
            loss = (jnp.mean(softplus(-real_logits)) + gp
                    + jnp.mean(softplus(fake_logits)))
            return loss, (jnp.mean(real_logits), gp)

        (loss, (score_real, gp)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(d_params)
        updates, opt_d = tx.update(grads, opt_d, d_params)
        return (optax.apply_updates(d_params, updates), opt_d,
                dict(d_loss=loss, score_real=score_real, gp=gp), grads)

    @fast
    def train_stn(stn_params, opt_stn, d_params, pseudo3_01):
        def loss_fn(p):
            placed, theta = stn.apply({'params': p},
                                      jimg.normalize_minus11(pseudo3_01))
            rendered = renderer.apply(renderer_vars, placed)
            logits = d_net.apply({'params': d_params}, rendered)
            g_loss = jnp.mean(softplus(-logits))
            c_loss = jtheta(theta)
            target = jac(jimg.normalize_zero1(jax.lax.stop_gradient(placed)))
            r_loss = jnp.mean(jnp.square(jimg.normalize_zero1(rendered)
                                         - target))
            return g_loss + c_loss, dict(g_r1=g_loss, g_con=c_loss,
                                         r_loss=r_loss,
                                         score_fake=jnp.mean(logits))

        (loss, aux), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            stn_params)
        updates, opt_stn = tx.update(grads, opt_stn, stn_params)
        return (optax.apply_updates(stn_params, updates), opt_stn,
                dict(aux, g_loss=loss), grads)
    return train_d, train_stn


def d_pair(kind):
    """(port D, JAX D, resolution, batch, the port names of JAX variables):
    SG2 narrow at 16 px, batch 2; the simple D at nf1 8, 16 px; V2 (fixed
    widths) at 64 px, batch 1."""
    if kind == 'sg2':
        kw = dict(img_resolution=16, img_channels=4, channel_base=256,
                  channel_max=32)
        port = seeded(Discriminator(**kw), 3)
        return (port, JaxD(**kw), 16, 2,
                lambda v: weights.discriminator_state_dict(v),
                lambda m: jti.discriminator_params_from_torch(m.state_dict()))
    if kind == 'simple':
        port = seeded(SimpleGlobalDiscriminator(16, 4, nf1=8), 3)
        jmod = JaxSimpleD(img_resolution=16, img_channels=4, nf1=8)
        res, batch = 16, 2
    else:
        port = seeded(SimpleGlobalDiscriminatorV2(64, 4), 3)
        jmod = JaxSimpleDV2(img_resolution=64, img_channels=4)
        res, batch = 64, 1
    return (port, jmod, res, batch, weights.simple_d_state_dict,
            lambda m: flax_params(m.state_dict()))


def nudged(module, seed):
    """A copy of ``module`` with every weight moved by 1e-6 relative."""
    out = copy.deepcopy(module)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in out.parameters():
            p.mul_(1 + 1e-6 * torch.randn(p.shape, generator=g))
    return out


def worst_on_scale(got, want):
    """The largest difference over the largest entry of ``want``."""
    scale = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    return max(float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
               for k in want) / scale


SPREADS = {}     # the ill-conditioned comparisons and their bounds


def check(what, got, want, spread_to):
    """``got`` within ``TOL_GRAD`` of ``want``'s largest entry, or, where a
    1e-6 nudge of the weights moves it by more than a tenth of that (the
    quantity is ill-conditioned), within the larger of 1e-3 and ten times
    the nudge's spread."""
    got = {k: v.numpy() for k, v in got.items()}
    err, spread = worst_on_scale(got, want), worst_on_scale(spread_to, got)
    bound = TOL_GRAD if spread < TOL_GRAD / 10 else max(1e-3, 10 * spread)
    if bound != TOL_GRAD:
        SPREADS[what] = (err, spread, bound)
    assert err <= bound, (what, err, spread, bound)


def check_losses(what, rec, ref, moved):
    """Each loss within ``TOL_LOSS`` relative, or, where the nudged
    replica's differs by more than a tenth of that, within the larger of
    1e-3 and ten times its spread."""
    for k in ref:
        err, spread = rel(rec[k], ref[k]), rel(moved[k], rec[k])
        bound = TOL_LOSS if spread < TOL_LOSS / 10 else max(1e-3, 10 * spread)
        if bound != TOL_LOSS:
            SPREADS[f'{what} {k}'] = (err, spread, bound)
        assert err <= bound, (what, k, float(rec[k]), float(ref[k]), spread)


class PortRun:
    """The port's D and STN with their optimizers, one round a call."""

    def __init__(self, d, stn, renderer):
        self.d, self.stn, self.renderer = d, stn, renderer
        self.opt_d = torch.optim.Adam(d.parameters(), lr=1e-3,
                                      betas=(0.9, 0.999))
        self.opt_stn = torch.optim.Adam(stn.parameters(), lr=1e-3,
                                        betas=(0.9, 0.999))

    def d_step(self, real1, p2):
        rec = pretrain.stn_d_step(self.d, self.opt_d, self.stn, self.renderer,
                                  torch.from_numpy(real1),
                                  torch.from_numpy(p2), 10.0)
        return rec, grads_of(self.d), params_of(self.d)

    def g_step(self, p3):
        rec = pretrain.stn_g_step(self.stn, self.opt_stn, self.d,
                                  self.renderer, torch.from_numpy(p3))
        return rec, grads_of(self.stn), params_of(self.stn)


@pytest.mark.parametrize('kind', pretrain.DISCRIMINATORS)
def test_stn_steps_match_jax(kind):
    """Two rounds of the D step and the STN step (Adam, the CLI's order):
    the D loss, R1 term and mean real logit, the STN's losses and the
    renderer metric, both nets' gradients and updates.  A replica whose
    weights are moved by 1e-6 gives each gradient's float32 spread: the
    STN's gradient reaches it through the renderer's and D's input
    gradients, piecewise constant in their inputs (ReLU, leaky ReLU), and
    the STN places the layers by sub-pixel shifts, so a float32 change of
    a shift flips some units and moves that gradient by about 1%."""
    d, jd, res, batch, to_port, to_jax = d_pair(kind)
    layers = 2
    nst = auto_stn_stages(res)
    stn = seeded(STN(img_resolution=res, img_channels=4, img_layers=layers,
                     num_stages=nst), 4)
    renderer = seeded(build_renderer('tanh', img_resolution=res,
                                     img_channels=4, img_layers=layers), 5)
    renderer.eval().requires_grad_(False)
    jstn = JaxSTN(img_resolution=res, img_channels=4, img_layers=layers,
                  num_stages=nst)
    renderer_vars = owned(jti.renderer_params_from_torch(
        renderer.state_dict(), 'tanh'))
    tx = optax.adam(1e-3, b1=0.9, b2=0.999)
    d_params = owned(to_jax(d)['params'])
    stn_params = owned(jax_stn(stn.state_dict())['params'])
    opt_d_ref, opt_stn_ref = tx.init(d_params), tx.init(stn_params)
    train_d, train_stn = jax_stn_steps(
        jd, jstn, jax_renderer('tanh', img_resolution=res, img_channels=4,
                               img_layers=layers), renderer_vars, 10.0, tx)
    run = PortRun(d, stn, renderer)
    moved = PortRun(nudged(d, 1), nudged(stn, 2), renderer)

    def stn_named(tree):
        return named(weights.stn_state_dict({'params': tree}), stn)

    def d_named(tree):
        return named(to_port({'params': tree}), d)

    rng = np.random.RandomState(6)
    for i in range(STEPS):
        data = synthetic_batch(rng, 3 * batch, layers, res)
        pseudo = generate_pseudo_fake_np(data)
        real1, p2, p3 = data[:batch], pseudo[batch:2 * batch], \
            pseudo[2 * batch:]
        d_params, opt_d_ref, rec_ref, grads = train_d(
            d_params, opt_d_ref, {'params': stn_params}, jnp.asarray(real1),
            jnp.asarray(p2))
        rec, d_grads, d_now = run.d_step(real1, p2)
        rec_moved, d_grads_moved, d_moved = moved.d_step(real1, p2)
        check_losses(f'{kind} D step {i}', rec, rec_ref, rec_moved)
        check(f'{kind} D grads {i}', d_grads, d_named(grads), d_grads_moved)
        check(f'{kind} D params {i}', d_now, d_named(d_params), d_moved)

        stn_params, opt_stn_ref, rec_ref, grads = train_stn(
            stn_params, opt_stn_ref, d_params, jnp.asarray(p3))
        rec, s_grads, s_now = run.g_step(p3)
        rec_moved, s_grads_moved, s_moved = moved.g_step(p3)
        check_losses(f'{kind} STN step {i}', rec, rec_ref, rec_moved)
        check(f'{kind} STN grads {i}', s_grads, stn_named(grads),
              s_grads_moved)
        check(f'{kind} STN params {i}', s_now, stn_named(stn_params),
              s_moved)
    print(f'ill-conditioned (error, spread, bound): {SPREADS}')


def test_stn_pretrain_launches(monkeypatch):
    """A step of the STN GAN with the SG2 D through the kernels' autograd
    Functions (emulated) launches ``expected_stn_pretrain_launches``; the
    simple Ds launch none."""
    d, _, res, batch, _, _ = d_pair('sg2')
    stn = seeded(STN(img_resolution=res, img_channels=4, img_layers=2,
                     num_stages=auto_stn_stages(res)), 4)
    renderer = build_renderer('tanh', img_resolution=res, img_channels=4,
                              img_layers=2).requires_grad_(False)
    data = synthetic_batch(np.random.RandomState(7), 3 * batch, 2, res)
    pseudo = torch.from_numpy(generate_pseudo_fake_np(data))
    data = torch.from_numpy(data)
    kernels = emulate_kernels(monkeypatch)
    for dd in (d, SimpleGlobalDiscriminator(res, 4, nf1=8)):
        for k in kernels.values():
            k.reset()
        opt_d = torch.optim.Adam(dd.parameters())
        opt_stn = torch.optim.Adam(stn.parameters())
        pretrain.stn_d_step(dd, opt_d, stn, renderer, data[:batch],
                            pseudo[batch:2 * batch])
        pretrain.stn_g_step(stn, opt_stn, dd, renderer, pseudo[2 * batch:])
        expect = expected_stn_pretrain_launches(dd, 1)
        assert {k: kernels[k].launches for k in expect} == expect
    assert expected_stn_pretrain_launches(d, 1)['bias_act_grad'] > 0


# ---------------------------------------------------------------------------
# The CLIs
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def layers16(tmp_path_factory):
    d = tmp_path_factory.mktemp('stage0')
    return make_synthetic_layer_dataset(str(d / 'layers'), num_samples=6,
                                        size=16, spec=DEFAULT_SPEC[:2])


def narrow_d(kind, img_resolution, img_channels):
    """The SG2 D at test widths (the CLI's is channel_base 32768)."""
    assert kind == 'sg2'
    return Discriminator(img_resolution=img_resolution,
                         img_channels=img_channels, channel_base=256,
                         channel_max=32)


def test_pretrain_clis_run_and_read_each_renderer_format(layers16, tmp_path,
                                                         monkeypatch):
    """``pretrain-renderer`` for 2 steps (its checkpoint holds the renderer
    and AMSGrad's state), then ``pretrain-stn`` for 2 steps on it, and for
    one step each on the same renderer as a JAX ``.msgpack``
    (``save_pytree``) and a reference ``.pth.tar``: each run reads the
    renderer exactly and so takes the same first step.  The SG2 D runs at
    test widths."""
    out = pretrain_renderer.main(['--data', layers16, '--outdir',
                                  str(tmp_path / 'r'), '--batch', '2',
                                  '--steps', '2', '--device', 'cpu'])
    assert out.snapshots == [str(tmp_path / 'r' / 'renderer000002.pt')]
    assert len(out.loss) == 2 and np.isfinite(out.loss + out.psnr).all()
    ckpt = torch.load(out.snapshots[0], weights_only=True)
    assert ckpt['global_step'] == 2 and ckpt['opt_state']['state']
    state = ckpt['renderer']

    monkeypatch.setattr(pretrain_stn, 'build_discriminator', narrow_d)
    base = ['--data', layers16, '--batch', '2', '--device', 'cpu']
    run = pretrain_stn.main([*base, '--outdir', str(tmp_path / 's'),
                             '--renderer-ckpt', out.snapshots[0],
                             '--steps', '1'])
    assert [os.path.basename(p) for p in run.snapshots] == [
        'r1gan000000.pt', 'r1gan000001.pt']
    assert len(run.records) == 2 and all(
        np.isfinite(list(r.values())).all() for r in run.records)

    msgpack = str(tmp_path / 'renderer.msgpack')
    jvars = jti.renderer_params_from_torch(state, 'tanh')
    jckpt.save_pytree(msgpack, {'global_step': 2, 'renderer': jvars,
                                'opt_state': None})
    pth = str(tmp_path / 'renderer.pth.tar')
    torch.save({'renderer': jte.renderer_state_dict(jvars, 'tanh')}, pth)
    for path in (msgpack, pth):
        again = pretrain_stn.main([*base, '--outdir', str(tmp_path / 'x'),
                                   '--renderer-ckpt', path, '--steps', '0'])
        for k, v in state.items():
            assert torch.equal(again.renderer.state_dict()[k], v), (path, k)
        assert again.records[0] == run.records[0], path
    if not torch.cuda.is_available():   # the card is the default: no fallback
        with pytest.raises(RuntimeError, match='no CUDA device'):
            pretrain_stn.main([*base[:-2], '--outdir', str(tmp_path / 'y'),
                               '--renderer-ckpt', pth, '--steps', '0'])
