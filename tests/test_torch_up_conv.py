"""The synthesis up-convolution (``ops/conv2d_resample.py``, ``up=2``): the
route every up block takes, and the card against the CPU.

The tests marked ``cuda`` need a CUDA card and skip without one.  This file
imports no JAX, so they run on the card's machine, where ``tests/conftest.py``
(which imports JAX) cannot load:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_up_conv.py
"""

import pytest
import torch

import chip_smoke
from montage_gan_tpu_torch import set_fp32_precision
from montage_gan_tpu_torch.models.synthesis import SynthesisNetwork
from montage_gan_tpu_torch.ops import conv2d_resample as tconv
from montage_gan_tpu_torch.ops import filters as tfilters
from montage_gan_tpu_torch.ops import upfirdn2d as tup


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    set_fp32_precision()
    return torch.cuda.get_device_name(0)


def test_synthesis_up_blocks_take_phase_route():
    """A micro synthesis net's forward: one ``up_phases`` per block
    above the first (its ``conv0``), every other conv (``conv1``, ToRGB)
    plain, no other up route."""
    net = SynthesisNetwork(img_resolution=32, img_channels=4, w_dim=16,
                           channel_base=128, channel_max=16, num_fp16_res=2)
    net.reset_parameters(torch.Generator().manual_seed(0))
    ws = torch.randn(2, net.num_ws, 16, generator=torch.Generator()
                     .manual_seed(1))
    tconv.reset()
    with torch.no_grad():
        img = net(ws, noise_mode='const')
    blocks = len(net.block_resolutions)
    assert img.shape == (2, 32, 32, 4)
    assert dict(tconv.LOWERINGS) == {'up_phases': blocks - 1,
                                     'plain': 2 * blocks}


def _orders(x0, w0, r, s, **kw):
    """The up path's output, order 1 of <out², r> in (x, w), and order 2
    (<∂x, s>) in (x, w)."""
    x = x0.clone().requires_grad_(True)
    w = w0.clone().requires_grad_(True)
    out = tconv.conv2d_resample(x, w, **kw)
    g1 = torch.autograd.grad((out.float().square() * r).sum(), (x, w),
                             create_graph=True)
    g2 = torch.autograd.grad((g1[0].float() * s).sum(), (x, w))
    return [out, *g1, *g2]


def _inputs(dtype, dev):
    """The synthesis conv0 at 16² → 32², 64 → 32 channels, O(1) values."""
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(4, 16, 16, 64, generator=gen)
    w = torch.randn(32, 64, 3, 3, generator=gen) / 24.0
    r = torch.randn(4, 32, 32, 32, generator=gen)
    s = torch.randn(4, 16, 16, 64, generator=gen)
    return (x.to(dev, dtype), w.to(dev), r.to(dev), s.to(dev))


KW = dict(up=2, padding=1, flip_weight=False)


@pytest.mark.cuda
def test_up_path_card_matches_cpu_f32(card):
    """float32, orders 0-2, card against CPU: the output within
    ``TOL_CROSS``, each gradient within ``TOL_TRAIN_GRAD`` of its largest
    entry; the up path launches no K2'."""
    tconv.reset()
    launches = tup.kernel.launches
    got = _orders(*_inputs(torch.float32, 'cuda'),
                  f=tfilters.setup_filter([1, 3, 3, 1], device='cuda'), **KW)
    assert dict(tconv.LOWERINGS) == {'up_phases': 1}, card
    assert tup.kernel.launches == launches, card
    ref = _orders(*_inputs(torch.float32, 'cpu'),
                  f=tfilters.setup_filter([1, 3, 3, 1]), **KW)
    torch.testing.assert_close(got[0].cpu(), ref[0], **chip_smoke.TOL_CROSS)
    for a, b in zip(got[1:], ref[1:]):
        err = (a.cpu() - b).abs().max().item()
        assert err <= chip_smoke.TOL_TRAIN_GRAD * b.abs().max().item(), (
            card, err, b.abs().max().item())


@pytest.mark.cuda
def test_up_path_card_matches_cpu_bf16(card):
    """bfloat16, orders 0-2: the card and the CPU's bfloat16 route held to
    the CPU's float32 truth, the card no further from it than twice the
    CPU's route plus 1e-2 of the truth's largest entry (``chip_smoke.py``'s
    rule for the kernels' gradients in bfloat16)."""
    f = tfilters.setup_filter([1, 3, 3, 1])
    got = _orders(*_inputs(torch.bfloat16, 'cuda'), f=f.cuda(), **KW)
    plain = _orders(*_inputs(torch.bfloat16, 'cpu'), f=f, **KW)
    truth = _orders(*_inputs(torch.float32, 'cpu'), f=f, **KW)
    for a, p, t in zip(got, plain, truth):
        dk = (a.cpu().float() - t).abs().max().item()
        dp = (p.float() - t).abs().max().item()
        assert dk <= 2 * dp + 1e-2 * t.abs().max().item(), (card, dk, dp)
