"""The benchmark's copy of the FLOP arithmetic gives the JAX package's
numbers (``montage_gan_tpu/utils/flops.py`` at config ``aio``, batch 32),
held here as constants: the copy must not import the JAX package."""

import pytest

from benchmark import flops, spec

# montage_gan_tpu.utils.flops: train_step_flops, and sum(phase_flops(s))
# for steps 0, 1 and 4, at MontageConfig() and TrainHyper(batch_size=32)
AIO_AMORTISED = 1.599e14
AIO_STEPS = {0: 2.629e14, 1: 1.463e14, 4: 1.799e14}


def _cell(config, traffic):
    return spec.build_reference(
        spec.load_json(spec.BENCH_DIR / 'configs' / f'{config}.json'),
        spec.load_json(spec.BENCH_DIR / 'traffic' / f'{traffic}.json'))


def test_aio_flops_match_the_jax_package():
    cfg, hyper = _cell('aio', 'layers-b32')
    assert flops.train_step_flops(cfg, hyper) == pytest.approx(
        AIO_AMORTISED, rel=5e-4)
    for step, expected in AIO_STEPS.items():
        assert flops.step_flops(cfg, hyper, step) == pytest.approx(
            expected, rel=5e-4)


def test_paper256_flops_are_the_local_phases_of_one_layer():
    cfg, hyper = _cell('paper256', 'images-b64')
    phases = flops.phase_flops(cfg, hyper, 0)
    assert list(phases) == ['local_image']
    assert phases['local_image'] == flops.local_phase_flops(
        cfg, hyper, 0, include_greg=True, include_dreg=True)
    # regularizers make step 0 the heaviest, step 1 the lightest
    s0, s1, s4 = (flops.step_flops(cfg, hyper, s) for s in (0, 1, 4))
    assert s0 > s4 > s1 > 0
    assert s1 < flops.train_step_flops(cfg, hyper) < s0
