"""Analytic FLOPs of the training step, for ``mfu_pct`` and
``conv_roofline``.

A copy of the JAX package's ``utils/flops.py`` arithmetic, which reads the
configuration through the reference's ``MontageConfig``: the convolutions'
and fully connected layers' multiply-accumulates (2 FLOPs each) of every
network forward, composed per phase with the AD multipliers (a backward
pass about 2x its forward; a backward through a frozen network to its input
1x; a gradient penalty's double backward 2x the forward and backward it
differentiates).  Elementwise work, the augment pipe's warps and the
composite are left out: the count is of the work the tensor cores could do.
It covers the single-GAN phases too (``paper256``: one layer, no global
mapping, no STN, renderer or global D), which are the local phases of one
layer.  The peak is the H100's dense bf16 rate (``peaks.py``), not a TPU's.
"""

from __future__ import annotations

from typing import Tuple

from .reference.synthesis import _spatial, block_resolutions, channels_for
from .reference.ensemble import MontageConfig


def _conv(b, h, w, cin, cout, k=3):
    return 2.0 * b * h * w * cin * cout * k * k


def _fc(b, cin, cout):
    return 2.0 * b * cin * cout


def mapping_fwd(cfg: MontageConfig, batch: int, num_splits: int) -> float:
    d = cfg.w_dim
    out_dim = d * num_splits
    feats = [cfg.z_dim] + [d] * (cfg.mapping_num_layers - 1) + [out_dim]
    return sum(_fc(batch, feats[i], feats[i + 1])
               for i in range(cfg.mapping_num_layers))


def synthesis_fwd(cfg: MontageConfig, layer_idx: int, batch: int) -> float:
    init_res, res = cfg.layer_geometry(layer_idx)
    cci = cfg.conv_config_index
    total = 0.0
    prev_ch = 0
    for r in block_resolutions(res, cci):
        ch = channels_for(r, cfg.channel_base, cfg.channel_max)
        h, w = _spatial(r, init_res, cci)
        if prev_ch:
            # conv0 upsamples 2×: the zero-stuffed input contributes only
            # ~k²/4 taps per output, so the contraction is ¼ of a dense conv
            # (validated against XLA cost_analysis, tests/test_flops.py)
            total += _conv(batch, h, w, prev_ch, ch) / 4
            total += _fc(batch, cfg.w_dim, prev_ch)      # its affine
        total += _conv(batch, h, w, ch, ch)              # conv1
        total += _fc(batch, cfg.w_dim, ch)
        total += _conv(batch, h, w, ch, cfg.img_channels, k=1)  # torgb (skip)
        total += _fc(batch, cfg.w_dim, ch)
        prev_ch = ch
    return total


def discriminator_fwd(cfg: MontageConfig, batch: int,
                      target: Tuple[int, int], res: int,
                      init_res: Tuple[int, int]) -> float:
    cci = cfg.conv_config_index
    resolutions = list(reversed(block_resolutions(res, cci)))  # top-down
    total = 0.0
    for i, r in enumerate(resolutions):
        ch_tmp = channels_for(r, cfg.channel_base, cfg.channel_max)
        ch_out = channels_for(r // 2, cfg.channel_base, cfg.channel_max) \
            if r > resolutions[-1] else ch_tmp
        h, w = _spatial(r, init_res, cci)
        if i == 0:
            total += _conv(batch, h, w, cfg.img_channels, ch_tmp, k=1)
        if r > resolutions[-1]:
            total += _conv(batch, h, w, ch_tmp, ch_tmp)             # conv0
            total += _conv(batch, h // 2, w // 2, ch_tmp, ch_out)   # conv1↓
            total += _conv(batch, h // 2, w // 2, ch_tmp, ch_out, k=1)  # skip
    # epilogue at the last block's resolution
    ch = channels_for(resolutions[-1], cfg.channel_base, cfg.channel_max)
    h0, w0 = init_res
    total += _conv(batch, h0, w0, ch + 1, ch)       # mbstd channel + conv
    total += _fc(batch, ch * h0 * w0, ch)           # fc over spatial cells
    total += _fc(batch, ch, 1)
    return total


def stn_fwd(cfg: MontageConfig, batch: int) -> float:
    lc = cfg.num_layers * cfg.img_channels
    widths = (64, 128, 256, 384, 512)[:cfg.stn_stages]
    kernels = (7, 5, 3, 3, 3)[:cfg.stn_stages]
    total = 0.0
    s = cfg.base_resolution
    prev = lc
    for wdt, k in zip(widths, kernels):
        total += _conv(batch, s, s, prev, wdt, k=k)
        s //= 2
        prev = wdt
    total += _fc(batch, prev * s * s, 64)
    total += _fc(batch, 64, cfg.num_layers * 2)
    return total


def renderer_fwd(cfg: MontageConfig, batch: int) -> float:
    if cfg.renderer_type == 'none':
        return 0.0
    lc = cfg.num_layers * cfg.img_channels
    r, nf = cfg.base_resolution, 64
    total = _conv(batch, r, r, lc, nf)
    total += 3 * _conv(batch, r, r, nf, nf)
    total += _conv(batch, r, r, nf, cfg.img_channels)
    return total


def local_phase_flops(cfg: MontageConfig, hyper, layer_idx: int, *,
                      include_greg: bool = False,
                      include_dreg: bool = False) -> float:
    """FLOPs of ONE execution of layer ``layer_idx``'s merged local program
    (Gmain + Dmain, plus the PL/R1 reg phases when their ``lax.cond`` masks
    fire).  Per-event — no interval amortization (the executor runs this as
    ``Timing/local_<name>``, training/phase_exec.py:381-392)."""
    b = hyper.batch_size
    n = cfg.num_layers
    map_f = mapping_fwd(cfg, b, n if cfg.use_global_mapping else 1)
    init_res, res = cfg.layer_geometry(layer_idx)
    g_f = synthesis_fwd(cfg, layer_idx, b)
    d_f = discriminator_fwd(cfg, b, cfg.layer_targets[layer_idx], res,
                            init_res)
    # Gmain: diff(map+G) fwd+bwd, frozen D fwd + input-bwd
    total = 3 * (map_f + g_f) + 2 * d_f
    # Dmain: frozen G fwd, D fwd+bwd on fake AND real
    total += (map_f + g_f) + 2 * 3 * d_f
    if include_greg:
        # Greg (PL): shrunk batch, double backward over map+G
        shrink = max(hyper.pl_batch_shrink, 1)
        total += 3 * 3 * (map_f + g_f) / shrink
    if include_dreg:
        # Dreg (R1): double backward over D on reals
        total += 3 * 3 * d_f
    return total


def tail_phase_flops(cfg: MontageConfig, hyper) -> dict:
    """Per-EVENT FLOPs of the global/renderer tail phases, keyed by the
    executor's ``Timing/<name>`` phase names (phase_exec.py:416-433)."""
    b = hyper.batch_size
    n = cfg.num_layers
    map_f = mapping_fwd(cfg, b, n if cfg.use_global_mapping else 1)
    all_g = sum(synthesis_fwd(cfg, i, b) for i in range(n))
    stn_f = stn_fwd(cfg, b)
    ren_f = renderer_fwd(cfg, b)
    gd_f = discriminator_fwd(cfg, b,
                             (cfg.base_resolution, cfg.base_resolution),
                             cfg.base_resolution, cfg.base_init_res)
    return {
        # renderer phase (losses.renderer_loss): frozen G-chain fwd to make
        # the gen stack + renderer fwd+bwd on gen AND real stacks
        'Renderer': n * map_f + all_g + stn_f + 2 * 3 * ren_f,
        # global Gmain: diff(9×map + 9×G + STN) fwd+bwd, frozen
        # renderer+D fwd + input-bwd
        'global_Gmain': 3 * (n * map_f + all_g + stn_f) + 2 * (ren_f + gd_f),
        # global Dmain: frozen G-chain fwd; frozen renderer fwd on fake AND
        # real stacks (no renderer bwd needed — D's param grads stop at D's
        # own input); D fwd+bwd on both
        'global_Dmain': (n * map_f + all_g + stn_f) + 2 * ren_f
                        + 2 * 3 * gd_f,
        # global Dreg (R1): double backward through renderer+augment+D
        'global_Dreg': 3 * 3 * (ren_f + gd_f),
    }


def phase_flops(cfg: MontageConfig, hyper, step_idx: int = 0) -> dict:
    """FLOPs of every phase program the PhaseExecutor dispatches at
    ``step_idx``, keyed exactly like its ``Timing/<name>`` stats — divide a
    measured phase wall-time by its entry to get achieved FLOP/s."""
    do_greg = (hyper.g_reg_interval is not None and hyper.pl_weight != 0
               and step_idx % hyper.g_reg_interval == 0)
    do_dreg = (hyper.d_reg_interval is not None and hyper.r1_gamma != 0
               and step_idx % hyper.d_reg_interval == 0)
    out = {}
    if hyper.train_local:
        for i, name in enumerate(cfg.layer_names):
            out[f'local_{name}'] = local_phase_flops(
                cfg, hyper, i, include_greg=do_greg, include_dreg=do_dreg)
    tail = tail_phase_flops(cfg, hyper)
    if hyper.train_renderer and cfg.renderer_type != 'none':
        out['Renderer'] = tail['Renderer']
    if hyper.train_global and cfg.train_global:
        goi = max(hyper.global_optimize_interval, 1)
        if step_idx % goi == 0:
            out['global_Gmain'] = tail['global_Gmain']
            out['global_Dmain'] = tail['global_Dmain']
            if (hyper.d_reg_interval is not None
                    and hyper.global_r1_gamma != 0
                    and step_idx % (hyper.d_reg_interval * goi) == 0):
                out['global_Dreg'] = tail['global_Dreg']
    return out


def train_step_flops(cfg: MontageConfig, hyper) -> float:
    """Amortized FLOPs of ONE AIO training step at batch ``hyper.batch_size``
    (lazy-reg phases divided by their intervals, mirroring
    training/train_step.py and reference custom/loss_aio.py)."""
    n = cfg.num_layers
    total = 0.0

    if hyper.train_local:
        for i in range(n):
            base = local_phase_flops(cfg, hyper, i)
            total += base
            if hyper.g_reg_interval and hyper.pl_weight:
                total += (local_phase_flops(cfg, hyper, i, include_greg=True)
                          - base) / hyper.g_reg_interval
            if hyper.d_reg_interval and hyper.r1_gamma:
                total += (local_phase_flops(cfg, hyper, i, include_dreg=True)
                          - base) / hyper.d_reg_interval

    tail = tail_phase_flops(cfg, hyper)
    if hyper.train_global and cfg.train_global:
        goi = max(hyper.global_optimize_interval, 1)
        total += (tail['global_Gmain'] + tail['global_Dmain']) / goi
        if hyper.d_reg_interval and hyper.global_r1_gamma:
            total += tail['global_Dreg'] / (hyper.d_reg_interval * goi)

    if hyper.train_renderer and cfg.renderer_type != 'none':
        total += tail['Renderer']

    return total


def step_flops(cfg: MontageConfig, hyper, step_idx: int) -> float:
    """FLOPs of the step numbered ``step_idx``: the phases it runs."""
    return sum(phase_flops(cfg, hyper, step_idx).values())
