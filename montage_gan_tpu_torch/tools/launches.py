"""Exact kernel launch counts of the port's main paths, from the module
structure: what ``chip_smoke.py``, ``tools/ddp_check.py`` and the CPU tests
(through the kernels' emulated autograd Functions) hold the launch counters
to.  Per rank of a data-parallel run the counts are one process's: a rank
runs every phase on its share of each round.
"""

from __future__ import annotations


def _count(module, kinds) -> int:
    """How many submodules of ``module`` (itself included) are ``kinds``."""
    return sum(isinstance(m, kinds) for m in module.modules())


def expected_launches(model):
    """Launches one sampling call makes: one bias_act per FullyConnected,
    SynthesisLayer and ToRGBLayer forward; one upfirdn2d (the ToRGB skip
    upsample) per synthesis block above the first."""
    from ..models.layers import FullyConnected
    from ..models.synthesis import SynthesisLayer, ToRGBLayer
    k1 = _count(model, (FullyConnected, SynthesisLayer, ToRGBLayer))
    k2 = sum(len(net.block_resolutions) - 1 for net in model.local_g)
    return {'bias_act': k1, 'upfirdn2d': k2}


def expected_train_launches(model, hyper, steps):
    """Launches of ``steps`` training steps from step 0, per kernel, from the
    module structure.  Per local layer (G: S synthesis layers, T ToRGBs, A
    style affines, B blocks; D: nD bias_act layers, Lb of them in the
    blocks; M mapping FCs, twice with style mixing):

    * K1' forward: one per bias_act a forward runs.  Gmain M + G + D;
      Greg M + G; Dmain M + G + 2 D (fakes and reals apart); Dr1 D.
    * K1' grad: one per backward of a bias_act whose activation is not the
      identity (the affines and D's last FC are linear with gain 1, no
      clamp: their backward is the identity; so are the ToRGBs' without
      ``conv_clamp``, and T counts 0 in K1' grad).  Gmain: D (nD - 1), G (S + T),
      M.  Greg: inner grad S + T; outer: each synthesis layer's order-1 node
      (S) and forward node (S: the style gradient reads its output), and M.
      The ToRGBs' inner nodes see the constant path-length noise and record
      nothing.  Dmain: 2 (nD - 1).  Dr1: inner nD - 1, outer nD - 1 for the
      order-1 nodes and Lb for the block layers' forward nodes (the
      minibatch-std's gradient reads the blocks' output).
    * K2' (forward and backward): B - 1 per G forward; Gmain's backward
      B - 1; Greg's inner grad B - 1 (its outer pass reads none).
    * K3': the augmented forward in Gmain (B), Dmain (2B) and Dr1, and the
      backward of K4' in Dr1's outer pass.  K4': Gmain's backward and Dr1's
      inner grad.

    The renderer and global phases run every local G once per global
    forward (all layers: M + G each, and B - 1 K2'), and the global D (nD,
    Lb of its own) as a local D is run: the renderer phase one global
    forward without gradients; global Gmain a global forward, the D, and
    the backward of both (no renderer, STN or composite op launches a
    kernel); global Dmain a global forward without gradients and the D on
    fakes and reals, augmented together at 2B; global R1 the D's Dr1.  The
    global pipe's warp runs as in the local phases.

    With microbatch accumulation every round runs its phase's forward and
    backward over its slice of the batch: the local phases' launches are
    multiplied by ``hyper.accum_rounds``, the renderer's and the global
    phases' by ``hyper.global_accum_rounds``.

    A conditional ensemble (``cfg.c_dim > 0``; the single-GAN ``train``
    with ``--cond``) adds the label ``embed`` FC to every mapping call (K1';
    linear with gain 1, so its backward launches nothing), and every local D
    call runs its own ``mapping`` (Md FCs: the embed and Ld lrelu FCs) for
    the projection: Md K1' per D forward, and Ld K1' grad where the backward
    reaches D's weights through the label map (Dmain's two D calls, and
    Dr1's outer pass, whose inner gradient reads the map); Gmain's backward
    stops at the G's weights and does not enter it.  Freeze-D
    (``cfg.freeze_d_layers``): the F frozen layers are the first ones, and
    every layer upstream of a frozen one is frozen too, so a backward to D's
    weights runs none of their backward nodes: F fewer K1' grad in each of
    Dmain's two D calls and in Dr1's outer pass (their forward nodes; the
    inner pass still runs to the image).  This is the launch count of a
    1-layer ensemble (``train``) as well as of config ``aio``."""
    from ..models.layers import Conv2dLayer, FullyConnected
    from ..models.synthesis import SynthesisLayer, ToRGBLayer

    def d_counts(d):
        """(bias_act layers of D's body, of its blocks, of its label map,
        lrelu layers of its label map, frozen layers)."""
        cond = getattr(d, 'c_dim', 0) > 0
        md = _count(d.mapping, FullyConnected) if cond else 0
        frozen = sum(not m.trainable for m in d.modules()
                     if isinstance(m, Conv2dLayer))
        return (_count(d, (Conv2dLayer, FullyConnected)) - md,
                sum(_count(b, Conv2dLayer) for b in d.blocks()), md,
                d.mapping.num_layers if cond else 0, frozen)

    def has_warp(aug):
        return int(aug is not None and (aug.any_blit or aug.any_geom))

    warp = has_warp(hyper.augment if not hyper.local_noaug else None)
    gwarp = has_warp(hyper.augment if not hyper.global_noaug else None)
    calls = 2 if hyper.style_mixing_prob > 0 else 1
    m_grad = model.mapping.num_layers * calls
    m = m_grad + int(model.cfg.c_dim > 0) * calls     # the label embed
    clamped = int(model.cfg.conv_clamp is not None)
    g_fwd = g_grad = g_up = 0        # one global forward: all local Gs
    for g in model.local_g:
        s, t = _count(g, SynthesisLayer), _count(g, ToRGBLayer)
        g_fwd += m + s + t + _count(g, FullyConnected)
        g_grad += m_grad + s + t * clamped
        g_up += len(g.block_resolutions) - 1
    use_r = not hyper.bypass_renderer and model.renderer is not None
    rounds, grounds = hyper.accum_rounds, hyper.global_accum_rounds
    renderer = int(hyper.train_renderer and use_r) * grounds
    glob = int(hyper.train_global and model.stn is not None)
    out = dict.fromkeys(('bias_act', 'bias_act_grad', 'upfirdn2d',
                         'warp_forward', 'warp_transpose'), 0)
    for step in range(steps):
        greg = int(hyper.g_reg_interval is not None and hyper.pl_weight != 0
                   and step % hyper.g_reg_interval == 0)
        dr1 = int(hyper.d_reg_interval is not None and hyper.r1_gamma != 0
                  and step % hyper.d_reg_interval == 0)
        for g, d in zip(model.local_g, model.local_d):
            if not hyper.train_local:
                break
            s, t = _count(g, SynthesisLayer), _count(g, ToRGBLayer)
            n_g = s + t + _count(g, FullyConnected)
            t_grad = t * clamped
            blocks = len(g.block_resolutions)
            n_d, lb, md, md_grad, f = d_counts(d)
            d_fwd = n_d + md
            out['bias_act'] += rounds * ((m + n_g + d_fwd)
                                         + greg * (m + n_g)
                                         + (m + n_g + 2 * d_fwd)
                                         + dr1 * d_fwd)
            out['bias_act_grad'] += rounds * (
                (n_d - 1 + s + t_grad + m_grad)
                + greg * (3 * s + t_grad + m_grad)
                + 2 * (n_d - 1 - f + md_grad)
                + dr1 * (2 * (n_d - 1) + lb - f + md_grad))
            out['upfirdn2d'] += rounds * (blocks - 1) * (2 + 2 * greg + 1)
            out['warp_forward'] += rounds * warp * (2 + 2 * dr1)
            out['warp_transpose'] += rounds * warp * (1 + dr1)
        out['bias_act'] += renderer * g_fwd
        out['upfirdn2d'] += renderer * g_up
        if not glob:
            continue
        goi = hyper.global_optimize_interval
        n_d, lb, _, _, _ = d_counts(model.global_d)
        main = int(step % goi == 0) * grounds
        gr1 = int(hyper.d_reg_interval is not None
                  and hyper.global_r1_gamma != 0
                  and step % (hyper.d_reg_interval * goi) == 0) * grounds
        out['bias_act'] += (main * ((g_fwd + n_d) + (g_fwd + 2 * n_d))
                            + gr1 * n_d)
        out['bias_act_grad'] += (main * ((n_d - 1 + g_grad) + 2 * (n_d - 1))
                                 + gr1 * (2 * (n_d - 1) + lb))
        out['upfirdn2d'] += main * 3 * g_up
        out['warp_forward'] += gwarp * (2 * main + 2 * gr1)
        out['warp_transpose'] += gwarp * (main + gr1)
    return out


def expected_projector_launches(model, steps):
    """Launches of ``cli/projector.project`` for ``steps`` steps: the
    mapping once over the w statistics' samples (one K1' per FC); per step
    every local G forward (``expected_launches`` without the mapping) and
    its backward (the layer stack joins every net, so all of them run it,
    ``--layer`` or not): K1' grad per synthesis layer and per ToRGB with
    ``conv_clamp`` (the affines' backward is the identity), K2' per skip
    upsample; then one forward of the result."""
    from ..models.layers import FullyConnected
    from ..models.synthesis import SynthesisLayer, ToRGBLayer

    clamped = int(model.cfg.conv_clamp is not None)
    fwd = grad = ups = 0
    for g in model.local_g:
        fwd += _count(g, (FullyConnected, SynthesisLayer, ToRGBLayer))
        grad += _count(g, SynthesisLayer) + clamped * _count(g, ToRGBLayer)
        ups += len(g.block_resolutions) - 1
    return {'bias_act': _count(model.mapping, FullyConnected)
            + (steps + 1) * fwd,
            'bias_act_grad': steps * grad,
            'upfirdn2d': (2 * steps + 1) * ups}


def expected_generator_launches(mapping, synthesis):
    """Launches of one call of a monolithic generator (a reference
    ``.pkl``'s, ``cli/generate.py::generate_pkl``): one K1' per
    FullyConnected (the label ``embed`` and the style affines included),
    SynthesisLayer and ToRGBLayer forward; one K2' (the ToRGB skip
    upsample) per synthesis block above the first."""
    from ..models.layers import FullyConnected
    from ..models.synthesis import SynthesisLayer, ToRGBLayer
    return {'bias_act': _count(mapping, FullyConnected)
            + _count(synthesis, (FullyConnected, SynthesisLayer, ToRGBLayer)),
            'upfirdn2d': len(synthesis.block_resolutions) - 1}


def expected_stn_pretrain_launches(d, steps):
    """Launches of ``steps`` steps of ``cli/pretrain_stn.py`` with the
    discriminator ``d``.  Only the SG2 ``Discriminator`` launches kernels
    (nD bias_act layers; the renderer, the STN, the composite and the
    simple Ds are plain PyTorch, and its down-sampling convs fold their FIR
    into the weights, so no K2').  A step:

    * the D step runs D on the reals, its input gradient with a graph (R1:
      nD - 1 K1' grad, the output FC being linear with gain 1), D on the
      detached fakes, and one backward of the loss to D's weights: each
      reals node whose backward is not the identity (nD - 1), each order-1
      node of the input gradient (nD - 1) and each fakes node (nD - 1);
    * the STN step runs D on the rendered placements and the backward
      through it to the STN (nD - 1)."""
    from ..models.layers import Conv2dLayer, FullyConnected
    n_d = _count(d, (Conv2dLayer, FullyConnected))
    grad = 5 * (n_d - 1) if n_d else 0
    return {'bias_act': steps * 3 * n_d, 'bias_act_grad': steps * grad,
            'upfirdn2d': 0}
