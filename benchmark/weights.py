"""Seeded weights, made on the device in a few large draws.

The reference's own initializers (``reference/*.reset_parameters``) say how
each parameter starts: N(mean, std), flax's truncated normal (±2σ), or a
constant (the parameters, and the buffers the initializers fill, such as
the synthesis nets' constant noise).  ``seeded_state`` reads those rules
once without drawing, then draws every normal parameter from one N(0, 1)
buffer and every truncated one from one truncated buffer, on a generator on
the device seeded from ``seed``, and returns the ensemble, float32 as the
networks store it.  Its state dict (parameters and buffers) is what both
sides start from."""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple
from unittest import mock

import torch
from torch import nn

from .draws import draw_key


@contextlib.contextmanager
def _recording(rules: Dict[int, Tuple]):
    """``nn.init``'s functions record each call's rule instead of drawing."""
    def normal_(t, mean=0.0, std=1.0, generator=None):
        rules[id(t)] = ('normal', float(mean), float(std))
        return t

    def trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=None):
        if abs(a - (mean - 2 * std)) > 1e-6 * std or \
                abs(b - (mean + 2 * std)) > 1e-6 * std:
            raise ValueError('only ±2σ truncation')
        rules[id(t)] = ('trunc', float(mean), float(std))
        return t

    def constant_(t, val):
        rules[id(t)] = ('const', float(val))
        return t

    def zeros_(t):
        return constant_(t, 0.0)
    with mock.patch.multiple(nn.init, normal_=normal_,
                             trunc_normal_=trunc_normal_,
                             constant_=constant_, zeros_=zeros_):
        yield


@torch.no_grad()
def seeded_state(cfg, seed: int, device):
    """The reference ``MontageEnsemble(cfg, with_d=True)`` on ``device``
    with every parameter drawn from ``seed``; its state dict is what the
    port loads."""
    from .reference.ensemble import MontageEnsemble
    device = torch.device(device)
    with torch.device(device):
        ens = MontageEnsemble(cfg, with_d=True)
    rules: Dict[int, Tuple] = {}
    with _recording(rules):
        ens.init_weights(0)
    normal: List[Tuple[torch.Tensor, float, float]] = []
    trunc: List[Tuple[torch.Tensor, float, float]] = []
    params = {id(p) for p in ens.parameters()}
    for name, p in list(ens.named_parameters()) + list(ens.named_buffers()):
        rule = rules.get(id(p))
        if rule is None:
            if id(p) in params:
                raise ValueError(f'{name}: no initializer')
            continue              # a buffer its constructor fills
        if rule[0] == 'const':
            p.fill_(rule[1])
        else:
            (normal if rule[0] == 'normal' else trunc).append(
                (p, rule[1], rule[2]))
    gen = torch.Generator(device=device)
    for kind, group in (('normal', normal), ('trunc', trunc)):
        total = sum(p.numel() for p, _, _ in group)
        if not total:
            continue
        gen.manual_seed(draw_key(seed, 'weights', kind))
        flat = torch.empty(total, device=device)
        if kind == 'normal':
            flat.normal_(generator=gen)
        else:
            nn.init.trunc_normal_(flat, a=-2.0, b=2.0, generator=gen)
        at = 0
        for p, mean, std in group:
            n = p.numel()
            p.copy_(flat[at:at + n].view_as(p) * std + mean)
            at += n
        del flat
    return ens
