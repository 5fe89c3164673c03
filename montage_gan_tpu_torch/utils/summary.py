"""Parameter summary of the ensemble (port of
``montage_gan_tpu/utils/summary.py``; reference contract:
torch_utils/misc.py:206-277), counted over the ``nn.Module``s."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from torch import nn


def ensemble_summary(model: nn.Module,
                     layer_names: Optional[Sequence[str]] = None) -> str:
    """A table of parameters and buffers per module of a
    ``MontageEnsemble``: mapping, local Gs, local Ds, STN, global D,
    renderer."""
    rows: List[Tuple[str, int, int]] = []

    def add(name, module):
        if module is None:
            return
        rows.append((name, sum(p.numel() for p in module.parameters()),
                     sum(b.numel() for b in module.buffers())))

    add('mapping', model.mapping)
    for kind, nets in (('G', model.local_g), ('D', model.local_d)):
        for i, net in enumerate(nets or ()):
            name = layer_names[i] if layer_names else f'layer{i}'
            add(f'local_{kind}[{name}]', net)
    add('stn', model.stn)
    add('global_D', getattr(model, 'global_d', None))
    add('renderer', model.renderer)

    width = max(len(r[0]) for r in rows) + 2
    lines = [f"{'Module':<{width}}{'Parameters':>14}{'Buffers':>12}"]
    lines.append('-' * (width + 26))
    total_p = total_b = 0
    for name, p, b in rows:
        lines.append(f"{name:<{width}}{p:>14,}{b:>12,}")
        total_p += p
        total_b += b
    lines.append('-' * (width + 26))
    lines.append(f"{'Total':<{width}}{total_p:>14,}{total_b:>12,}")
    return '\n'.join(lines)
