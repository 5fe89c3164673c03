"""One entry point: ``python -m montage_gan_tpu_torch <command> [args]``.

The subcommands of ``montage_gan_tpu/__main__.py:34-46`` under the same
names, each dispatched to the port's CLI (each also runs as
``python -m montage_gan_tpu_torch.cli.<name>``).  ``WAITING`` would list a
command that waits for a ROADMAP queue item; none does.
"""

from __future__ import annotations

import importlib
import sys
from typing import Optional, Sequence

# command → the port's CLI module
PORTED = {'train-aio': 'train_aio', 'generate': 'generate',
          'calc-metrics': 'calc_metrics', 'check-weights': 'check_weights',
          'projector': 'projector', 'style-mixing': 'style_mixing',
          'export-model': 'export_model',
          'compare-renderers': 'compare_renderers',
          'convert-pickle': 'convert_pickle', 'export-torch': 'export_torch',
          'pretrain-renderer': 'pretrain_renderer',
          'pretrain-stn': 'pretrain_stn', 'train': 'train',
          'run-recipe': 'run_recipe', 'dataset-tool': 'dataset_tool'}
# the JAX package's other commands → the ROADMAP queue item they wait for
WAITING: dict = {}

def main(argv: Optional[Sequence[str]] = None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ('-h', '--help'):
        print(__doc__)
        print('commands: ' + ', '.join(PORTED))
        return None
    command, rest = argv[0], argv[1:]
    if command in WAITING:
        raise NotImplementedError(f'{command}: not ported yet, ROADMAP '
                                  f'{WAITING[command]}')
    if command not in PORTED:
        raise SystemExit(f'unknown command {command!r}; commands: '
                         f'{", ".join([*PORTED, *WAITING])}')
    cli = importlib.import_module(f'.cli.{PORTED[command]}', __package__)
    return cli.main(rest)


if __name__ == '__main__':
    main()
