"""Canned training recipes: the reference's ``main.py`` launcher as a CLI.

Port of ``montage_gan_tpu/cli/run_recipe.py``, with ``argparse`` in place of
click.  Each routine of the reference's ``main.py`` (reference: main.py:
7-16, 27-58) is a named recipe: ``train_aio`` with the canonical argument
set, differing only in ``--resume``/``--metrics`` per routine:

    python -m montage_gan_tpu_torch.cli.run_recipe step1 --data DIR \\
        [--outdir output] [--resume PATH|ALIAS] [--dry-run] [overrides...]

Flags after the recipe that are not the recipe's own are passed to
``train_aio`` and override the canonical set (``--kimg 100``; a flag
followed by another flag carries no value).  The recipe prints its
``train-aio`` command line, then runs the port's ``cli/train_aio.main``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

# The canonical argument set (reference: main.py:7-16).
CANONICAL = {
    '--mirror': 'true',
    '--metrics': 'none',
    '--kimg': '5000',
    '--target': '0.6',
    '--augpipe': 'bgcfnc',
    '--net-snap': '5',
    '--cfg': 'aio',
}

# recipe → (needs_resume, extra flags) (reference: main.py:24-58)
RECIPES = {
    # step 1: joint pretraining from scratch (no resume)
    'step1': (False, {}),
    # step 2: resume from the step-1 snapshot
    'step2': (True, {}),
    # latent-interpolation sheet from a snapshot (the reference flips the
    # run_latent_interpolation/run_once config knobs,
    # custom/training_loop_aio.py:77-80)
    'interpolation': (True, {'--run-latent-interpolation': None,
                             '--run-once': None}),
    # metric evaluation of a snapshot (reference: main.py:50-58)
    'metrics': (True, {'--metrics': 'fid50k_full,is50k',
                       '--run-once': None}),
}


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog='python -m montage_gan_tpu_torch.cli.run_recipe',
        allow_abbrev=False,
        description='Run a canned train_aio recipe (reference main.py '
                    'routine); flags after it override the canonical set.')
    add = p.add_argument
    add('recipe', choices=list(RECIPES))
    add('--outdir', default='output', metavar='DIR')
    add('--data', required=True, metavar='DIR')
    add('--resume', default=None, metavar='PATH|ALIAS')
    add('--dry-run', action='store_true', default=False)
    return p


def recipe_argv(recipe: str, outdir: str, data: str, resume: Optional[str],
                dry_run: bool, overrides: Sequence[str]) -> list:
    """``train_aio``'s command line of a recipe; a usage error raises
    ``ValueError``."""
    needs_resume, extra = RECIPES[recipe]
    if needs_resume and not resume:
        raise ValueError(f'recipe {recipe!r} requires --resume '
                         '(reference main.py step-2 semantics)')
    flags = dict(CANONICAL)
    flags.update(extra)
    # overrides: alternating --flag [value] (a flag directly followed by
    # another --flag is boolean-style and carries no value)
    toks = list(overrides)
    i = 0
    while i < len(toks):
        tok = toks[i]
        if not tok.startswith('--'):
            raise ValueError(f'unexpected argument {tok!r}')
        if i + 1 < len(toks) and not toks[i + 1].startswith('--'):
            flags[tok] = toks[i + 1]
            i += 2
        else:
            flags[tok] = None
            i += 1
    argv = ['--outdir', outdir, '--data', data]
    if resume:
        argv += ['--resume', resume]
    for k, v in flags.items():
        argv.append(k)
        if v is not None:
            argv.append(str(v))
    if dry_run:
        argv.append('--dry-run')
    return argv


def main(argv: Optional[Sequence[str]] = None):
    """Print the recipe's ``train-aio`` line and run it; returns what
    ``train_aio.main`` returns."""
    parser = make_parser()
    opts, overrides = parser.parse_known_args(argv)
    try:
        args = recipe_argv(opts.recipe, opts.outdir, opts.data, opts.resume,
                           opts.dry_run, overrides)
    except ValueError as e:
        parser.error(str(e))
    print(f'run-recipe {opts.recipe}: train-aio ' + ' '.join(args))
    from .train_aio import main as train_aio_main
    return train_aio_main(args)


if __name__ == '__main__':
    main()
