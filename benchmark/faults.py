"""Faults planted in the port's trainer (or the reference's, which has the
same seams), each a hook on a ``harness.PortRun``-like object with a
``trainer``: ``correct`` has to come out false under each."""


def no_update(run) -> None:
    """Every phase runs and hands its gradients on, and no optimizer steps
    and no EMA moves: a step that returns its state unchanged, its losses
    and gradients kept."""
    trainer = run.trainer

    def apply(name, opt, params, grads):
        if trainer.phase_hook is not None:
            trainer.phase_hook(name, grads)

    def ema_and_ada(state):
        state.step += 1
    trainer._apply = apply
    trainer._ema_and_ada = ema_and_ada


def half_batch(run) -> None:
    """Half of each batch left out, the losses the mean over the rest."""
    step = run.trainer.train_step

    def broken(state, stack, crops, rng, **kw):
        n = crops[0].shape[0] // 2
        return step(state, None if stack is None else stack[:n],
                    [c[:n] for c in crops], rng, **kw)
    run.trainer.train_step = broken
