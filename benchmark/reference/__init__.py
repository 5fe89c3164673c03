"""The benchmark's plain reference of the training step.

A frozen copy of the port's modules on their plain routes: the mapping,
synthesis nets, discriminators, STN, renderer, the augment pipe, the phase
losses, the optimizers, the EMA and the ADA controller, with every
hand-written kernel replaced by its plain PyTorch version (``bias_act``,
``upfirdn2d``, ``affine_warp``, ``composite``) and every collective by the
identity (``mesh``).  It imports nothing of the port; the benchmark gives it
the same weights, rows and draws as the port and compares what each makes.
Its precision is the caller's: ``torch.backends`` decides TF32.
"""
