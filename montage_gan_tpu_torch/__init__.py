"""montage_gan_tpu_torch — MontageGAN in PyTorch, with hand-written CUDA
kernels for Hopper (H100).

The port of ``montage_gan_tpu`` (JAX on a TPU), which stays beside it as the
reference.  Module layout and names mirror the JAX package (``ops/``,
``models/``, ``utils/``, ``cli/``); public op and model functions keep its
NHWC layout; module state-dict keys are the reference checkpoint's
(``montage_gan_tpu/utils/torch_export.py``).  ``csrc/`` holds the CUDA
sources of the kernels that replace the JAX package's Pallas kernels.

This package imports ``torch`` and never ``jax``.
"""

import torch


def set_fp32_precision() -> None:
    """The port's one precision setting: float32 convolutions and matrix
    products run in full float32 on the card, never in TF32.

    cuDNN would otherwise run float32 convolutions in TF32 (about three
    decimal digits), which the JAX reference does not do on the CPU.  The
    blocks that trade precision for speed are the bfloat16 synthesis blocks
    (``num_fp16_res``), as in the reference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
