"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``python3 -m benchmark.run ...``) from the root of a checkout, on a
machine with as many CUDA devices as the cell asks for.  The kernels the
port builds at first use go to ``montage_gan_tpu_torch/build/`` and any
other kernel cache to ``.bench_cache/``, both inside the checkout."""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
for var, sub in (('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('TRITON_CACHE_DIR', 'triton')):
    os.environ[var] = os.path.join(ROOT, '.bench_cache', sub)

from benchmark.harness import main  # noqa: E402

if __name__ == '__main__':
    sys.exit(main(t_start=T_START))
