"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source under ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` (Hopper)
into its own shared library with a plain C interface, at first use, under
``montage_gan_tpu_torch/build/``, and is loaded with ``ctypes``.  The
library's file name carries a hash of its sources and flags, so an edited
source is never served by a stale build.  ``build`` starts one ``nvcc`` per
source, all at once.

Every kernel is a :class:`CudaKernel`: the C entry point, its ``ctypes``
signature, a plain integer count of the launches it made, the same count per
variant of the kernel, and the bytes those launches had to move.  A failed
build or a launch that returns a CUDA error raises; nothing falls back.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')
SOURCES = ('bias_act', 'upfirdn2d', 'warp', 'composite')

# name -> compiler log (ptxas register/spill report) of the builds this
# process ran; empty for libraries that were already built.
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else the toolkit's default install location."""
    candidates: List[str] = []
    home = os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
    if home:
        candidates.append(os.path.join(home, 'bin', 'nvcc'))
    on_path = shutil.which('nvcc')
    if on_path:
        candidates.append(on_path)
    candidates.append('/usr/local/cuda/bin/nvcc')
    for c in candidates:
        if os.path.isfile(c):
            return c
    raise RuntimeError('nvcc not found: set CUDA_HOME to the CUDA toolkit '
                       '(the kernels build from csrc/ at first use)')


def library_path(name: str) -> Path:
    digest = hashlib.sha1()
    for src in sorted(CSRC_DIR.glob('*.cuh')) + [CSRC_DIR / f'{name}.cu']:
        digest.update(src.read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{digest.hexdigest()[:12]}.so'


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no current library, one ``nvcc``
    per source, all started together.  Raises with the compiler's output if
    any build fails."""
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f'.{os.getpid()}.tmp')
        cmd = [nvcc, *NVCC_FLAGS, '-I', str(CSRC_DIR), '-o', str(tmp),
               str(CSRC_DIR / f'{n}.cu')]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[n] = out
        if proc.returncode != 0:
            failed.append(f'--- {n}.cu (nvcc exit {proc.returncode}) ---\n{out}')
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError('CUDA kernel build failed:\n' + '\n'.join(failed))
    return paths


class CudaKernel:
    """One C entry point of a ``csrc/`` library, bound on first launch.

    ``launches`` counts the launches this wrapper made, ``variants`` the
    same launches by the variant the wrapper chose, and ``bytes`` the bytes
    they had to move (each input read once, each output written once, as
    the wrapper counts them).  Callers that measure a path call ``reset``
    before and read them after."""

    def __init__(self, source: str, symbol: str,
                 argtypes: Sequence[type]):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.bytes = 0
        self.variants: collections.Counter = collections.Counter()
        self._lib = None
        self._fn = None

    def reset(self) -> None:
        self.launches = 0
        self.bytes = 0
        self.variants.clear()

    def count(self, variant: str, nbytes: int) -> None:
        """Record one launch of ``variant`` that moves ``nbytes``."""
        self.launches += 1
        self.variants[variant] += 1
        self.bytes += int(nbytes)

    def _bind(self):
        if self._fn is None:
            path = build([self.source])[self.source]
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            lib.mgt_error_string.argtypes = [ctypes.c_int]
            lib.mgt_error_string.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args, variant: str = 'kernel', nbytes: int = 0) -> None:
        """Call the entry point (which launches on the given stream and
        returns ``cudaGetLastError()``); raise if the launch failed, else
        count it under ``variant`` with the ``nbytes`` it moves."""
        rc = (self._fn or self._bind())(*args)
        if rc != 0:
            msg = self._lib.mgt_error_string(rc).decode()
            raise RuntimeError(f'{self.symbol} ({variant}) failed: CUDA error '
                               f'{rc} ({msg})')
        self.count(variant, nbytes)


def tensor_bytes(*tensors) -> int:
    """Bytes of the given tensors (None counts 0): what a launch that reads
    or writes each once moves."""
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def takes_plain(x) -> bool:
    """Whether an op runs its plain PyTorch version on ``x``: exactly when
    ``x`` lies on the CPU.  A CUDA tensor launches the kernel or raises."""
    return x.device.type == 'cpu'


def check_current(device, current: int) -> int:
    """``device``'s index, where it is the CUDA device of index
    ``current``; raises otherwise.  An entry point launches on the current
    device and reads its attributes there, so a tensor on another card
    would be read from the wrong one."""
    if device.type != 'cuda' or device.index != current:
        raise RuntimeError(f'a kernel launch for a tensor on {device} while '
                           f'cuda:{current} is the current device: make the '
                           'tensor\'s card current (torch.cuda.set_device)')
    return device.index


def launch_device(x) -> int:
    """The index of ``x``'s card, which must be the current device."""
    import torch
    return check_current(x.device, torch.cuda.current_device())


def stream_handle(device: int) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on the CUDA
    device of index ``device`` (``tensor.get_device()``), read without
    building a stream object."""
    import torch
    return torch._C._cuda_getCurrentRawStream(device)
