"""Console/file logging tee (copy of the JAX package's
``utils/logging_utils.py``; reference contract: dnnlib/util.py:56-112)."""

from __future__ import annotations

import sys
from typing import Optional


class Logger:
    """Tee stdout (and optionally stderr) to a log file."""

    def __init__(self, file_name: Optional[str] = None, mode: str = 'w',
                 should_flush: bool = True):
        self.file = open(file_name, mode) if file_name else None
        self.should_flush = should_flush
        self.stdout = sys.stdout
        self.stderr = sys.stderr
        sys.stdout = self
        sys.stderr = self

    def write(self, text: str) -> None:
        if len(text) == 0:
            return
        if self.file is not None:
            self.file.write(text)
        self.stdout.write(text)
        if self.should_flush:
            self.flush()

    def flush(self) -> None:
        if self.file is not None:
            self.file.flush()
        self.stdout.flush()

    def close(self) -> None:
        self.flush()
        if sys.stdout is self:
            sys.stdout = self.stdout
        if sys.stderr is self:
            sys.stderr = self.stderr
        if self.file is not None:
            self.file.close()
            self.file = None


def format_time(seconds: float) -> str:
    s = int(round(seconds))
    if s < 60:
        return f'{s}s'
    if s < 3600:
        return f'{s // 60}m {s % 60:02d}s'
    if s < 86400:
        return f'{s // 3600}h {(s // 60) % 60:02d}m'
    return f'{s // 86400}d {(s // 3600) % 24:02d}h'
