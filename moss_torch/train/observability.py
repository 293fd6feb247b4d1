"""The drivers' logging (port of the parts of moss_tpu/train/observability.py
they call): timestamped stdout, EMA-smoothed losses and the result-file
lines. TensorBoard and the profiler trace are not ported yet.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional


class TimestampedStdout:
    """Prefix each stdout line with [HH:MM:SS] (the reference's safe_state
    wrapper, utils/general_utils.py:120-136); quiet=True drops the output."""

    def __init__(self, inner, quiet: bool = False, fmt: str = "%H:%M:%S"):
        self._inner = inner
        self._quiet = quiet
        self._fmt = fmt
        self._line_start = True

    def write(self, s: str):
        if self._quiet:
            return
        for piece in s.splitlines(keepends=True):
            if self._line_start and piece.strip():
                self._inner.write(f"[{time.strftime(self._fmt)}] ")
            self._inner.write(piece)
            self._line_start = piece.endswith("\n")

    def flush(self):
        self._inner.flush()

    def __getattr__(self, name):
        return getattr(self._inner, name)


def install_timestamped_stdout(quiet: bool = False):
    """Wrap sys.stdout in place (idempotent); returns the wrapper."""
    if isinstance(sys.stdout, TimestampedStdout):
        return sys.stdout
    sys.stdout = TimestampedStdout(sys.stdout, quiet=quiet)
    return sys.stdout


class EMALogger:
    """EMA-smoothed losses (the reference's 0.4 / 0.6 mix, train_ZJU.py:146)."""

    def __init__(self, alpha: float = 0.4):
        self.alpha = alpha
        self.values: Dict[str, float] = {}

    def update(self, logs: Dict) -> Dict[str, float]:
        for k, v in logs.items():
            try:
                f = float(v)
            except (TypeError, ValueError):
                continue
            self.values[k] = self.alpha * f + (1 - self.alpha) * self.values.get(k, f)
        return dict(self.values)


def append_result_line(path: str, iteration: int, psnr: float, ssim: float, lpips: float,
                       note: Optional[str] = None):
    """The reference's result line 'iter psnr ssim lpips*1000'
    (train_ZJU.py:270), byte for byte moss_tpu's; `note` appends a trailing
    comment for values that are not comparable to the reference's."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    suffix = f"  # {note}" if note else ""
    with open(path, "a") as f:
        f.write(f"{iteration} {psnr} {ssim} {lpips * 1000}{suffix}\n")
