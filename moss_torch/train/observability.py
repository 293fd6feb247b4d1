"""Observability (port of moss_tpu/train/observability.py): timestamped
stdout, EMA-smoothed losses, the result-file lines, TensorBoard scalars,
images and histograms (tensorboardX, the reference's train_ZJU.py:220-291),
a torch.profiler trace where moss_tpu takes a jax.profiler one, and section
timing that waits for the device.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch


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


def _host(x) -> np.ndarray:
    """A tensor on any device, or an array, as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class TBWriter:
    """A thin tensorboardX writer; it writes nothing when logdir is empty or
    tensorboardX does not import (as moss_tpu's: a logging choice)."""

    def __init__(self, logdir: Optional[str]):
        self.writer = None
        if logdir:
            try:
                from tensorboardX import SummaryWriter

                os.makedirs(logdir, exist_ok=True)
                self.writer = SummaryWriter(logdir)
            except ImportError:
                pass

    def scalar(self, tag: str, value, step: int):
        if self.writer is not None:
            self.writer.add_scalar(tag, float(value), step)

    def scalars(self, logs: Dict, step: int, prefix: str = "train/"):
        for k, v in logs.items():
            try:
                self.scalar(prefix + k, float(v), step)
            except (TypeError, ValueError):
                pass

    def image(self, tag: str, img_hwc, step: int):
        if self.writer is not None:
            self.writer.add_image(tag, np.clip(_host(img_hwc), 0, 1), step, dataformats="HWC")

    def histogram(self, tag: str, values, step: int):
        if self.writer is not None:
            self.writer.add_histogram(tag, _host(values), step)

    def close(self):
        if self.writer is not None:
            self.writer.close()


@contextlib.contextmanager
def profile_trace(logdir: Optional[str]):
    """A torch.profiler trace of the block, CPU and (where there is one) CUDA
    activities, written under logdir as a Chrome trace
    (trace_<pid>_<ns>.json); nothing when logdir is empty. The profile object
    is yielded."""
    if not logdir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Timer:
    """Host-clock section timing; a section with a sync_value waits for the
    device its tensors lie on before it stops the clock (moss_tpu's
    block_until_ready)."""

    def __init__(self):
        self.sections: Dict[str, float] = {}

    @contextlib.contextmanager
    def section(self, name: str, sync_value=None):
        t0 = time.time()
        yield
        if sync_value is not None:
            _synchronize(sync_value)
        self.sections[name] = self.sections.get(name, 0.0) + time.time() - t0


def _synchronize(value):
    """Wait for every CUDA device the tensors in `value` (a tensor, or a
    list, tuple or dict of them) lie on."""
    if isinstance(value, torch.Tensor):
        if value.device.type == "cuda":
            torch.cuda.synchronize(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _synchronize(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _synchronize(v)
