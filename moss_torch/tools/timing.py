"""Timers of the tools and chip_smoke.py: device time on a GPU, host time on the CPU."""
from __future__ import annotations

import time

import numpy as np
import torch


_cycles_per_ms = None


def _sleep_ms(ms: float):
    """Keep the current stream busy for about `ms` in a spinning kernel."""
    global _cycles_per_ms
    if _cycles_per_ms is None:  # calibrate the spin once per process
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(10 ** 7)
        e1.record()
        e1.synchronize()
        _cycles_per_ms = 10 ** 7 / max(e0.elapsed_time(e1), 1e-3)
    torch.cuda._sleep(int(min(ms, 1e3) * _cycles_per_ms))


def cuda_ms(fn, n=20, reps=10, warmup=3):
    """Device ms per call of fn: the median over n samples, each a run of
    `reps` back-to-back calls between two CUDA events, after warm-up. Before
    each run the stream spins for twice the host time it takes to queue a
    run, so the host's work between launches (a wrapper's checks, ctypes)
    leaves the device no idle gap inside the events: a kernel shorter than
    that work is timed, not the host. A call that synchronizes waits for the
    spin and is timed with its host work, as it would be without it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        _sleep_ms(2 * queue_ms)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1) / reps)
    return float(np.median(times))


def cpu_ms(fn, n=20, reps=10, warmup=3):
    """cuda_ms's sampling on the host clock, for runs asked onto the CPU."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / reps)
    return float(np.median(times))


def timer(device: torch.device):
    """The timer for work on `device`: cuda_ms on a GPU, cpu_ms on the CPU."""
    return cuda_ms if device.type == "cuda" else cpu_ms


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
