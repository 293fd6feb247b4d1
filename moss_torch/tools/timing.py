"""Timers of the tools and chip_smoke.py: device time on a GPU, host time on the CPU."""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np
import torch


_cycles_per_ms = None
# runs cuda_ms took again because their spin ended before the host had queued
# them (set to 0 to count a stretch of timings), in all and by call site: the
# `site` a caller names, else its file:line (clear to count a stretch)
runs_retaken = 0
retaken_by_site = {}


def _caller() -> str:
    """file:line of the first frame outside this module."""
    frame = sys._getframe(1)
    while frame.f_code.co_filename == __file__:
        frame = frame.f_back
    return f"{os.path.basename(frame.f_code.co_filename)}:{frame.f_lineno}"


def _sleep_ms(ms: float):
    """Keep the current stream busy for about `ms` in a spinning kernel."""
    global _cycles_per_ms
    if _cycles_per_ms is None:  # calibrate the spin once per process
        torch.cuda._sleep(10 ** 7)  # loads the spin kernel and lifts the clocks from idle
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        torch.cuda._sleep(10 ** 7)
        e1.record()
        e1.synchronize()
        _cycles_per_ms = 10 ** 7 / max(e0.elapsed_time(e1), 1e-3)
    torch.cuda._sleep(int(min(ms, 1e3) * _cycles_per_ms))


def cuda_ms(fn, n=20, reps=10, warmup=3, site=None):
    """Device ms per call of fn: the median over n samples, each a run of
    `reps` back-to-back calls between two CUDA events, after warm-up. Before
    each run the stream spins for twice the host time it takes to queue a
    run, so the host's work between launches (a wrapper's checks, ctypes)
    leaves the device no idle gap inside the events: a kernel shorter than
    that work is timed, not the host. A run whose spin ended before the host
    had queued it (the host slowed down, or the spin ran short) was paced by
    the host: it is taken again, after a spin twice as long, up to n times
    (counted in runs_retaken). A call that synchronizes waits for any spin:
    it is timed with its host work, as it would be without one, and no run
    of it is taken again. A retaken run is also counted under `site` (by
    default the caller's file:line) in retaken_by_site."""
    global runs_retaken
    site = site or _caller()
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    _sleep_ms(2 * queue_ms)
    spun = torch.cuda.Event()
    spun.record()
    fn()
    retakes = 0 if spun.query() else n  # the call returned only once the spin was done
    torch.cuda.synchronize()
    times = []
    while len(times) < n:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        _sleep_ms(2 * queue_ms)
        e0.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        e1.record()
        took_ms = (time.perf_counter() - t0) * 1e3
        paced = e0.query()  # the spin was over before the run was queued
        e1.synchronize()
        if paced and retakes:
            retakes -= 1
            runs_retaken += 1
            retaken_by_site[site] = retaken_by_site.get(site, 0) + 1
            queue_ms = max(2 * queue_ms, took_ms)
            continue
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


def sm_clock_hz(device: torch.device):
    """The card's top SM clock in Hz, as nvidia-smi reports it
    (clocks.max.sm); None on the CPU."""
    if device.type != "cuda":
        return None
    index = device.index if device.index is not None else torch.cuda.current_device()
    out = subprocess.run(["nvidia-smi", "-i", str(index), "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], check=True, capture_output=True,
                         text=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6
