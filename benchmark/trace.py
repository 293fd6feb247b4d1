"""What a torch.profiler trace of the window's first segment says.

Read from the profiler's raw results (chip_smoke.py's trace_events: the
events key_averages() is built from, without building its objects): each
device operation's name and interval, and the host events beside them. The
device is busy where some operation runs (the union of their intervals); an
idle gap is a stretch between two busy ones, named by what the host was
doing in it: a CUDA graph capture, a read of the step logs, graph replays being launched, or other host work.
"""
from __future__ import annotations

import collections
from typing import List, Tuple

# a gap's name, by the first of these found among the host events in it
GAP_NAMES = (("capture", ("cudaStreamBeginCapture", "cudaStreamEndCapture", "cudaGraphInstantiate")),
             ("log read", ("aten::_local_scalar_dense", "cudaStreamSynchronize", "aten::to",
                           "aten::item")),
             ("segment", ("cudaGraphLaunch",)))


class Trace:
    def __init__(self, prof, wall_s: float, steps: int):
        from torch.autograd import DeviceType
        from torch.autograd.profiler_util import _filter_name

        self.wall_s, self.steps = wall_s, steps
        self.device: List[Tuple[str, int, int]] = []
        self.host: List[Tuple[str, int, int]] = []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if _filter_name(name) or getattr(e, "is_hidden_event", lambda: False)():
                continue
            row = (name, e.start_ns(), e.end_ns())
            on_card = e.device_type() == DeviceType.CUDA
            (self.device if on_card else self.host).append(row)
        self.device.sort(key=lambda r: r[1])
        self.busy_spans = _merge([(s, e) for _, s, e in self.device])

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_spans) / 1e9

    def device_s(self, *names: str) -> float:
        """Seconds of the device operations whose name holds one of `names`."""
        return sum(e - s for n, s, e in self.device if any(k in n for k in names)) / 1e9

    def top_ops(self, n: int = 10) -> List[list]:
        by = collections.Counter()
        for name, s, e in self.device:
            by[name[:120]] += (e - s) / 1e9
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10) -> List[list]:
        gaps = [(a_end, b_start) for (_, a_end), (b_start, _) in
                zip(self.busy_spans, self.busy_spans[1:]) if b_start > a_end]
        named = []
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
            inside = {name for name, hs, he in self.host if hs < e and he > s}
            label = next((lbl for lbl, keys in GAP_NAMES if inside & set(keys)), "host")
            named.append([label, (e - s) / 1e9])
        return named


def _merge(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out
