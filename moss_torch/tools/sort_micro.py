"""Time one bitonic compare-exchange pass on the GPU against torch.sort.

Counterpart of tools/sort_micro.py (:100-122). It times one lane-stride pass
(s = 64) and one row-stride pass (S = 64) over a (4096, 128) int32 block,
each repeated R = 64 times inside one launch of csrc/sort_pass.cu and
divided by R; extrapolates a full 19-stage bitonic network over the 2^19
keys (112 lane passes, 78 row passes); and prints torch.sort of int32 keys
at the binning's key counts (46,080 splats x 10 and x 16) and at 2^19 beside
it. A lane pass at a stride under 32 exchanges through warp shuffles and one
at 32 or 64 within a thread's registers, so the s = 1 pass is timed too and
a second extrapolation prices each lane pass at its own kind.

    python -m moss_torch.tools.sort_micro

Runs on the GPU; main(device="cpu") runs the plain versions on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.sort_pass import LANES, R, ROWS, lane_pass, lane_pass_plain, network_passes, row_pass, \
    row_pass_plain
from .timing import device_name, timer

SORT_KEYS = (46080 * 10, 46080 * 16, ROWS * LANES)


def main(device=None):
    """Print and return the pass times (ms per pass), the extrapolated
    network and the torch.sort times (ms) at SORT_KEYS."""
    dev = resolve_device(device)
    time_ms = timer(dev)
    x = torch.as_tensor(
        np.random.default_rng(0).integers(0, 1 << 30, (ROWS, LANES), np.int32), device=dev)
    for name, got, want in (
            ("lane pass s=64", lane_pass(x, 64, R), lane_pass_plain(x, 64, R)),
            ("lane pass s=1", lane_pass(x, 1, R), lane_pass_plain(x, 1, R)),
            ("row pass S=64", row_pass(x, 64, R), row_pass_plain(x, 64, R))):
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: the kernel differs from its plain version")

    n_total = ROWS * LANES
    n_lane, n_row = network_passes(n_total)
    n_stages = n_total.bit_length() - 1
    n_shuffle = sum(n_stages - j for j in range(5))  # strides 1..16: stage k > j has one
    t_lane = time_ms(lambda: lane_pass(x, 64, R)) / R
    t_lane1 = time_ms(lambda: lane_pass(x, 1, R)) / R
    t_row = time_ms(lambda: row_pass(x, 64, R)) / R
    est = n_lane * t_lane + n_row * t_row
    est_by_kind = n_shuffle * t_lane1 + (n_lane - n_shuffle) * t_lane + n_row * t_row
    print(f"device: {device_name(dev)}; {ROWS}x{LANES} int32, R = {R}")
    print(f"lane-stride pass (s=64):  {t_lane * 1e3:8.3f} us x {n_lane} passes")
    print(f"lane-stride pass (s=1):   {t_lane1 * 1e3:8.3f} us (shuffle strides 1-16: "
          f"{n_shuffle} of the {n_lane})")
    print(f"row-stride pass (S=64):   {t_row * 1e3:8.3f} us x {n_row} passes")
    print(f"=> full bitonic estimate for {n_total} keys: {est:.4f} ms "
          f"({est_by_kind:.4f} ms with the shuffle strides at s=1's time)")

    sort_ms = {}
    rng = np.random.default_rng(1)
    for n in SORT_KEYS:
        keys = torch.as_tensor(rng.integers(0, 1 << 30, n, np.int32), device=dev)
        sort_ms[n] = time_ms(lambda: torch.sort(keys))
        print(f"torch.sort {n:>7d} keys:  {sort_ms[n]:.4f} ms ({sort_ms[n] / n * 1e6:.2f} ns/key)")
    return {"device": device_name(dev), "rows": ROWS, "reps": R,
            "lane_pass_ms": t_lane, "lane_pass_s1_ms": t_lane1, "row_pass_ms": t_row,
            "lane_passes": n_lane, "row_passes": n_row, "shuffle_lane_passes": n_shuffle,
            "network_ms": est, "network_by_kind_ms": est_by_kind, "torch_sort_ms": sort_ms}


if __name__ == "__main__":
    main()
