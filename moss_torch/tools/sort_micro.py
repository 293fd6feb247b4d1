"""Time one bitonic compare-exchange pass on the GPU against torch.sort.

Counterpart of tools/sort_micro.py (:100-122). It checks the lane-stride pass
at each of its seven strides (1-64) and the row-stride pass at each of its
twelve (1-2048 rows) over a (4096, 128) int32 block exactly against their
plain versions, and times each, repeated R = 64 times inside one launch of
csrc/sort_pass.cu and divided by R; each also at 4R (the difference is what
the passes cost, the rest a launch's fixed cost); both passes with r = 0 (the
read and the write on each kernel's grid, no pass) and an empty kernel on the
lane pass's grid (the launch alone); extrapolates a full 19-stage bitonic
network over the 2^19 keys (112 lane passes, 78 row passes) three ways:
every lane pass at s = 64's time and every row pass at S = 64's (the JAX
tool's estimate), the lane passes at strides 1-16 at s = 1's, and each lane
and row pass at its own stride's time, which prices any map of elements to
threads fairly; and prints torch.sort of int32 keys at the binning's key
counts (46,080 splats x 10 and x 16) and at 2^19 beside it. The table's row
pass stays at S = 64, the JAX tool's stride (tools/sort_micro.py:109).

Both kernels run on one grid, 512 CTAs of 8 warps at 4,096 rows, and keep a
thread's int2s in registers across the repeats: the lane pass a warp a row,
the row pass a warp 64 lanes of a pair of rows, a thread the int2 at the
same lanes of both (ops/sort_pass.py row_elements). So the row pass's r = 0
and the lane pass's differ only by where the second int2 lies, and the empty
kernel on the lane grid is the launch of both.

    python -m moss_torch.tools.sort_micro

Runs on the GPU; main(device="cpu") runs the plain versions on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.sort_pass import LANES, R, ROWS, lane_pass, lane_pass_empty, lane_pass_plain, \
    lane_passes_by_stride, network_passes, row_pass, row_pass_plain, row_passes_by_stride
from .timing import device_name, sm_clock_hz, timer

SORT_KEYS = (46080 * 10, 46080 * 16, ROWS * LANES)
STRIDES = (1, 2, 4, 8, 16, 32, 64)
# a pass is one int32 min or max an element (IMNMX, the ALU pipe: 64 lanes a
# clock an SM on the H100's 132 SMs, half the FP32 rate)
IMNMX_LANES, SMS = 64, 132


def main(device=None):
    """Print and return the pass times (ms per pass), each lane and row
    stride's ms a launch at R and 4R, the reference launches (ms), the
    extrapolated network and the torch.sort times (ms) at SORT_KEYS. Raises if
    a pass differs from its plain version."""
    dev = resolve_device(device)
    time_ms = timer(dev)
    x = torch.as_tensor(
        np.random.default_rng(0).integers(0, 1 << 30, (ROWS, LANES), np.int32), device=dev)
    n_total = ROWS * LANES
    n_lane, n_row = network_passes(n_total)
    by_stride = lane_passes_by_stride(n_total)
    row_by_stride = row_passes_by_stride(n_total)
    checks = [(f"lane pass s={s}", lambda s=s: lane_pass(x, s, R),
               lambda s=s: lane_pass_plain(x, s, R)) for s in STRIDES]
    checks += [(f"row pass S={s}", lambda s=s: row_pass(x, s, R),
                lambda s=s: row_pass_plain(x, s, R)) for s in row_by_stride]
    for name, got, want in checks:
        if not torch.equal(got(), want()):
            raise AssertionError(f"{name}: the kernel differs from its plain version")

    n_shuffle = sum(by_stride[s] for s in STRIDES if s < 32)
    ms_by_stride = {s: {r: time_ms(lambda s=s, r=r: lane_pass(x, s, r)) for r in (R, 4 * R)}
                    for s in STRIDES}
    row_ms_by_stride = {s: {r: time_ms(lambda s=s, r=r: row_pass(x, s, r)) for r in (R, 4 * R)}
                        for s in row_by_stride}
    reference_ms = {"lane_r0": time_ms(lambda: lane_pass(x, 64, 0)),
                    "row_r0": time_ms(lambda: row_pass(x, 64, 0)),
                    "empty": time_ms(lambda: lane_pass_empty(x))}
    t_lane = ms_by_stride[64][R] / R
    t_lane1 = ms_by_stride[1][R] / R
    t_row = row_ms_by_stride[64][R] / R
    est = n_lane * t_lane + n_row * t_row
    est_by_kind = n_shuffle * t_lane1 + (n_lane - n_shuffle) * t_lane + n_row * t_row
    est_by_stride = (sum(n * ms_by_stride[s][R] / R for s, n in by_stride.items())
                     + sum(n * row_ms_by_stride[s][R] / R for s, n in row_by_stride.items()))
    # a pass's own cost: the 3R passes more that 4R takes
    pass_ns = {s: (t[4 * R] - t[R]) / (3 * R) * 1e6 for s, t in ms_by_stride.items()}
    row_pass_ns = {s: (t[4 * R] - t[R]) / (3 * R) * 1e6 for s, t in row_ms_by_stride.items()}
    clock_hz = sm_clock_hz(dev)
    # the least time of a launch's R passes at one IMNMX an element, at the top clock
    issue_floor_ms = R * n_total / (IMNMX_LANES * SMS * clock_hz) * 1e3 if clock_hz else None
    print(f"device: {device_name(dev)}; {ROWS}x{LANES} int32, R = {R}")
    print(f"lane-stride pass (s=64):  {t_lane * 1e3:8.3f} us x {n_lane} passes")
    print(f"lane-stride pass (s=1):   {t_lane1 * 1e3:8.3f} us (strides 1-16: "
          f"{n_shuffle} of the {n_lane})")
    for s in STRIDES:
        print(f"lane pass s={s:<3d} {by_stride[s]:3d} passes:  {ms_by_stride[s][R]:.5f} ms at R, "
              f"{ms_by_stride[s][4 * R]:.5f} at 4R, {pass_ns[s]:7.2f} ns a pass")
    print(f"row-stride pass (S=64):   {t_row * 1e3:8.3f} us x {n_row} passes")
    for s, n in row_by_stride.items():
        print(f"row pass S={s:<4d} {n:3d} passes:  {row_ms_by_stride[s][R]:.5f} ms at R, "
              f"{row_ms_by_stride[s][4 * R]:.5f} at 4R, {row_pass_ns[s]:7.2f} ns a pass")
    print(f"reference launches: lane pass r = 0 {reference_ms['lane_r0']:.5f} ms, row pass "
          f"r = 0 {reference_ms['row_r0']:.5f} ms, empty kernel on the lane grid "
          f"{reference_ms['empty']:.5f} ms")
    if issue_floor_ms:
        print(f"IMNMX issue floor of a launch of R passes: {issue_floor_ms:.5f} ms "
              f"({IMNMX_LANES} lanes a clock an SM, {clock_hz / 1e9:.3f} GHz)")
    print(f"=> full bitonic estimate for {n_total} keys: {est:.4f} ms "
          f"({est_by_kind:.4f} ms with lane strides 1-16 at s=1's time, {est_by_stride:.4f} ms "
          "with each lane and row stride at its own)")

    sort_ms = {}
    rng = np.random.default_rng(1)
    for n in SORT_KEYS:
        keys = torch.as_tensor(rng.integers(0, 1 << 30, n, np.int32), device=dev)
        sort_ms[n] = time_ms(lambda: torch.sort(keys))
        print(f"torch.sort {n:>7d} keys:  {sort_ms[n]:.4f} ms ({sort_ms[n] / n * 1e6:.2f} ns/key)")
    return {"device": device_name(dev), "rows": ROWS, "reps": R,
            "lane_pass_ms": t_lane, "lane_pass_s1_ms": t_lane1, "row_pass_ms": t_row,
            "lane_passes": n_lane, "row_passes": n_row, "shuffle_lane_passes": n_shuffle,
            "lane_passes_by_stride": by_stride, "lane_ms_by_stride": ms_by_stride,
            "row_passes_by_stride": row_by_stride, "row_ms_by_stride": row_ms_by_stride,
            "lane_pass_ns_by_stride": pass_ns, "row_pass_ns_by_stride": row_pass_ns,
            "reference_ms": reference_ms,
            "sm_clock_hz": clock_hz, "issue_floor_ms": issue_floor_ms,
            "network_ms": est, "network_by_kind_ms": est_by_kind,
            "network_by_stride_ms": est_by_stride, "torch_sort_ms": sort_ms}


if __name__ == "__main__":
    main()
