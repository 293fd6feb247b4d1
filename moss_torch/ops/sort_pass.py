"""One bitonic compare-exchange pass, repeated: csrc/sort_pass.cu and its plain version.

Port of tools/sort_micro.py::_lane_pass_kernel (:47) and _row_pass_kernel
(:68), the TPU's measure of what one pass of an in-memory bitonic sort
network costs. Both take a (rows, 128) int32 block and repeat one pass `r`
times; the lower position of each pair keeps the min, the upper the max:

  lane_pass(x, stride, r):  element l of a row pairs with l ^ stride
                            (stride a power of two below 128)
  row_pass(x, stride_rows, r): rows [g, g + S) pair with [g + S, g + 2S)

A pass is idempotent, so r repeats give the result of one; the repeats are
there to time a pass with the data on chip. On a CPU tensor the wrappers run
the plain version; on a CUDA tensor they launch the kernel or raise.
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build

LANES = 128  # csrc/sort_pass.cu kLanes
# tools/sort_micro.py's block and repeat count: 2^19 keys, R = 64
ROWS, R = 4096, 64

# kernel launches since the last reset (set to 0 to count a run)
lane_launches = 0  # moss_sort_lane_pass
row_launches = 0   # moss_sort_row_pass

# x, out; rows, stride, reps
_SIGNATURE = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3


def network_passes(n_keys: int):
    """(lane passes, row passes) of a full bitonic network over n_keys = 2^k
    keys in rows of 128 (tools/sort_micro.py:101-106): stage k has k passes,
    at strides 2^(k-1) ... 1; those below 128 are lane passes."""
    n_stages = n_keys.bit_length() - 1
    lane = sum(min(k, 7) for k in range(1, n_stages + 1))
    row = sum(max(k - 7, 0) for k in range(1, n_stages + 1))
    return lane, row


def lane_pass_plain(x, stride: int, r: int = 1):
    lane = torch.arange(x.shape[1], device=x.device)
    partner = lane ^ stride
    lower = (lane & stride) == 0
    for _ in range(r):
        p = x[:, partner]
        x = torch.where(lower, torch.minimum(x, p), torch.maximum(x, p))
    return x


def row_pass_plain(x, stride_rows: int, r: int = 1):
    rows, lanes = x.shape
    for _ in range(r):
        y = x.reshape(rows // (2 * stride_rows), 2, stride_rows, lanes)
        x = torch.stack([torch.minimum(y[:, 0], y[:, 1]), torch.maximum(y[:, 0], y[:, 1])],
                        dim=1).reshape(rows, lanes)
    return x


def _check(x, stride: int, r: int, what: str):
    if x.dtype != torch.int32 or x.dim() != 2 or x.shape[1] != LANES or not x.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous (rows, {LANES}) int32 block, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if stride < 1 or stride & (stride - 1) or r < 0:
        raise ValueError(f"{what}: stride {stride} must be a power of two and r {r} >= 0")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: runs on CPU or CUDA tensors, got {x.device}")


def lane_pass(x, stride: int, r: int = 1):
    """r repeats of the lane-stride pass over x (rows, 128) int32."""
    global lane_launches
    _check(x, stride, r, "lane_pass")
    if stride >= LANES:
        raise ValueError(f"lane_pass: stride {stride} must be below {LANES}")
    if x.device.type == "cpu":
        return lane_pass_plain(x, stride, r)
    out = torch.empty_like(x)
    cuda_build.launch("sort_pass", "moss_sort_lane_pass", _SIGNATURE, x.device,
                      x.data_ptr(), out.data_ptr(), x.shape[0], stride, r)
    lane_launches += 1
    return out


def row_pass(x, stride_rows: int, r: int = 1):
    """r repeats of the row-stride pass over x (rows, 128) int32."""
    global row_launches
    _check(x, stride_rows, r, "row_pass")
    if x.shape[0] % (2 * stride_rows):
        raise ValueError(f"row_pass: {x.shape[0]} rows are not groups of 2 x {stride_rows}")
    if x.device.type == "cpu":
        return row_pass_plain(x, stride_rows, r)
    out = torch.empty_like(x)
    cuda_build.launch("sort_pass", "moss_sort_row_pass", _SIGNATURE, x.device,
                      x.data_ptr(), out.data_ptr(), x.shape[0], stride_rows, r)
    row_launches += 1
    return out
