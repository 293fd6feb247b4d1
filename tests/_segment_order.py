"""Pair lists for the segment sum's tests, and csrc/segment_sum.cu's order of
adds in numpy float32 (no jax, no moss_tpu: the card tests import it too)."""
import numpy as np
import torch

from moss_torch.ops import rasterize_cuda as rc
from moss_torch.ops.binning import PairList

LANES = 32
PER_WARP = 3  # csrc/segment_sum.cu kPerWarp: Gaussians of a warp, GRAD_COLS lanes each


def pair_list(lengths, seed=0, device="cpu"):
    """A PairList whose Gaussian g has lengths[g] pairs, scattered over the
    pair list in increasing order (as binning's tile order leaves them).
    Only the fields the segment sum and its references read are real."""
    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int64)
    n = int(lengths.sum())
    perm = rng.permutation(n)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    gaussian_pairs = np.concatenate(
        [np.sort(perm[offsets[g]:offsets[g + 1]]) for g in range(len(lengths))] + [[]]
    ).astype(np.int32)
    pair_gaussian = np.empty(n, np.int32)
    pair_gaussian[gaussian_pairs] = np.repeat(np.arange(len(lengths)), lengths)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=device)

    return PairList(pair_gaussian=t(pair_gaussian), tile_offsets=t([0, n]), tile_count=t([n]),
                    overflow=torch.zeros((), dtype=torch.int32, device=device),
                    gaussian_pairs=t(gaussian_pairs), gaussian_offsets=t(offsets))


def kernel_order(rows, gaussian_pairs, offsets):
    """csrc/segment_sum.cu's sums, add for add, in float32: a segment of at
    most SEGMENT_LONG pairs in order by one lane a column; a longer one by 32
    lanes (lane l takes pairs l, l + 32, ...) and an xor butterfly, column k
    read from lane 10 (g % 3) + k."""
    rows = np.asarray(rows, np.float32)
    out = np.zeros((len(offsets) - 1, rows.shape[1]), np.float32)
    for g in range(len(offsets) - 1):
        seg = rows[gaussian_pairs[offsets[g]:offsets[g + 1]]]
        acc = np.zeros(rows.shape[1], np.float32)
        if len(seg) <= rc.SEGMENT_LONG:
            for r in seg:
                acc = acc + r
        else:
            part = np.zeros((LANES, rows.shape[1]), np.float32)
            for j, r in enumerate(seg):
                part[j % LANES] = part[j % LANES] + r
            for off in (16, 8, 4, 2, 1):
                part = part + part[np.arange(LANES) ^ off]
            first = rc.GRAD_COLS * (g % PER_WARP)
            acc = part[first + np.arange(rows.shape[1]), np.arange(rows.shape[1])]
        out[g] = acc
    return out


# (name, segment lengths): bench-like short segments; empty Gaussians (no
# pair, a zero row) around one segment longer than 64 pairs (a large splat
# over many tiles); long segments next to each other in one warp
CASES = (
    ("short", np.random.default_rng(1).integers(1, 6, 200)),
    ("empty_and_long", [0, 3, 0, 0, 97, 1, 0, 2, 0, 5, 33, 0, 32, 4] + [0] * 7),
    ("long_neighbours", [70, 65, 200, 1, 0, 129, 31, 2]),
    ("all_empty", [0] * 10),
)
