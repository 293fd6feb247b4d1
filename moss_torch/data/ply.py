"""Gaussian-cloud PLY export and import (port of moss_tpu/data/ply.py).

The reference's binary little-endian layout, attribute for attribute:
x y z nx ny nz f_dc_* f_rest_* opacity scale_* rot_*, with f_dc and f_rest
flattened channel-major. For the same arrays the file is byte for byte the
one moss_tpu writes, so clouds move between the two packages and open in
standard 3DGS viewers. Host code in numpy: tensors are read back first.
"""
from __future__ import annotations

import numpy as np
import torch


def _attribute_names(n_rest: int) -> list:
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    names += [f"f_rest_{i}" for i in range(3 * n_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def _np(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def save_ply(path, xyz, f_dc, f_rest, opacity, scaling, rotation):
    """Raw (pre-activation) arrays or tensors: f_dc (P, 1, 3), f_rest (P, K, 3)."""
    xyz = _np(xyz)
    P = xyz.shape[0]
    f_dc = _np(f_dc).transpose(0, 2, 1).reshape(P, -1)
    f_rest = _np(f_rest).transpose(0, 2, 1).reshape(P, -1)
    attrs = np.concatenate([xyz, np.zeros_like(xyz), f_dc, f_rest, _np(opacity).reshape(P, -1),
                            _np(scaling), _np(rotation)], axis=1)
    names = _attribute_names(f_rest.shape[1] // 3)
    if attrs.shape[1] != len(names):
        raise ValueError(f"{attrs.shape[1]} attributes for {len(names)} names")
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {P}"]
    header += [f"property float {n}" for n in names]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(attrs.astype("<f4").tobytes())


def load_ply(path) -> dict:
    """{xyz, f_dc (P, 1, 3), f_rest (P, K, 3), opacity (P, 1), scaling (P, 3),
    rotation (P, 4)} as numpy arrays."""
    with open(path, "rb") as f:
        data = f.read()
    head_end = data.index(b"end_header\n") + len(b"end_header\n")
    names, P = [], 0
    for line in data[:head_end].decode("ascii").splitlines():
        if line.startswith("element vertex"):
            P = int(line.split()[-1])
        elif line.startswith("property float"):
            names.append(line.split()[-1])
        elif line.startswith("property"):
            raise ValueError(f"only float properties supported, got: {line}")
    arr = np.frombuffer(data[head_end:], dtype="<f4").reshape(P, len(names))
    col = {n: i for i, n in enumerate(names)}

    def cols(*keys):
        return np.stack([arr[:, col[k]] for k in keys], axis=1)

    rest = sorted((n for n in names if n.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1]))
    return {
        "xyz": cols("x", "y", "z"),
        "f_dc": cols(*(f"f_dc_{i}" for i in range(3)))[:, None, :],
        "f_rest": cols(*rest).reshape(P, 3, len(rest) // 3).transpose(0, 2, 1) if rest
        else np.zeros((P, 0, 3), np.float32),
        "opacity": cols("opacity"),
        "scaling": cols(*(f"scale_{i}" for i in range(3))),
        "rotation": cols(*(f"rot_{i}" for i in range(4))),
    }
