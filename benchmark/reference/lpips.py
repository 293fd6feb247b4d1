"""LPIPS perceptual distance with a VGG16 backbone (port of moss_tpu/ops/lpips_jax.py).

A frozen copy of moss_torch/ops/lpips.py for the benchmark's reference (its
plain path only, imports pointed into benchmark.reference).

Five VGG16 stages (relu1_2 ... relu5_3), channel-unit-normalized, squared
difference weighted by the lin heads, spatial mean, summed over stages.
Inputs are (H, W, 3) images in [0, 1], fed to the scaling layer without a
[-1, 1] shift, as the reference calls it.

Parameters are a dict {"convs": [[{"w", "b"}, ...] per stage], "lins": [...]}
of tensors: conv weights (Cout, Cin, 3, 3), as torch's conv2d takes them.
`params_from_numpy` reads moss_tpu's layout (HWIO numpy arrays, lpips_jax.py
:50-86); `init_random(seed)` makes the same He-initialized random backbone and
uniform heads as moss_tpu's init_random from the same numpy seed, and
`load_params` reads the same npz schema. The backbone is frozen: its
tensors take no grad. `backbone(path)` is the drivers' choice: the weights at
`path`, or the random backbone with RANDOM_NOTE (moss_tpu's result note);
there is no environment lookup.

The convs are torch.nn.functional.conv2d: moss_tpu computes them in XLA, not
in a Pallas kernel. `dtype` is the towers' activation type: bf16 for the
training loss, f32 for the metric; the head always runs in f32. Feature maps
that leave this module (gt_features) are (1, H', W', C), moss_tpu's layout.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


_VGG_CFG = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def gt_feature_bytes(h: int, w: int, dtype_bytes: int = 2) -> int:
    """Bytes of one frame's cached ground-truth tower (gt_features, bf16) at
    input size (h, w): every conv stage's output (moss_tpu's
    lpips_jax.gt_feature_bytes)."""
    total = 0
    for out_ch, _ in _VGG_CFG:
        total += h * w * out_ch * dtype_bytes
        h, w = max(h // 2, 1), max(w // 2, 1)
    return total


def _features(params, x, dtype) -> List[torch.Tensor]:
    """x: (N, 3, H, W) normalized -> the five stage features (N, C, H', W')."""
    feats = []
    h = x.to(dtype)
    for bi, block in enumerate(params["convs"]):
        for p in block:
            h = torch.relu(F.conv2d(h, p["w"].to(dtype), p["b"].to(dtype), padding=1))
        feats.append(h)
        if bi < len(params["convs"]) - 1:
            h = F.max_pool2d(h, 2)  # odd trailing row/col dropped, as moss_tpu's _maxpool2
    return feats


_SCALING_ON = {}  # device -> (shift, scale): copied to a device once, not every call


def _norm_input(im):
    """(H, W, 3) in [0, 1] -> (1, 3, H, W) through the scaling layer."""
    if im.device not in _SCALING_ON:
        _SCALING_ON[im.device] = (torch.as_tensor(_SHIFT, device=im.device),
                                  torch.as_tensor(_SCALE, device=im.device))
    shift, scale = _SCALING_ON[im.device]
    return ((im - shift) / scale).permute(2, 0, 1)[None]


def gt_features(params: Dict, img, dtype=torch.bfloat16) -> List[torch.Tensor]:
    """The ground-truth tower for lpips(cached_f2=...), computed once per frame:
    five (1, H', W', C) maps in `dtype`."""
    with torch.no_grad():
        return [f.permute(0, 2, 3, 1) for f in _features(params, _norm_input(img), dtype)]


def lpips(params: Dict, img1, img2=None, dtype=torch.float32, cached_f2=None):
    """Perceptual distance of two (H, W, 3) images in [0, 1]; a scalar.

    cached_f2: gt_features(params, img2) in place of img2."""
    f1 = [f.permute(0, 2, 3, 1) for f in _features(params, _norm_input(img1), dtype)]
    f2 = cached_f2 if cached_f2 is not None else [
        f.permute(0, 2, 3, 1) for f in _features(params, _norm_input(img2), dtype)]
    total = 0.0
    for a, b, lin in zip(f1, f2, params["lins"]):
        a = a.float()
        b = b.float()
        # sum_c lin_c (a_c/|a| - b_c/|b|)^2 as three lin-weighted channel dots
        inv_a = 1.0 / (torch.sqrt(torch.sum(a * a, dim=-1)) + 1e-10)
        inv_b = 1.0 / (torch.sqrt(torch.sum(b * b, dim=-1)) + 1e-10)
        aa = torch.sum(a * a * lin, dim=-1)
        bb = torch.sum(b * b * lin, dim=-1)
        ab = torch.sum(a * b * lin, dim=-1)
        d = aa * inv_a * inv_a + bb * inv_b * inv_b - 2.0 * ab * inv_a * inv_b
        total = total + torch.mean(d)
    return total
