"""SSIM / S3IM / PSNR (port of moss_tpu/ops/ssim.py).

A frozen copy of moss_torch/ops/ssim.py for the benchmark's reference (its
plain path only, imports pointed into benchmark.reference).

  * ssim: 11x11 gaussian window (sigma 1.5) as a separable blur of 2 x 11
    shifted adds, SAME zero padding, C1 = 0.01^2, C2 = 0.03^2.
  * s3im: the reference's S3IM as executed with batch size 1: SSIM over the
    image with every pixel repeated 10x along width, computed by phases
    (each output phase of the repeated blur is a 2-tap mix of the H-blurred
    original), returned as the loss 1 - ssim.
  * psnr over [0, 1] images.

Images are (H, W, C), as in moss_tpu.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

WINDOW_SIZE = 11
SIGMA = 1.5
C1 = 0.01**2
C2 = 0.03**2


def _gaussian_1d():
    xs = np.arange(WINDOW_SIZE) - WINDOW_SIZE // 2
    g = np.exp(-(xs**2) / (2 * SIGMA**2))
    return (g / g.sum()).astype(np.float32)


_G1D = _gaussian_1d()


def _blur_axis(x, axis: int):
    """SAME-padded 11-tap gaussian blur along `axis` (0 or 1 of (H, W, C))."""
    r = WINDOW_SIZE // 2
    pad = [0, 0, 0, 0, 0, 0]  # F.pad lists the last axis first
    pad[2 * (2 - axis)] = pad[2 * (2 - axis) + 1] = r
    xp = F.pad(x, pad)
    n = x.shape[axis]
    acc = None
    for k in range(WINDOW_SIZE):
        term = float(_G1D[k]) * xp.narrow(axis, k, n)
        acc = term if acc is None else acc + term
    return acc


def _filter(img):
    return _blur_axis(_blur_axis(img, 0), 1)


def _ssim_map(F_, img1, img2):
    mu1 = F_(img1)
    mu2 = F_(img2)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = F_(img1 * img1) - mu1_sq
    s2 = F_(img2 * img2) - mu2_sq
    s12 = F_(img1 * img2) - mu1_mu2
    return ((2 * mu1_mu2 + C1) * (2 * s12 + C2)) / ((mu1_sq + mu2_sq + C1) * (s1 + s2 + C2))


def ssim(img1, img2):
    """Mean SSIM. Images (H, W, C) in [0, 1]."""
    return torch.mean(_ssim_map(_filter, img1, img2))


def _filter_rep(x, repeat: int):
    """Blur of the `repeat`x column-repeated image, phase-major:
    (H, W, C) -> (repeat, H, W, C), out[p, h, t] = _filter(rep(x))[h, repeat t + p].
    With WINDOW_SIZE <= repeat + 1 the window spans at most two source columns."""
    r = WINDOW_SIZE // 2
    u = _blur_axis(x, 0)
    up = F.pad(u, (0, 0, 1, 1))
    um1, u0, up1 = up[:, :-2], up[:, 1:-1], up[:, 2:]
    outs = []
    for p in range(repeat):
        if p < r:
            a = float(_G1D[: r - p].sum())
            outs.append(a * um1 + (1.0 - a) * u0)
        else:
            a = float(_G1D[: repeat + r - p].sum())
            outs.append(a * u0 + (1.0 - a) * up1)
    return torch.stack(outs, 0)


def s3im(img1, img2, repeat: int = 10):
    """The reference's effective S3IM loss, 1 - ssim of the width-repeated pair."""
    if WINDOW_SIZE > repeat + 1:
        a = torch.repeat_interleave(img1, repeat, dim=1)
        b = torch.repeat_interleave(img2, repeat, dim=1)
        return 1.0 - ssim(a, b)
    # rep(x)^2 == rep(x^2): every filtered field is a _filter_rep of an
    # original-width image, and the mean over (H, repeat W) is the mean over
    # (repeat, H, W)
    return 1.0 - torch.mean(_ssim_map(lambda x: _filter_rep(x, repeat), img1, img2))


