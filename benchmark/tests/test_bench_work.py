"""The counts behind step_mfu and blend_roofline against hand counts."""
from __future__ import annotations

import torch

from benchmark import work as W
from benchmark.reference.projection import Projected


def test_vgg16_by_hand():
    # 16 x 16: stage maps 16, 8, 4, 2, 1
    hand = 2 * 9 * (3 * 64 + 64 * 64) * 256 + 2 * 9 * (64 * 128 + 128 * 128) * 64 \
        + 2 * 9 * (128 * 256 + 2 * 256 * 256) * 16 + 2 * 9 * (256 * 512 + 2 * 512 * 512) * 4 \
        + 2 * 9 * (3 * 512 * 512) * 1
    assert W.vgg16_flops(16, 16) == hand


def test_ssim_and_lbs_by_hand():
    px = 4 * 5 * 3
    assert W.ssim_flops(4, 5) == 5 * 2 * 44 * px + 20 * px + 5 * (44 * px + 30 * px) + 200 * px
    per = 2 * (63 * 128 + 128 * 128 + 128 * 128 + 191 * 128 + 128 * 24 + 24 * 24) + 2 * 216 * 2
    assert W.lbs_flops(7) == 7 * per


def one_splat(opacity=0.5, x=8.0, y=8.0, radius=3):
    """One round Gaussian of variance 1 pixel^2 at (x, y) in a 32 x 32 frame."""
    return Projected(mean2d=torch.tensor([[x, y]]), depth=torch.tensor([1.0]),
                     conic=torch.tensor([[1.0, 0.0, 1.0]]),
                     radius=torch.tensor([radius], dtype=torch.int32),
                     color=torch.tensor([[1.0, 0.0, 0.0]]), opacity=torch.tensor([opacity]),
                     valid=torch.tensor([True]))


def test_blend_work_one_splat():
    """A splat at a tile's centre reaches only its tile; each of the tile's
    256 pixels evaluates it once, and it contributes where alpha >= 1/255."""
    p = one_splat()
    w = W.blend_work(p, 32, 32)
    ys, xs = torch.meshgrid(torch.arange(16.0), torch.arange(16.0), indexing="ij")
    alpha = 0.5 * torch.exp(-0.5 * ((xs - 8) ** 2 + (ys - 8) ** 2))
    assert w["pairs"] == 1 and w["tiles"] == 4 and w["gaussians"] == 1
    assert w["evaluations"] == 256
    assert w["contributions"] == int((alpha >= 1 / 255).sum())
    b = W.blend_bounds(w, 32, 32)
    fwd_bytes = 4 * (1 + 4 + 10 + 6 * 32 * 32)
    assert b["fwd"] == max(fwd_bytes / W.PEAK_BYTES,
                           (14 * 256 + 13 * w["contributions"]) / W.PEAK_F32)
    assert b["bwd"] == max((fwd_bytes + 40) / W.PEAK_BYTES,
                           (14 * 256 + 38 * w["contributions"]) / W.PEAK_F32)
    assert b["segment"] == max(4 * (10 + 1 + 2 + 10) / W.PEAK_BYTES, 10 / W.PEAK_F32)


def test_blend_work_stops_at_opaque():
    """Three nearly flat splats of alpha just under 0.99: T is just over 1e-4
    after two, so the third stops every pixel; it is evaluated and does not
    contribute."""
    big = Projected(mean2d=torch.tensor([[8.5, 8.5]] * 3),
                    depth=torch.tensor([1.0, 2.0, 3.0]),
                    conic=torch.tensor([[1e-4, 0.0, 1e-4]] * 3),
                    radius=torch.tensor([3, 3, 3], dtype=torch.int32),
                    color=torch.ones(3, 3), opacity=torch.tensor([0.99, 0.99, 0.99]),
                    valid=torch.tensor([True, True, True]))
    w = W.blend_work(big, 16, 16)
    assert w["pairs"] == 3 and w["evaluations"] == 3 * 256 and w["contributions"] == 2 * 256


def test_step_seconds_at_peak():
    w = {"evaluations": 1000, "contributions": 400}
    s = W.step_seconds_at_peak(w, (16, 16), 5, gt_tower_cached=False)
    assert s["lpips"] == 3 * W.vgg16_flops(16, 16) / W.PEAK_BF16
    assert s["blend"] == (2 * 14 * 1000 + (13 + 38) * 400) / W.PEAK_F32
    assert s["lbs_field"] == 3 * W.lbs_flops(5) / W.PEAK_F32
