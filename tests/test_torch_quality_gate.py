"""The quality gate at CPU scale for the port: the counterpart of
tests/test_quality_gate.py, on the port's own Trainer.

bench._quality_psnr's fixture (bench.py:253-281, not imported: bench
imports moss_tpu): make_scene(400), three 128x128 frames with a 48 crop, a
768 capacity, 120 iterations with densify rounds from 30 to 90 every 30, and
one eval on the held-out third frame, which must reach the gate's 36 dB. The
LPIPS backbone is the seeded random one. Slow (a few minutes on the CPU):
the default run skips it; pass --runslow.
"""
import pytest

from moss_torch.config import Config, ModelConfig, OptimConfig
from moss_torch.data.synthetic import make_frames, make_scene
from moss_torch.ops import lpips
from moss_torch.train.trainer import Trainer
from _torch_threads import two_torch_threads  # noqa: F401

PSNR_FLOOR = 36.0


@pytest.mark.slow
def test_quality_gate_cpu_scale():
    iters, H, crop = 120, 128, 48
    scene = make_scene(n_verts=400, device="cpu")
    frames, _ = make_frames(scene, n_frames=3, H=H, W=H, crop=crop)
    cfg = Config(model=ModelConfig(sh_degree=3, capacity=768, n_init_points=400),
                 optim=OptimConfig(iterations=iters, densify_from_iter=iters // 4,
                                   densify_until_iter=3 * iters // 4,
                                   densification_interval=iters // 4,
                                   opacity_reset_interval=10 * iters))
    tr = Trainer(scene, frames[:2], frames[2:], cfg, lpips.init_random(3407, "cpu"),
                 crop_hw=(crop, crop), device="cpu")
    tr.train(iters, eval_iters=[iters])
    psnr = float(tr.metrics_history[-1]["psnr"])
    assert psnr >= PSNR_FLOOR, f"quality gate: psnr {psnr:.2f} < {PSNR_FLOOR}"
