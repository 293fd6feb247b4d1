"""The CUDA blend kernel (csrc/rasterize_fwd.cu) against its plain PyTorch
version, on the card.

Needs an NVIDIA GPU and nvcc; skipped elsewhere. Imports neither jax nor
moss_tpu, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Image rule of tests/test_rasterize_tpu.py:50-59 (atol 3e-5, at most 2e-3 of
the pixels as termination-threshold flips; depth atol 1e-4).
"""
import numpy as np
import pytest
import torch

from moss_torch.ops import rasterize_cuda as rc
from moss_torch.ops.projection import preprocess
from moss_torch.ops.rasterize_ref import rasterize_reference
from moss_torch.ops.transforms import build_covariance
from moss_torch.render.camera import Camera


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the blend kernel has no CPU mode")
    return torch.device("cuda", 0)


def projected(device, H, W, n=128, dense=False, seed=3407):
    """tests/test_rasterize_tpu.py's random scene (dense: its :76-90 variant)."""
    rng = np.random.default_rng(seed)
    fx = 60.0 if dense else 80.0
    cam = Camera.from_KRT(np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]]),
                          np.eye(3), np.zeros(3), H, W, device=device)
    means = np.stack([rng.uniform(-0.5, 0.5, n), rng.uniform(-0.5, 0.5, n),
                      rng.uniform(2.0, 3.0, n)], axis=-1).astype(np.float32)
    scales = rng.uniform(0.02, 0.12, size=(n, 3)).astype(np.float32)
    quats = rng.normal(size=(n, 4)).astype(np.float32)
    colors = rng.uniform(size=(n, 3)).astype(np.float32)
    opacity = rng.uniform(0.2, 0.95, size=(n,)).astype(np.float32)
    if dense:
        means[:, :2] *= 0.15
        scales *= 1.5
        opacity[:] = 0.97

    def t(x):
        return torch.as_tensor(x, device=device)

    return preprocess(t(means), build_covariance(t(scales), t(quats)), t(colors), t(opacity), cam)


def assert_images_match(a, b, atol=3e-5, outlier_frac=2e-3):
    diff = (a - b).abs().reshape(-1).cpu()
    n_out = int((diff > atol).sum())
    assert n_out <= outlier_frac * diff.numel() + 1, f"{n_out} pixels beyond {atol}"
    assert float(diff.max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True], ids=["scene", "dense"])
@pytest.mark.parametrize("hw", [(64, 64), (45, 77)], ids=["64x64", "45x77"])
def test_kernel_matches_plain(cuda_device, hw, dense):
    H, W = hw
    proj = projected(cuda_device, H, W, dense=dense)
    bg = torch.tensor([0.2, 0.5, 0.7], device=cuda_device)
    before = rc.launches
    with torch.inference_mode():
        out = rc.rasterize_cuda(proj, bg, H, W)
        ref = rasterize_reference(proj, bg, H, W, tile_h=rc.TILE, tile_w=rc.TILE)
    torch.cuda.synchronize()
    assert rc.launches == before + 1
    if dense:
        assert float(ref["final_T"].min()) < 1e-3  # termination exercised
    for key in ("color", "alpha", "final_T"):
        assert_images_match(out[key], ref[key])
    assert_images_match(out["depth"], ref["depth"], atol=1e-4)
    assert int(out["overflow"]) == 0


@pytest.mark.cuda
def test_kernel_all_invalid_is_background(cuda_device):
    proj = projected(cuda_device, 32, 32, n=20)
    proj = proj._replace(valid=torch.zeros_like(proj.valid))
    bg = torch.tensor([0.3, 0.6, 0.9], device=cuda_device)
    with torch.inference_mode():
        out = rc.rasterize_cuda(proj, bg, 32, 32)
    assert torch.equal(out["color"], bg.expand(32, 32, 3))
    assert float(out["alpha"].abs().max()) == 0.0


@pytest.mark.cuda
def test_kernel_refuses_grad(cuda_device):
    proj = projected(cuda_device, 32, 32, n=10)
    proj = proj._replace(opacity=proj.opacity.clone().requires_grad_())
    with pytest.raises(NotImplementedError, match="training slice"):
        rc.rasterize_cuda(proj, torch.zeros(3, device=cuda_device), 32, 32)
