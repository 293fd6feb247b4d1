"""The CUDA blend kernels (csrc/rasterize_fwd.cu, csrc/rasterize_bwd.cu,
csrc/segment_sum.cu) against their plain PyTorch versions, on the card, and
one training step through them.

Needs an NVIDIA GPU and nvcc; skipped elsewhere. Imports neither jax nor
moss_tpu, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Image rule of tests/test_rasterize_tpu.py:50-59 (atol 3e-5, at most 2e-3 of
the pixels as termination-threshold flips; depth atol 1e-4); grads at
tests/test_rasterize_tpu.py:150 (divide by max|g_ref|, atol 5e-4), bg rtol 1e-4.
"""
import functools

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


def _grads(proj, bg, H, W, up, raster):
    leaves = [getattr(proj, f).clone().requires_grad_() for f in rc._KERNEL_FIELDS]
    bg = bg.clone().requires_grad_()
    out = raster(proj._replace(**dict(zip(rc._KERNEL_FIELDS, leaves))), bg, H, W)
    loss = sum((out[k] * up[k]).sum() for k in up)
    return torch.autograd.grad(loss, leaves + [bg]), out


def _upstream(device, H, W, seed=5):
    g = torch.Generator(device=device).manual_seed(seed)
    return {k: torch.randn(s, generator=g, device=device)
            for k, s in (("color", (H, W, 3)), ("depth", (H, W)), ("alpha", (H, W)),
                         ("final_T", (H, W)))}


def assert_grad_close(g, g_ref, name, atol=5e-4, scale=None):
    scale = (float(g_ref.abs().max()) if scale is None else scale) + 1e-8
    err = float((g - g_ref).abs().max()) / scale
    assert torch.isfinite(g).all() and err <= atol, f"{name}: scaled error {err:.2e}"


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True], ids=["scene", "dense"])
@pytest.mark.parametrize("hw", [(64, 64), (45, 77)], ids=["64x64", "45x77"])
def test_backward_kernel_matches_plain(cuda_device, hw, dense):
    H, W = hw
    proj = projected(cuda_device, H, W, dense=dense)
    bg = torch.tensor([0.2, 0.5, 0.7], device=cuda_device)
    up = _upstream(cuda_device, H, W)
    before = (rc.bwd_launches, rc.segment_launches)
    g, out = _grads(proj, bg, H, W, up, rc.rasterize_cuda)
    torch.cuda.synchronize()
    assert (rc.bwd_launches, rc.segment_launches) == (before[0] + 1, before[1] + 1)
    plain = functools.partial(rasterize_reference, tile_h=rc.TILE, tile_w=rc.TILE)
    g_ref, ref = _grads(proj, bg, H, W, up, plain)
    if dense:
        assert float(ref["final_T"].min()) < 1e-3  # termination exercised
    for name, a, b in zip(rc._KERNEL_FIELDS, g[:-1], g_ref[:-1]):
        assert_grad_close(a, b, name)
    torch.testing.assert_close(g[-1], g_ref[-1], rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_backward_repeats_bit_for_bit(cuda_device):
    H = W = 64
    proj = projected(cuda_device, H, W, n=400, dense=True)
    bg = torch.tensor([0.2, 0.5, 0.7], device=cuda_device)
    up = _upstream(cuda_device, H, W)
    first, _ = _grads(proj, bg, H, W, up, rc.rasterize_cuda)
    second, _ = _grads(proj, bg, H, W, up, rc.rasterize_cuda)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_segment_sum_matches_plain(cuda_device):
    H = W = 64
    proj = projected(cuda_device, H, W, n=300)
    pairs = rc.bin_projected(proj, H, W)
    rows = torch.randn((pairs.num_pairs, rc.GRAD_COLS), device=cuda_device)
    torch.testing.assert_close(rc.segment_sum(rows, pairs), rc.segment_sum_plain(rows, pairs),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_train_step_on_the_card(cuda_device):
    """One step at 64x64 through the kernels: its grads against the same
    step through the plain blend, and one launch of each kernel."""
    from moss_torch.config import Config, ModelConfig
    from moss_torch.data.synthetic import make_frames, make_scene
    from moss_torch.models import gaussians as G
    from moss_torch.models.lbs_field import LBSField
    from moss_torch.models.pose_refine import PoseRefine
    from moss_torch.ops import lpips
    from moss_torch.train.train_step import TrainState, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    scene = make_scene(n_verts=300, device=cuda_device)
    frames, _ = make_frames(scene, n_frames=1, H=64, W=64, crop=48)
    rng = np.random.default_rng(0)
    verts = scene.big_pose_vertices.cpu().numpy()
    params, valid = G.create_from_points(verts + rng.normal(0, 0.005, verts.shape),
                                         rng.uniform(size=verts.shape), 320, device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    mlps = {"pose": PoseRefine(gen, cuda_device), "lbs": LBSField(gen, cuda_device)}
    cfg = Config(model=ModelConfig(capacity=320))
    lp = lpips.init_random(device=cuda_device)
    plain = functools.partial(rasterize_reference, tile_h=rc.TILE, tile_w=rc.TILE)
    init, step = make_train_step(scene, cfg, None, lp, 48, 48, device=cuda_device)
    _, ref_step = make_train_step(scene, cfg, plain, lp, 48, 48, device=cuda_device)
    ts = TrainState({"gauss": params, "mlps": mlps}, init({"gauss": params, "mlps": mlps}),
                    G.initial_state(valid), 0)
    _, _, _, g_ref, off_ref = ref_step.grads(ts, frames[0], 0)
    before = (rc.launches, rc.bwd_launches, rc.segment_launches)
    _, _, _, g, off = step.grads(ts, frames[0], 0)
    torch.cuda.synchronize()
    assert (rc.launches, rc.bwd_launches, rc.segment_launches) == tuple(b + 1 for b in before)
    for group in g_ref:
        # an MLP's parameters share its largest grad as scale (tests/test_torch_grads.py)
        scale = None if group not in ("pose", "lbs") else max(
            float(t.abs().max()) for t in g_ref[group].values())
        for name in g_ref[group]:
            assert_grad_close(g[group][name], g_ref[group][name], f"{group}.{name}", scale=scale)
    assert_grad_close(off, off_ref, "mean2d_offset")
    ts, logs = step(ts, frames[0], 0)
    assert torch.isfinite(logs["loss"]) and float(ts.gstate.xyz_grad_accum.max()) > 0
