"""The CUDA kernels against their plain PyTorch versions, on the card: the
blend kernels (csrc/rasterize_fwd.cu, csrc/rasterize_bwd.cu and its stages,
csrc/segment_sum.cu) and one training step through them, the sort passes
(csrc/sort_pass.cu) and the 3x3 conv (csrc/conv3x3.cu).

Needs an NVIDIA GPU and nvcc; skipped elsewhere. Imports neither jax nor
moss_tpu, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Image rule of tests/test_rasterize_tpu.py:50-59 (atol 3e-5, at most 2e-3 of
the pixels as termination-threshold flips; depth atol 1e-4); grads at
tests/test_rasterize_tpu.py:150 (divide by max|g_ref|, atol 5e-4), bg rtol 1e-4.
Sort passes: exact. Conv: f32 atol 1e-4 (tools/conv_pallas_proto.py:102), bf16
max |y - y_plain| <= 2e-2 max |y_plain| (tests/test_losses_parity.py:108).
Reductions and scans: max |out - plain| <= 1e-5 max |plain|, the plain version
rounding a tensor-core form's operands as its kernel does; observers bitwise
equal across tiles.
"""
import functools

import numpy as np
import pytest
import torch

from moss_torch.ops import bwd_stages, conv3x3 as conv, rasterize_cuda as rc, reduce_scan as rs, \
    sort_pass
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


def _block(device, rows, seed=0):
    x = np.random.default_rng(seed).integers(0, 1 << 30, (rows, sort_pass.LANES), np.int32)
    return torch.as_tensor(x, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("stride", [1, 2, 4, 8, 16, 32, 64])
def test_lane_pass_matches_plain(cuda_device, stride):
    x = _block(cuda_device, 72)
    before = sort_pass.lane_launches
    got = sort_pass.lane_pass(x, stride, 3)
    torch.cuda.synchronize()
    assert sort_pass.lane_launches == before + 1
    assert torch.equal(got, sort_pass.lane_pass_plain(x, stride, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("stride_rows", [1, 4, 64])
def test_row_pass_matches_plain(cuda_device, stride_rows):
    x = _block(cuda_device, 256)
    before = sort_pass.row_launches
    got = sort_pass.row_pass(x, stride_rows, 3)
    torch.cuda.synchronize()
    assert sort_pass.row_launches == before + 1
    assert torch.equal(got, sort_pass.row_pass_plain(x, stride_rows, 3))


@pytest.mark.cuda
def test_sort_pass_time_grows_with_repeats(cuda_device):
    """A compare-exchange is idempotent; were the R repeats folded into one,
    4R repeats would take about the time of R."""
    from moss_torch.tools.timing import cuda_ms

    x = _block(cuda_device, sort_pass.ROWS)
    R = sort_pass.R
    for fn in (lambda r: sort_pass.lane_pass(x, 64, r), lambda r: sort_pass.lane_pass(x, 1, r),
               lambda r: sort_pass.row_pass(x, 64, r)):
        t_r, t_4r = cuda_ms(lambda: fn(R)), cuda_ms(lambda: fn(4 * R))
        assert t_4r > 1.5 * t_r, (t_r, t_4r)


def _conv_inputs(device, H, W, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=(H, W, cin)).astype(np.float32), device=device),
            torch.as_tensor(rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32),
                            device=device),
            torch.as_tensor(rng.normal(0, 0.1, cout).astype(np.float32), device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 128, 8, 16), (8, 256, 64, 64), (32, 128, 16, 8),
                                   (13, 29, 5, 70)], ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_matches_plain_f32(cuda_device, shape):
    x, w, b = _conv_inputs(cuda_device, *shape)
    before = conv.launches
    for relu in (True, False):
        got = conv.conv3x3(x, w, b, relu=relu)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, conv.conv3x3_plain(x, w, b, relu=relu), rtol=0, atol=1e-4)
    assert conv.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [None, torch.float32], ids=["bf16_out", "f32_out"])
def test_conv3x3_matches_plain_bf16(cuda_device, out_dtype):
    x, w, b = _conv_inputs(cuda_device, 24, 40, 48, 72, seed=1)
    x = x.to(torch.bfloat16)
    for relu in (True, False):
        got = conv.conv3x3(x, w, b, relu=relu, out_dtype=out_dtype)
        want = conv.conv3x3_plain(x, w, b, relu=relu, out_dtype=out_dtype)
        assert got.dtype == want.dtype == (out_dtype or torch.bfloat16)
        err = float((got.float() - want.float()).abs().max())
        assert err <= 2e-2 * float(want.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True], ids=["scene", "dense"])
def test_bwd_stages_match_production_and_plain(cuda_device, dense):
    """full and full_soa are the production kernel's rows bit for bit; every
    stage is its plain version (staged rows exactly, observers within 1e-4
    of the max but for termination flips, full rows within the grad rule)."""
    from moss_torch.tools.bwd_kernel_floor import floor_inputs

    H, W = 64, 77
    proj = projected(cuda_device, H, W, n=400, dense=dense)
    pairs, gimg = floor_inputs(proj, H, W)
    prod = rc.rasterize_pairs_bwd(pairs, proj, gimg, H, W)
    before = bwd_stages.launches
    for stage in bwd_stages.STAGES:
        rows, obs = bwd_stages.rasterize_bwd_stage(pairs, proj, gimg, H, W, stage)
        rows_p, obs_p = bwd_stages.bwd_stage_plain(pairs, proj, gimg, H, W, stage)
        torch.cuda.synchronize()
        if stage in bwd_stages.ABLATED:
            assert torch.equal(rows, rows_p), stage
            scale = float(obs_p.abs().max())
            assert_images_match(obs / scale, obs_p / scale, atol=1e-4)
        else:
            assert obs is None
            assert torch.equal(rows.T if stage == "full_soa" else rows, prod), stage
            assert_grad_close(rows, rows_p, stage)
    assert bwd_stages.launches == before + len(bwd_stages.STAGES)


def _chunk(device):
    from moss_torch.tools.mxu_micro import inputs

    return inputs(device)


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [rs.REPS, 3])
@pytest.mark.parametrize("name", [r[0] for r in rs.RUNS])
def test_reduce_scan_matches_plain(cuda_device, name, reps):
    """Each of the twelve instantiations: kernel against plain, the observers
    of the tiles bitwise equal, one launch; the same wrapper given CPU
    tensors runs the plain version and launches nothing."""
    x, s = _chunk(cuda_device)
    family = rs.RUN[name][1]
    key = {"cumsum": "scan", "cumprod": "scan"}.get(family, family)
    before = rs.launch_counts()
    out, obs = rs.run(name, x, s, reps=reps)
    torch.cuda.synchronize()
    assert rs.launch_counts()[key] == before[key] + 1
    plain = rs.run_plain(name, x, s, reps=reps)
    assert out.shape == plain.shape and torch.isfinite(out).all()
    err = float((out - plain).abs().max()) / float(plain.abs().max())
    assert err <= 1e-5, err
    assert obs.shape[0] == rs.TILES and torch.isfinite(obs).all()
    assert torch.equal(obs, obs[:1].expand_as(obs))
    counts = rs.launch_counts()
    cpu_out, cpu_obs = rs.run(name, x.cpu(), s.cpu(), reps=reps)
    assert rs.launch_counts() == counts and cpu_obs is None
    assert torch.equal(cpu_out, rs.run_plain(name, x.cpu(), s.cpu(), reps=reps))


@pytest.mark.cuda
@pytest.mark.parametrize("name", [r[0] for r in rs.RUNS])
def test_reduce_scan_time_grows_with_reps(cuda_device, name):
    """Were the repeats folded, 4 REPS would take about the time of REPS."""
    from moss_torch.tools.timing import cuda_ms

    x, s = _chunk(cuda_device)
    t_r = cuda_ms(lambda: rs.run(name, x, s, reps=rs.REPS))
    t_4r = cuda_ms(lambda: rs.run(name, x, s, reps=4 * rs.REPS))
    assert t_4r > 1.5 * t_r, (t_r, t_4r)
