"""The CUDA kernels against their plain PyTorch versions, on the card: the
blend kernels (csrc/rasterize_fwd.cu, csrc/rasterize_bwd.cu and its stages,
csrc/segment_sum.cu), with tiles split into segments against the plain
segment scheme (ops/split_blend.py) and against the same kernels unsplit,
and one training step through them, a Trainer resumed from its checkpoint
(bitwise the uninterrupted run) and a saved avatar loaded, compacted and
rendered, a ragged frame (W no multiple of the tile) with split tiles and a
J=55 (SMPL-X) frame, an orbit camera's frame (render/novel_view.py), a
1024x1024 frame, and a pixel band of a shifted mean2d (parallel/sharded.py:
bitwise the full frame's rows, the bands' grads summing to the full
frame's), the sort passes
(csrc/sort_pass.cu), the 3x3 conv's two kernels (csrc/conv3x3.cu: tensor
cores for bf16, CUDA cores for f32) and the reductions and scans
(csrc/reduce_scan.cu); the 3x3 SVD (csrc/svd3.cu) against torch.linalg.svd,
the budgeted pair list on the card equal to the CPU's, the blend kernels at
the pair capacity against the plain blend of the kept pairs, the table-driven
AdamW bitwise the host one, and the trainer's CUDA-graph engine bitwise the
launched ones with every queued segment free of host syncs.

Needs an NVIDIA GPU and nvcc; skipped elsewhere. Imports neither jax nor
moss_tpu, so it runs on a machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py

Image rule of tests/test_rasterize_tpu.py:50-59 (atol 3e-5, at most 2e-3 of
the pixels as termination-threshold flips; depth atol 1e-4); grads at
tests/test_rasterize_tpu.py:150 (divide by max|g_ref|, atol 5e-4), bg rtol 1e-4.
Segment sum: 1e-5 of the max against its plain version and index_add_, and
bit for bit its own order of adds (tests/_segment_order.py). Sort passes:
exact, the lane pass at every stride on row counts that fill no whole CTA and
with r = 0. Conv: f32 atol 1e-4 (tools/conv_pallas_proto.py:102), bf16
max |y - y_plain| <= 2e-2 max |y_plain| (tests/test_losses_parity.py:108),
two calls bitwise equal; the tensor-core kernel's ablated stages exactly
their plain version.
Reductions and scans: max |out - plain| <= 1e-5 max |plain|, the plain version
rounding a tensor-core form's operands as its kernel does; observers bitwise
equal across tiles; the same for the stages of the tensor-core cumsums, of the
log-space cumprod kernel, of the CUDA-core moments, accumulator, cumsum, cumprod and reshape
kernels and of the bf16 moments (at least two CTAs an SM; the redesigned ones also at REPS / 3
and 4 REPS, where they walk or pair their reps otherwise) and of the 3xTF32 moments and
accumulator kernels; the tensor-core moments' and accumulators' layout tables are
the C library's, and the tensor cores read the unmasked TF32 operands as
cvt.rna's, bit for bit (csrc/tc_rate.cu). The
f32 conv also at the VGG16 layers, bitwise repeatable, its tile table the C
library's.
"""
import functools
import time

import numpy as np
import pytest
import torch

from moss_torch.ops import bwd_stages, conv3x3 as conv, rasterize_cuda as rc, reduce_scan as rs, \
    sort_pass, split_blend
from moss_torch.ops.projection import preprocess
from moss_torch.ops.rasterize_ref import rasterize_reference
from moss_torch.ops.transforms import build_covariance
from moss_torch.render.camera import Camera
from _conv_tiles import F32_TILES
from _segment_order import CASES, kernel_order, pair_list


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the blend kernel has no CPU mode")
    return torch.device("cuda", 0)


def projected(device, H, W, n=128, dense=False, seed=3407, fx=None):
    """tests/test_rasterize_tpu.py's random scene (dense: its :76-90 variant);
    fx scales it to a larger frame."""
    rng = np.random.default_rng(seed)
    fx = fx or (60.0 if dense else 80.0)
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


def _assert_planes_match(a, b):
    """The image rule on the six planes r, g, b, depth, alpha, final_T."""
    for k in range(6):
        assert_images_match(a[k], b[k], atol=1e-4 if k == 3 else 3e-5)


def _gimg(img, up, bg):
    g_img = torch.stack([up["color"][..., 0], up["color"][..., 1], up["color"][..., 2],
                         up["depth"], up["alpha"], up["final_T"] + (up["color"] * bg).sum(-1)])
    return torch.cat([g_img[:5], (g_img * img).sum(0, keepdim=True)]).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("cut", ["every_tile", "some_tiles"])
@pytest.mark.parametrize("dense", [False, True], ids=["scene", "dense"])
def test_split_kernels_match_plain_scheme_and_unsplit(cuda_device, dense, cut):
    """At S = 1 (every tile of more than one pair split, a segment a pair) and
    at S = 32: the forward's planes against the plain segment scheme and the
    unsplit kernels (S >= the longest tile) under the image rule, the
    backward's rows against the plain segment scheme's and its per-Gaussian
    grads against the unsplit kernels' within the grad rule."""
    H, W = 64, 77
    proj = projected(cuda_device, H, W, n=400, dense=dense)
    pairs = rc.bin_projected(proj, H, W)
    busy = pairs.tile_count[pairs.tile_count > 0]
    S = 1 if cut == "every_tile" else 32
    assert int(busy.max()) > 2 * S
    bg = torch.tensor([0.2, 0.5, 0.7], device=cuda_device)
    up = _upstream(cuda_device, H, W)
    before = (rc.launches, rc.bwd_launches)
    img, state = rc.rasterize_pairs(pairs, proj, H, W, S)
    gimg = _gimg(img, up, bg)
    rows = rc.rasterize_pairs_bwd(pairs, proj, gimg, H, W, state, S)
    torch.cuda.synchronize()
    assert (rc.launches, rc.bwd_launches) == (before[0] + 1, before[1] + 1)
    plain, plain_state = split_blend.blend_split(pairs, proj, H, W, S)
    _assert_planes_match(img, plain)
    assert_grad_close(rows, split_blend.blend_split_bwd(pairs, proj, gimg, H, W, plain_state),
                      "rows vs plain segment scheme")
    whole = pairs.num_pairs
    img_u, state_u = rc.rasterize_pairs(pairs, proj, H, W, whole)
    _assert_planes_match(img, img_u)
    rows_u = rc.rasterize_pairs_bwd(pairs, proj, gimg, H, W, state_u, whole)
    assert_grad_close(rc.segment_sum(rows, pairs), rc.segment_sum(rows_u, pairs),
                      "grads vs unsplit")
    if dense:
        assert float(img[5].min()) < 1e-3  # termination exercised


@pytest.mark.cuda
def test_split_kernels_repeat_bit_for_bit(cuda_device):
    H, W = 64, 64
    proj = projected(cuda_device, H, W, n=400, dense=True)
    pairs = rc.bin_projected(proj, H, W)
    up = _upstream(cuda_device, H, W)
    bg = torch.zeros(3, device=cuda_device)
    runs = []
    for _ in range(2):
        img, state = rc.rasterize_pairs(pairs, proj, H, W, 8)
        rows = rc.rasterize_pairs_bwd(pairs, proj, _gimg(img, up, bg), H, W, state, 8)
        runs.append((img, rows))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_split_on_a_dense_scene_reaching_the_stop(cuda_device):
    """bench_scene's dense cloud at 64x64: the least final T reaches the
    1e-4 stop, pixels stop inside and at the start of segments; the split
    kernels through rasterize_cuda against the plain blend and autograd
    through it."""
    from moss_torch.data.synthetic import bench_scene

    H = W = 64
    proj, _ = bench_scene(cuda_device, dense=True, H=H, P=4000)
    bg = torch.tensor([0.2, 0.5, 0.7], device=cuda_device)
    up = _upstream(cuda_device, H, W)
    g, out = _grads(proj, bg, H, W, up, rc.rasterize_cuda)
    plain = functools.partial(rasterize_reference, tile_h=rc.TILE, tile_w=rc.TILE)
    g_ref, ref = _grads(proj, bg, H, W, up, plain)
    assert float(ref["final_T"].min()) < 2e-4
    assert int(rc.bin_projected(proj, H, W).tile_count.max()) > 4 * rc.SEGMENT
    for key in ("color", "alpha", "final_T"):
        assert_images_match(out[key], ref[key])
    assert_images_match(out["depth"], ref["depth"], atol=1e-4)
    for name, a, b in zip(rc._KERNEL_FIELDS, g[:-1], g_ref[:-1]):
        assert_grad_close(a, b, name)
    torch.testing.assert_close(g[-1], g_ref[-1], rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_segment_sum_matches_plain(cuda_device):
    H = W = 64
    proj = projected(cuda_device, H, W, n=300)
    pairs = rc.bin_projected(proj, H, W)
    rows = torch.randn((pairs.num_pairs, rc.GRAD_COLS), device=cuda_device)
    torch.testing.assert_close(rc.segment_sum(rows, pairs), rc.segment_sum_plain(rows, pairs),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("name,lengths", CASES, ids=[c[0] for c in CASES])
def test_segment_sum_empty_and_long_segments(cuda_device, name, lengths):
    """Gaussians with no pair give zero rows; segments longer than 64 pairs
    take the warp-wide path; the kernel is its own order of adds bit for bit,
    repeats bit for bit, and is within 1e-5 of the max of the plain version
    and of index_add_."""
    pairs = pair_list(lengths, seed=4, device=cuda_device)
    rows = torch.as_tensor(np.random.default_rng(4).normal(size=(pairs.num_pairs, rc.GRAD_COLS))
                           .astype(np.float32), device=cuda_device)
    before = rc.segment_launches
    got = rc.segment_sum(rows, pairs)
    again = rc.segment_sum(rows, pairs)
    torch.cuda.synchronize()
    assert rc.segment_launches == before + 2
    assert torch.equal(got, again)
    order = kernel_order(rows.cpu().numpy(), pairs.gaussian_pairs.cpu().numpy(),
                         pairs.gaussian_offsets.cpu().numpy())
    assert np.array_equal(got.cpu().numpy(), order)
    assert not bool(got[torch.as_tensor(np.asarray(lengths) == 0, device=cuda_device)].any())
    lib = torch.zeros_like(got).index_add_(0, pairs.pair_gaussian.long(), rows)
    for want in (rc.segment_sum_plain(rows, pairs), lib):
        scale = float(want.abs().max()) + 1e-30
        assert float((got - want).abs().max()) <= 1e-5 * scale


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
@pytest.mark.parametrize("rows,r", [(72, 3), (72, 0), (4096, 3), (70, 3)],
                         ids=["72x3", "72x0", "4096x3", "70x3"])
@pytest.mark.parametrize("stride", [1, 2, 4, 8, 16, 32, 64])
def test_lane_pass_matches_plain(cuda_device, stride, rows, r):
    """Exact at every stride, on 72 and 70 rows (neither a multiple of a
    CTA's rows), on the tool's 4,096, and with r = 0 (a copy)."""
    x = _block(cuda_device, rows)
    before = sort_pass.lane_launches
    got = sort_pass.lane_pass(x, stride, r)
    torch.cuda.synchronize()
    assert sort_pass.lane_launches == before + 1
    assert torch.equal(got, sort_pass.lane_pass_plain(x, stride, r))
    if r == 0:
        assert torch.equal(got, x)


@pytest.mark.cuda
def test_lane_pass_empty_launches_nothing_else(cuda_device):
    """The empty kernel on the lane pass's grid: one launch, counted, x unchanged."""
    x = _block(cuda_device, sort_pass.ROWS)
    before, copy = sort_pass.empty_launches, x.clone()
    sort_pass.lane_pass_empty(x)
    torch.cuda.synchronize()
    assert sort_pass.empty_launches == before + 1
    assert torch.equal(x, copy)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [0, 1, sort_pass.R], ids=["r0", "r1", "R"])
@pytest.mark.parametrize("stride_rows", [1 << j for j in range(12)])
def test_row_pass_matches_plain(cuda_device, stride_rows, r):
    """Exact at every row stride of the tool's 2^19-key network, on its
    4,096 rows, with r = 0 (a copy), 1 and R."""
    x = _block(cuda_device, sort_pass.ROWS)
    before = sort_pass.row_launches
    got = sort_pass.row_pass(x, stride_rows, r)
    torch.cuda.synchronize()
    assert sort_pass.row_launches == before + 1
    assert torch.equal(got, sort_pass.row_pass_plain(x, stride_rows, r))
    if r == 0:
        assert torch.equal(got, x)


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


@pytest.mark.cuda
def test_cuda_ms_times_the_device_when_the_host_slows_down(cuda_device):
    """A host that queues each call 0.5 ms more slowly once cuda_ms has sized
    its spin: the runs it paced are taken again behind a longer spin, so the
    sort pass is timed on the device, not at the host's pace."""
    from moss_torch.tools import timing

    x = _block(cuda_device, sort_pass.ROWS)
    calls = [0]

    def fn():
        calls[0] += 1
        if calls[0] > 3 + 10 + 1:  # past the warm-up, the queueing run and the probe
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < 5e-4:
                pass
        return sort_pass.lane_pass(x, 64, sort_pass.R)

    timing.runs_retaken = 0
    ms = timing.cuda_ms(fn)
    assert timing.runs_retaken > 0 and ms < 0.1, (timing.runs_retaken, ms)


def _conv_inputs(device, H, W, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=(H, W, cin)).astype(np.float32), device=device),
            torch.as_tensor(rng.normal(0, 0.1, (3, 3, cin, cout)).astype(np.float32),
                            device=device),
            torch.as_tensor(rng.normal(0, 0.1, cout).astype(np.float32), device=device))


F32_SHAPES = [(16, 128, 8, 16), (8, 256, 64, 64), (32, 128, 16, 8), (13, 29, 5, 70),
              (13, 29, 48, 72)]
VGG_LAYERS = [(512, 64, 64), (256, 64, 128), (256, 128, 128), (128, 128, 256), (128, 256, 256),
              (64, 256, 512), (64, 512, 512), (32, 512, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F32_SHAPES, ids=lambda s: "x".join(map(str, s)))
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
@pytest.mark.parametrize("layer", VGG_LAYERS, ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_f32_at_the_vgg_layers(cuda_device, layer):
    """The CUDA-core kernel at the eight VGG16 layers with the JAX tool's
    bench() draws (x N(0, 1), w N(0, 0.05)), atol 1e-4; one launch a call."""
    H, cin, cout = layer
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(H, H, cin)).astype(np.float32), device=cuda_device)
    w = torch.as_tensor(rng.normal(0, 0.05, (3, 3, cin, cout)).astype(np.float32),
                        device=cuda_device)
    b = torch.as_tensor(rng.normal(0, 0.1, cout).astype(np.float32), device=cuda_device)
    before = conv.launches
    got = conv.conv3x3(x, w, b)
    torch.cuda.synchronize()
    assert conv.launches == before + 1
    torch.testing.assert_close(got, conv.conv3x3_plain(x, w, b), rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", F32_SHAPES + [(32, 32, 512, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_f32_repeats_bit_for_bit(cuda_device, shape):
    """The K walk split over a cluster adds the partials in rank order: two
    calls give the same bits."""
    x, w, b = _conv_inputs(cuda_device, *shape)
    assert torch.equal(conv.conv3x3(x, w, b), conv.conv3x3(x, w, b))


@pytest.mark.cuda
def test_conv3x3_f32_tiles_are_the_c_librarys(cuda_device):
    """The CUDA-core kernel's tile table that tests/_conv_tiles.py copies is
    the one the C library reports, and every check() shape gets
    a grid of at least one CTA per SM."""
    tiles = conv.f32_tiles(cuda_device)
    assert [{k: t[k] for k in ("rows", "channels", "per_thread")} for t in tiles] == \
        list(F32_TILES)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for H, W, cin, cout in F32_SHAPES[:3]:
        code, split = conv.f32_tile(H, W, cin, cout, tiles, sms)
        t = tiles[code]
        assert -(-H // t["rows"]) * -(-W // 16) * -(-cout // t["channels"]) * split >= sms


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
    of the max but for termination flips, full rows within the grad rule);
    with the scene's longer tiles split into segments of rc.SEGMENT pairs."""
    from moss_torch.tools.bwd_kernel_floor import floor_inputs

    H, W = 64, 77
    proj = projected(cuda_device, H, W, n=400, dense=dense)
    pairs, gimg, state = floor_inputs(proj, H, W)
    assert int(pairs.tile_count.max()) > 2 * rc.SEGMENT
    prod = rc.rasterize_pairs_bwd(pairs, proj, gimg, H, W, state)
    before = bwd_stages.launches
    for stage in bwd_stages.STAGES:
        rows, obs = bwd_stages.rasterize_bwd_stage(pairs, proj, gimg, H, W, stage, state)
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
@pytest.mark.parametrize("reps", [rs.REPS, 3])
@pytest.mark.parametrize("stage", rs.SCAN_STAGES)
def test_scan_stage_matches_plain(cuda_device, stage, reps):
    """Each stage of the log-space cumprod kernel against its plain version
    (1e-5 of the max), observers bitwise equal across tiles, one launch;
    "full" bitwise the production kernel."""
    x, s = _chunk(cuda_device)
    before = rs.stage_launches
    out, obs = rs.scan_stage(x, stage, reps)
    torch.cuda.synchronize()
    assert rs.stage_launches == before + 1
    plain = rs.scan_stage_plain(x, stage, reps)
    err = float((out - plain).abs().max()) / float(plain.abs().max())
    assert err <= 1e-5 and torch.isfinite(out).all(), err
    assert torch.equal(obs, obs[:1].expand_as(obs))
    if stage == "full":
        assert torch.equal(out, rs.scan(x, reps, "mul", "split2")[0])


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [rs.REPS, 3])
@pytest.mark.parametrize("stage", rs.CUMSUM_STAGES)
@pytest.mark.parametrize("mode", rs.CUMSUM_MODES)
def test_cumsum_stage_matches_plain(cuda_device, mode, stage, reps):
    """Each stage of the tensor-core cumsums against its plain version (1e-5
    of the max), observers bitwise equal across tiles, one launch; "full"
    bitwise the production kernel."""
    x, s = _chunk(cuda_device)
    before = rs.cumsum_stage_launches
    out, obs = rs.cumsum_stage(x, mode, stage, reps)
    torch.cuda.synchronize()
    assert rs.cumsum_stage_launches == before + 1
    plain = rs.cumsum_stage_plain(x, mode, stage, reps)
    err = float((out - plain).abs().max()) / float(plain.abs().max())
    assert err <= 1e-5 and torch.isfinite(out).all(), err
    assert torch.equal(obs, obs[:1].expand_as(obs))
    if stage == "full":
        assert torch.equal(out, rs.scan(x, reps, "add", mode)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [rs.REPS, 3])
@pytest.mark.parametrize("stage", rs.TF32X3_STAGES)
@pytest.mark.parametrize("family", ["moments", "acc"])
def test_tf32x3_stage_matches_plain(cuda_device, family, stage, reps):
    """Each stage of the 3xTF32 moments and accumulator kernels against its
    plain version (1e-5 of the max), observers bitwise equal across tiles,
    one launch; "full" bitwise the production kernel."""
    x, s = _chunk(cuda_device)
    before = rs.tf32x3_stage_launches
    out, obs = rs.tf32x3_stage(family, x, s, stage, reps)
    torch.cuda.synchronize()
    assert rs.tf32x3_stage_launches == before + 1
    plain = rs.tf32x3_stage_plain(family, x, s, stage, reps)
    err = float((out - plain).abs().max()) / float(plain.abs().max())
    assert err <= 1e-5 and torch.isfinite(out).all(), err
    assert torch.equal(obs, obs[:1].expand_as(obs))
    if stage == "full":
        assert torch.equal(out, rs.run(f"{family}_tf32x3", x, s, reps=reps)[0])


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [rs.REPS, 3, rs.REPS // 3, 4 * rs.REPS])
@pytest.mark.parametrize("stage", rs.CUDA_STAGES)
@pytest.mark.parametrize("family", rs.CUDA_FAMILIES)
def test_cuda_stage_matches_plain(cuda_device, family, stage, reps):
    """Each stage of the CUDA-core moments, accumulator, cumsum, cumprod and
    reshape kernels against its plain version (1e-5 of the max), observers
    bitwise equal across tiles, one launch; "full" bitwise the production
    kernel; the kernels fit at least two CTAs an SM."""
    x, s = _chunk(cuda_device)
    before = rs.cuda_stage_launches
    out, obs = rs.cuda_stage(family, x, s, stage, reps)
    torch.cuda.synchronize()
    assert rs.cuda_stage_launches == before + 1
    plain = rs.cuda_stage_plain(family, x, s, stage, reps)
    err = float((out - plain).abs().max()) / float(plain.abs().max())
    assert err <= 1e-5 and torch.isfinite(out).all(), err
    assert torch.equal(obs, obs[:1].expand_as(obs))
    if stage == "full":
        assert torch.equal(out, rs.run(rs.CUDA_RUNS[family], x, s, reps=reps)[0])
    assert rs.ctas_per_sm("reshape" if family == "reshape" else rs.CUDA_RUNS[family]) >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [rs.REPS, 3, rs.REPS // 3, 4 * rs.REPS])
@pytest.mark.parametrize("stage", rs.BF16_STAGES)
@pytest.mark.parametrize("family", rs.BF16_FAMILIES)
def test_bf16_stage_matches_plain(cuda_device, family, stage, reps):
    """Each stage of the bf16 moments and accumulator kernels against its
    plain version (1e-5 of the max), observers bitwise equal across tiles,
    one launch; "full" bitwise the production kernel, which fits two CTAs an
    SM."""
    x, s = _chunk(cuda_device)
    before = rs.bf16_stage_launches
    out, obs = rs.bf16_stage(family, x, s, stage, reps)
    torch.cuda.synchronize()
    assert rs.bf16_stage_launches == before + 1
    plain = rs.bf16_stage_plain(family, x, s, stage, reps)
    err = float((out - plain).abs().max()) / float(plain.abs().max())
    assert err <= 1e-5 and torch.isfinite(out).all(), err
    assert torch.equal(obs, obs[:1].expand_as(obs))
    if stage == "full":
        assert torch.equal(out, rs.run(f"{family}_bf16", x, s, reps=reps)[0])
    assert rs.ctas_per_sm(f"{family}_bf16") >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("reps", [rs.REPS // 3, 4 * rs.REPS])
@pytest.mark.parametrize("name", ["cumprod_cuda", "moments_bf16", "cumsum_cuda", "acc_bf16",
                                  "reshape_only"])
def test_redesigned_kernels_at_more_reps(cuda_device, name, reps):
    """The CUDA-core cumprod and cumsum (their reps in walks of 16, 4 and 1),
    the bf16 moments and accumulators (two reps in flight, an odd one alone)
    and the reshape at REPS / 3 and 4 REPS, beside
    test_reduce_scan_matches_plain's REPS and 3: kernel within 1e-5 of the
    max of plain, observers bitwise equal, one launch."""
    x, s = _chunk(cuda_device)
    before = rs.launch_counts()
    out, obs = rs.run(name, x, s, reps=reps)
    torch.cuda.synchronize()
    key = {"cumprod": "scan", "cumsum": "scan"}.get(rs.RUN[name][1], rs.RUN[name][1])
    assert rs.launch_counts()[key] == before[key] + 1
    plain = rs.run_plain(name, x, s, reps=reps)
    err = float((out - plain).abs().max()) / float(plain.abs().max())
    assert err <= 1e-5 and torch.isfinite(out).all(), err
    assert torch.equal(obs, obs[:1].expand_as(obs))


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["moments", "acc"])
def test_tf32x3_order_is_the_c_librarys(cuda_device, family):
    """The 3xTF32 kernels' order of the contraction axis that
    ops/reduce_scan.py copies (mom_pixel, acc_pixel) is the C library's."""
    assert torch.equal(rs.tf32x3_order(family), rs.tf32x3_order_plain(family))


@pytest.mark.cuda
def test_bf16_order_is_the_c_librarys(cuda_device):
    """The bf16 moments kernel's order of the pixels that ops/reduce_scan.py
    copies (mom_bf16_pixel) is the C library's."""
    assert torch.equal(rs.bf16_order(), rs.bf16_order_plain())


@pytest.mark.cuda
def test_tensor_cores_read_only_the_tf32_bits(cuda_device):
    """An m16n8k8 product of the unmasked bits(v) + 0x1000 the 3xTF32 kernels
    hand over is bitwise the product of cvt.rna.tf32.f32(v)."""
    from moss_torch.tools import tc_rate

    before = tc_rate.low_bits_launches
    assert tc_rate.low_bits(cuda_device) == 0.0
    assert tc_rate.low_bits_launches == before + tc_rate.LOW_BITS_DRAWS


@pytest.mark.cuda
@pytest.mark.parametrize("name", [r[0] for r in rs.RUNS])
def test_reduce_scan_time_grows_with_reps(cuda_device, name):
    """Were the repeats folded, 4 REPS would take about the time of REPS."""
    from moss_torch.tools.timing import cuda_ms

    x, s = _chunk(cuda_device)
    t_r = cuda_ms(lambda: rs.run(name, x, s, reps=rs.REPS))
    t_4r = cuda_ms(lambda: rs.run(name, x, s, reps=4 * rs.REPS))
    assert t_4r > 1.5 * t_r, (t_r, t_4r)


def _conv_bf16(device, shape, seed=2):
    x, w, b = _conv_inputs(device, *shape, seed=seed)
    return x.to(torch.bfloat16), w.to(torch.bfloat16), b.to(torch.bfloat16)


def _bf16_close(got, want):
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2e-2 * float(want.float().abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", [None, torch.float32], ids=["bf16_out", "f32_out"])
@pytest.mark.parametrize("shape", [(13, 29, 48, 72), (32, 32, 512, 512), (5, 7, 128, 136)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_tensor_cores_match_plain(cuda_device, shape, out_dtype):
    """The tensor-core kernel at its edges (Cin not a multiple of 64, Cout not
    one of the tile's channels, H and W not multiples of the tile, an image
    smaller than a tile) and at the 32x32x512->512 VGG layer: one launch of
    the tensor-core kernel a call, none of the CUDA-core one."""
    x, w, b = _conv_bf16(cuda_device, shape)
    before = (conv.launches, conv.tc_launches)
    for relu in (True, False):
        got = conv.conv3x3(x, w, b, relu=relu, out_dtype=out_dtype)
        want = conv.conv3x3_plain(x, w, b, relu=relu, out_dtype=out_dtype)
        assert got.dtype == want.dtype == (out_dtype or torch.bfloat16)
        _bf16_close(got, want)
    torch.cuda.synchronize()
    assert (conv.launches, conv.tc_launches) == (before[0], before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [(512, 64, 64), (256, 64, 128), (256, 128, 128),
                                   (128, 128, 256), (128, 256, 256), (64, 256, 512),
                                   (64, 512, 512), (32, 512, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_tensor_cores_at_the_vgg_layers(cuda_device, layer):
    """The eight VGG16 layers, which between them take every tile the C
    library has; its tiles are those tests/test_torch_conv3x3.py::TILES
    copies."""
    assert [(t["rows"], t["channels"]) for t in conv.tc_tiles(cuda_device)] == \
        [(8, 128), (8, 64), (4, 64)]
    H, cin, cout = layer
    x, w, b = _conv_bf16(cuda_device, (H, H, cin, cout), seed=3)
    before = conv.tc_launches
    _bf16_close(conv.conv3x3(x, w, b), conv.conv3x3_plain(x, w, b))
    assert conv.tc_launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(13, 29, 5, 70), (13, 29, 48, 70)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_bf16_off_the_tensor_cores(cuda_device, shape):
    """Cin or Cout not a multiple of 8: the CUDA-core kernel takes bf16 too."""
    x, w, b = _conv_bf16(cuda_device, shape)
    before = (conv.launches, conv.tc_launches)
    _bf16_close(conv.conv3x3(x, w, b, relu=False), conv.conv3x3_plain(x, w, b, relu=False))
    torch.cuda.synchronize()
    assert (conv.launches, conv.tc_launches) == (before[0] + 1, before[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(13, 29, 48, 72), (32, 32, 512, 512), (64, 64, 256, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_bf16_repeats_bit_for_bit(cuda_device, shape):
    x, w, b = _conv_bf16(cuda_device, shape)
    assert torch.equal(conv.conv3x3(x, w, b), conv.conv3x3(x, w, b))


@pytest.mark.cuda
def test_conv3x3_unaligned_input_takes_the_tensor_cores(cuda_device):
    """An x that does not start on 16 bytes is copied to one that does, and
    goes to the tensor-core kernel with the aligned input's bits."""
    x, w, b = _conv_bf16(cuda_device, (13, 29, 48, 72))
    xs = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda_device)[1:].view(x.shape)
    xs.copy_(x)
    assert xs.data_ptr() % 16 != 0
    before = (conv.launches, conv.tc_launches)
    assert torch.equal(conv.conv3x3(xs, w, b), conv.conv3x3(x, w, b))
    assert (conv.launches, conv.tc_launches) == (before[0], before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("stage", conv.STAGES)
@pytest.mark.parametrize("shape", [(13, 29, 48, 72), (32, 32, 512, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_conv3x3_stage_matches_plain(cuda_device, shape, stage):
    """Each stage of the tensor-core kernel at every tile: "full" the conv,
    bitwise equal to the production call at the tile that call takes; the
    others exactly relu(b) at every pixel."""
    x, w, b = _conv_bf16(cuda_device, shape)
    for tile in [None, *range(len(conv.tc_tiles(cuda_device)))]:
        before = conv.stage_launches
        got = conv.conv3x3_tc_stage(x, w, b, stage, tile=tile)
        assert conv.stage_launches == before + 1
        if stage != "full":
            assert torch.equal(got, conv.conv3x3_stage_plain(x, w, b, stage)), tile
        elif tile is None:
            assert torch.equal(got, conv.conv3x3(x, w, b))
        else:
            _bf16_close(got, conv.conv3x3_plain(x, w, b))


def _densify_world(device, P=4096, n=2000, seed=11):
    """A cloud 1 cm around a 300-vertex synthetic body, in scattered slots,
    100 of its points with a twin 1.5 mm away (merge candidates), with window
    statistics and Adam moments: (params, gstate, opt, verts)."""
    from scipy.spatial.transform import Rotation

    from moss_torch.data.synthetic import make_scene
    from moss_torch.models import gaussians as G
    from moss_torch.train.optim import AdamState

    rng = np.random.default_rng(seed)
    verts = make_scene(n_verts=300, device="cpu").big_pose_vertices.numpy()
    slots = np.sort(rng.permutation(P)[:n])
    valid = np.zeros(P, bool)
    valid[slots] = True
    xyz = np.zeros((P, 3), np.float32)
    xyz[:, 2] = -1e6
    xyz[slots] = verts[rng.integers(0, len(verts), n)] + rng.normal(0, 0.01, (n, 3))
    fields = {"xyz": xyz, "f_dc": rng.normal(size=(P, 1, 3)), "f_rest": rng.normal(size=(P, 15, 3)),
              "scaling": rng.uniform(np.log(0.002), np.log(0.03), (P, 3)),
              "rotation": rng.normal(size=(P, 4)), "opacity": rng.normal(0, 2, (P, 1))}
    a, b = slots[:100], slots[100:200]
    d = rng.normal(size=(100, 3))
    xyz[b] = xyz[a] + 0.0015 * d / np.linalg.norm(d, axis=1, keepdims=True)
    fields["scaling"][a] = rng.uniform(np.log(0.006), np.log(0.0095), (100, 3))
    fields["scaling"][b], fields["rotation"][b] = fields["scaling"][a], fields["rotation"][a]
    denom = rng.integers(0, 11, P) * valid

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    params = G.GaussianParams(**{f: t(v) for f, v in fields.items()})
    gstate = G.GaussianState(
        valid=torch.as_tensor(valid, device=device), max_radii2d=t(rng.uniform(0, 40, P)),
        xyz_grad_accum=t(rng.uniform(0, 4e-4, P) * denom), denom=t(denom),
        joint_F=t(sum(Rotation.random(23, random_state=s).as_matrix() for s in range(10))),
        lbs_weight_sum=t(rng.dirichlet(np.full(24, 0.3), P) * 10.0 * valid[:, None]))
    opt = {f: AdamState(7, {f: t(rng.normal(size=v.shape))}, {f: t(rng.uniform(0.1, 1, v.shape))})
           for f, v in fields.items()}
    return params, gstate, opt, t(verts)


@pytest.mark.cuda
def test_densify_round_on_the_card_matches_the_cpu(cuda_device):
    """One densify_and_prune round on the card and on the CPU with the same
    noise and normals (chip_smoke.py's densify gate): the clone, split, merge
    and prune masks differ on at most 1e-3 of the slots, params and moments
    within 1e-5 of their max where masks and valid agree."""
    from moss_torch.config import OptimConfig
    from moss_torch.models.gaussians import FIELDS
    from moss_torch.train import densify as D

    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = _densify_world("cpu")
    card = _densify_world(cuda_device)
    P = cpu[0].capacity
    noise = torch.randn((3, P, 3), generator=torch.Generator().manual_seed(0))
    normals = D.pca_normals(cpu[0].xyz, D.neighbours(cpu[0], cpu[1].valid))
    cfg = OptimConfig()
    ref = D.densify_and_prune(*cpu[:3], noise, cfg, 1.0, cpu[3], False, normals=normals)
    out = D.densify_and_prune(*card[:3], noise.to(cuda_device), cfg, 1.0, card[3], False,
                              normals=normals.to(cuda_device))
    diff = torch.zeros(P, dtype=torch.bool)
    for k in ("clone", "split", "merge", "prune"):
        diff |= out[3]["masks"][k].cpu() != ref[3]["masks"][k]
    assert float(diff.float().mean()) <= 1e-3
    assert min(int(ref[3][k]) for k in ("cloned", "split", "merged")) > 0
    keep = ~diff & (out[1].valid.cpu() == ref[1].valid) & ref[1].valid
    for f in FIELDS:
        pairs = [(getattr(out[0], f), getattr(ref[0], f))]
        pairs += [(getattr(out[2][f], m)[f], getattr(ref[2][f], m)[f]) for m in ("mu", "nu")]
        for a, b in pairs:
            a, b = a.cpu()[keep], b[keep]
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max()), f


def _small_trainer(device):
    """A 12-iteration Trainer at 64x64 from 300 points (rounds at 4 and 8, a
    reset at 6, evals at 6, 7 and 12)."""
    from moss_torch.config import Config, ModelConfig, OptimConfig, PipelineConfig
    from moss_torch.data.synthetic import make_frames, make_scene
    from moss_torch.ops import lpips
    from moss_torch.train.trainer import Trainer

    scene = make_scene(n_verts=300, device=device)
    frames, _ = make_frames(scene, n_frames=3, H=64, W=64, crop=48, opacity=0.5)
    cfg = Config(model=ModelConfig(sh_degree=1, capacity=1024, n_init_points=300),
                 optim=OptimConfig(iterations=12, densify_from_iter=3, densify_until_iter=10,
                                   densification_interval=4, opacity_reset_interval=6),
                 pipe=PipelineConfig(test_iterations=(6, 7, 12), save_iterations=()))
    return Trainer(scene, frames[:2], frames[2:], cfg, lpips.init_random(3407, device),
                   crop_hw=(48, 48), device=device)


@pytest.mark.cuda
def test_resume_on_the_card_is_bitwise_equal(cuda_device, tmp_path):
    """12 iterations against 6, resume_latest, 6 more (chip_smoke.py's
    checkpoint gate at a small size): every checkpoint leaf and the evals at
    7 and 12 bitwise equal."""
    from moss_torch.train import checkpoint as ckpt

    tr = _small_trainer(cuda_device)
    tr.train(ckpt_fn=lambda it: tr.save(str(tmp_path / f"chkpnt{it}.npz")) if it == 6 else None)
    again = _small_trainer(cuda_device)
    assert again.resume_latest(str(tmp_path)) == 6
    again.train()
    a, b = ckpt.flatten(tr.ts), ckpt.flatten(again.ts)
    assert sorted(a) == sorted(b)
    assert [k for k in a if not np.array_equal(a[k], b[k])] == []

    def strip(hist):
        return [{k: v for k, v in m.items() if k != "elapsed_s"} for m in hist]

    assert strip(again.metrics_history) == strip(tr.metrics_history[1:])


@pytest.mark.cuda
def test_loaded_compacted_avatar_renders_as_the_plain_version(cuda_device, tmp_path):
    """A trained state saved, loaded into a fresh Trainer and compacted: its
    frame on the full and the cached path through the forward kernel against
    the same renders through the plain blend (the image rule)."""
    from moss_torch.render.render import render_frame

    tr = _small_trainer(cuda_device)
    tr.train(eval_iters=[])
    path = str(tmp_path / "final.npz")
    tr.save(path)
    srv = _small_trainer(cuda_device)
    srv.load(path)
    live = int(tr.ts.gstate.valid.sum())
    assert srv.compact_for_eval(granularity=128) == -(-live // 128) * 128 < 1024
    assert int(srv.ts.gstate.valid.sum()) == live
    ts, frame = srv.ts, srv.test_frames[0]
    plain = functools.partial(rasterize_reference, tile_h=rc.TILE, tile_w=rc.TILE)

    def render(cache=None, **kw):
        extra = {} if cache is None else {"cached_transforms": cache["transforms"],
                                          "cached_translation": cache["translation"]}
        with torch.no_grad():
            return render_frame(ts.params["gauss"], ts.gstate.valid, ts.params["mlps"],
                                srv.scene, frame.smpl_params, frame.camera, srv.bg, 1,
                                device=cuda_device, **extra, **kw)

    before = rc.launches
    full = render()
    cached = render(full)
    assert rc.launches == before + 2
    for out, ref in ((full, render(rasterize_fn=plain)), (cached, render(full, rasterize_fn=plain))):
        assert float(out["render_alpha"].max()) > 0.1
        for key in ("render", "render_alpha", "final_T"):
            assert_images_match(out[key], ref[key])
        assert_images_match(out["render_depth"], ref["render_depth"], atol=1e-4)


@pytest.mark.cuda
def test_kernels_on_a_ragged_frame_with_split_tiles(cuda_device):
    """W = 120 = 7.5 tiles (DNA-Rendering's 1224 is 76.5): the last tile
    column half outside the frame, tiles of more than rc.SEGMENT pairs split
    into segments. The forward kernel against the plain blend under the
    image rule, the backward kernel + segment sum against autograd through
    it within the grad rule, one launch of each."""
    H, W = 64, 120
    proj = projected(cuda_device, H, W, n=1500)
    # the cloud moved 45 px right, so it straddles the frame's right edge
    proj = proj._replace(mean2d=proj.mean2d + torch.tensor([45.0, 0.0], device=cuda_device))
    pairs = rc.bin_projected(proj, H, W)
    assert int(pairs.tile_count.max()) > 2 * rc.SEGMENT
    last_col = pairs.tile_count.reshape(-1, -(-W // rc.TILE))[:, -1]
    assert int(last_col.sum()) > 0  # pairs in the partial tiles
    bg = torch.tensor([0.2, 0.5, 0.7], device=cuda_device)
    up = _upstream(cuda_device, H, W)
    before = (rc.launches, rc.bwd_launches, rc.segment_launches)
    g, out = _grads(proj, bg, H, W, up, rc.rasterize_cuda)
    torch.cuda.synchronize()
    assert (rc.launches, rc.bwd_launches, rc.segment_launches) == tuple(b + 1 for b in before)
    plain = functools.partial(rasterize_reference, tile_h=rc.TILE, tile_w=rc.TILE)
    g_ref, ref = _grads(proj, bg, H, W, up, plain)
    assert out["color"].shape == (H, W, 3)
    for key in ("color", "alpha", "final_T"):
        assert_images_match(out[key], ref[key])
    assert_images_match(out["depth"], ref["depth"], atol=1e-4)
    for name, a, b in zip(rc._KERNEL_FIELDS, g[:-1], g_ref[:-1]):
        assert_grad_close(a, b, name)
    torch.testing.assert_close(g[-1], g_ref[-1], rtol=1e-4, atol=0)


@pytest.mark.cuda
def test_smplx_frame_on_the_card(cuda_device):
    """A J=55 frame (synthetic_smplx, motion_offset=False) at 48x72 through
    render_frame: the kernel's render against the plain blend's, and the
    Gaussian grads of a random image loss through both within the grad rule."""
    from moss_torch.models import gaussians as G
    from moss_torch.models import smpl as S
    from moss_torch.render.render import SceneContext, render_frame

    model = S.synthetic_smplx(n_verts=500, device=cuda_device)
    big = S.big_pose_params_smplx(device=cuda_device)
    v_big, _ = S.lbs_vertices(model, big["poses"][0], big["shapes"][0])
    scene = SceneContext(smpl=model, big_pose_params=big, big_pose_vertices=v_big)
    rng = np.random.default_rng(3)
    params, valid = G.create_from_points(v_big.cpu().numpy(), rng.uniform(size=(500, 3)), 640,
                                         sh_degree=1, device=cuda_device)
    params.opacity = torch.where(valid[:, None], 0.0, params.opacity)  # opacity 0.5
    H, W = 48, 72
    cam = Camera.from_KRT(np.array([[60.0, 0, W / 2], [0, 60.0, H / 2], [0, 0, 1.0]]),
                          np.eye(3), np.array([0, 0, 2.5]), H, W, device=cuda_device)
    sp = {"poses": torch.as_tensor(rng.normal(0, 0.2, (1, 165)).astype(np.float32),
                                   device=cuda_device),
          "shapes": torch.zeros((1, 20), device=cuda_device),
          "R": torch.eye(3, device=cuda_device), "Th": torch.zeros((1, 3), device=cuda_device)}
    up = _upstream(cuda_device, H, W)
    plain = functools.partial(rasterize_reference, tile_h=rc.TILE, tile_w=rc.TILE)

    def grads(raster):
        leaves = G.GaussianParams(**{f: getattr(params, f).clone().requires_grad_()
                                     for f in G.FIELDS})
        out = render_frame(leaves, valid, None, scene, sp, cam, torch.zeros(3, device=cuda_device),
                           1, rasterize_fn=raster, motion_offset=False, device=cuda_device)
        loss = (out["render"] * up["color"]).sum() + (out["render_alpha"] * up["alpha"]).sum()
        return out, torch.autograd.grad(loss, [getattr(leaves, f) for f in G.FIELDS],
                                        allow_unused=True)

    before = rc.launches
    out, g = grads(None)
    assert rc.launches == before + 1
    ref, g_ref = grads(plain)
    assert out["pose_out"] is None and out["lbs_weights"].shape == (640, 55)
    assert float(out["render_alpha"].detach().max()) > 0.1
    for key in ("render", "render_alpha", "final_T"):
        assert_images_match(out[key].detach(), ref[key].detach())
    assert_images_match(out["render_depth"].detach(), ref["render_depth"].detach(), atol=1e-4)
    for name, a, b in zip(G.FIELDS, g, g_ref):
        if b is not None and float(b.abs().max()) > 0:
            assert_grad_close(a, b, name)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["zju", "monocap"])
def test_orbit_frame_matches_plain(cuda_device, name):
    """A blob at the orbit's centre through orbit view 5's camera (128x128):
    the kernel against the plain blend, the subject in view."""
    from moss_torch.render import novel_view as nv

    fn = nv.orbit_w2c_zju if name == "zju" else nv.orbit_w2c_monocap
    rng = np.random.default_rng(4)
    H = W = 128
    n = 2000
    w2c = fn(5)
    K = np.array([[1.1 * H, 0, W / 2], [0, 1.1 * H, H / 2], [0, 0, 1.0]])
    cam = Camera.from_KRT(K, w2c[:3, :3].T, w2c[:3, 3], H, W, device=cuda_device)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=cuda_device)

    means = rng.normal(0, [0.15, 0.4, 0.15], (n, 3)) + nv.ORBIT_CENTER[name]
    proj = preprocess(t(means), build_covariance(t(rng.uniform(0.01, 0.04, (n, 3))),
                                                 t(rng.normal(size=(n, 4)))),
                      t(rng.uniform(size=(n, 3))), t(rng.uniform(0.3, 0.9, n)), cam)
    bg = torch.zeros(3, device=cuda_device)
    before = rc.launches
    with torch.inference_mode():
        out = rc.rasterize_cuda(proj, bg, H, W)
        ref = rasterize_reference(proj, bg, H, W, tile_h=rc.TILE, tile_w=rc.TILE)
    assert rc.launches == before + 1
    assert float(out["alpha"].max()) > 0.5
    for key in ("color", "alpha", "final_T"):
        assert_images_match(out[key], ref[key])
    assert_images_match(out["depth"], ref["depth"], atol=1e-4)


@pytest.mark.cuda
def test_1024_frame_matches_plain(cuda_device):
    """MonoCap's frame size, 1024x1024, four times the 512x512 paths' pixels."""
    H = W = 1024
    proj = projected(cuda_device, H, W, n=4096, fx=1100.0)
    bg = torch.tensor([0.2, 0.5, 0.7], device=cuda_device)
    with torch.inference_mode():
        out = rc.rasterize_cuda(proj, bg, H, W)
        ref = rasterize_reference(proj, bg, H, W, tile_h=rc.TILE, tile_w=rc.TILE)
    assert float(ref["alpha"].max()) > 0.5
    for key in ("color", "alpha", "final_T"):
        assert_images_match(out[key], ref[key])
    assert_images_match(out["depth"], ref["depth"], atol=1e-4)


def _band(proj, t, hb):
    shift = torch.tensor([0.0, float(t * hb)], device=proj.mean2d.device)
    return proj._replace(mean2d=proj.mean2d - shift)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tile", [2, 4])
def test_band_of_a_shifted_mean2d_is_the_full_frames_rows(cuda_device, n_tile):
    H, W = 128, 96
    proj = projected(cuda_device, H, W, n=400, fx=110.0)
    bg = torch.tensor([0.2, 0.5, 0.7], device=cuda_device)
    hb = H // n_tile
    with torch.inference_mode():
        full = rc.rasterize_cuda(proj, bg, H, W)
        for t in range(n_tile):
            band = rc.rasterize_cuda(_band(proj, t, hb), bg, hb, W)
            for key in ("color", "depth", "alpha", "final_T"):
                assert torch.equal(band[key], full[key][t * hb:(t + 1) * hb]), (t, key)


@pytest.mark.cuda
def test_band_grads_sum_to_the_full_frames(cuda_device):
    H, W, n_tile = 128, 96, 2
    proj = projected(cuda_device, H, W, n=400, fx=110.0)
    bg = torch.tensor([0.2, 0.5, 0.7], device=cuda_device)
    up = _upstream(cuda_device, H, W)
    g_full, _ = _grads(proj, bg, H, W, up, rc.rasterize_cuda)
    hb = H // n_tile
    total = None
    for t in range(n_tile):
        rows = slice(t * hb, (t + 1) * hb)
        g, _ = _grads(_band(proj, t, hb), bg, hb, W, {k: v[rows] for k, v in up.items()},
                      rc.rasterize_cuda)
        total = g if total is None else [a + b for a, b in zip(total, g)]
    for name, a, b in zip(rc._KERNEL_FIELDS, total, g_full):
        assert_grad_close(a, b, name)


# ---- the static budgets, the 3x3 SVD and the engines ------------------------------------


@pytest.mark.cuda
def test_svd3_kernel_against_plain(cuda_device):
    """csrc/svd3.cu against torch.linalg.svd on the card: S and the proper S
    within 1e-5 of the max, U diag(g) V^T within 1e-4 where the singular values
    are apart; one launch a call; bitwise repeatable."""
    from moss_torch.ops import fisher

    g = torch.Generator().manual_seed(0)
    a = torch.cat([torch.randn((1000, 3, 3), generator=g),
                   torch.eye(3) + 1e-5 * torch.randn((23, 3, 3), generator=g)]).to(cuda_device)
    before = fisher.launches
    U, S, V, sign = fisher.svd3(a)
    again = fisher.svd3(a)
    assert fisher.launches == before + 2
    assert all(torch.equal(x, y) for x, y in zip((U, S, V, sign), again))
    Ur, Sr, Vr, sr = fisher.svd3_plain(a)
    scale = Sr[:, :1].clamp_min(1.0)
    assert float(((S - Sr).abs() / scale).max()) <= 1e-5
    ok = Sr[:, 2] > 1e-3 * Sr[:, 0]
    assert torch.equal(sign[ok], sr[ok])
    gv = torch.tensor([0.3, -1.2, 0.7], device=cuda_device)
    apart = ((Sr[:, :2] - Sr[:, 1:]) > 1e-3 * scale).all(1)

    def back(U, V, s):
        return torch.einsum("bik,bk,bjk->bij", U, gv * torch.stack(
            [torch.ones_like(s), torch.ones_like(s), s], 1), V)

    assert float((back(U, V, sign) - back(Ur, Vr, sr))[apart].abs().max()) <= 1e-4


@pytest.mark.cuda
def test_device_adamw_is_the_host_adamw_on_the_card(cuda_device):
    """The tables' reciprocals reproduce a Python scalar divisor's CUDA path bit for bit."""
    from moss_torch.config import OptimConfig
    from moss_torch.models import gaussians as G
    from moss_torch.train import optim

    cfg = OptimConfig(iterations=30, densify_from_iter=3, densify_until_iter=25,
                      densification_interval=5, opacity_reset_interval=7)
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = {"gauss": G.GaussianParams(**{f: torch.randn((5000, 3), generator=g,
                                                          device=cuda_device)
                                           for f in G.FIELDS}), "mlps": None}
    dev = {"gauss": G.GaussianParams(**{f: getattr(params["gauss"], f).clone()
                                        for f in G.FIELDS}), "mlps": None}
    host = optim.init_state(params)
    state = {k: optim.AdamState(torch.tensor(0, device=cuda_device), s.mu, s.nu)
             for k, s in optim.init_state(dev).items()}
    tables = optim.step_tables(cfg, False, optim.param_groups(params), 1.0, cuda_device)
    for step in range(30):
        grads = {f: {f: torch.randn((5000, 3), generator=g, device=cuda_device)}
                 for f in G.FIELDS}
        host = optim.adamw_step(cfg, params, grads, host,
                                optim.skipped_groups(cfg, False, step + 1))
        optim.adamw_step_device(cfg, dev, grads, state, tables,
                                torch.tensor(step, device=cuda_device))
    for f in G.FIELDS:
        assert torch.equal(getattr(params["gauss"], f), getattr(dev["gauss"], f)), f
        assert torch.equal(host[f].mu[f], state[f].mu[f]) and int(state[f].count) == host[f].count


@pytest.mark.cuda
@pytest.mark.parametrize("B,budget", [(4, 40000), (64, 512), (4, 384), (64, 40000)])
def test_budgeted_pairs_on_the_card_are_the_cpus(cuda_device, B, budget):
    from moss_torch.ops import binning

    proj = projected(cuda_device, 64, 96, n=300)
    args = (proj.mean2d, proj.conic, proj.opacity, proj.depth, proj.radius, proj.radius_xy,
            proj.valid, 64, 96)
    gpu = binning.bin_pairs(*args, pair_budget=budget, max_tiles_per_gaussian=B)
    cpu = binning.bin_pairs(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args),
                            pair_budget=budget, max_tiles_per_gaussian=B)
    for f in gpu._fields:
        assert torch.equal(getattr(gpu, f).cpu(), getattr(cpu, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("B,budget", [(4, 40000), (64, 512), (64, 40000)])
def test_budgeted_blend_kernels_against_plain(cuda_device, B, budget):
    """rasterize_cuda with budgets (pair arrays at the capacity NPb, CTAs for the
    capacity) against the plain blend of the same kept pairs on the card: the
    image rule, and the grads of mean2d, conic, opacity, color and depth."""
    from moss_torch.ops import binning

    H, W = 64, 96
    proj = projected(cuda_device, H, W, n=300)
    leaves = {f: getattr(proj, f).clone().requires_grad_() for f in
              ("mean2d", "conic", "opacity", "color", "depth")}
    p = proj._replace(**leaves)
    bg = torch.tensor([0.2, 0.5, 0.9], device=cuda_device)
    out = rc.rasterize_cuda(p, bg, H, W, pair_budget=budget, max_tiles_per_gaussian=B)
    pairs = rc.bin_projected(proj, H, W, budget, B)
    mask = binning.kept_pair_mask(pairs, proj.mean2d.shape[0], pairs.tile_offsets.shape[0] - 1)
    ref = rasterize_reference(p, bg, H, W, tile_h=rc.TILE, tile_w=rc.TILE, pair_mask=mask)
    assert int(out["overflow"]) == int(pairs.overflow)
    for k in ("color", "alpha", "final_T"):
        assert_images_match(out[k], ref[k])
    g = torch.randn((H, W, 3), generator=torch.Generator().manual_seed(1)).to(cuda_device)
    got = torch.autograd.grad((out["color"] * g).sum(), list(leaves.values()))
    want = torch.autograd.grad((ref["color"] * g).sum(), list(leaves.values()))
    for name, a, b in zip(leaves, got, want):
        assert float((a - b).abs().max()) <= 5e-4 * float(b.abs().max()) + 1e-12, name


@pytest.mark.cuda
def test_captured_step_equals_the_uncaptured_one(cuda_device):
    """The scan engine (a CUDA graph of the step, replayed) against eager and
    queued (the same step, launched): bitwise every leaf after 12 iterations
    with two rounds and a reset; every queued segment free of host syncs. The
    wrappers count what they launch: every step under eager and queued, the
    warm-up step of each capture under scan, whose captures record one step's
    calls each and whose replays run the rest of the 12 steps."""
    from moss_torch.ops import fisher
    from moss_torch.train import checkpoint as ckpt

    leaves, launches = {}, {}
    for engine in ("eager", "queued", "scan"):
        tr = _small_trainer(cuda_device)
        if engine == "queued":
            tr.segment_sync_mode = "error"
        rc.launches = rc.bwd_launches = rc.segment_launches = fisher.launches = 0
        tr.train(eval_iters=[], dispatch_engine=engine)
        launches[engine] = (rc.bwd_launches, rc.segment_launches, fisher.launches)
        leaves[engine] = ckpt.flatten(tr.ts)
        if engine == "scan":
            many = tr._many
            assert many.captures >= 1 and many.pool_mb > 0
            assert many.captures + many.replays == 12
            assert many.captured_launches == {"rasterize_fwd": 1, "rasterize_bwd": 1,
                                              "segment_sum": 1, "svd3": 1}
            assert launches["scan"] == (many.captures,) * 3
    for engine in ("eager", "queued"):
        assert launches[engine] == (12, 12, 12), (engine, launches)
    for engine in ("queued", "scan"):
        assert [k for k in leaves["eager"]
                if not np.array_equal(leaves["eager"][k], leaves[engine][k])] == [], engine
