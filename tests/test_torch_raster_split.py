"""The segment scheme of the split blend kernels (moss_torch/ops/split_blend.py)
against moss_tpu, on the CPU.

The plain split forward and backward walk tiles cut into segments of at most
S <= 32 pairs, so most busy tiles of these small scenes have several:

  * the forward against moss_tpu's Pallas kernel, rasterize_tpu (interpret
    mode), with both binned at its 8x128 tiles, under
    tests/test_rasterize_tpu.py:50-59's image rule: a random scene, a dense
    near-opaque one whose pixels stop inside segments, and one where S is
    chosen so that pixels stop on the first pair of a segment;
  * the backward's per-pair rows, summed per Gaussian, against jax.grad
    through the same JAX function (divide by max|g_ref|, atol 5e-4:
    tests/test_rasterize_tpu.py:150);
  * at S >= the longest tile, both bitwise the unsplit plain walk (S None);
  * the kernels' CTA-to-segment map covers every pair once.
"""
import os

os.environ["MOSS_PALLAS_INTERPRET"] = "1"

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moss_tpu.ops.rasterize_tpu import TILE_H, TILE_W, rasterize_tpu
from moss_torch.ops import binning, rasterize_cuda as rc, split_blend as sb
from test_rasterize_tpu import assert_images_match, make_camera
from test_torch_raster_bwd import assert_grad_close
from test_torch_rasterize import jax_projected, to_torch
from _torch_threads import two_torch_threads  # noqa: F401

FIELDS = ("mean2d", "conic", "opacity", "color", "depth")


def tpu_pairs(proj, H, W):
    """The port's pair list at rasterize_tpu's 8x128 tiles (groups=1)."""
    return binning.bin_pairs(proj.mean2d, proj.conic, proj.opacity, proj.depth, proj.radius,
                             proj.radius_xy, proj.valid, H, W, TILE_H, TILE_W)


def split(pairs, proj, H, W, S):
    return sb.blend_split(pairs, proj, H, W, S, tile_h=TILE_H, tile_w=TILE_W)


def images(img, bg):
    """rasterize_tpu's dict from the six planes."""
    color = img[:3].permute(1, 2, 0) + img[5][..., None] * torch.as_tensor(bg)
    return {"color": color, "depth": img[3], "alpha": img[4], "final_T": img[5]}


def stop_positions(pairs, proj, H, W):
    """Per (tile, pixel), the place in its tile's pair list of the pair on
    which the sequential walk stops; -1 where it does not."""
    m2, con, op = proj.mean2d.numpy(), proj.conic.numpy(), proj.opacity.numpy()
    offs, pg = pairs.tile_offsets.numpy(), pairs.pair_gaussian.numpy()
    grid_w = -(-W // TILE_W)
    lane = np.arange(TILE_H * TILE_W)
    f32 = np.float32
    out = []
    for t in range(len(offs) - 1):
        px = ((t % grid_w) * TILE_W + lane % TILE_W).astype(f32)
        py = ((t // grid_w) * TILE_H + lane // TILE_W).astype(f32)
        T = np.ones(lane.shape, f32)
        pos = np.full(lane.shape, -1)
        for j, g in enumerate(pg[offs[t]:offs[t + 1]]):
            dx, dy = m2[g, 0] - px, m2[g, 1] - py
            a, b, c = con[g]
            power = f32(-0.5) * (a * dx * dx + c * dy * dy) - b * dx * dy
            alpha = np.minimum(f32(0.99), op[g] * np.exp(power))
            ok = (pos < 0) & (power <= 0) & (alpha >= f32(1 / 255))
            test_T = T * (f32(1) - alpha)
            pos = np.where(ok & (test_T < f32(1e-4)), j, pos)
            T = np.where(ok & (test_T >= f32(1e-4)), test_T, T)
        out.append(pos)
    return np.stack(out)


CASES = {  # name: (n, dense, S, fx)
    "scene": (60, False, 4, 80.0),
    "dense": (128, True, 16, 60.0),
    "stop_on_first_pair": (128, True, None, 60.0),  # S from the stops
}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    n, dense, S, fx = CASES[request.param]
    rng = np.random.default_rng(11)
    H = W = 32 if dense else 64
    jproj = jax_projected(rng, make_camera(H, W, fx=fx), n=n, dense=dense)
    proj = to_torch(jproj)
    pairs = tpu_pairs(proj, H, W)
    if S is None:  # the least S on which some pixel stops on a segment's first pair
        pos = stop_positions(pairs, proj, H, W)
        S = next(s for s in range(2, 33) if ((pos > 0) & (pos % s == 0)).any())
    return request.param, H, W, jproj, proj, pairs, S


def test_forward_matches_pallas_kernel(case):
    name, H, W, jproj, proj, pairs, S = case
    counts = pairs.tile_count[pairs.tile_count > 0]
    assert float((counts > S).float().mean()) >= 0.5 and int(counts.max()) > 3 * S
    bg = np.array([0.9, 0.4, 0.1], np.float32)
    tpu = rasterize_tpu(jproj, jnp.asarray(bg), H, W, groups=1)
    img, _ = split(pairs, proj, H, W, S)
    out = images(img, bg)
    if name != "scene":
        assert float(out["final_T"].min()) < 1e-3  # termination exercised
    for key in ("color", "alpha", "final_T"):
        assert_images_match(out[key].numpy(), np.asarray(tpu[key]))
    assert_images_match(out["depth"].numpy(), np.asarray(tpu["depth"]), atol=1e-4)


def test_backward_matches_jax_grad(case):
    name, H, W, jproj, proj, pairs, S = case
    rng = np.random.default_rng(5)
    up = {k: rng.normal(size=s).astype(np.float32)
          for k, s in (("color", (H, W, 3)), ("depth", (H, W)), ("alpha", (H, W)),
                       ("final_T", (H, W)))}
    bg = np.array([0.2, 0.5, 0.7], np.float32)

    def loss(*fields):
        out = rasterize_tpu(jproj._replace(**dict(zip(FIELDS, fields))), jnp.asarray(bg), H, W,
                            groups=1)
        return sum(jnp.sum(out[k] * up[k]) for k in up)

    want = jax.grad(loss, argnums=tuple(range(5)))(*(getattr(jproj, f) for f in FIELDS))

    img, state = split(pairs, proj, H, W, S)
    g_img = np.stack([up["color"][..., 0], up["color"][..., 1], up["color"][..., 2], up["depth"],
                      up["alpha"], up["final_T"] + (up["color"] * bg).sum(-1)])
    gimg = torch.as_tensor(g_img)
    gimg = torch.cat([gimg[:5], (gimg * img).sum(0, keepdim=True)])
    rows = sb.blend_split_bwd(pairs, proj, gimg, H, W, state, tile_h=TILE_H, tile_w=TILE_W)
    got = rc.segment_sum(rows, pairs).numpy()
    cols = (slice(0, 2), slice(2, 5), 5, slice(6, 9), 9)
    for f, sl, w in zip(FIELDS, cols, want):
        assert np.abs(np.asarray(w)).max() > 0, f
        assert_grad_close(got[:, sl], np.asarray(w), f)


@pytest.mark.parametrize("dense", [False, True], ids=["scene", "dense"])
def test_one_segment_a_tile_is_the_unsplit_walk(rng, dense):
    """At S >= the longest tile the split forms take no other step than the
    unsplit walk: their planes and rows are bitwise those of S None."""
    H, W = 45, 77
    proj = to_torch(jax_projected(rng, make_camera(H, W, fx=60.0 if dense else 80.0), n=128,
                                  dense=dense))
    pairs = rc.bin_projected(proj, H, W)
    gimg = torch.as_tensor(rng.normal(size=(6, H, W)).astype(np.float32))
    longest = int(pairs.tile_count.max())
    img0, state0 = sb.blend_split(pairs, proj, H, W, None)
    rows0 = sb.blend_split_bwd(pairs, proj, gimg, H, W, state0)
    for S in (longest, longest + 100):
        img, state = sb.blend_split(pairs, proj, H, W, S)
        assert state[0].tile.numel() == pairs.tile_count.numel()  # one segment a tile
        assert torch.equal(img, img0)
        assert torch.equal(sb.blend_split_bwd(pairs, proj, gimg, H, W, state), rows0)
    # and cut into segments, within rounding of it
    img, state = sb.blend_split(pairs, proj, H, W, 7)
    assert int(state[0].count.max()) > 1
    assert_images_match(img.numpy(), img0.numpy(), atol=1e-6)
    rows = sb.blend_split_bwd(pairs, proj, gimg, H, W, state)
    assert_grad_close(rows.numpy(), rows0.numpy(), "rows", atol=1e-5)


@pytest.mark.parametrize("S", [1, 3, 32, 10 ** 6])
def test_segment_plan_covers_every_pair_once(rng, S):
    H, W = 45, 77
    pairs = rc.bin_projected(to_torch(jax_projected(rng, make_camera(H, W), n=128)), H, W)
    plan = sb.segment_plan(pairs.tile_offsets, S)
    num_tiles = pairs.tile_count.numel()
    assert plan.slots == num_tiles + -(-pairs.num_pairs // S)
    assert sorted(plan.slot.tolist()) == plan.slot.tolist()  # one segment a slot
    covered = torch.zeros(pairs.num_pairs, dtype=torch.int64)
    for start, end in zip(plan.start.tolist(), plan.end.tolist()):
        assert 0 < end - start <= S or start == end
        covered[start:end] += 1
    assert bool((covered == 1).all())
    # every tile's segments, in order, each once; empty tiles one empty segment
    K = torch.where(pairs.tile_count > 0, (pairs.tile_count + S - 1) // S, 1)
    assert torch.equal(torch.bincount(plan.tile, minlength=num_tiles), K)
    assert bool((plan.start[plan.k == 0] == pairs.tile_offsets[:-1].long()).all())
