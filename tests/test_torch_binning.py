"""moss_torch's pair build (ops/binning.py) against moss_tpu's binning.

Per-tile live pair counts must equal moss_tpu's `_pair_keys` at the same tile
shape with groups=1 and no truncation (rect cap and pair budget both large
enough to drop nothing), and blending the pair list in order, pixel by pixel,
exactly as csrc/rasterize_fwd.cu does, must reproduce the plain blend.
"""
import numpy as np
import pytest
import torch

from moss_tpu.ops.binning import _pair_keys, measure_slot_need
from moss_torch.ops import binning
from moss_torch.ops.rasterize_cuda import TILE, bin_projected
from moss_torch.ops.rasterize_ref import rasterize_reference
from test_rasterize_tpu import assert_images_match, make_camera
from test_torch_rasterize import jax_projected, to_torch


def jax_tile_counts(jproj, H, W, tile_h, tile_w):
    num_tiles = -(-H // tile_h) * -(-W // tile_w)
    P = jproj.mean2d.shape[0]
    args = (jproj.mean2d, jproj.conic, jproj.opacity, jproj.depth, jproj.radius,
            jproj.valid, H, W, tile_h, tile_w)
    keys, _ = _pair_keys(*args, max_tiles_per_gaussian=num_tiles,
                         pair_budget=P * num_tiles, align=8, groups=1,
                         radius_xy=jproj.radius_xy)
    live = measure_slot_need(*args, max_tiles_per_gaussian=num_tiles,
                             pair_budget=P * num_tiles, align=8, groups=1,
                             radius_xy=jproj.radius_xy)["live"]
    assert int(keys.rect_overflow) == 0 and int(keys.budget_overflow) == 0
    return np.asarray(keys.tile_count), int(live)


@pytest.mark.parametrize("hw,tile,n", [((64, 64), (16, 16), 200), ((45, 77), (16, 16), 120),
                                       ((64, 64), (8, 32), 200)],
                         ids=["64x64-16x16", "45x77-16x16", "64x64-8x32"])
def test_tile_counts_match_jax(rng, hw, tile, n):
    H, W = hw
    jproj = jax_projected(rng, make_camera(H, W), n=n)
    counts, live = jax_tile_counts(jproj, H, W, *tile)
    p = to_torch(jproj)
    pairs = binning.bin_pairs(p.mean2d, p.conic, p.opacity, p.depth, p.radius, p.radius_xy,
                              p.valid, H, W, *tile)
    np.testing.assert_array_equal(pairs.tile_count.numpy(), counts)
    assert pairs.num_pairs == live == int(counts.sum())
    assert int(pairs.overflow) == 0
    assert pairs.tile_offsets[-1] == pairs.num_pairs


def test_pairs_are_depth_ordered_within_tiles(rng):
    H = W = 64
    p = to_torch(jax_projected(rng, make_camera(H, W), n=200))
    pairs = bin_projected(p, H, W)
    offs = pairs.tile_offsets.numpy()
    depth = p.depth.numpy()[pairs.pair_gaussian.numpy()]
    assert np.all(p.valid.numpy()[pairs.pair_gaussian.numpy()])
    for t in range(len(offs) - 1):
        d = depth[offs[t]:offs[t + 1]]
        assert np.all(np.diff(d) >= 0), t


def sequential_blend(pairs, proj, H, W, bg):
    """csrc/rasterize_fwd.cu's per-pixel loop in numpy, one tile at a time."""
    m2, con = proj.mean2d.numpy(), proj.conic.numpy()
    op, col, dep = proj.opacity.numpy(), proj.color.numpy(), proj.depth.numpy()
    offs, pg = pairs.tile_offsets.numpy(), pairs.pair_gaussian.numpy()
    grid_w = -(-W // TILE)
    lane = np.arange(TILE * TILE)
    out = np.zeros((6, H, W), np.float32)
    f32 = np.float32
    for t in range(len(offs) - 1):
        px = (t % grid_w) * TILE + lane % TILE
        py = (t // grid_w) * TILE + lane // TILE
        inside = (px < W) & (py < H)
        done = ~inside
        T = np.ones(lane.shape, f32)
        acc = np.zeros((5,) + lane.shape, f32)
        for g in pg[offs[t]:offs[t + 1]]:
            dx = m2[g, 0] - px.astype(f32)
            dy = m2[g, 1] - py.astype(f32)
            a, b, c = con[g]
            power = f32(-0.5) * (a * dx * dx + c * dy * dy) - b * dx * dy
            alpha = np.minimum(f32(0.99), op[g] * np.exp(power))
            ok = ~done & (power <= 0) & (alpha >= f32(1.0 / 255.0))
            test_T = T * (f32(1) - alpha)
            stop = ok & (test_T < f32(1e-4))
            done |= stop
            ok &= ~stop
            w = np.where(ok, alpha * T, f32(0))
            acc += w * np.array([*col[g], dep[g], 1.0], f32)[:, None]
            T = np.where(ok, test_T, T)
        yy, xx = py[inside], px[inside]
        out[:5, yy, xx] = acc[:, inside]
        out[5, yy, xx] = T[inside]
    color = np.moveaxis(out[:3], 0, -1) + out[5][..., None] * bg
    return {"color": color, "depth": out[3], "alpha": out[4], "final_T": out[5]}


@pytest.mark.parametrize("dense", [False, True], ids=["scene", "dense"])
def test_sequential_blend_of_pair_list_matches_plain(rng, dense):
    H, W = 45, 77
    cam = make_camera(H, W, fx=60.0 if dense else 80.0)
    p = to_torch(jax_projected(rng, cam, n=128, dense=dense))
    bg = np.array([0.2, 0.5, 0.7], np.float32)
    out = sequential_blend(bin_projected(p, H, W), p, H, W, bg)
    ref = rasterize_reference(p, torch.as_tensor(bg), H, W, tile_h=TILE, tile_w=TILE)
    if dense:
        assert float(ref["final_T"].min()) < 1e-3
    for key, atol in (("color", 3e-5), ("alpha", 3e-5), ("depth", 1e-4), ("final_T", 3e-5)):
        assert_images_match(out[key], ref[key].numpy(), atol=atol)
