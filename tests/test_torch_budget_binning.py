"""The port's budgeted pair list (ops/binning.py, pair_budget / max_tiles_per_gaussian)
against moss_tpu's _pair_keys and measure_slot_need at groups=1 and 16x16 tiles.

  * Inputs from a numpy seed where the rect cap binds, where the NPb cut binds,
    and both: the kept keys (tile and depth rank, every one of the NPb), the
    tile ranges, total_live, max_rect and both overflow counts exactly
    moss_tpu's; the per-Gaussian ranges name each kept pair once.
  * The plain blend on the truncated list (rasterize_cuda on CPU tensors)
    within tests/test_rasterize_tpu.py's image tolerance (atol 3e-5) of
    moss_tpu's rasterize_reference fed the same kept pairs: a render per tile
    with only the Gaussians the list keeps in that tile valid.
  * Budgets that do not bind reproduce the per-frame list bit for bit, and
    its image.
  * Every output shape depends on P, the budgets and the frame alone.
  * default_pair_budget is moss_tpu's at groups=1.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moss_tpu.ops import binning as jbinning
from moss_tpu.ops.binning import _pair_keys, measure_slot_need
from moss_tpu.ops.rasterize_ref import rasterize_reference as jax_rasterize_reference
from moss_torch.ops import binning
from moss_torch.ops.rasterize_cuda import rasterize_cuda
from test_rasterize_tpu import assert_images_match, make_camera
from test_torch_rasterize import jax_projected, to_torch
from _torch_threads import two_torch_threads  # noqa: F401

H = W = 64
TILES = (H // 16) * (W // 16)
BG = np.array([0.3, 0.6, 0.1], np.float32)
# (name, rect cap B, pair budget): the cap binds, the NPb cut binds, both
CASES = [("rect_cap", 4, 40000), ("npb_cut", 64, 512), ("both", 4, 384)]


@pytest.fixture(scope="module")
def scene():
    jproj = jax_projected(np.random.default_rng(11), make_camera(H, W), n=300)
    return jproj, to_torch(jproj)


def port_args(p):
    return (p.mean2d, p.conic, p.opacity, p.depth, p.radius, p.radius_xy, p.valid, H, W)


def jax_keys(jproj, B, budget):
    keys, dims = _pair_keys(jproj.mean2d, jproj.conic, jproj.opacity, jproj.depth, jproj.radius,
                            jproj.valid, H, W, 16, 16, B, budget, 128, 1, jproj.radius_xy)
    return keys, dims[6]


def budgeted(p, B, budget):
    return binning.bin_pairs(*port_args(p), pair_budget=budget, max_tiles_per_gaussian=B)


@pytest.mark.parametrize("name,B,budget", CASES, ids=[c[0] for c in CASES])
def test_budgeted_keys_are_moss_tpus(scene, name, B, budget):
    jproj, p = scene
    jk, KB = jax_keys(jproj, B, budget)
    pairs = budgeted(p, B, budget)
    NPb = binning.npb(300, budget, TILES, B)
    assert pairs.num_pairs == NPb == jk.keys_b.shape[0]
    # every kept key, dead tail included, as (tile, depth rank)
    jkeys = np.asarray(jk.keys_b).astype(np.int64)
    k = binning._budgeted_keys(p.mean2d, p.conic, p.opacity, p.depth, p.radius, p.radius_xy,
                               p.valid, H // 16, W // 16, 16, 16, B)
    keys = k.keys[:NPb].numpy()
    np.testing.assert_array_equal(keys >> 32, jkeys >> KB)
    np.testing.assert_array_equal(keys & 0xFFFFFFFF, jkeys & ((1 << KB) - 1))
    np.testing.assert_array_equal(k.order.numpy(), np.asarray(jk.order))
    # the tile ranges and counts
    np.testing.assert_array_equal(pairs.tile_offsets.numpy()[:-1], np.asarray(jk.t_start))
    np.testing.assert_array_equal(pairs.tile_count.numpy(), np.asarray(jk.tile_count))
    kept = int(pairs.tile_offsets[-1])
    assert kept == int(np.asarray(jk.tile_count).sum())
    # both drop counts, and the need moss_tpu's probe reads
    need = binning.measure_pair_need(*port_args(p), 16, 16, B)
    jneed = measure_slot_need(jproj.mean2d, jproj.conic, jproj.opacity, jproj.depth,
                              jproj.radius, jproj.valid, H, W, 16, 16, max_tiles_per_gaussian=B,
                              pair_budget=300 * B, align=128, groups=1, radius_xy=jproj.radius_xy)
    assert int(need["total_live"]) == int(jneed["total_live"]) == int(jk.total_live)
    assert int(need["max_rect"]) == int(jneed["max_rect"]) == int(jk.max_rect)
    assert int(need["rect_overflow"]) == int(jk.rect_overflow)
    assert int(pairs.overflow) == int(jk.rect_overflow) + int(jk.budget_overflow)
    assert int(k.total_live) - kept == int(jk.budget_overflow)
    binds = {"rect_cap": int(jk.rect_overflow) > 0, "npb_cut": int(jk.budget_overflow) > 0}
    assert binds[name] if name in binds else all(binds.values()), binds
    # the per-Gaussian ranges: each kept pair once, under its own Gaussian
    go, gp = pairs.gaussian_offsets.numpy(), pairs.gaussian_pairs.numpy()
    pg = pairs.pair_gaussian.numpy()
    assert go[0] == 0 and go[-1] == kept and np.all(np.diff(go) >= 0)
    np.testing.assert_array_equal(np.sort(gp[:kept]), np.arange(kept))
    np.testing.assert_array_equal(gp[kept:], np.arange(kept, NPb))
    for g in range(300):
        seg = gp[go[g]:go[g + 1]]
        assert np.all(pg[seg] == g) and np.all(np.diff(seg) > 0)


@pytest.mark.parametrize("name,B,budget", CASES, ids=[c[0] for c in CASES])
def test_plain_blend_on_the_truncated_list(scene, name, B, budget):
    """rasterize_cuda's plain path with budgets against moss_tpu's oracle fed
    the same kept pairs, one tile at a time."""
    jproj, p = scene
    pairs = budgeted(p, B, budget)
    out = rasterize_cuda(p, torch.as_tensor(BG), H, W, pair_budget=budget,
                         max_tiles_per_gaussian=B)
    assert int(out["overflow"]) == int(pairs.overflow) > 0
    mask = binning.kept_pair_mask(pairs, 300, TILES).numpy()
    ref = {k: np.zeros(out[k].shape, np.float32) for k in ("color", "alpha", "depth", "final_T")}
    for t in range(TILES):
        ty, tx = divmod(t, W // 16)
        sl = (slice(ty * 16, ty * 16 + 16), slice(tx * 16, tx * 16 + 16))
        r = jax_rasterize_reference(jproj._replace(valid=jnp.asarray(mask[:, t])),
                                    jnp.asarray(BG), H, W, tile_h=16, tile_w=16)
        for k in ref:
            ref[k][sl] = np.asarray(r[k])[sl]
    for k in ("color", "alpha", "final_T"):
        assert_images_match(out[k].numpy(), ref[k])
    np.testing.assert_allclose(out["depth"].numpy(), ref["depth"], atol=1e-4)
    # and the drops changed the image: the unbudgeted one differs
    full = rasterize_cuda(p, torch.as_tensor(BG), H, W)
    assert not torch.equal(full["color"], out["color"])


def test_budgets_that_do_not_bind_are_the_per_frame_list(scene):
    _, p = scene
    full = binning.bin_pairs(*port_args(p))
    b = budgeted(p, 64, 40000)
    n = full.num_pairs
    assert int(b.overflow) == 0 and int(b.tile_offsets[-1]) == n < b.num_pairs
    for f in ("pair_gaussian", "gaussian_pairs"):
        assert torch.equal(getattr(b, f)[:n], getattr(full, f)), f
    for f in ("tile_offsets", "tile_count", "gaussian_offsets"):
        assert torch.equal(getattr(b, f), getattr(full, f)), f
    bg = torch.as_tensor(BG)
    a, c = rasterize_cuda(p, bg, H, W), rasterize_cuda(p, bg, H, W, pair_budget=40000,
                                                       max_tiles_per_gaussian=64)
    for k in ("color", "depth", "alpha", "final_T"):
        assert torch.equal(a[k], c[k]), k


def test_shapes_depend_on_p_the_budgets_and_the_frame_alone():
    cam = make_camera(H, W)
    shapes = set()
    for seed, opacity_max in ((1, 0.95), (2, 0.3), (3, 0.95)):
        p = to_torch(jax_projected(np.random.default_rng(seed), cam, n=200,
                                   opacity_max=opacity_max))
        if seed == 3:
            p = p._replace(valid=torch.zeros_like(p.valid))  # nothing live
        pairs = binning.bin_pairs(*port_args(p), pair_budget=1000, max_tiles_per_gaussian=8)
        shapes.add(tuple(tuple(t.shape) for t in pairs))
    assert shapes == {((1024,), (TILES + 1,), (TILES,), (), (1024,), (201,))}


@pytest.mark.parametrize("P,hw,B", [(46080, (512, 512), 16), (300, (64, 64), 4),
                                    (2000, (45, 77), 10), (8, (512, 512), 16)])
def test_default_pair_budget_is_moss_tpus(P, hw, B):
    got = binning.default_pair_budget(P, *hw, 16, 16, max_tiles_per_gaussian=B)
    assert got == jbinning.default_pair_budget(P, *hw, 16, 16, groups=1,
                                               max_tiles_per_gaussian=B)
    assert binning.npb(P, 0, -(-hw[0] // 16) * -(-hw[1] // 16), B) == got
