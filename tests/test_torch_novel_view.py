"""The port's orbit cameras (moss_torch/render/novel_view.py) against
moss_tpu/render/novel_view.py, on the CPU.

The counterparts of tests/test_novel_view.py, whose oracle is the
reference's own code under /root/reference (absent here, which is why that
file fails); this one holds the port to moss_tpu instead:
  * both orbits' world-to-camera matrices bit for bit at that file's
    indices, and at other view counts;
  * every orbit camera rigid, its eye on the circle (radius 2 about
    (0, 0, -0.8) ZJU, 3 about (0, 0.8, 0) MonoCap), distinct views distinct;
  * novel_view_specs grafted onto the port's FrameSpecs as moss_tpu grafts
    onto its own, the full orbit spaced by camera_view_num;
  * a blob at each orbit's centre in view and roughly centred in every
    view, through the port's camera, projection and plain blend (the check
    of tests/test_novel_view.py:147-187).
"""
import numpy as np
import pytest
import torch

from moss_tpu.data.readers import FrameSpec as JFrameSpec
from moss_tpu.render import novel_view as jnv
from moss_torch.data.readers import FrameSpec
from moss_torch.ops import rasterize_cuda as rc
from moss_torch.ops.projection import preprocess
from moss_torch.ops.rasterize_ref import rasterize_reference
from moss_torch.ops.transforms import build_covariance
from moss_torch.render import novel_view as nv
from moss_torch.render.camera import Camera
from _torch_threads import two_torch_threads  # noqa: F401

ORBITS = {"zju": (nv.orbit_w2c_zju, jnv.orbit_w2c_zju),
          "monocap": (nv.orbit_w2c_monocap, jnv.orbit_w2c_monocap)}


@pytest.mark.parametrize("name,idx", [("zju", i) for i in (0, 1, 7, 17, 35)]
                         + [("monocap", i) for i in (0, 1, 9, 20, 35)])
def test_orbit_is_bitwise_moss_tpus(name, idx):
    port, ref = ORBITS[name]
    a, b = port(idx), ref(idx)
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["zju", "monocap"])
@pytest.mark.parametrize("n", [4, 40])
def test_orbit_at_other_view_counts_is_bitwise_moss_tpus(name, n):
    port, ref = ORBITS[name]
    for v in range(n):
        np.testing.assert_array_equal(port(v, n), ref(v, n))


@pytest.mark.parametrize("name", ["zju", "monocap"])
def test_orbit_is_rigid_and_fixed_radius(name):
    fn = ORBITS[name][0]
    center, radius = np.array(nv.ORBIT_CENTER[name]), {"zju": 2.0, "monocap": 3.0}[name]
    for idx in range(0, 36, 5):
        w2c = fn(idx)
        R, t = w2c[:3, :3], w2c[:3, 3]
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)
        assert abs(np.linalg.det(R) - 1.0) < 1e-5
        eye = -R.T @ t
        assert abs(np.linalg.norm(eye - center) - radius) < 1e-4
    views = [fn(i) for i in range(8)]
    assert all(np.abs(a - b).max() > 1e-3 for a, b in zip(views, views[1:]))


def _spec(cls, pose_id):
    return cls(image_path=f"img_{pose_id}.jpg", mask_path=f"msk_{pose_id}.png",
               K=np.diag([500.0, 500.0, 1.0]), D=np.zeros(5), R_w2c=np.eye(3),
               T_w2c=np.zeros((3, 1)),
               smpl_param={"poses": np.zeros((1, 72)), "shapes": np.zeros((1, 10)),
                           "R": np.eye(3, dtype=np.float32), "Th": np.zeros((1, 3), np.float32)},
               world_bound=np.array([[-1, -1, -1], [1, 1, 1]], np.float32), pose_id=pose_id,
               image_scaling=0.5, white_background=False)


@pytest.mark.parametrize("dataset", ["zju", "monocap"])
@pytest.mark.parametrize("n_views,view_num", [(4, 36), (4, 4), (40, 40)])
def test_novel_view_specs_graft_as_moss_tpus(dataset, n_views, view_num):
    """One spec per (pose, view), the pose's first spec with the orbit's R|T
    and D=None, in moss_tpu's order and bit for bit its matrices."""
    out = nv.novel_view_specs([_spec(FrameSpec, p) for p in (0, 0, 3)], dataset, n_views,
                              view_num)
    ref = jnv.novel_view_specs([_spec(JFrameSpec, p) for p in (0, 0, 3)], dataset, n_views,
                               view_num)
    assert len(out) == len(ref) == 2 * n_views
    for s, r in zip(out, ref):
        np.testing.assert_array_equal(s.R_w2c, r.R_w2c)
        np.testing.assert_array_equal(s.T_w2c, r.T_w2c)
        assert s.R_w2c.dtype == np.float64 and s.D is None and s.K[0, 0] == 500.0
        assert (s.pose_id, s.image_path) == (r.pose_id, r.image_path)
    assert [s.pose_id for s in out] == [0] * n_views + [3] * n_views


def test_full_orbit_spacing_follows_the_view_count():
    """N views over the whole orbit with camera_view_num = N: view v of 4 is
    view 9v of 36; with the divisor left at 36, view 36 of 40 repeats view 0."""
    specs = [_spec(FrameSpec, 0)]
    four = nv.novel_view_specs(specs, "zju", 4, 4)
    for v in range(4):
        np.testing.assert_allclose(four[v].R_w2c, nv.orbit_w2c_zju(9 * v, 36)[:3, :3], atol=1e-5)
    dup = nv.novel_view_specs(specs, "zju", 40, 36)
    np.testing.assert_array_equal(dup[36].R_w2c, dup[0].R_w2c)
    full = nv.novel_view_specs(specs, "zju", 40, 40)
    assert all(np.abs(full[v].R_w2c - full[0].R_w2c).max() > 1e-4 for v in range(1, 40))


@pytest.mark.parametrize("name", ["zju", "monocap"])
def test_orbit_cameras_see_the_subject(name):
    """A blob parked at the orbit's centre: alpha above 0.5 somewhere and the
    blob within a quarter of the frame of its centre in every view tried."""
    fn = ORBITS[name][0]
    rng = np.random.default_rng(2)
    H = W = 64
    K = np.array([[70.0, 0, W / 2], [0, 70.0, H / 2], [0, 0, 1.0]])
    n = 80
    pts = torch.tensor((rng.normal(0, 0.12, (n, 3)) + nv.ORBIT_CENTER[name]).astype(np.float32))
    cov3d = build_covariance(torch.full((n, 3), 0.05),
                             torch.tensor(rng.normal(size=(n, 4)).astype(np.float32)))
    for idx in (0, 9, 23):
        w2c = fn(idx)
        # FrameSpec.make_camera passes R transposed (readers.py), as the reference stores it
        cam = Camera.from_KRT(K, w2c[:3, :3].T, w2c[:3, 3], H, W, device="cpu")
        proj = preprocess(pts, cov3d, torch.zeros((n, 3)), torch.full((n,), 0.9), cam)
        alpha = rasterize_reference(proj, torch.zeros(3), H, W, tile_h=rc.TILE,
                                    tile_w=rc.TILE)["alpha"].numpy()
        assert alpha.max() > 0.5, (name, idx, "subject not visible")
        ys, xs = np.nonzero(alpha > 0.1)
        assert abs(ys.mean() - H / 2) < H * 0.25 and abs(xs.mean() - W / 2) < W * 0.25, (
            name, idx, ys.mean(), xs.mean())
