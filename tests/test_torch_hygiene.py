"""moss_torch stands alone: no jax, no moss_tpu, and no silent CPU fallback."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import moss_torch
from moss_torch import convert
from moss_torch.data import synthetic
from moss_torch.models import gaussians, smpl
from moss_torch.config import Config
from moss_torch.ops import lpips, rasterize_cuda as rc
from moss_torch.ops.projection import Projected
from moss_torch.render.camera import Camera
from moss_torch.render.render import render_frame
from moss_torch.tools import bwd_kernel_floor, conv_proto, mxu_micro, sort_micro
from moss_torch.train.train_step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
before = set(sys.modules)
import moss_torch
names = [m.name for m in pkgutil.walk_packages(moss_torch.__path__, "moss_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in set(sys.modules) - before
                if m.split(".")[0] in ("jax", "jaxlib", "moss_tpu"))
print(len(names), leaked)
sys.exit(1 if leaked or len(names) < 15 else 0)
"""


def test_imports_neither_jax_nor_moss_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _entry_points():
    pts = np.zeros((4, 3), np.float32)
    K = np.diag([50.0, 50.0, 1.0])
    return {
        "make_scene": lambda: synthetic.make_scene(n_verts=50),
        "make_camera": lambda: synthetic.make_camera(32, 32),
        "synthetic_smpl": lambda: smpl.synthetic_smpl(n_verts=50),
        "big_pose_params": lambda: smpl.big_pose_params(),
        "Camera.from_KRT": lambda: Camera.from_KRT(K, np.eye(3), np.zeros(3), 32, 32),
        "create_from_points": lambda: gaussians.create_from_points(pts, pts, 8),
        "gaussians_from_jax": lambda: convert.gaussians_from_jax({}),
        "mlps_from_jax": lambda: convert.mlps_from_jax({}),
        "scene_from_jax": lambda: convert.scene_from_jax({}, {}, pts),
        "load_jax_checkpoint": lambda: convert.load_jax_checkpoint("missing.npz"),
        "render_frame": lambda: render_frame(None, None, None, None, None, None, None, 3),
        "train_state_from_jax": lambda: convert.train_state_from_jax(None),
        "frame_from_jax": lambda: convert.frame_from_jax(None),
        "lpips.init_random": lambda: lpips.init_random(),
        "lpips.load_params": lambda: lpips.load_params("missing.npz"),
        "make_train_step": lambda: make_train_step(None, Config(), None, None, 8, 8),
        "bench_scene": lambda: synthetic.bench_scene(H=32, P=8),
        "tools.sort_micro.main": lambda: sort_micro.main(),
        "tools.conv_proto.main": lambda: conv_proto.main(),
        "tools.bwd_kernel_floor.main": lambda: bwd_kernel_floor.main(),
        "tools.mxu_micro.main": lambda: mxu_micro.main(),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_point_without_device_raises_on_a_cpu_only_machine(name):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour where no CUDA device exists")
    with pytest.raises(RuntimeError, match="CUDA device"):
        _entry_points()[name]()


def test_resolve_device_honours_an_explicit_cpu():
    assert moss_torch.resolve_device("cpu") == torch.device("cpu")


def test_rasterize_cuda_on_cpu_tensors_takes_the_plain_version():
    n = 3
    proj = Projected(
        mean2d=torch.tensor([[8.0, 8.0], [20.0, 9.0], [5.0, 25.0]]),
        depth=torch.tensor([2.0, 1.0, 3.0]),
        conic=torch.tensor([[0.2, 0.0, 0.2]] * n),
        radius=torch.tensor([7, 7, 7], dtype=torch.int32),
        color=torch.rand(n, 3, generator=torch.Generator().manual_seed(0)),
        opacity=torch.tensor([0.8, 0.5, 0.9]),
        valid=torch.ones(n, dtype=torch.bool),
        radius_xy=torch.tensor([[7, 7]] * n, dtype=torch.int32),
    )
    before = rc.launches
    out = rc.rasterize_cuda(proj, torch.zeros(3), 32, 32)
    ref = rc.rasterize_reference(proj, torch.zeros(3), 32, 32, tile_h=rc.TILE, tile_w=rc.TILE)
    assert rc.launches == before
    for key in ("color", "depth", "alpha", "final_T"):
        assert torch.equal(out[key], ref[key])
    assert float(out["alpha"].max()) > 0.5
    with pytest.raises(ValueError, match="CUDA device"):
        rc.rasterize_pairs(rc.bin_projected(proj, 32, 32), proj, 32, 32)

