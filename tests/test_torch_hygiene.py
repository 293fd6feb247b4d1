"""moss_torch stands alone: no jax, no moss_tpu, and no silent CPU fallback.

Every module, the drivers under moss_torch/cli/ included, imports neither jax
nor moss_tpu (parallel/, render/novel_view.py and train/network_gui.py, whose
moss_tpu counterparts import no jax, by their source too); cv2 and imageio
only in the readers (data/readers.py, smc.py, dna.py, colmap.py) and the
drivers; the readers import h5py and imageio only inside functions, so they
import on a machine without them; tensorboardX only inside
train/observability.py's TBWriter; every entry point, the slice's loaders,
the drivers without --device, global_mesh without a device and
Trainer(mesh=...) among them, raises where there is no CUDA device.
"""
import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import moss_torch
from moss_torch import convert
from moss_torch.data import synthetic
from moss_torch.models import gaussians, smpl
from moss_torch.cli import render_monocap, render_zju, train_monocap, train_zju
from moss_torch.config import Config
from moss_torch.data import colmap, dna, readers
from moss_torch.ops import lpips, rasterize_cuda as rc
from moss_torch.ops.projection import Projected
from moss_torch.parallel import distributed
from moss_torch.render.camera import Camera
from moss_torch.render.render import render_frame
from moss_torch.tools import bwd_kernel_floor, conv_proto, mxu_micro, sort_micro
from moss_torch.train import checkpoint
from moss_torch.train.train_step import make_train_step
from moss_torch.train.trainer import Trainer, init_gaussians_and_mlps
from _torch_threads import two_torch_threads  # noqa: F401

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
missing = {"moss_torch.cli.train_zju", "moss_torch.cli.render_zju",
           "moss_torch.cli.render_monocap", "moss_torch.data.readers",
           "moss_torch.data.prefetch", "moss_torch.data.ply",
           "moss_torch.train.checkpoint", "moss_torch.train.observability",
           "moss_torch.data.smc", "moss_torch.data.dna", "moss_torch.data.colmap",
           "moss_torch.cli.train_monocap", "moss_torch.parallel.distributed",
           "moss_torch.parallel.sharded", "moss_torch.render.novel_view",
           "moss_torch.train.network_gui"} - set(names)
print(len(names), leaked, missing)
sys.exit(1 if leaked or missing or len(names) < 15 else 0)
"""


def test_imports_neither_jax_nor_moss_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# the host-side image libraries, allowed only where frames are decoded or written
IMAGE_IO = re.compile(r"^\s*(import|from)\s+(cv2|imageio)\b", re.M)
IMAGE_IO_ALLOWED = {"data/readers.py", "data/smc.py", "data/dna.py", "data/colmap.py",
                    "cli/train_zju.py", "cli/render_zju.py", "cli/render_monocap.py"}
# h5py and imageio at a module's top level (an import inside a function is indented)
TOP_LEVEL_H5PY_IMAGEIO = re.compile(r"^(import|from)\s+(h5py|imageio)\b", re.M)


def test_cv2_and_imageio_only_in_the_readers_and_drivers():
    root = os.path.join(REPO, "moss_torch")
    users = {os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*.py"),
                                                         recursive=True)
             if IMAGE_IO.search(open(p).read())}
    assert users and users <= IMAGE_IO_ALLOWED, users


def test_the_readers_import_h5py_and_imageio_inside_functions_only():
    """The card's machine may lack h5py and has no imageio: the readers and
    the modules that import them must still import there."""
    data = os.path.join(REPO, "moss_torch", "data")
    for name in ("readers.py", "smc.py", "dna.py", "colmap.py", "prefetch.py"):
        src = open(os.path.join(data, name)).read()
        assert not TOP_LEVEL_H5PY_IMAGEIO.search(src), name
    assert "import h5py" in open(os.path.join(data, "smc.py")).read()
    assert "import imageio" in open(os.path.join(data, "colmap.py")).read()


JAX_OR_MOSS_TPU = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|moss_tpu)\b|\bmoss_tpu\.", re.M)


@pytest.mark.parametrize("rel", ["parallel/__init__.py", "parallel/distributed.py",
                                 "parallel/sharded.py", "render/novel_view.py",
                                 "train/network_gui.py", "cli/train_monocap.py"])
def test_the_slice_modules_name_neither_jax_nor_moss_tpu(rel):
    src = open(os.path.join(REPO, "moss_torch", rel)).read()
    assert not JAX_OR_MOSS_TPU.search(src), rel


def test_tensorboardx_only_inside_observability():
    root = os.path.join(REPO, "moss_torch")
    users = {os.path.relpath(p, root) for p in glob.glob(os.path.join(root, "**", "*.py"),
                                                         recursive=True)
             if re.search(r"^\s*(import|from)\s+tensorboardX\b", open(p).read(), re.M)}
    assert users == {"train/observability.py"}
    src = open(os.path.join(root, "train", "observability.py")).read()
    assert not re.search(r"^(import|from)\s+tensorboardX\b", src, re.M)  # inside a function


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
        "Trainer": lambda: Trainer(None, [], [], Config(), None),
        "init_gaussians_and_mlps": lambda: init_gaussians_and_mlps(None, Config()),
        "bench_scene": lambda: synthetic.bench_scene(H=32, P=8),
        "tools.sort_micro.main": lambda: sort_micro.main(),
        "tools.conv_proto.main": lambda: conv_proto.main(),
        "tools.bwd_kernel_floor.main": lambda: bwd_kernel_floor.main(),
        "tools.mxu_micro.main": lambda: mxu_micro.main(),
        "checkpoint.restore_checkpoint (Trainer.load)":
            lambda: checkpoint.restore_checkpoint("missing.npz"),
        "checkpoint.load_params": lambda: checkpoint.load_params("missing.npz"),
        "checkpoint.convert_torch_mlp_state":
            lambda: checkpoint.convert_torch_mlp_state({}, {}),
        "smpl.load_smpl_pickle": lambda: smpl.load_smpl_pickle("missing.pkl"),
        "smpl.synthetic_smplx": lambda: smpl.synthetic_smplx(n_verts=50),
        "smpl.big_pose_params_smplx": lambda: smpl.big_pose_params_smplx(),
        "smpl.load_smplx_npz": lambda: smpl.load_smplx_npz("missing.npz"),
        "dna.read_dna_rendering": lambda: dna.read_dna_rendering("missing_main.smc"),
        "dna.DNAFrameSpec.load": lambda: dna.DNAFrameSpec(
            "missing_main.smc", "missing_annots.smc", 26, 0, 0.5, False, {},
            np.zeros((2, 3))).load(),
        "readers.detect_and_read (.smc)": lambda: readers.detect_and_read("missing_main.smc"),
        "colmap.static_scene_context": lambda: colmap.static_scene_context(pts),
        "colmap.frame_from_spec": lambda: colmap.frame_from_spec(
            {"image_path": "missing.png", "R_w2c": np.eye(3), "T_w2c": np.zeros((3, 1)),
             "fovx": 0.8}),
        "readers.read_zju_mocap_refine": lambda: readers.read_zju_mocap_refine("missing"),
        "readers.read_monocap": lambda: readers.read_monocap("missing"),
        "readers.FrameSpec.load": lambda: readers.FrameSpec(
            "missing.jpg", "missing.png", K, None, np.eye(3), np.zeros((3, 1)), {},
            np.zeros((2, 3)), 0, 1.0, False).load(),
        "cli.train_zju.main": lambda: train_zju.main(["--data_root", "missing"]),
        "cli.render_zju.main": lambda: render_zju.main(["--data_root", "missing"]),
        "cli.render_monocap.main": lambda: render_monocap.main(["--data_root", "missing"]),
        "cli.train_monocap.main": lambda: train_monocap.main(["--data_root", "missing"]),
        "cli.render_zju.main --novel_view": lambda: render_zju.main(
            ["--data_root", "missing", "--novel_view", "4"]),
        "distributed.global_mesh": lambda: distributed.global_mesh(),
        "distributed.make_mesh": lambda: distributed.make_mesh(1, 1),
        "Trainer(mesh=...)": lambda: Trainer(None, [], [], Config(), None, mesh=distributed.Mesh(
            1, 1, 0, 0, 0, None, None, None)),
        "Camera.from_viewer_spec": lambda: Camera.from_viewer_spec({}),
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

