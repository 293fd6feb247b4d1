"""moss_tpu's queued Trainer runs on the SMPL-X and static scene families, and
the port's Trainer set up to be held to them: shared by test_torch_smplx.py,
test_torch_colmap.py and test_torch_family_engines.py, so that a module runs
moss_tpu once a world, whatever it runs of the port.

  * dna_world: moss_tpu's DNA-Rendering reader on a written capture
    (tests/test_smplx_dna.py's, extended to 3 frames) with a 500-vertex
    SMPL-X asset (J=55): the scene and 3 train frames (view 26) at a 48x48
    crop, in both packages' forms (h5py and cv2 needed);
  * static_world: moss_tpu's static fixture (tests/test_static_scene.py) at
    48x64, four frames of a known 160-Gaussian cloud rendered over a black
    or a white background, the training starting from its positions;
  * jax_run: moss_tpu's Trainer on a world over SCHEDULE (24 iterations,
    rounds at 8 and 16, the opacity reset at 12, and at densify_from_iter 5
    on a white background; evals at 1, 12, 24), once a world in a process
    (start_jax_run queues it on a thread, so that the port's runs go on
    meanwhile): its state before training, l1 by iteration, each round's
    live count;
  * port_trainer: the port's Trainer on the same world, started by set_state
    from that state (a fresh copy each call: the port trains in place), with
    moss_tpu's densify noise; densify.pca_normals is moss_tpu's inside
    jax_normals_patched (the eigensolver's sign, ROADMAP Q3).
"""
import functools
import queue
import threading
from typing import Dict, List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from moss_tpu.config import Config as JConfig
from moss_tpu.config import ModelConfig as JModelConfig
from moss_tpu.config import OptimConfig as JOptimConfig
from moss_tpu.config import PipelineConfig as JPipelineConfig
from moss_tpu.ops import lpips_jax
from moss_tpu.train.trainer import Trainer as JTrainer
from moss_torch import convert
from moss_torch.data import colmap as C
from moss_torch.train import densify as D
from moss_torch.train.trainer import Trainer
from test_torch_densify import jax_densify_noise
from test_torch_trainer import jax_pca_normals

CPU = "cpu"
CAPACITY = 512
SCHEDULE = dict(iterations=24, densify_from_iter=5, densify_until_iter=20,
                densification_interval=8, opacity_reset_interval=12)
EVALS = (1, 12, 24)
SMPLX_CROP = (48, 48)
STATIC_CROP = (32, 32)
STATIC_EXTENT = 2.0
STATIC_POINTS = 160


# ---- SMPL-X on DNA-Rendering frames ------------------------------------------------

def write_smplx_npz(path, jmodel, seed=5):
    """A 400-column SMPL-X asset holding jmodel's arrays: its betas in
    columns [:10], its expressions in [300:310], noise elsewhere."""
    rng = np.random.default_rng(seed)
    sd = np.asarray(jmodel.shapedirs)
    full = rng.normal(0, 0.5, sd.shape[:2] + (400,)).astype(np.float32)
    full[..., :10], full[..., 300:310] = sd[..., :10], sd[..., 10:]
    parents = np.array(jmodel.parents, np.int64)
    np.savez(path, v_template=np.asarray(jmodel.v_template), shapedirs=full,
             posedirs=np.asarray(jmodel.posedirs), J_regressor=np.asarray(jmodel.J_regressor),
             weights=np.asarray(jmodel.weights), f=np.asarray(jmodel.faces).astype(np.uint32),
             kintree_table=np.stack([parents, np.arange(55)]))
    return path


def write_dna_capture(root, n_frames=3, H=128, W=128, views=(24, 25, 26, 27, 28)):
    """tests/test_smplx_dna.py's capture pair, its colour frames and masks
    extended from frame 0 to n_frames (each frame its own JPEG and mask), so
    that every pose of the SMPL-X block can be decoded."""
    import cv2
    import h5py
    from test_smplx_dna import _write_smc_fixture

    main = _write_smc_fixture(root, n_frames=n_frames, H=H, W=W, views=views)
    annot = main.replace("main", "annotations").split(".")[0] + "_annots.smc"
    rng = np.random.default_rng(11)
    with h5py.File(main, "a") as fm, h5py.File(annot, "a") as fa:
        for i in range(1, n_frames):
            img = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
            msk = np.zeros((H, W, 3), np.uint8)
            msk[H // 8 + i: H - H // 8, W // 8: W - W // 8 - i] = 255
            jpg, png = cv2.imencode(".jpg", img)[1], cv2.imencode(".png", msk)[1]
            for v in views:
                fm[f"Camera_5mp/{v}/color"].create_dataset(
                    str(i), data=np.frombuffer(jpg.tobytes(), np.uint8))
                fa[f"Mask/{v}/mask"].create_dataset(
                    str(i), data=np.frombuffer(png.tobytes(), np.uint8))
    return main


def smplx_jax_cfg(**optim):
    return JConfig(model=JModelConfig(sh_degree=1, capacity=CAPACITY, n_init_points=400,
                                      smpl_type="smplx", motion_offset=False),
                   optim=JOptimConfig(**optim),
                   pipe=JPipelineConfig(rasterizer="reference", test_iterations=EVALS,
                                        save_iterations=()))


class World(NamedTuple):
    """One family's inputs in both packages' forms. jscene / scene: the
    SceneContexts; jframes / frames: all frames, the first n_train training
    ones and the rest the test split; jcfg: moss_tpu's config."""

    name: str
    jscene: object
    jframes: list
    scene: object
    frames: list
    jcfg: JConfig
    n_train: int
    crop: Tuple[int, int]
    extent: float


def dna_world(root, jmodel) -> World:
    """moss_tpu's reader on the DNA capture (128x128, 48x48 frames) with the
    500-vertex SMPL-X asset: its scene and 3 train frames (view 26); the
    test split is the first of them, as test_trainer_at_j55_matches_moss_tpu
    takes it."""
    pytest.importorskip("cv2")
    pytest.importorskip("h5py")
    from moss_tpu.data.dna import read_dna_rendering

    asset = write_smplx_npz(f"{root}/SMPLX_NEUTRAL.npz", jmodel)
    main = write_dna_capture(str(root))
    jscene, specs = read_dna_rendering(main, split="train", smplx_path=asset)
    jframes = [s.load(SMPLX_CROP) for s in specs]
    scene = convert.scene_from_jax(jscene.smpl, jscene.big_pose_params,
                                   jscene.big_pose_vertices, device=CPU)
    frames = [convert.frame_from_jax(f, CPU) for f in jframes]
    return World("smplx", jscene, jframes + jframes[:1], scene, frames + frames[:1],
                 smplx_jax_cfg(**SCHEDULE), len(jframes), SMPLX_CROP, 1.0)


# ---- the static scene ----------------------------------------------------------------

def static_points():
    rng = np.random.default_rng(7)
    n = STATIC_POINTS
    return (rng.normal(0.0, 0.25, (n, 3)).astype(np.float32),
            rng.uniform(0.2, 0.9, (n, 3)).astype(np.float32),
            rng.uniform(0.02, 0.05, (n, 3)).astype(np.float32),
            rng.normal(size=(n, 4)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def static_world(white: bool = False) -> World:
    """moss_tpu's static fixture (tests/test_static_scene.py) at 48x64: four
    frames of a known 160-Gaussian cloud over the background (black, or
    white with white_background set), three to train on and one to test;
    the training starts from its positions with random colours."""
    from moss_tpu.data import colmap as JC
    from moss_tpu.data.synthetic import make_camera as jax_make_camera
    from moss_tpu.ops import transforms as tf
    from moss_tpu.ops.projection import preprocess
    from moss_tpu.ops.rasterize_ref import rasterize_reference
    from test_static_scene import _static_frame

    pts, colors, scales, quats = static_points()
    n = pts.shape[0]
    cov3d = tf.build_covariance(jnp.asarray(scales), jnp.asarray(quats))
    bg = jnp.full(3, 1.0 if white else 0.0)
    jframes = []
    for ang in (0.0, 0.35, -0.35, 0.7):
        cam = jax_make_camera(H=48, W=64, dist=2.0, angle=ang)
        proj = preprocess(jnp.asarray(pts), cov3d, jnp.asarray(colors), jnp.full((n,), 0.85),
                          cam)
        out = rasterize_reference(proj, bg, cam.height, cam.width)
        jframes.append(_static_frame(cam, np.asarray(out["color"])))
    jcfg = JConfig(
        model=JModelConfig(sh_degree=1, capacity=CAPACITY, n_init_points=n, motion_offset=False,
                           static_scene=True, white_background=white),
        optim=JOptimConfig(w_mask=0.0, w_nll=0.0, w_lpips=0.0, w_s3im=0.0,
                           densify_grad_threshold=1e-5, **SCHEDULE),
        pipe=JPipelineConfig(rasterizer="reference", test_iterations=EVALS,
                             save_iterations=()))
    return World("static_white" if white else "static", JC.static_scene_context(pts), jframes,
                 C.static_scene_context(pts, device=CPU),
                 [convert.frame_from_jax(f, CPU) for f in jframes], jcfg, 3, STATIC_CROP,
                 STATIC_EXTENT)


# ---- the runs -------------------------------------------------------------------------

class JaxRun(NamedTuple):
    """moss_tpu's queued run on a world: its Trainer after the run, its
    state before it, l1 by iteration and (iteration, live count) a round."""

    jtr: JTrainer
    ts0: object
    l1: Dict[int, float]
    counts: List[Tuple[int, int]]


class _Pending(NamedTuple):
    world: World             # kept, so that its id stays its
    ready: threading.Event   # its Trainer is built: out[0] is its JaxRun
    done: threading.Event    # its training has ended
    out: list                # [JaxRun], then the exception the thread raised, if any


_RUNS: Dict[int, _Pending] = {}
_QUEUE: "queue.Queue[_Pending]" = queue.Queue()


def _moss_tpu_runs():
    """The thread that builds and trains the queued worlds, one at a time."""
    while True:
        pending = _QUEUE.get()
        world, out = pending.world, pending.out
        try:
            l1, counts = {}, []
            jtr = JTrainer(world.jscene, world.jframes[:world.n_train],
                           world.jframes[world.n_train:], world.jcfg, crop_hw=world.crop,
                           extent=world.extent,
                           log_fn=lambda it, logs: l1.__setitem__(it, float(logs["l1"])))
            out.append(JaxRun(jtr, jtr.ts, l1, counts))
            pending.ready.set()
            densify = jtr.densify
            jtr.densify = lambda it: counts.append((it, int(densify(it)["count_after"]))) or None
            jtr.train(world.jcfg.optim.iterations)
            del jtr.densify
        except BaseException as e:  # raised again by jax_started and jax_run
            out.append(e)
        finally:
            pending.ready.set()
            pending.done.set()


def start_jax_run(world: World) -> None:
    """Queue moss_tpu's Trainer on the world, built and trained over the
    world's schedule under its default (queued) engine on a thread of its
    own, once a world in this process, in the order they are started: the
    port's runs go on meanwhile."""
    if id(world) not in _RUNS:
        if not any(t.name == "moss_tpu_runs" for t in threading.enumerate()):
            threading.Thread(target=_moss_tpu_runs, name="moss_tpu_runs", daemon=True).start()
        _RUNS[id(world)] = _Pending(world, threading.Event(), threading.Event(), [])
        _QUEUE.put(_RUNS[id(world)])


def _wait(world: World, event: str) -> JaxRun:
    start_jax_run(world)
    pending = _RUNS[id(world)]
    getattr(pending, event).wait()
    errors = [x for x in pending.out if isinstance(x, BaseException)]
    if errors:
        raise errors[0]
    return pending.out[0]


def jax_started(world: World) -> JaxRun:
    """The world's moss_tpu run once its Trainer is built: its ts0 and key
    (the densify noise); l1, counts and jtr.ts fill in as it trains."""
    return _wait(world, "ready")


def jax_run(world: World) -> JaxRun:
    """The world's moss_tpu run, ended."""
    return _wait(world, "done")


def port_trainer(world: World, run: JaxRun, log_fn=None, start: bool = True) -> Trainer:
    """The port's Trainer on the world (the default LPIPS weights, as
    moss_tpu's), started (start_from) unless start is False."""
    tr = Trainer(world.scene, world.frames[:world.n_train], world.frames[world.n_train:],
                 convert.config_from_jax(world.jcfg),
                 convert.lpips_params_from_jax(lpips_jax.get_default_params(), CPU),
                 crop_hw=world.crop, extent=world.extent, log_fn=log_fn, device=CPU)
    return start_from(tr, run) if start else tr


def start_from(tr: Trainer, run: JaxRun) -> Trainer:
    """tr set to a fresh copy of run's initial state, with moss_tpu's densify
    noise of each round."""
    tr.set_state(convert.train_state_from_jax(run.ts0, CPU))
    P, static = tr.cfg.model.capacity, tr.cfg.model.static_scene
    tr.densify_noise = lambda it: torch.as_tensor(jax_densify_noise(
        jax.random.fold_in(run.jtr.key, it), P, static=static))
    return tr


def jax_normals_patched(monkeypatch):
    """densify.pca_normals as moss_tpu's for the rest of the monkeypatch."""
    monkeypatch.setattr(D, "pca_normals", jax_pca_normals)
