"""The configuration fields the render path, the training step, densification,
the trainer and the drivers read.

The port's own copies of moss_tpu/config.py (ModelConfig, OptimConfig,
PipelineConfig, Config, the presets and the JSON round trip), with the same
defaults. PipelineConfig keeps moss_tpu's rect cap, max_tiles_per_gaussian:
the trainer's static pair budgets start from it (ops/binning.py,
train/trainer.py), and its rasterizer: "cuda" (moss_tpu's "pallas"), the
blend kernels with the static budgets, or "reference", the plain blend
(ops/rasterize_ref.py) with no budgets, on any device, as the user's
explicit choice (train/trainer.py). A cfg.json keeps moss_tpu's words:
save_json writes "pallas" for "cuda", load_json reads either, so each
package loads the other's file.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    sh_degree: int = 3
    smpl_type: str = "smpl"      # 'smpl' | 'smplx' (DNA-Rendering, J=55, motion_offset=False)
    actor_gender: str = "neutral"
    motion_offset: bool = True   # pose-correction MLPs + LBS-weight field
    static_scene: bool = False   # vanilla 3DGS: no body model, no deform
    white_background: bool = False
    # the reference caps densification at 45,695 points; rounded up to a
    # lane-aligned 46,080 (the north-star capacity, bench.py:90-91)
    capacity: int = 46080
    n_init_points: int = 6890   # the SMPL vertex count


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    iterations: int = 3000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    pose_refine_lr: float = 0.00025     # 'auto_regression' group
    lbs_field_lr: float = 0.0001        # 'cross_attention_lbs' group
    adam_eps: float = 1e-15             # AdamW eps (the reference's gaussian_model.py:226)
    weight_decay: float = 0.01          # torch AdamW default

    percent_dense: float = 0.01
    densification_interval: int = 100
    opacity_reset_interval: int = 4000
    densify_from_iter: int = 400
    densify_until_iter: int = 2000
    densify_grad_threshold: float = 0.0002
    min_opacity: float = 0.005
    kl_threshold: float = 0.4
    kl_merge_threshold: float = 0.1
    max_screen_size: int = 20
    # prune-by-SMPL-distance threshold in meters, euclidean (a 5 cm shell):
    # train/densify.py compares sqrt(d2) against it
    smpl_dist_threshold: float = 0.05

    # loss weights (the reference's train_ZJU.py:131)
    w_l1: float = 1.0
    w_mask: float = 0.5
    w_ssim: float = 0.2
    w_lpips: float = 0.5
    w_nll: float = 0.06
    w_s3im: float = 0.3


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    # the initial rect cap: the tiles one Gaussian may take before the rest
    # are counted as overflow; the trainer's first probe may lower it and the
    # self-heal raise it (moss_tpu/config.py:81-87)
    max_tiles_per_gaussian: int = 16
    rasterizer: str = "cuda"     # 'cuda' (moss_tpu's 'pallas') | 'reference'
    # evals and saves fire independently (Trainer.train eval_iters / save_iters)
    test_iterations: Tuple[int, ...] = (2500, 2700, 3000)
    save_iterations: Tuple[int, ...] = (2500, 2700, 3000)


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    optim: OptimConfig = OptimConfig()
    pipe: PipelineConfig = PipelineConfig()
    seed: int = 3407   # frame order, initial colours, MLP init, densify noise
    source_path: str = ""
    model_path: str = "output/default"
    exp_name: str = "default"


RASTERIZERS = ("cuda", "reference")
# the rasterizer as a cfg.json spells it (moss_tpu's words), and as load_json reads it
RASTERIZER_IN_JSON = {"cuda": "pallas", "reference": "reference"}
RASTERIZER_FROM_JSON = {"pallas": "cuda", "cuda": "cuda", "reference": "reference"}


def zju_preset(subject: str = "377") -> Config:
    return dataclasses.replace(Config(), exp_name=f"zju_mocap_refine/my_{subject}")


def monocap_preset(seq: str = "olek_images0812") -> Config:
    return dataclasses.replace(Config(), exp_name=f"monocap/{seq}")


def save_json(cfg: Config, path: str) -> None:
    """The experiment config as JSON (moss_tpu's cfg.json layout, the
    rasterizer in its words), which the render drivers read back with
    load_json."""
    raw = dataclasses.asdict(cfg)
    raw["pipe"]["rasterizer"] = RASTERIZER_IN_JSON[cfg.pipe.rasterizer]
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(raw, f, indent=2)


def load_json(path: str) -> Config:
    """A Config from save_json's output, the port's or moss_tpu's: the
    rasterizer "pallas" read as "cuda"; an unknown key or rasterizer is
    rejected."""
    with open(path) as f:
        raw = json.load(f)
    sections = {name: dict(raw.get(name, {})) for name in ("model", "optim", "pipe")}
    pipe = sections["pipe"]
    if "rasterizer" in pipe:
        if pipe["rasterizer"] not in RASTERIZER_FROM_JSON:
            raise ValueError(f"{path}: unknown rasterizer {pipe['rasterizer']!r}")
        pipe["rasterizer"] = RASTERIZER_FROM_JSON[pipe["rasterizer"]]
    for k in ("test_iterations", "save_iterations"):
        if k in pipe:
            pipe[k] = tuple(pipe[k])
    return Config(
        model=ModelConfig(**sections["model"]),
        optim=OptimConfig(**sections["optim"]),
        pipe=PipelineConfig(**pipe),
        **{k: v for k, v in raw.items() if k not in ("model", "optim", "pipe")},
    )
