"""A cell's files at a size the CPU tests can hold: 64 x 64 frames, a
300-vertex rig, 1,024 Gaussian slots, four frames."""
from __future__ import annotations

import copy

from benchmark.inputs import load_json


def small(cell: str):
    """(config, workload) of `cell` cut to the CPU's size."""
    w = copy.deepcopy(load_json("workloads", cell))
    c = copy.deepcopy(load_json("configs", w["config"]))
    c["raw_size"], c["image_scaling"], c["train_frames"] = 64, 1.0, 4
    c["smpl"]["n_verts"] = 300
    c["model"]["capacity"] = 1024
    c["crop_hw"] = [48, 32]
    c["camera"]["focal"] = 1.2
    w["cloud"]["live"] = 500
    w["state_iteration"] -= 1900
    w["run_iterations"] = 1000
    return c, w
