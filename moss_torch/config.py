"""The model configuration fields the render path reads.

The port's own copy of moss_tpu/config.py:15-31 (ModelConfig), reduced to the
fields serving reads. The JAX pipeline's rect cap
(PipelineConfig.max_tiles_per_gaussian) has no counterpart: the port sizes
its pair buffers per frame from the live pair count (ops/binning.py), so no
Gaussian is ever capped.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    sh_degree: int = 3
    motion_offset: bool = True   # pose-correction MLPs + LBS-weight field
    static_scene: bool = False   # vanilla 3DGS: no body model, no deform
    # the reference caps densification at 45,695 points; rounded up to a
    # lane-aligned 46,080 (the north-star capacity, bench.py:90-91)
    capacity: int = 46080
