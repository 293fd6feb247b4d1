"""Frame: everything the training step needs for one camera view.

Port of moss_tpu/data/frames.py:20-38, with the same fields; a static
(COLMAP/Blender) frame carries all-ones masks and zero SMPL fields. The crop
window's top-left and the pose id are plain ints here: the port crops with
Python slices, so they never wait on the device.
"""
from __future__ import annotations

import dataclasses

import torch

from ..render.camera import Camera


@dataclasses.dataclass(frozen=True)
class Frame:
    camera: Camera
    image: torch.Tensor         # (H, W, 3) f32 in [0, 1]
    bkgd_mask: torch.Tensor     # (H, W) f32 soft foreground mask
    bound_mask: torch.Tensor    # (H, W) f32 0/1 bound region
    poses: torch.Tensor         # (1, 3 J) axis-angle pose: (1, 72) SMPL, (1, 165) SMPL-X
    shapes: torch.Tensor        # (1, 10) SMPL betas; (1, 20) SMPL-X betas ++ expression
    R: torch.Tensor             # (3, 3) global rotation
    Th: torch.Tensor            # (1, 3) global translation
    pose_rotmats: torch.Tensor  # (J - 1, 3, 3) target rotations for the Fisher NLL
    #                             (read only by the 23-joint pose MLPs' loss)
    crop_y0: int                # fixed-size crop window top-left
    crop_x0: int
    pose_id: int

    @property
    def smpl_params(self):
        return {"poses": self.poses, "shapes": self.shapes, "R": self.R, "Th": self.Th}
