"""DNA-Rendering reader, the SMPL-X path (port of moss_tpu/data/dna.py).

The reference's readCamerasDNARendering (dataset_readers.py:744-994): frames
come from a capture pair, <x>_main.smc (the 5-megapixel colour frames) and
<x>_annotations_annots.smc (calibration, masks, the per-frame SMPL-X block),
read through data/smc.SMCReader. The body is SMPL-X: 55 joints, a (1, 165)
full pose, (1, 20) shapes (betas ++ expression), R = I and Th = transl, so
the cloud and the bounds live in world coordinates. Splits: train view [26]
over 100 poses at stride 1, test views [24, 25, 27, 28] over 20 poses at
stride 5, clamped to the capture's length; frames at 0.5x.

DNAFrameSpec.load decodes one frame on the host with cv2, as moss_tpu's does
(BGR -> RGB, undistort, background fill, INTER_AREA resize with K scaled,
the bound mask, the crop window's origin, the 54 target rotations), and
returns the port's Frame on `device` (the GPU unless the caller asks for the
CPU). Without an SMPL-X asset the J=55 stand-in synthetic_smplx() is used.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import smpl as S
from ..render.camera import Camera
from ..render.render import SceneContext
from .frames import Frame
from .readers import get_bound_2d_mask
from .smc import SMCReader

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

TRAIN_VIEWS, TEST_VIEWS = [26], [24, 25, 27, 28]


@dataclasses.dataclass
class DNAFrameSpec:
    main_smc_path: str
    annot_smc_path: str
    camera_id: int
    frame_id: int
    image_scaling: float
    white_background: bool
    smpl_param: dict          # poses (1, 165), shapes (1, 20), R (3, 3), Th (1, 3)
    world_bound: np.ndarray

    def load(self, crop_hw: Optional[Tuple[int, int]] = None, device=None) -> Frame:
        """Decode the frame; its tensors on `device` (default: the GPU)."""
        from scipy.spatial.transform import Rotation

        device = resolve_device(device)
        main = SMCReader(self.main_smc_path)
        annots = SMCReader(self.annot_smc_path)
        try:
            image = main.get_img("Camera_5mp", self.camera_id, "color", self.frame_id)
            msk = annots.get_mask(self.camera_id, self.frame_id)
            cal = annots.get_Calibration(self.camera_id)
        finally:
            main.release()
            annots.release()
        image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        msk = (np.asarray(msk) != 0).astype(np.float32)
        K = np.asarray(cal["K"], np.float64)
        D = np.asarray(cal["D"], np.float64)
        RT = np.asarray(cal["RT"], np.float64)  # camera-to-world
        image = cv2.undistort(image, K, D)
        msk = cv2.undistort(msk, K, D)
        image[msk == 0] = 1.0 if self.white_background else 0.0

        w2c = np.linalg.inv(np.vstack([RT[:3], [0, 0, 0, 1]]) if RT.shape[0] == 3 else RT)
        R_w2c, T_w2c = w2c[:3, :3], w2c[:3, 3:4]
        if self.image_scaling != 1.0:
            H = int(image.shape[0] * self.image_scaling)
            W = int(image.shape[1] * self.image_scaling)
            image = cv2.resize(image, (W, H), interpolation=cv2.INTER_AREA)
            msk = cv2.resize(msk, (W, H), interpolation=cv2.INTER_NEAREST)
            K = K.copy()
            K[:2] = K[:2] * self.image_scaling
        H, W = image.shape[:2]
        bound_mask = get_bound_2d_mask(self.world_bound, K, np.concatenate([R_w2c, T_w2c], 1),
                                       H, W).astype(np.float32)

        # the fixed-size crop window, centred on the bound rect
        ys, xs = np.nonzero(bound_mask)
        ch, cw = crop_hw if crop_hw else (H, W)
        if len(ys):
            y0 = int(np.clip((ys.min() + ys.max()) // 2 - ch // 2, 0, max(H - ch, 0)))
            x0 = int(np.clip((xs.min() + xs.max()) // 2 - cw // 2, 0, max(W - cw, 0)))
        else:
            y0 = x0 = 0

        sp = self.smpl_param
        # the NLL targets: the full pose's non-root rotations (the offset is
        # added in f32, as moss_tpu adds it)
        rots = Rotation.from_rotvec(sp["poses"].reshape(-1, 3)[1:] + 1e-8).as_matrix()

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)

        return Frame(
            camera=Camera.from_KRT(K, R_w2c.T, T_w2c[:, 0], H, W, device=device),
            image=t(image), bkgd_mask=t(msk), bound_mask=t(bound_mask),
            poses=t(sp["poses"].reshape(1, -1)), shapes=t(sp["shapes"].reshape(1, -1)),
            R=t(sp["R"]), Th=t(sp["Th"].reshape(1, 3)), pose_rotmats=t(rots),
            crop_y0=y0, crop_x0=x0, pose_id=int(self.frame_id))


def read_dna_rendering(path: str, split: str = "train", white_background: bool = False,
                       image_scaling: float = 0.5, smplx_path: Optional[str] = None,
                       device=None) -> Tuple[SceneContext, List[DNAFrameSpec]]:
    """path: the capture's *_main.smc (the reference passes the main file);
    the annotations file is found beside it. Returns the big-pose SMPL-X
    scene on `device` and the split's frame specs."""
    device = resolve_device(device)
    if split == "train":
        views, pose_start, pose_interval, pose_num = TRAIN_VIEWS, 0, 1, 100
    else:
        views, pose_start, pose_interval, pose_num = TEST_VIEWS, 0, 5, 20

    annot_path = path.replace("main", "annotations").split(".")[0] + "_annots.smc"
    if smplx_path and os.path.exists(smplx_path):
        model = S.load_smplx_npz(smplx_path, device=device)
    else:
        # the capture's full pose is 165-dim: the stand-in is SMPL-X-shaped
        model = S.synthetic_smplx(device=device)
    big = S.big_pose_params_smplx(device=device)
    v_big, _ = S.lbs_vertices(model, big["poses"][0], big["shapes"][0])
    scene = SceneContext(smpl=model, big_pose_params=big, big_pose_vertices=v_big)

    annots = SMCReader(annot_path)
    specs: List[DNAFrameSpec] = []
    try:
        # clamped to the capture's length, so short captures load
        stop = min(pose_start + pose_num * pose_interval,
                   int(annots.smc["SMPLx"]["fullpose"].shape[0]))
        for frame_id in range(pose_start, stop, pose_interval):
            sd = annots.get_SMPLx(frame_id)
            poses = np.asarray(sd["fullpose"], np.float32).reshape(1, -1)
            shapes = np.concatenate([np.asarray(sd["betas"], np.float32).reshape(1, -1),
                                     np.asarray(sd["expression"], np.float32).reshape(1, -1)],
                                    axis=-1)
            sp = {"poses": poses, "shapes": shapes, "R": np.eye(3, dtype=np.float32),
                  "Th": np.asarray(sd["transl"], np.float32).reshape(1, 3)}
            v, _ = S.lbs_vertices(model, torch.as_tensor(poses[0], device=device),
                                  torch.as_tensor(shapes[0], device=device))
            xyz = v.cpu().numpy() + sp["Th"]
            bound = np.stack([xyz.min(0) - 0.05, xyz.max(0) + 0.05], axis=0)
            specs.extend(DNAFrameSpec(
                main_smc_path=path, annot_smc_path=annot_path, camera_id=view,
                frame_id=frame_id, image_scaling=image_scaling,
                white_background=white_background, smpl_param=sp, world_bound=bound)
                for view in views)
    finally:
        annots.release()
    return scene, specs
