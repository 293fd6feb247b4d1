"""Dataset readers: ZJU-MoCap-Refine and MonoCap (port of moss_tpu/data/readers.py).

Host code in numpy and cv2: the same splits as moss_tpu's
(ZJU train: view 4, 100 poses at stride 5; test: the views other than 3 and
4, 17 poses at stride 30; MonoCap's per-sequence views and paths), the same
per-frame work (undistort, background fill or soft-mask multiply, 0.5x (ZJU)
or 1x (MonoCap) resize with K scaled, the world bound's cube faces filled
into a 2D bound mask, SMPL params with Rodrigues'd global rotation, per-joint
target rotmats for the Fisher NLL). Frames are decoded lazily by
FrameSpec.load(crop_hw, device), which returns the port's Frame on `device`
(the GPU unless the caller asks for the CPU).

The SMPL asset is proprietary: pass its path when there is one, else the
synthetic rig of the same structure is used. detect_and_read sends a
DNA-Rendering capture (.smc) to data/dna.py; COLMAP and Blender scenes are
read by data/colmap.py.

imread and imwrite decode and write frames with cv2, and imread returns
what moss_tpu's frame decode (Pillow's) returns for a PNG or a JPEG:
RGB(A) channel order, grey kept 2-D, a 1-bit grey PNG as bool, a 16-bit
grey PNG as uint16 and the other 16-bit PNGs cut to their high bytes, a
palette's and a tRNS chunk's transparency dropped, an 8-bit grey+alpha PNG
as (H, W, 2) and a 16-bit one as RGBA, no EXIF rotation. The PNG's bit depth and colour type and the
JPEG's component count come from the file's header (image_header), which
also gives FrameSpec.image_size without a decode.
"""
from __future__ import annotations

import dataclasses
import os
import warnings
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..models import smpl as S
from ..render.camera import Camera
from ..render.render import SceneContext
from .frames import Frame

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# JPEG start-of-frame markers: 0xC0-0xCF but DHT (C4), JPG (C8) and DAC (CC)
JPEG_SOF = frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}


def image_header(data: bytes) -> dict:
    """{"format", "height", "width", ...} from a PNG's IHDR (with its
    "bit_depth" and "color_type") or a JPEG's start-of-frame marker (with its
    "components"); {"format": None} for anything else."""
    if data[:8] == PNG_SIGNATURE and data[12:16] == b"IHDR":
        return {"format": "png", "width": int.from_bytes(data[16:20], "big"),
                "height": int.from_bytes(data[20:24], "big"), "bit_depth": data[24],
                "color_type": data[25]}
    if data[:2] == b"\xff\xd8":
        i = 2
        while i + 4 <= len(data):
            if data[i] != 0xFF:
                break
            marker = data[i + 1]
            if marker == 0xFF:  # fill byte
                i += 1
                continue
            if marker in JPEG_SOF and i + 10 <= len(data):
                return {"format": "jpeg", "height": int.from_bytes(data[i + 5:i + 7], "big"),
                        "width": int.from_bytes(data[i + 7:i + 9], "big"),
                        "components": data[i + 9]}
            if marker == 0x01 or 0xD0 <= marker <= 0xD8:  # no length field
                i += 2
                continue
            i += 2 + int.from_bytes(data[i + 2:i + 4], "big")
    return {"format": None}


def imread(path: str) -> np.ndarray:
    """The image at `path` as moss_tpu's readers decode it (module
    docstring), decoded by cv2. Raises on a missing or undecodable file and
    on a CMYK JPEG (Pillow keeps CMYK, cv2 converts it)."""
    import cv2

    with open(path, "rb") as f:
        data = f.read()
    img = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_UNCHANGED)
    if img is None:
        raise ValueError(f"cv2 cannot decode {path}")
    head = image_header(data)
    if head["format"] == "jpeg" and head["components"] == 4:
        raise ValueError(f"{path}: a CMYK JPEG, which cv2 decodes otherwise than Pillow")
    if head["format"] == "png":
        depth, ctype = head["bit_depth"], head["color_type"]
        if ctype == 0:           # grey: Pillow's mode "1" is bool, "I;16" uint16
            return img != 0 if depth == 1 else img
        if ctype == 4 and depth == 8:  # grey + alpha, which cv2 expands to BGRA
            img = img[..., [0, 3]]
        elif ctype in (2, 3):    # RGB or palette: tRNS transparency dropped
            img = img[..., 2::-1]
        else:                    # RGBA, and 16-bit grey + alpha (Pillow's RGBA too)
            img = img[..., [2, 1, 0, 3]]
        if depth == 16:          # Pillow keeps each sample's high byte
            img = (img >> 8).astype(np.uint8)
        return np.ascontiguousarray(img)
    if img.ndim == 3:  # BGR(A) to RGB(A)
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return np.ascontiguousarray(img)


def imwrite(path: str, image: np.ndarray) -> None:
    """`image` as a PNG at `path` (whatever its extension) that imread reads
    back bitwise: uint8 (H, W), (H, W, 3) RGB or (H, W, 4) RGBA, uint16
    (H, W), or bool (H, W) as a 1-bit PNG."""
    import cv2

    image = np.asarray(image)
    params = []
    if image.dtype == np.bool_ and image.ndim == 2:
        image, params = image.astype(np.uint8) * 255, [cv2.IMWRITE_PNG_BILEVEL, 1]
    elif image.dtype == np.uint16 and image.ndim == 2:
        pass
    elif image.dtype == np.uint8 and (image.ndim == 2 or image.shape[2] in (3, 4)):
        if image.ndim == 3:
            image = image[..., [2, 1, 0, 3][:image.shape[2]]]
    else:
        raise ValueError(f"imwrite: cannot write a {image.dtype} image of shape {image.shape}")
    ok, buf = cv2.imencode(".png", np.ascontiguousarray(image), params)
    if not ok:
        raise ValueError(f"cv2 cannot encode {path}")
    with open(path, "wb") as f:
        f.write(buf.tobytes())


def get_bound_corners(bounds):
    min_x, min_y, min_z = bounds[0]
    max_x, max_y, max_z = bounds[1]
    return np.array([
        [min_x, min_y, min_z], [min_x, min_y, max_z],
        [min_x, max_y, min_z], [min_x, max_y, max_z],
        [max_x, min_y, min_z], [max_x, min_y, max_z],
        [max_x, max_y, min_z], [max_x, max_y, max_z],
    ])


def project_points_np(xyz, K, RT):
    xyz = xyz @ RT[:, :3].T + RT[:, 3:].T
    xyz = xyz @ K.T
    return xyz[:, :2] / xyz[:, 2:]


def get_bound_2d_mask(bounds, K, w2c34, H, W):
    """The bound box's six faces filled with cv2.fillPoly (the reference's
    dataset_readers.py:1034-1045)."""
    corners = np.round(project_points_np(get_bound_corners(bounds), K, w2c34)).astype(np.int32)
    mask = np.zeros((H, W), np.uint8)
    faces = [[0, 1, 3, 2, 0], [4, 5, 7, 6, 4], [0, 1, 5, 4, 0],
             [2, 3, 7, 6, 2], [0, 2, 6, 4, 0], [1, 3, 7, 5, 1]]
    for f in faces:
        cv2.fillPoly(mask, [corners[f]], 1)
    return mask


def rodrigues_np(rvec):
    return cv2.Rodrigues(np.asarray(rvec, np.float64).reshape(3))[0].astype(np.float32)


def pose_rotmats_np(poses72):
    """(72,) axis-angle -> (23, 3, 3) non-root rotations (the NLL targets)."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(
        np.asarray(poses72, np.float64).reshape(24, 3)[1:] + 1e-8).as_matrix().astype(np.float32)


@dataclasses.dataclass
class FrameSpec:
    """Everything needed to decode one frame lazily."""

    image_path: str
    mask_path: str
    K: np.ndarray
    D: np.ndarray
    R_w2c: np.ndarray       # (3, 3)
    T_w2c: np.ndarray       # (3, 1)
    smpl_param: dict        # poses / shapes / R / Th
    world_bound: np.ndarray
    pose_id: int
    image_scaling: float
    white_background: bool
    mask_style: str = "binary"   # 'binary' (ZJU) | 'soft' (MonoCap olek/vlad)
    mask_multiply: bool = False  # MonoCap olek/vlad multiply instead of fill

    def image_size(self) -> Tuple[int, int]:
        """(H, W) after scaling, from the image header alone."""
        with open(self.image_path, "rb") as f:
            head = image_header(f.read())
        if head["format"] is None:
            raise ValueError(f"{self.image_path}: neither a PNG nor a JPEG")
        h, w = head["height"], head["width"]
        if self.image_scaling != 1.0:
            h, w = int(h * self.image_scaling), int(w * self.image_scaling)
        return h, w

    def _scaled_K(self):
        K = self.K.copy().astype(np.float64)
        K[:2] = K[:2] * self.image_scaling
        return K

    def make_camera(self, image_hw: Optional[Tuple[int, int]] = None, device=None) -> Camera:
        """The frame's Camera without decoding pixels (load()'s K scaling and
        R transpose; undistortion leaves K unchanged)."""
        H, W = image_hw if image_hw is not None else self.image_size()
        return Camera.from_KRT(self._scaled_K(), self.R_w2c.T, self.T_w2c[:, 0], H, W,
                               device=device)

    def bound_rect_hw(self, H: int, W: int) -> Tuple[int, int]:
        """(height, width) of the bound mask's bounding rect without decoding:
        the filled faces' extremes are the projected corners, so the rect is
        their rounded bbox clipped to the image."""
        w2c34 = np.concatenate([self.R_w2c, self.T_w2c], axis=1)
        corners = project_points_np(get_bound_corners(self.world_bound), self._scaled_K(), w2c34)
        corners = np.round(corners).astype(np.int64)
        y0, y1 = (int(np.clip(v, 0, H - 1)) for v in (corners[:, 1].min(), corners[:, 1].max()))
        x0, x1 = (int(np.clip(v, 0, W - 1)) for v in (corners[:, 0].min(), corners[:, 0].max()))
        return y1 - y0 + 1, x1 - x0 + 1

    def load(self, crop_hw: Optional[Tuple[int, int]] = None, device=None) -> Frame:
        """Decode the frame; its tensors on `device` (default: the GPU)."""
        device = resolve_device(device)
        image = np.asarray(imread(self.image_path), np.float32) / 255.0
        msk = imread(self.mask_path)
        if self.mask_style == "binary":
            msk = (np.asarray(msk) != 0).astype(np.float32)
        else:
            msk = np.asarray(msk, np.float32) / 255.0
        if msk.ndim == 3:
            msk = msk[..., 0]

        K = self.K.copy().astype(np.float64)
        if self.D is not None:
            image = cv2.undistort(image, K, self.D)
            msk = cv2.undistort(msk, K, self.D)
        if self.mask_multiply:
            image = image * msk[..., None]
        else:
            image[msk == 0] = 1.0 if self.white_background else 0.0
        if self.image_scaling != 1.0:
            H = int(image.shape[0] * self.image_scaling)
            W = int(image.shape[1] * self.image_scaling)
            image = cv2.resize(image, (W, H), interpolation=cv2.INTER_AREA)
            msk = cv2.resize(msk, (W, H), interpolation=cv2.INTER_NEAREST)
            K[:2] = K[:2] * self.image_scaling
        H, W = image.shape[:2]

        w2c34 = np.concatenate([self.R_w2c, self.T_w2c], axis=1)
        bound_mask = get_bound_2d_mask(self.world_bound, K, w2c34, H, W).astype(np.float32)

        # the fixed-size crop window, centred on the bound rect
        ys, xs = np.nonzero(bound_mask)
        ch, cw = crop_hw if crop_hw is not None else (H, W)
        if len(ys):
            rect_h, rect_w = int(ys.max() - ys.min() + 1), int(xs.max() - xs.min() + 1)
            if rect_h > ch or rect_w > cw:
                # the reference's perceptual losses see the exact bound rect
                # (train_ZJU.py:115-117): a smaller window cuts the subject
                warnings.warn(
                    f"bound rect {rect_h}x{rect_w} exceeds static crop {ch}x{cw} for "
                    f"{self.image_path}: SSIM/LPIPS/S3IM will see a clipped subject. Use "
                    f"autosize_crop() or a larger --crop.", stacklevel=2)
            yc = int(np.clip((ys.min() + ys.max()) // 2 - ch // 2, 0, max(H - ch, 0)))
            xc = int(np.clip((xs.min() + xs.max()) // 2 - cw // 2, 0, max(W - cw, 0)))
        else:
            yc = xc = 0

        def t(x):
            return torch.as_tensor(np.ascontiguousarray(x, np.float32), device=device)

        sp = self.smpl_param
        return Frame(
            # the reference stores R transposed (dataset_readers.py:643)
            camera=Camera.from_KRT(K, self.R_w2c.T, self.T_w2c[:, 0], H, W, device=device),
            image=t(image), bkgd_mask=t(msk), bound_mask=t(bound_mask),
            poses=t(sp["poses"].reshape(1, 72)), shapes=t(sp["shapes"].reshape(1, -1)),
            R=t(sp["R"]), Th=t(sp["Th"].reshape(1, 3)),
            pose_rotmats=t(pose_rotmats_np(sp["poses"])),
            crop_y0=yc, crop_x0=xc, pose_id=int(self.pose_id))


def autosize_crop(specs: List[FrameSpec], image_hw: Optional[Tuple[int, int]] = None,
                  bucket: int = 64, min_crop: int = 128) -> Tuple[int, int]:
    """The smallest crop, in multiples of `bucket`, that holds every frame's
    bound rect (computed from the projected corners, no decode), clamped to
    the image. The reference crops its losses to each frame's exact rect;
    moss_tpu needs a fixed window, and the port keeps its choice so the two
    train on the same crops."""
    if not specs:
        return (min_crop, min_crop)
    H, W = image_hw if image_hw is not None else specs[0].image_size()
    return crop_for_rects([s.bound_rect_hw(H, W) for s in specs], (H, W), bucket, min_crop)


def crop_for_rects(rects_hw, image_hw: Tuple[int, int], bucket: int = 64,
                   min_crop: int = 128) -> Tuple[int, int]:
    """autosize_crop's rule on bound rects given as (height, width): the
    largest, at least min_crop, rounded up to a multiple of bucket, clamped
    to the image."""
    H, W = image_hw
    mh = max([1] + [int(h) for h, _ in rects_hw])
    mw = max([1] + [int(w) for _, w in rects_hw])
    ch = min(H, -(-max(mh, min_crop) // bucket) * bucket)
    cw = min(W, -(-max(mw, min_crop) // bucket) * bucket)
    return ch, cw


def _big_pose_scene(smpl_model: S.SMPLModel, device) -> SceneContext:
    big = S.big_pose_params(device=device)
    v, _ = S.lbs_vertices(smpl_model, big["poses"][0], big["shapes"][0])
    return SceneContext(smpl=smpl_model, big_pose_params=big, big_pose_vertices=v)


def load_smpl_or_synthetic(smpl_path: Optional[str], device=None) -> S.SMPLModel:
    if smpl_path and os.path.exists(smpl_path):
        return S.load_smpl_pickle(smpl_path, device=device)
    return S.synthetic_smpl(device=device)


def _smpl_param(sp, rh) -> dict:
    return {"poses": np.asarray(sp["poses"], np.float32).reshape(1, 72),
            "shapes": np.asarray(sp["shapes"], np.float32),
            "R": rodrigues_np(rh),
            "Th": np.asarray(sp["Th"], np.float32)}


def read_zju_mocap_refine(path: str, split: str = "train", white_background: bool = False,
                          image_scaling: float = 0.5, smpl_path: Optional[str] = None,
                          device=None) -> Tuple[SceneContext, List[FrameSpec]]:
    """ZJU-MoCap-Refine (the reference's dataset_readers.py:540-740)."""
    device = resolve_device(device)
    annots = np.load(os.path.join(path, "annots.npy"), allow_pickle=True).item()
    cams = annots["cams"]
    n_cams = len(cams["K"])
    if split == "train":
        output_view = [4] if n_cams > 4 else [0]
        pose_start, pose_interval, pose_num = 0, 5, 100
    else:
        # the reference's 23 test views minus the train view (:699-702), and
        # view 3 dropped from every test split (:555-557, whose condition is
        # always true); clamped to the cameras present
        output_view = [i for i in range(min(23, n_cams)) if i not in (3, 4)]
        pose_start, pose_interval, pose_num = 0, 30, 17
    ims_meta = annots["ims"][pose_start: pose_start + pose_num * pose_interval][::pose_interval]
    ims = np.array([np.array(d["ims"])[output_view] for d in ims_meta])
    cam_inds = np.array([np.arange(len(d["ims"]))[output_view] for d in ims_meta])

    scene = _big_pose_scene(load_smpl_or_synthetic(smpl_path, device), device)
    specs: List[FrameSpec] = []
    for pose_index in range(ims.shape[0]):
        for view_index in range(len(output_view)):
            image_path = os.path.join(path, str(ims[pose_index][view_index]).replace("\\", "/"))
            msk_path = image_path.replace("images", "mask").replace("jpg", "png")
            ci = cam_inds[pose_index][view_index]
            i = int(os.path.basename(image_path)[:-4])
            xyz = np.load(os.path.join(path, "smpl_vertices", f"{i}.npy")).astype(np.float32)
            sp = np.load(os.path.join(path, "smpl_params", f"{i}.npy"), allow_pickle=True).item()
            specs.append(FrameSpec(
                image_path=image_path, mask_path=msk_path,
                K=np.array(cams["K"][ci], np.float64), D=np.array(cams["D"][ci], np.float64),
                R_w2c=np.array(cams["R"][ci], np.float64),
                T_w2c=np.array(cams["T"][ci], np.float64).reshape(3, 1) / 1000.0,
                smpl_param=_smpl_param(sp, sp["Rh"]),
                world_bound=np.stack([xyz.min(0) - 0.05, xyz.max(0) + 0.05], axis=0),
                pose_id=pose_index, image_scaling=image_scaling,
                white_background=white_background))
    return scene, specs


def read_monocap(path: str, split: str = "train", white_background: bool = False,
                 image_scaling: float = 1.0, smpl_path: Optional[str] = None,
                 device=None) -> Tuple[SceneContext, List[FrameSpec]]:
    """MonoCap (the reference's dataset_readers.py:299-505, quirks included)."""
    device = resolve_device(device)
    if "olek_images0812" in path:
        train_view, test_view, pose_start = [44], [45], 1
    elif "vlad_images1011" in path:
        train_view, test_view, pose_start = [66], [0, 10, 20, 30, 40, 50, 60, 70, 80, 90, 100], 1
    else:
        train_view, test_view, pose_start = [0], list(range(1, 11)), 0
    if split == "train":
        output_view, pose_interval, pose_num = train_view, 5, 100
    else:
        output_view, pose_interval, pose_num = test_view, 30, 17

    annots = np.load(os.path.join(path, "annots.npy"), allow_pickle=True).item()
    cams = annots["cams"]
    smpl_model = load_smpl_or_synthetic(smpl_path, device)
    scene = _big_pose_scene(smpl_model, device)

    def paths_for(view, pose):
        if "olek_images0812" in path:
            v, p, mext = str(view).zfill(2), str(pose).zfill(6), ".png"
        elif "vlad_images1011" in path:
            v, p, mext = str(view).zfill(3), str(pose).zfill(6), ".jpg"
        else:
            v, p, mext = str(view).zfill(2), str(pose).zfill(4), ".png"
        return (os.path.join(path, "images", v, p + ".jpg"),
                os.path.join(path, "mask", v, p + mext))

    soft_mask = ("olek_images0812" in path) or ("vlad_images1011" in path)
    specs: List[FrameSpec] = []
    for pose_index in range(pose_start, pose_start + pose_num * pose_interval, pose_interval):
        params = np.load(os.path.join(path, "params", f"{pose_index}.npy"),
                         allow_pickle=True).item()
        smpl_param = _smpl_param(params, np.asarray(params["Rh"], np.float32))
        v, _ = S.lbs_vertices(smpl_model, torch.as_tensor(smpl_param["poses"][0], device=device),
                              torch.as_tensor(smpl_param["shapes"].reshape(-1), device=device))
        xyz = v.cpu().numpy() @ smpl_param["R"].T + smpl_param["Th"].reshape(1, 3)
        bound = np.stack([xyz.min(0) - 0.1, xyz.max(0) + 0.1], axis=0)
        for view in output_view:
            image_path, msk_path = paths_for(view, pose_index)
            specs.append(FrameSpec(
                image_path=image_path, mask_path=msk_path,
                K=np.array(cams["K"][view], np.float64), D=np.array(cams["D"][view], np.float64),
                R_w2c=np.array(cams["R"][view], np.float64),
                T_w2c=np.array(cams["T"][view], np.float64).reshape(3, 1) / 1000.0,
                smpl_param=smpl_param, world_bound=bound, pose_id=pose_index,
                image_scaling=image_scaling, white_background=white_background,
                mask_style="soft" if soft_mask else "binary", mask_multiply=soft_mask))
    return scene, specs


def _read_dna(*a, **kw):
    from .dna import read_dna_rendering

    return read_dna_rendering(*a, **kw)


READERS = {"zju_mocap_refine": read_zju_mocap_refine, "monocap": read_monocap,
           "dna_rendering": _read_dna}


def detect_and_read(path: str, split: str = "train", **kw):
    """Dispatch on the path as the reference's Scene does (scene/__init__.py:42-57)."""
    if path.endswith(".smc") or "dna_rendering" in path.lower():
        return _read_dna(path, split, **kw)
    if "zju" in path.lower() or "my_" in os.path.basename(os.path.normpath(path)):
        return read_zju_mocap_refine(path, split, **kw)
    if "monocap" in path.lower() or any(
            s in path for s in ("olek", "vlad", "lan_images", "marc_images")):
        return read_monocap(path, split, **kw)
    raise ValueError(f"cannot detect dataset type from path: {path}")
