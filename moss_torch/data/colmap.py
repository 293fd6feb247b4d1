"""COLMAP and Blender (NeRF-synthetic) scenes: the reference's static scene
paths (sceneLoadTypeCallbacks 'Colmap' and 'Blender', dataset_readers.py:
77-297, colmap_loader.py), the port's own copy of moss_tpu/data/colmap.py.

The parsers and writers of COLMAP's binary and text models read and write
the same bytes as moss_tpu's; read_colmap_scene and read_blender_scene give
the same spec dicts (K or the Blender field of view, the world-to-camera R
and T, the image path). static_scene_context and frame_from_spec carry them
into the port: a SceneContext with no body (the points seed the cloud) and
Frames with all-ones masks and zero SMPL fields, on `device` (the GPU unless
the caller asks for the CPU); render them with
render_frame(..., static_scene=True), which skips the deformation. Images
are decoded by readers.imread (cv2), to the arrays moss_tpu decodes; the
readers of specs need neither cv2 nor h5py.
"""
from __future__ import annotations

import json
import os
import struct
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..render.camera import Camera
from ..render.render import SceneContext
from .frames import Frame


class ColmapCamera(NamedTuple):
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


class ColmapImage(NamedTuple):
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str


_CAM_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4), 3: ("RADIAL", 5), 4: ("OPENCV", 8),
}


def read_cameras_binary(path) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            cam_id, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, n_params = _CAM_MODELS[model_id]
            params = np.array(struct.unpack(f"<{n_params}d", f.read(8 * n_params)))
            cams[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return cams


def write_cameras_binary(path, cams: Dict[int, ColmapCamera]):
    inv = {v[0]: k for k, v in _CAM_MODELS.items()}
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            f.write(struct.pack("<iiQQ", c.id, inv[c.model], c.width, c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))


def read_images_binary(path) -> Dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            img_id = struct.unpack("<i", f.read(4))[0]
            qvec = np.array(struct.unpack("<4d", f.read(32)))
            tvec = np.array(struct.unpack("<3d", f.read(24)))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            n_pts = struct.unpack("<Q", f.read(8))[0]
            f.read(24 * n_pts)  # xys + point3D ids, unused
            images[img_id] = ColmapImage(img_id, qvec, tvec, cam_id, name.decode())
    return images


def write_images_binary(path, images: Dict[int, ColmapImage]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", 0))


def read_points3d_binary(path) -> Tuple[np.ndarray, np.ndarray]:
    xyzs, rgbs = [], []
    with open(path, "rb") as f:
        n = struct.unpack("<Q", f.read(8))[0]
        for _ in range(n):
            f.read(8)  # id
            xyzs.append(struct.unpack("<3d", f.read(24)))
            rgbs.append(struct.unpack("<3B", f.read(3)))
            f.read(8)  # error
            track_len = struct.unpack("<Q", f.read(8))[0]
            f.read(8 * track_len)
    return np.array(xyzs, np.float32), np.array(rgbs, np.float32) / 255.0


def write_points3d_binary(path, xyz, rgb_u8):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<Q", i))
            f.write(struct.pack("<3d", *xyz[i]))
            f.write(struct.pack("<3B", *rgb_u8[i]))
            f.write(struct.pack("<d", 0.0))
            f.write(struct.pack("<Q", 0))


def _text_lines(path):
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line and line[0] != "#":
                yield line.split()


def read_cameras_text(path) -> Dict[int, ColmapCamera]:
    """cameras.txt (read_intrinsics_text, colmap_loader.py:156-178).

    Unlike the reference (which asserts PINHOLE-only), any model in
    _CAM_MODELS is accepted — read_colmap_scene maps params to K uniformly.
    """
    cams = {}
    for e in _text_lines(path):
        cam_id, model, w, h = int(e[0]), e[1], int(e[2]), int(e[3])
        cams[cam_id] = ColmapCamera(cam_id, model, w, h,
                                    np.array([float(x) for x in e[4:]]))
    return cams


def read_images_text(path) -> Dict[int, ColmapImage]:
    """images.txt (read_extrinsics_text, colmap_loader.py:244-270): two lines
    per image — the pose line, then the 2D-point line (skipped)."""
    images = {}
    pose_line = True
    for e in _text_lines(path):
        if pose_line:
            img_id = int(e[0])
            qvec = np.array([float(x) for x in e[1:5]])
            tvec = np.array([float(x) for x in e[5:8]])
            images[img_id] = ColmapImage(img_id, qvec, tvec, int(e[8]), e[9])
        pose_line = not pose_line
    return images


def read_points3d_text(path) -> Tuple[np.ndarray, np.ndarray]:
    """points3D.txt (read_points3D_text, colmap_loader.py:83-124)."""
    xyzs, rgbs = [], []
    for e in _text_lines(path):
        xyzs.append([float(x) for x in e[1:4]])
        rgbs.append([float(x) for x in e[4:7]])
    if not xyzs:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32)
    return np.array(xyzs, np.float32), np.array(rgbs, np.float32) / 255.0


def nerfpp_norm(specs) -> Dict[str, np.ndarray]:
    """Scene extent from camera centers (getNerfppNorm,
    dataset_readers.py:54-75): radius = 1.1 * max distance of any camera
    center from their mean; translate = -mean. Takes the spec dicts produced
    by read_colmap_scene / read_blender_scene."""
    centers = []
    for s in specs:
        R = np.asarray(s["R_w2c"], np.float64)
        T = np.asarray(s["T_w2c"], np.float64).reshape(3)
        centers.append(-R.T @ T)  # C2W translation
    centers = np.stack(centers, 0)
    center = centers.mean(0)
    radius = 1.1 * float(np.linalg.norm(centers - center, axis=1).max())
    return {"translate": -center, "radius": radius}


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def read_colmap_scene(path: str, images_dir: str = "images"):
    """Returns (frame_specs, points, colors): specs are dicts with K/R/T/paths.

    Mirrors readColmapSceneInfo (dataset_readers.py:140-186): sparse/0 binary
    model with text fallback (:146-157,166-176), world-to-camera R stored
    transposed, intrinsics -> K. Scene extent: nerfpp_norm(specs).
    """
    sparse = os.path.join(path, "sparse", "0")
    if os.path.exists(os.path.join(sparse, "cameras.bin")):
        cams = read_cameras_binary(os.path.join(sparse, "cameras.bin"))
        images = read_images_binary(os.path.join(sparse, "images.bin"))
    else:
        cams = read_cameras_text(os.path.join(sparse, "cameras.txt"))
        images = read_images_text(os.path.join(sparse, "images.txt"))
    if os.path.exists(os.path.join(sparse, "points3D.bin")):
        xyz, rgb = read_points3d_binary(os.path.join(sparse, "points3D.bin"))
    elif os.path.exists(os.path.join(sparse, "points3D.txt")):
        xyz, rgb = read_points3d_text(os.path.join(sparse, "points3D.txt"))
    else:
        xyz = np.zeros((0, 3), np.float32)
        rgb = np.zeros((0, 3), np.float32)

    specs = []
    for im in sorted(images.values(), key=lambda i: i.name):
        cam = cams[im.camera_id]
        if cam.model == "SIMPLE_PINHOLE":
            f_, cx, cy = cam.params
            fx = fy = f_
        elif cam.model == "PINHOLE":
            fx, fy, cx, cy = cam.params[:4]
        else:
            fx, fy, cx, cy = cam.params[0], cam.params[0], cam.params[1], cam.params[2]
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
        R_w2c = qvec2rotmat(im.qvec)
        specs.append({
            "K": K,
            "R_w2c": R_w2c,
            "T_w2c": im.tvec.reshape(3, 1),
            "image_path": os.path.join(path, images_dir, im.name),
            "width": cam.width, "height": cam.height,
            "name": im.name,
        })
    return specs, xyz, rgb


def read_blender_scene(path: str, split: str = "train", white_background=False):
    """NeRF-synthetic transforms_{split}.json reader
    (readNerfSyntheticInfo / readCamerasFromTransforms, dataset_readers.py:218-297):
    OpenGL c2w with flipped y/z -> COLMAP w2c."""
    with open(os.path.join(path, f"transforms_{split}.json")) as f:
        meta = json.load(f)
    fovx = meta["camera_angle_x"]
    specs = []
    for fr in meta["frames"]:
        c2w = np.array(fr["transform_matrix"], np.float64)
        c2w[:3, 1:3] *= -1  # OpenGL -> COLMAP axes
        w2c = np.linalg.inv(c2w)
        specs.append({
            "R_w2c": w2c[:3, :3],
            "T_w2c": w2c[:3, 3:4],
            "image_path": os.path.join(path, fr["file_path"] + ".png"),
            "fovx": fovx,
            "white_background": white_background,
        })
    return specs


def static_scene_context(points, device=None) -> SceneContext:
    """SceneContext of a static (no-body) scene: the sparse points stand in
    for big_pose_vertices (they seed the cloud; nothing else reads the body
    fields when cfg.model.static_scene is set)."""
    device = resolve_device(device)
    return SceneContext(smpl=None, big_pose_params=None,
                        big_pose_vertices=torch.as_tensor(np.asarray(points, np.float32),
                                                          device=device))


def frame_from_spec(spec: Dict, white_background: bool = False, device=None) -> Frame:
    """A training Frame from a read_colmap_scene / read_blender_scene spec:
    the image decoded here (PNG alpha composited onto the background, as the
    reference's reader blends it, dataset_readers.py:262-270), all-ones
    masks (a static scene has no subject mask: train with w_mask=0), zero
    SMPL fields (render_frame(static_scene=True) and the losses ignore
    them: with no pose MLPs the Fisher NLL is 0), a Blender spec's K built
    from camera_angle_x."""
    from .readers import imread

    device = resolve_device(device)
    img = np.asarray(imread(spec["image_path"]), np.float32) / 255.0
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=2)
    if img.shape[2] == 4:
        a = img[..., 3:4]
        bg = 1.0 if (white_background or spec.get("white_background")) else 0.0
        img = img[..., :3] * a + bg * (1.0 - a)
    H, W = img.shape[:2]
    if "K" in spec:
        K = spec["K"]
    else:
        fx = fy = 0.5 * W / np.tan(0.5 * spec["fovx"])
        K = np.array([[fx, 0, W / 2], [0, fy, H / 2], [0, 0, 1.0]])
    # from_KRT takes R in the reference's transposed storage
    camera = Camera.from_KRT(K, spec["R_w2c"].T, spec["T_w2c"][:, 0], H, W, device=device)
    ones = torch.ones((H, W), device=device)
    return Frame(
        camera=camera,
        image=torch.as_tensor(np.ascontiguousarray(img[..., :3], np.float32), device=device),
        bkgd_mask=ones, bound_mask=ones,
        poses=torch.zeros((1, 72), device=device), shapes=torch.zeros((1, 10), device=device),
        R=torch.eye(3, device=device), Th=torch.zeros((1, 3), device=device),
        pose_rotmats=torch.zeros((23, 3, 3), device=device),
        crop_y0=0, crop_x0=0, pose_id=0)
