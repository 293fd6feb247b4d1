"""Everything a cell feeds the program, made from --seed on the card.

One general generator for every configuration and traffic file:

  * the synthetic SMPL rig (moss_torch's synthetic_smpl, drawn here with a
    torch Generator): joints on a random tree, vertices along the bones,
    skinning weights and the joint regressor from distances, random shape
    and pose blendshapes;
  * the train frames: per frame an SMPL pose drawn as chip_smoke.py's
    smpl_param_draw, the camera of the capture drivers' geometry
    (chip_smoke.py's write_zju_capture / write_monocap_capture: focal a share
    of the raw width, one view's intrinsics, the body at a fixed distance, K
    scaled with the image), the world bound (the posed body's box plus a
    pad) filled into the bound mask, each frame's crop window centred on its
    rect, as moss_torch's readers do, at the configuration's crop (what the
    readers' autosize gives on the drivers' capture: the same for every
    seed, so that a seed changes no size); the image and the mask are a target cloud rendered at the
    frame's pose by the reference (render_targets), so the cloud trains
    towards frames it can reproduce, as an avatar does;
  * the Gaussian cloud at the traffic's start, points jittered around the
    big-pose vertices (a trained cloud's placement, chip_smoke.py's
    make_cloud; scales from the mean 3-NN distance, opacities, colours and
    SH), and the target cloud: the start cloud perturbed (a target it is
    near). The workload's geometry_seed draws the rig, the poses and the
    cloud's placement, so that a seed changes no size; the run's seed draws
    the rest and the poses' order;
  * the correction MLPs' weights and the LPIPS backbone's (random, He
    initialised). AdamW starts afresh: zero moments, counts 0. (With the
    schedule's counts, about 2000, its bias correction is about 1, and zero
    second moments then make the first hundreds of updates 3 to 6 times the
    learning rate: the cloud would move faster than in any run and outgrow
    its probed pair budgets.)

Frames are the port's shapes but never its objects: harness.py and check.py
wrap the same tensors for the program and for the reference.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from .reference import gaussians as RG
from .reference import smpl as RS
from .reference.camera import Camera as RCamera
from .reference.knn import mean_knn_dist2
from .reference.lbs_field import LBSField
from .reference.pose_refine import PoseRefine
from .reference.render import SceneContext, render_frame
from .reference.sh import rgb_to_sh
from .reference.transforms import inverse_sigmoid, rodrigues

HERE = os.path.dirname(os.path.abspath(__file__))
VGG16 = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]


def load_json(kind: str, name: str) -> Dict:
    """benchmark/<kind>/<name>.json: a configuration, a cell or a metric's data."""
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def seeds(seed: int, n: int) -> List[int]:
    """n 63-bit seeds for n torch Generators, from the run's --seed."""
    state = np.random.SeedSequence(seed).generate_state(2 * n, np.uint32)
    return [int((int(state[2 * i]) << 31) ^ int(state[2 * i + 1])) for i in range(n)]


@dataclasses.dataclass
class FrameData:
    """One train frame: tensors on the card, the camera as numbers."""

    K: np.ndarray           # (3, 3) float64, scaled with the image
    R_w2c: np.ndarray       # (3, 3) float64
    T_w2c: np.ndarray       # (3,) float64, metres
    height: int
    width: int
    image: torch.Tensor     # (H, W, 3) f32 in [0, 1]
    bkgd_mask: torch.Tensor  # (H, W) f32
    bound_mask: torch.Tensor  # (H, W) f32 0/1
    poses: torch.Tensor     # (1, 72)
    shapes: torch.Tensor    # (1, 10)
    R: torch.Tensor         # (3, 3) the body's global rotation
    Th: torch.Tensor        # (1, 3)
    pose_rotmats: torch.Tensor  # (23, 3, 3)
    crop_y0: int
    crop_x0: int
    pose_id: int


@dataclasses.dataclass
class Inputs:
    config: Dict
    workload: Dict
    rig: RS.SMPLModel
    big_pose_vertices: torch.Tensor
    frames: List[FrameData]
    crop_hw: tuple
    gauss: Dict[str, torch.Tensor]   # GaussianParams fields at the capacity
    valid: torch.Tensor
    mlp_weights: Dict[str, Dict[str, torch.Tensor]]  # {"pose", "lbs"}: state dicts
    lpips: Dict
    start: int                       # the state's iteration (steps taken)

    @property
    def optim(self):
        return SimpleNamespace(**self.config["optim"], iterations=self.workload["run_iterations"])

    @property
    def model(self):
        return SimpleNamespace(**self.config["model"])


def make_rig(gen, device, n_verts: int, n_shapes: int) -> RS.SMPLModel:
    """synthetic_smpl's construction (moss_torch/models/smpl.py) from `gen`."""
    parents = RS.SMPL_PARENTS
    J = len(parents)
    steps = torch.randn((J, 3), generator=gen, device=device) * 0.12
    rise = torch.tensor([[0.0, 0.1 if j < 12 else -0.05, 0.0] for j in range(J)], device=device)
    joints = [torch.zeros(3, device=device)]
    for j in range(1, J):
        joints.append(joints[parents[j]] + steps[j] + rise[j])
    joints = torch.stack(joints)
    bone = torch.randint(0, J, (n_verts,), generator=gen, device=device)
    t = torch.rand((n_verts, 1), generator=gen, device=device)
    parent_of = torch.tensor([p if p >= 0 else 0 for p in parents], device=device)[bone]
    v = joints[bone] * t + joints[parent_of] * (1 - t)
    v = v + torch.randn((n_verts, 3), generator=gen, device=device) * 0.04
    d = torch.cdist(v.double(), joints.double())
    weights = torch.softmax(-d / 0.07, dim=1).float()
    J_reg = torch.softmax(-d.T / 0.03, dim=1).float()
    shapedirs = torch.randn((n_verts, 3, n_shapes), generator=gen, device=device) * 0.01
    posedirs = torch.randn((n_verts, 3, 9 * (J - 1)), generator=gen, device=device) * 0.001
    return RS.SMPLModel(v_template=v, shapedirs=shapedirs, posedirs=posedirs, J_regressor=J_reg,
                        weights=weights, faces=torch.zeros((0, 3), dtype=torch.int32,
                                                           device=device), parents=parents)


def convex_hull(points: np.ndarray) -> np.ndarray:
    """The hull of (n, 2) points, counter-clockwise (monotone chain)."""
    pts = np.unique(points, axis=0)
    if len(pts) < 3:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and _cross(out[-1] - out[-2], p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out[:-1]

    return np.array(half(pts) + half(pts[::-1]))


def _cross(a, b):
    return a[0] * b[1] - a[1] * b[0]


def fill_hull(hull: np.ndarray, H: int, W: int, device) -> torch.Tensor:
    """(H, W) bool: the pixels (column x, row y) on or inside a
    counter-clockwise hull."""
    v = torch.as_tensor(hull, dtype=torch.float64, device=device)
    e = torch.roll(v, -1, 0) - v
    ys = torch.arange(H, dtype=torch.float64, device=device)[:, None, None]
    xs = torch.arange(W, dtype=torch.float64, device=device)[None, :, None]
    cross = e[:, 0] * (ys - v[:, 1]) - e[:, 1] * (xs - v[:, 0])
    return (cross >= 0).all(-1)


def project(xyz, K, R, T):
    """(n, 2) pixels of world points (x_cam = R x + T, then K)."""
    cam = xyz @ R.T + T
    uv = cam @ K.T
    return uv[:, :2] / uv[:, 2:]


def make_frames(cfg: Dict, rig: RS.SMPLModel, gen, device) -> (List[FrameData], tuple):
    """The train frames' poses, cameras, bound masks and crop windows (the
    configuration's crop, each frame's centred on its bound rect); their
    images and masks are rendered afterwards (render_targets)."""
    cam, draw = cfg["camera"], cfg["pose_draw"]
    raw, scaling = cfg["raw_size"], cfg["image_scaling"]
    H = W = int(raw * scaling)
    f = cam["focal"] * raw * (1 + cam["focal_step"] * cam["view"])
    K = np.array([[f, 0, raw / 2], [0, f, raw / 2], [0, 0, 1.0]])
    K[:2] *= scaling
    R_w2c = np.eye(3)
    T_w2c = np.array([cam["x_offset_m"], 0.0, cam["distance_m"]])
    n = cfg["train_frames"]
    sig = torch.tensor([draw["poses"]] * 72 + [draw["shapes"]] * 10 + [draw["Rh"]] * 3
                       + [draw["Th"]] * 3, device=device)
    params = torch.randn((n, 88), generator=gen, device=device) * sig
    Kt, Rt, Tt = (torch.as_tensor(x, dtype=torch.float64, device=device) for x in (K, R_w2c, T_w2c))
    frames = []
    for i in range(n):
        poses, shapes = params[i, :72][None], params[i, 72:82][None]
        Rg = rodrigues(params[i, 82:85].double()[None])[0].float()
        Th = params[i, 85:88][None]
        v, _ = RS.lbs_vertices(rig, poses, shapes)
        xyz = (v @ Rg.T + Th).double()
        lo, hi = xyz.min(0).values - cfg["bound_pad_m"], xyz.max(0).values + cfg["bound_pad_m"]
        corners = torch.stack([torch.stack([a, b, c]) for a in (lo[0], hi[0]) for b in (lo[1], hi[1])
                               for c in (lo[2], hi[2])])
        uv = torch.round(project(corners, Kt, Rt, Tt)).cpu().numpy()
        bound = fill_hull(convex_hull(uv), H, W, device).float()
        rot = rodrigues(poses.reshape(24, 3)[1:].double() + 1e-8).float()
        frames.append(dict(poses=poses.contiguous(), shapes=shapes.contiguous(), R=Rg,
                           Th=Th.contiguous(), pose_rotmats=rot, pose_id=i, bound_mask=bound))
    crop = tuple(cfg["crop_hw"])
    rows = torch.stack([fr["bound_mask"].any(1) for fr in frames])
    cols = torch.stack([fr["bound_mask"].any(0) for fr in frames])
    ar_h, ar_w = torch.arange(H, device=device), torch.arange(W, device=device)
    y0 = torch.where(rows, ar_h, H).min(1).values
    y1 = torch.where(rows, ar_h, -1).max(1).values
    x0 = torch.where(cols, ar_w, W).min(1).values
    x1 = torch.where(cols, ar_w, -1).max(1).values
    data = []
    for fr, (ya, yb, xa, xb) in zip(frames, torch.stack([y0, y1, x0, x1], 1).tolist()):
        yc = int(np.clip((ya + yb) // 2 - crop[0] // 2, 0, max(H - crop[0], 0)))
        xc = int(np.clip((xa + xb) // 2 - crop[1] // 2, 0, max(W - crop[1], 0)))
        data.append(FrameData(K=K, R_w2c=R_w2c, T_w2c=T_w2c, height=H, width=W, image=None,
                              bkgd_mask=None, crop_y0=yc, crop_x0=xc, **fr))
    return data, crop


def reference_frame(f: FrameData, device):
    """A frame as the reference's render and loss read it."""
    return SimpleNamespace(
        camera=RCamera.from_KRT(f.K, f.R_w2c.T, f.T_w2c, f.height, f.width, device=device),
        image=f.image, bkgd_mask=f.bkgd_mask, bound_mask=f.bound_mask,
        smpl_params={"poses": f.poses, "shapes": f.shapes, "R": f.R, "Th": f.Th},
        pose_rotmats=f.pose_rotmats, crop_y0=f.crop_y0, crop_x0=f.crop_x0)


def reference_mlps(weights: Dict, device) -> Dict:
    mlps = {"pose": PoseRefine(None, device), "lbs": LBSField(None, device)}
    for k, m in mlps.items():
        m.load_state_dict(weights[k])
    return mlps


@torch.no_grad()
def render_targets(frames: List[FrameData], cfg: Dict, scene, mlps, gauss: Dict, valid, device):
    """Each frame's image and mask: the target cloud rendered by the
    reference at the frame's pose (SH at the full degree, black
    background). ZJU-MoCap's mask is the binary alpha > 0.5 and its image is
    black outside it (its reader's fill); MonoCap's soft mask is the alpha."""
    params = RG.GaussianParams(**gauss)
    bg = torch.zeros(3, device=device)
    for f in frames:
        out = render_frame(params, valid, mlps, scene, reference_frame(f, device).smpl_params,
                           reference_frame(f, device).camera, bg, cfg["model"]["sh_degree"],
                           device=device)
        alpha = out["render_alpha"]
        if cfg["mask"] == "soft":
            f.image, f.bkgd_mask = out["render"].contiguous(), alpha.contiguous()
        else:
            mask = (alpha > 0.5).float()
            f.image, f.bkgd_mask = (out["render"] * mask[..., None]).contiguous(), mask


def make_cloud(spec: Dict, model: Dict, verts, geo, app, device) -> (Dict, torch.Tensor):
    """The GaussianParams fields (capacity-padded) and the live mask of a
    cloud spec: points jittered around the body vertices (make_cloud of
    chip_smoke.py), a share of them large. The Generator `geo` draws where
    the points are and which are large, `app` their opacities, colours and
    SH."""
    capacity, n_rest = model["capacity"], (model["sh_degree"] + 1) ** 2 - 1
    idx = torch.randint(0, verts.shape[0], (spec["live"],), generator=geo, device=device)
    pts = verts[idx] + torch.randn((spec["live"], 3), generator=geo,
                                   device=device) * spec["jitter_m"]
    lo, hi = spec["opacity"]
    opacity = lo + (hi - lo) * torch.rand((pts.shape[0], 1), generator=app, device=device)
    f_rest = torch.randn((pts.shape[0], n_rest, 3), generator=app,
                         device=device) * spec["f_rest_sigma"]
    n = pts.shape[0]
    colors = torch.rand((n, 3), generator=app, device=device)
    log_scale = torch.log(torch.sqrt(torch.clamp_min(mean_knn_dist2(pts), 1e-7)))[:, None].repeat(1, 3)
    log_scale = torch.clamp_max(log_scale, math.log(spec["max_scale_m"]))
    # a trained cloud's tail of large splats (they set the rect cap a run reaches)
    lo, hi = spec["big_scale_m"]
    big = torch.rand((n, 1), generator=geo, device=device) < spec["big_share"]
    size = lo + (hi - lo) * torch.rand((n, 1), generator=geo, device=device)
    log_scale = torch.where(big, torch.log(size), log_scale)
    pad = capacity - n

    def padded(x, fill):
        return torch.cat([x, x.new_full((pad,) + x.shape[1:], fill)], 0).contiguous()

    xyz = padded(pts, 0.0)
    xyz[n:, 2] = -1e6
    rotation = torch.zeros((capacity, 4), device=device)
    rotation[:, 0] = 1.0
    gauss = {"xyz": xyz, "f_dc": padded(rgb_to_sh(colors)[:, None, :], 0.0),
             "f_rest": padded(f_rest, 0.0), "scaling": padded(log_scale, -10.0),
             "rotation": rotation, "opacity": padded(inverse_sigmoid(opacity), -15.0)}
    return gauss, torch.arange(capacity, device=device) < n


def perturbed(gauss: Dict, valid, spec: Dict, gen, device) -> Dict:
    """The cloud with its live colours and opacity logits moved by the
    spec's normal draws: a target the cloud is near, not at, with the same
    geometry (a trained avatar's last third refines appearance more than
    shape)."""
    out = {k: v.clone() for k, v in gauss.items()}
    live = valid[:, None].float()
    for key, sigma in (("f_dc", spec["f_dc_sigma"]), ("opacity", spec["opacity_logit_sigma"])):
        noise = torch.randn(out[key].shape, generator=gen, device=device) * sigma
        out[key] = out[key] + noise * live.reshape((-1,) + (1,) * (noise.ndim - 1))
    return out


def make_lpips(gen, device) -> Dict:
    """A He-initialised VGG16 backbone and uniform heads (moss_torch's
    lpips.init_random's rule), drawn on the card."""
    convs, lins, c_in = [], [], 3
    for c_out, n_layers in VGG16:
        block = []
        for _ in range(n_layers):
            w = torch.randn((c_out, c_in, 3, 3), generator=gen, device=device)
            block.append({"w": w * math.sqrt(2.0 / (9 * c_in)),
                          "b": torch.zeros(c_out, device=device)})
            c_in = c_out
        convs.append(block)
        lins.append(torch.full((c_out,), 1.0 / c_out, device=device))
    return {"convs": convs, "lins": lins}


def make_inputs(workload_name: str, seed: int, device, config: Dict = None,
                workload: Dict = None) -> Inputs:
    """A cell's inputs from `seed` (its files under benchmark/, or the given
    dicts)."""
    workload = workload or load_json("workloads", workload_name)
    config = config or load_json("configs", workload["config"])
    # the run's draws take the last four of six seeds (the limits were read on these draws)
    g_cloud, g_mlp, g_lpips, g_target = (
        torch.Generator(device=device).manual_seed(s) for s in seeds(seed, 6)[2:])
    # every seed trains the same rig, poses and cloud geometry, the poses in
    # an order of its own: the seed changes no size
    g_rig, g_frames, g_geo = (torch.Generator(device=device).manual_seed(s)
                              for s in seeds(workload["geometry_seed"], 3))
    smpl = config["smpl"]
    rig = make_rig(g_rig, device, smpl["n_verts"], smpl["n_shapes"])
    big = RS.big_pose_params(smpl["n_shapes"], device=device)
    big_verts, _ = RS.lbs_vertices(rig, big["poses"][0], big["shapes"][0])
    frames, crop = make_frames(config, rig, g_frames, device)
    perm = torch.randperm(len(frames), generator=g_cloud, device=device).tolist()
    frames = [frames[i] for i in perm]
    gauss, valid = make_cloud(workload["cloud"], config["model"], big_verts, g_geo, g_cloud,
                              device)
    mlps = reference_mlps({k: {n: p.detach() for n, p in m.named_parameters()} for k, m in
                           {"pose": PoseRefine(g_mlp, device), "lbs": LBSField(g_mlp, device)}.items()},
                          device)
    t_gauss = perturbed(gauss, valid, workload["target"], g_target, device)
    scene = SceneContext(smpl=rig, big_pose_params=big, big_pose_vertices=big_verts)
    render_targets(frames, config, scene, mlps, t_gauss, valid, device)
    weights = {k: {n: p.detach() for n, p in m.named_parameters()} for k, m in mlps.items()}
    return Inputs(config=config, workload=workload, rig=rig, big_pose_vertices=big_verts,
                  frames=frames, crop_hw=crop, gauss=gauss, valid=valid, mlp_weights=weights,
                  lpips=make_lpips(g_lpips, device), start=workload["state_iteration"])


def frame_order(seed: int, n_frames: int, iterations: int) -> List[int]:
    """The frame each iteration trains on (order[it - 1]): moss_torch's
    Trainer shuffles epochs with np.random.default_rng(cfg.seed)."""
    rng = np.random.default_rng(seed)
    order: List[int] = []
    while len(order) < iterations:
        order.extend(rng.permutation(n_frames).tolist())
    return order
