"""Training over a ('data', 'tile') mesh of ranks (port of moss_tpu/parallel/sharded.py).

The cloud and the MLPs are replicated; each tile rank renders a horizontal
band of whole 16-row tiles (rasterize_cuda.TILE) of its data row's frame, and
each data row trains on its own frame. The bands are gathered into the full
frame before the loss, so SSIM, S3IM and LPIPS see the whole image and the
loss code is the single-process step's.

moss_tpu differentiates through shard_map, and jax.grad counts each term
once. Here each rank runs autograd on its own copy of the loss, and two
rules keep the sum over ranks exact:
  * the gather's backward hands each rank its own band's rows of the image
    cotangent, so the bands' raster gradients add up to the full frame's;
  * the terms every tile rank computes alike (the Fisher NLL: the losses'
    direct gradient to the pose MLP) pass their gradient on tile rank 0
    only.
Each rank differentiates its frame's loss over n_data (the data mean); the
gradients are then summed over the tile group and over the data group, in
that order, in one flat buffer each, so every rank applies the same update.

The band gather is a SUM all-reduce of zero-padded full frames (a value plus
zeros is that value): NCCL and gloo both take it, and gloo's CUDA path has
no all_gather.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from ..config import Config
from ..data.frames import Frame
from ..ops import rasterize_cuda as rc
from ..render.camera import Camera
from ..render.render import SceneContext
from ..train.train_step import TrainState, TrainStep
from .distributed import Mesh, make_mesh  # noqa: F401  (make_mesh: moss_tpu's home for it)

IMAGE_KEYS = ("color", "depth", "alpha", "final_T")


class _BandGather(torch.autograd.Function):
    """The full (H, ...) image from this rank's (H / n_tile, ...) band: the
    band written into zeros at its rows, summed over the tile group. The
    backward returns the band's rows of the cotangent."""

    @staticmethod
    def forward(ctx, band, mesh: Mesh, y0: int, height: int):
        full = band.new_zeros((height,) + tuple(band.shape[1:]))
        full[y0:y0 + band.shape[0]] = band
        mesh.all_reduce(full, "tile")
        ctx.rows = (y0, y0 + band.shape[0])
        return full

    @staticmethod
    def backward(ctx, g):
        y0, y1 = ctx.rows
        return g[y0:y1].contiguous(), None, None, None


class _OnTileZero(torch.autograd.Function):
    """The identity, whose gradient passes on tile rank 0 only."""

    @staticmethod
    def forward(ctx, x, keep: bool):
        ctx.keep = keep
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None


def band_rasterize_fn(mesh: Mesh, rasterize=None):
    """A rasterize_fn for render_frame that renders this rank's pixel band:
    mean2d shifted into band-local rows (binning and blending commute with
    a shift of whole tiles), the images gathered over the tile group, the
    overflow summed. rasterize defaults to rasterize_cuda."""
    raster = rc.rasterize_cuda if rasterize is None else rasterize

    def fn(proj, bg_color, height: int, width: int):
        if height % (mesh.n_tile * rc.TILE):
            raise ValueError(f"image height {height} does not split into {mesh.n_tile} bands "
                             f"of whole {rc.TILE}-row tiles")
        hb = height // mesh.n_tile
        y0 = mesh.tile_index * hb
        shift = torch.tensor([0.0, float(y0)], device=proj.mean2d.device)
        out = raster(proj._replace(mean2d=proj.mean2d - shift), bg_color, hb, width)
        full = {k: _BandGather.apply(out[k], mesh, y0, height) for k in IMAGE_KEYS}
        overflow = torch.as_tensor(out["overflow"]).to(device=mesh.device, dtype=torch.int64)
        full["overflow"] = mesh.all_reduce(overflow.reshape(1).clone(), "tile")[0]
        return full

    return fn


class ShardedTrainStep(TrainStep):
    """make_sharded_train_step's step: step(ts, frames_all, idx, sh_degree,
    gt_lpips_feats=None), idx the (n_data,) frame indices of this step."""

    def __init__(self, scene: SceneContext, cfg: Config, mesh: Mesh, crop_h: int, crop_w: int,
                 lpips_params=None, spatial_lr_scale: float = 1.0, rasterize=None):
        super().__init__(scene, cfg, band_rasterize_fn(mesh, rasterize), lpips_params, crop_h,
                         crop_w, spatial_lr_scale, mesh.device)
        self.mesh = mesh
        self.loss_scale = 1.0 / mesh.n_data

    def loss_inputs(self, out: Dict) -> Dict:
        pose_out = out.get("pose_out")
        if pose_out is None or self.mesh.n_tile == 1:
            return out
        keep = self.mesh.tile_index == 0
        return {**out, "pose_out": {**pose_out, "Rs": _OnTileZero.apply(pose_out["Rs"], keep)}}

    def mesh_grads(self, ts: TrainState, frames_all, idx: Sequence[int], sh_degree: int,
                   gt_lpips_feats=None):
        """(logs averaged over data, this rank's render out, the all-reduced
        grads {group: {name: grad}}, the mean2d-offset grad of this rank's
        whole frame, that frame)."""
        mesh = self.mesh
        i = int(idx[mesh.data_index])
        frame = frame_at(frames_all, i)
        feats = None if gt_lpips_feats is None else gt_lpips_feats[i]
        _, logs, out, grads, offset_grad = self.grads(ts, frame, sh_degree, feats)
        names = [(g, n) for g in grads for n in grads[g]]
        flat = torch.cat([grads[g][n].reshape(-1) for g, n in names] + [offset_grad.reshape(-1)])
        mesh.all_reduce(flat, "tile")
        n_off = offset_grad.numel()
        param_flat = flat[:-n_off]
        mesh.all_reduce(param_flat, "data")
        reduced, at = {g: {} for g in grads}, 0
        for g, n in names:
            k = grads[g][n].numel()
            reduced[g][n] = param_flat[at:at + k].view_as(grads[g][n])
            at += k
        # the loss was divided by n_data: this rank's frame's own offset grad
        # is n_data times its share (sharded.py:229-235 in moss_tpu)
        frame_offset_grad = flat[-n_off:].view_as(offset_grad) * float(mesh.n_data)
        keys = sorted(k for k in logs if k != "raster_overflow")
        vals = torch.stack([logs[k].to(torch.float32).reshape(()) for k in keys])
        vals = mesh.all_reduce(vals, "data") / float(mesh.n_data)
        mean_logs = {k: v for k, v in zip(keys, vals)}
        overflow = torch.as_tensor(out["overflow"]).to(mesh.device, torch.int64).reshape(1)
        mean_logs["raster_overflow"] = mesh.all_reduce(overflow.clone(), "data")[0]
        return mean_logs, out, reduced, frame_offset_grad, frame

    def __call__(self, ts: TrainState, frames_all, idx: Sequence[int], sh_degree: int,
                 gt_lpips_feats=None):
        """One data-parallel update; (new TrainState, logs), the same on every rank."""
        cfg, mesh = self.cfg, self.mesh
        logs, out, grads, offset_grad, frame = self.mesh_grads(ts, frames_all, idx, sh_degree,
                                                               gt_lpips_feats)
        opt_state = self.update(ts, grads)
        with torch.no_grad():
            gs = ts.gstate
            vis = out["visibility_filter"]
            cam = frame.camera
            ndc_scale = torch.tensor([cam.width * 0.5, cam.height * 0.5], device=self.device)
            gnorm = torch.linalg.norm(offset_grad * ndc_scale[None, :], dim=-1)
            pose_out = out["pose_out"]
            with_bw = pose_out is not None and out["lbs_weights"] is not None
            P = vis.shape[0]
            # per-frame statistics summed over data in one buffer; the radii's
            # max as a sum of zero-padded rows, then a max over them
            radii_rows = torch.zeros((mesh.n_data, P), device=self.device)
            radii_rows[mesh.data_index] = torch.where(vis, out["radii"].to(torch.float32), 0.0)
            parts = [torch.where(vis, gnorm, 0.0), vis.to(torch.float32), radii_rows.reshape(-1)]
            if pose_out is not None:
                parts.append(pose_out["Rs"].detach().reshape(-1))
            if with_bw:
                parts.append(out["lbs_weights"].detach().reshape(-1))
            summed = mesh.all_reduce(torch.cat(parts), "data")
            acc, den = summed[:P], summed[P:2 * P]
            at = 2 * P + mesh.n_data * P
            radii_max = summed[2 * P:at].view(mesh.n_data, P).amax(0)
            gstate = dataclasses.replace(
                gs, xyz_grad_accum=gs.xyz_grad_accum + acc, denom=gs.denom + den,
                max_radii2d=torch.maximum(gs.max_radii2d, radii_max))
            if pose_out is not None:
                nF = gs.joint_F.numel()
                gstate = dataclasses.replace(
                    gstate, joint_F=gs.joint_F + summed[at:at + nF].view_as(gs.joint_F))
                at += nF
            if with_bw:
                gstate = dataclasses.replace(
                    gstate, lbs_weight_sum=gs.lbs_weight_sum + summed[at:].view_as(
                        gs.lbs_weight_sum))
            logs["psnr_proxy"] = -10.0 * torch.log10(logs["l1"] ** 2 + 1e-12)
            logs["num_points"] = gstate.num_valid
        return TrainState(ts.params, opt_state, gstate, ts.step + 1), logs


def make_sharded_train_step(scene: SceneContext, cfg: Config, mesh: Mesh, crop_h: int,
                            crop_w: int, lpips_params=None, spatial_lr_scale: float = 1.0,
                            rasterize=None):
    """(init_fn, step_fn) for training over the mesh, as moss_tpu's
    make_sharded_train_step: step_fn(ts, frames_all, idx, sh_degree,
    gt_lpips_feats=None), frames_all the whole train split (a list of Frames
    or stack_frames of it) on every rank, idx the (n_data,) frame each data
    row trains on; gt_lpips_feats, if given, is indexed by frame."""
    step = ShardedTrainStep(scene, cfg, mesh, crop_h, crop_w, lpips_params, spatial_lr_scale,
                            rasterize)
    return step.init, step


def stack_frames(frames: List[Frame]) -> Frame:
    """The frames' tensors stacked on a new leading dim (the cameras' too;
    their sizes must agree), the int fields as tuples; frame_at takes one back."""
    cams = [f.camera for f in frames]
    if len({(c.height, c.width) for c in cams}) != 1:
        raise ValueError("stack_frames needs one image size")
    camera = Camera(**{k: torch.stack([getattr(c, k) for c in cams])
                       for k in ("world_view", "full_proj", "cam_center", "tan_fovx",
                                 "tan_fovy")}, height=cams[0].height, width=cams[0].width)
    fields = {}
    for f in dataclasses.fields(Frame):
        if f.name == "camera":
            continue
        vals = [getattr(fr, f.name) for fr in frames]
        fields[f.name] = torch.stack(vals) if isinstance(vals[0], torch.Tensor) else tuple(vals)
    return Frame(camera=camera, **fields)


def frame_at(frames_all, i: int) -> Frame:
    """Frame i of a list of Frames or of stack_frames' stack."""
    if not isinstance(frames_all, Frame):
        return frames_all[i]
    cam = frames_all.camera
    camera = dataclasses.replace(cam, **{k: getattr(cam, k)[i] for k in (
        "world_view", "full_proj", "cam_center", "tan_fovx", "tan_fovy")})
    return Frame(camera=camera, **{f.name: getattr(frames_all, f.name)[i]
                                   for f in dataclasses.fields(Frame) if f.name != "camera"})
