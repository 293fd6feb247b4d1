"""Serve trained avatars with the port: render the ZJU-MoCap-Refine test
split from a checkpoint (the counterpart of the repository's render_zju.py,
after the reference's render_ZJU.py).

Per subject: read the test split and the saved cfg.json (which decides the
model fields), resolve --iterations -1 to the newest checkpoint on disk,
load chkpnt{N}.npz or else the reference layout (point_cloud/iteration_N/ +
mlp_ckpt/iteration_N/), fit the capacity to the live cloud unless
--keep_capacity, cache each pose's transforms once (written to
smpl_rot/iteration_N/smpl_rot.pickle as numpy), time the cached MLP-free
render of every test frame and print one JSON line: subject, iteration, fps,
psnr, ssim, lpips_x1000, the LPIPS backbone and raster_overflow. --novel_view
N renders instead N orbit views about each test pose (render/novel_view.py:
each pose decoded once, its camera swapped for the orbit's), writes them all
to renders/novel_view_iteration_N/ and prints subject, iteration, fps,
novel_views, img_dir (no ground truth exists at those viewpoints) and
raster_overflow. Runs on the GPU; --device cpu runs the plain PyTorch path.

The cached renders bin at the static pair budgets the trainer probed on the
first served frame after the load and the compaction (trainer._eval_raster,
as the repository's render_zju.py renders through trainer.rasterize_fn), so
a served frame makes no host read in binning. raster_overflow is the pairs
those budgets dropped, summed over the served frames; a frame that drops
pairs is reported there, not rendered again.

    python -m moss_torch.cli.render_zju --data_root /data/zju_mocap --subjects 377 \\
        --iterations -1
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import pickle
import re
import time

import numpy as np
import torch

from .. import resolve_device
from ..config import Config, ModelConfig, load_json
from ..data.readers import read_monocap, read_zju_mocap_refine
from ..ops import lpips
from ..ops.ssim import psnr as psnr_fn
from ..ops.ssim import ssim as ssim_fn
from ..render.novel_view import novel_view_specs
from ..render.render import render_frame
from ..train.checkpoint import load_reference_layout
from ..train.trainer import Trainer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", required=True)
    p.add_argument("--smpl", default=None)
    p.add_argument("--subjects", nargs="+", default=["377", "386", "387", "392", "393", "394"])
    p.add_argument("--iterations", nargs="+", type=int, default=[2700, 2700, 3000, 3000, 2500, 2700],
                   help="the iteration per subject (the reference's best); -1: the newest")
    p.add_argument("--output", default="output/zju_mocap_refine")
    p.add_argument("--save_images", action="store_true")
    p.add_argument("--white_background", action="store_true")
    p.add_argument("--reader", default="zju", choices=["zju", "monocap"])
    p.add_argument("--keep_capacity", action="store_true",
                   help="render inside the training capacity (no compact_for_eval)")
    p.add_argument("--lpips_weights", default=None,
                   help="LPIPS weights (.npz, ops/lpips.load_params); else a random backbone, "
                        "whose values are marked as not comparable")
    p.add_argument("--novel_view", type=int, default=0, metavar="N",
                   help="render N orbit views evenly spaced over the whole circle about each "
                        "test pose instead of the test views (no metrics; PNGs always saved)")
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    return p.parse_args(argv)


def latest_iteration(model_path: str) -> int:
    """The newest iteration of either layout under model_path."""
    cands = glob.glob(os.path.join(model_path, "chkpnt*.npz"))
    cands += glob.glob(os.path.join(model_path, "point_cloud", "iteration_*"))
    if not cands:
        raise FileNotFoundError(f"no checkpoints under {model_path}")
    return max(int(re.findall(r"(\d+)", os.path.basename(p))[0]) for p in cands)


def render_subject(args, subject: str, iteration: int, device):
    zju = args.reader == "zju"
    reader = read_zju_mocap_refine if zju else read_monocap
    name = f"my_{subject}" if zju else subject
    scene, test_specs = reader(os.path.join(args.data_root, name), "test",
                               args.white_background, smpl_path=args.smpl, device=device)
    if args.novel_view:
        # camera_view_num = N: N views over the whole orbit (36, the reference's)
        test_specs = novel_view_specs(test_specs, dataset=args.reader, n_views=args.novel_view,
                                      camera_view_num=args.novel_view)
        # decode each pose once; its orbit views only swap the camera
        loaded, test_frames = {}, []
        for s in test_specs:
            if s.pose_id not in loaded:
                loaded[s.pose_id] = s.load(None, device)
            f = loaded[s.pose_id]
            test_frames.append(dataclasses.replace(
                f, camera=s.make_camera((f.camera.height, f.camera.width), device)))
    else:
        test_frames = [s.load(None, device) for s in test_specs]
    model_path = os.path.join(args.output, name)
    cfg_json = os.path.join(model_path, "cfg.json")
    # the saved training config decides the model fields (capacity, SH degree, MLPs)
    cfg = load_json(cfg_json) if os.path.exists(cfg_json) else Config(
        model=ModelConfig(white_background=args.white_background))
    cfg = dataclasses.replace(cfg, model_path=model_path)
    lp, kind, note = lpips.backbone(args.lpips_weights, device)
    trainer = Trainer(scene, test_frames[:1], test_frames, cfg, lp, lpips_backbone=kind,
                      device=device)
    if iteration < 0:
        iteration = latest_iteration(model_path)
        print(f"[{subject}] loading latest iteration {iteration}")
    ckpt_path = os.path.join(model_path, f"chkpnt{iteration}.npz")
    if os.path.exists(ckpt_path):
        trainer.load(ckpt_path)
    else:
        trainer.set_state(load_reference_layout(model_path, iteration, trainer.ts))
    if not args.keep_capacity:
        cap = trainer.compact_for_eval()
        print(f"[{subject}] eval capacity fit: {int(trainer.ts.gstate.valid.sum())} live "
              f"points in {cap}-slot buffer")

    # 1. each pose's transforms, once (the MLP-free eval path)
    smpl_rot = {}
    for frame in test_frames:
        if frame.pose_id not in smpl_rot:
            out = trainer.render_eval(frame)
            smpl_rot[frame.pose_id] = (out["transforms"], out["translation"])
    cache_dir = os.path.join(model_path, "smpl_rot", f"iteration_{iteration}")
    os.makedirs(cache_dir, exist_ok=True)
    with open(os.path.join(cache_dir, "smpl_rot.pickle"), "wb") as f:
        pickle.dump({k: tuple(None if t is None else t.cpu().numpy() for t in v)
                     for k, v in smpl_rot.items()}, f)

    # 2. the cached render of every test frame through the installed budgets,
    # timed, then the metrics
    ts, bg, raster = trainer.ts, trainer.bg, trainer._eval_raster

    def cached_render(frame):
        transforms, translation = smpl_rot[frame.pose_id]
        out = render_frame(ts.params["gauss"], ts.gstate.valid, ts.params.get("mlps"), scene,
                           frame.smpl_params, frame.camera, bg, cfg.model.sh_degree,
                           rasterize_fn=raster, cached_transforms=transforms,
                           cached_translation=translation, motion_offset=cfg.model.motion_offset,
                           static_scene=cfg.model.static_scene, device=device)
        return out["render"], out["overflow"]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with torch.no_grad():
        cached_render(test_frames[0])  # warm-up
        sync()
        t0 = time.perf_counter()
        renders, overflow = zip(*[cached_render(frame) for frame in test_frames])
        sync()
        fps = len(test_frames) / (time.perf_counter() - t0)
        overflow = int(torch.stack(overflow).sum())
        if args.novel_view:
            img_dir = os.path.join(model_path, "renders", f"novel_view_iteration_{iteration}")
            write_pngs(img_dir, renders)
            result = {"subject": subject, "iteration": iteration, "fps": fps,
                      "novel_views": len(test_frames), "img_dir": img_dir,
                      "raster_overflow": overflow}
            print(json.dumps(result))
            return result
        img_dir = os.path.join(model_path, "renders", f"iteration_{iteration}")
        sums = np.zeros(3)
        for frame, img in zip(test_frames, renders):
            img = torch.clamp(img, 0.0, 1.0)
            gt = torch.clamp(frame.image, 0.0, 1.0)
            sums += [float(psnr_fn(img, gt)), float(ssim_fn(img, gt)),
                     float(lpips.lpips(lp, img, gt))]
        if args.save_images:
            write_pngs(img_dir, renders)
    n = len(test_frames)
    result = {"subject": subject, "iteration": iteration, "fps": fps, "psnr": sums[0] / n,
              "ssim": sums[1] / n, "lpips_x1000": sums[2] / n * 1000, "lpips_backbone": kind,
              "raster_overflow": overflow}
    if note:
        result["lpips_note"] = note
    print(json.dumps(result))
    return result


def write_pngs(img_dir: str, renders):
    """Each render, clipped to [0, 1], as <img_dir>/<index:05d>.png."""
    import imageio.v2 as imageio

    os.makedirs(img_dir, exist_ok=True)
    for i, img in enumerate(renders):
        imageio.imwrite(os.path.join(img_dir, f"{i:05d}.png"),
                        (torch.clamp(img, 0.0, 1.0).cpu().numpy() * 255).astype(np.uint8))


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    return [render_subject(args, subject, iteration, device)
            for subject, iteration in zip(args.subjects, args.iterations)]


if __name__ == "__main__":
    main()
