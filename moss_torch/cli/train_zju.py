"""Train avatars on ZJU-MoCap-Refine subjects with the port (the counterpart
of the repository's train_zju.py, after the reference's train_ZJU.py).

One process per subject: read the subject, train, write
point_cloud/iteration_N/ and mlp_ckpt/iteration_N/ at --save_iterations (the
state before step N), chkpnt{N}.npz at --test_iterations (the state after
step N; --resume continues from the newest), append the evals to the result
file ('iter psnr ssim lpips*1000'), then write point_cloud.ply, cfg.json and
cameras.json. Runs on the GPU; --device cpu runs the plain PyTorch path.
--tensorboard logs to the output directory (tensorboardX), --gui_port serves
the SIBR remote viewer, --debug_nans turns on autograd's anomaly mode (the
loss of every step is checked finite in any case, and a non-finite one
raises with its iteration). --dispatch picks the trainer's engine (queued,
the default, scan or eager: train/trainer.py). --rasterizer reference
trains and evaluates through the plain blend (ops/rasterize_ref.py) with no
pair budgets, on the card too: an oracle for the default, cuda (the blend
kernels with the static budgets).

Several ranks (one process each, the same command) train one avatar over
pixel bands and frames: --coordinator host:port --num_processes N
--process_id i, or torchrun's environment; --n_data/--n_tile lay the ranks
out (0 0 factors automatically). Only rank 0 writes files. They run the
queued engine (the default; --dispatch scan prints a line and runs it too,
no CUDA graph being taken over collectives) or eager, with budgets probed
per band and full-image ones for the evals.

    python -m moss_torch.cli.train_zju --data_root /data/zju_mocap \\
        --smpl assets/SMPL_NEUTRAL.pkl --subjects 377 386
    torchrun --nproc_per_node 4 -m moss_torch.cli.train_zju --data_root /data/zju_mocap \\
        --subjects 377 --n_data 1 --n_tile 4
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .. import resolve_device
from ..config import Config, ModelConfig, OptimConfig, PipelineConfig, save_json
from ..data.ply import save_ply
from ..data.readers import autosize_crop, read_zju_mocap_refine
from ..ops import lpips
from ..parallel import distributed
from ..render.camera import dump_cameras_json
from ..train.checkpoint import save_reference_layout
from ..train.network_gui import NetworkGUI
from ..train.observability import (EMALogger, TBWriter, append_result_line,
                                   install_timestamped_stdout)
from ..train.trainer import Trainer


def add_training_args(p: argparse.ArgumentParser, output: str, result_file: str):
    """The flags the two training drivers share."""
    p.add_argument("--data_root", required=True)
    p.add_argument("--smpl", default=None, help="SMPL_NEUTRAL.pkl (else the synthetic rig)")
    p.add_argument("--iterations", type=int, default=3000)
    p.add_argument("--test_iterations", nargs="+", type=int, default=[2500, 2700, 3000])
    p.add_argument("--save_iterations", nargs="+", type=int, default=[2500, 2700, 3000],
                   help="reference-layout saves, independent of --test_iterations")
    p.add_argument("--output", default=output)
    p.add_argument("--result_file", default=result_file)
    p.add_argument("--white_background", action="store_true")
    p.add_argument("--crop", type=int, default=0,
                   help="the loss crop; 0 sizes it to the split's largest bound rect")
    p.add_argument("--capacity", type=int, default=46080)
    p.add_argument("--n_init", type=int, default=6890, help="initial points (SMPL vertices)")
    p.add_argument("--lpips_weights", default=None,
                   help="LPIPS weights (.npz, ops/lpips.load_params); else a random backbone, "
                        "whose values are marked as not comparable")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest chkpnt*.npz in the output directory")
    p.add_argument("--tensorboard", action="store_true",
                   help="TensorBoard logs in the output directory (needs tensorboardX)")
    p.add_argument("--gui_port", type=int, default=0,
                   help="the SIBR remote viewer's port (0: off)")
    p.add_argument("--debug_nans", action="store_true",
                   help="autograd anomaly mode: the backward op that makes a NaN raises")
    p.add_argument("--coordinator", default=None,
                   help="several ranks: host:port of rank 0 (each rank runs the same command "
                        "with its own --process_id)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--n_data", type=int, default=0, help="frames a step (data rows of the mesh)")
    p.add_argument("--n_tile", type=int, default=0, help="pixel bands a frame (ranks per frame)")
    p.add_argument("--dispatch", choices=["queued", "scan", "eager"], default="queued",
                   help="dispatch engine: queued (steps launched with no host read, logs read "
                        "at the host boundaries), scan (blocks of steps, each a CUDA graph of "
                        "the step replayed) or eager (a step at a time, logs read every 10)")
    p.add_argument("--rasterizer", choices=["cuda", "reference"], default="cuda",
                   help="cuda: the blend kernels with the static pair budgets; reference: the "
                        "plain blend with none, as moss_tpu's --rasterizer reference")
    p.add_argument("--quiet", action="store_true", help="silence stdout")
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    add_training_args(p, "output/zju_mocap_refine", "result/ZJU.txt")
    p.add_argument("--subjects", nargs="+", default=["377", "386", "387", "392", "393", "394"])
    return p.parse_args(argv)


def train_scene(args, name: str, path: str, reader, exp_name: str, device, mesh=None):
    """Read one subject or sequence (`name` in the log; its files under
    `path`, its outputs under --output/<path's last directory>) with
    `reader`, train it and write what the module docstring lists (rank 0
    only). Returns the eval metrics."""
    is_main = mesh is None or mesh.is_main
    print(f"[{name}] reading {path}")
    scene, train_specs = reader(path, "train", args.white_background, smpl_path=args.smpl,
                                device=device)
    _, test_specs = reader(path, "test", args.white_background, smpl_path=args.smpl,
                           device=device)
    crop_hw = (args.crop, args.crop) if args.crop > 0 else autosize_crop(train_specs)
    print(f"[{name}] loss crop {crop_hw}")
    train_frames = [s.load(crop_hw, device) for s in train_specs]
    # the test split stays lazy: the trainer's evals stream it
    test_hw = test_specs[0].image_size() if test_specs else None
    test_cameras = [s.make_camera(test_hw, device) for s in test_specs]

    cfg = Config(
        model=ModelConfig(white_background=args.white_background, capacity=args.capacity,
                          n_init_points=args.n_init),
        optim=OptimConfig(iterations=args.iterations),
        pipe=PipelineConfig(rasterizer=args.rasterizer,
                            test_iterations=tuple(args.test_iterations),
                            save_iterations=tuple(args.save_iterations)),
        exp_name=exp_name, model_path=os.path.join(args.output, os.path.basename(path)))
    if is_main:
        save_json(cfg, os.path.join(cfg.model_path, "cfg.json"))
        dump_cameras_json(os.path.join(cfg.model_path, "cameras.json"),
                          test_cameras + [f.camera for f in train_frames])
    lp, kind, note = lpips.backbone(args.lpips_weights, device)
    tb = TBWriter(cfg.model_path if args.tensorboard and is_main else None)
    ema, t0 = EMALogger(), time.time()

    def log(it, logs):
        sm = ema.update(logs)
        tb.scalars(logs, it)
        if it % 100 == 0 and is_main:
            msg = " ".join(f"{k}={sm[k]:.4f}" for k in ("loss", "l1", "ssim") if k in sm)
            print(f"[{name}] iter {it} {msg} pts={int(logs['num_points'])} "
                  f"({time.time() - t0:.0f}s)")

    gui = None
    if args.gui_port and is_main:
        gui = NetworkGUI(port=args.gui_port)
        gui.init()
    trainer = Trainer(scene, train_frames, test_specs, cfg, lp, crop_hw=crop_hw, log_fn=log,
                      tb=tb, mesh=mesh, gui=gui, source_path=path, lpips_backbone=kind,
                      device=device)
    try:
        if args.resume:
            resumed = trainer.resume_latest(cfg.model_path)
            if resumed:
                print(f"[{name}] resumed from iteration {resumed}")

        def save_at(it):
            # the state before step N, as the reference's in-loop scene.save
            if is_main:
                save_reference_layout(cfg.model_path, it, trainer.ts)

        def ckpt_at(it):
            # the state after step N, as the reference's torch.save(capture())
            if is_main:
                trainer.save(os.path.join(cfg.model_path, f"chkpnt{it}.npz"))

        metrics = trainer.train(eval_iters=args.test_iterations,
                                save_iters=args.save_iterations, save_fn=save_at,
                                ckpt_fn=ckpt_at, dispatch_engine=args.dispatch)
    finally:
        tb.close()
        if gui is not None:
            gui.close()
    if is_main:
        for m in metrics:
            append_result_line(args.result_file, m["iteration"], m["psnr"], m["ssim"],
                               m["lpips"], note=note)
            print(f"[{name}] iter {m['iteration']}: PSNR {m['psnr']:.3f} SSIM "
                  f"{m['ssim']:.5f} LPIPSx1e3 {m['lpips'] * 1000:.3f}")
        g, valid = trainer.ts.params["gauss"], trainer.ts.gstate.valid
        save_ply(os.path.join(cfg.model_path, "point_cloud.ply"),
                 *(getattr(g, f)[valid] for f in ("xyz", "f_dc", "f_rest", "opacity",
                                                  "scaling", "rotation")))
    return metrics


def run(args, scenes):
    """Set up the device, the ranks and the logging, then train each
    (name, path, reader, exp_name) of `scenes`; the result file gets a
    header line of each path's last directory."""
    cpu = args.device is not None and torch.device(args.device).type == "cpu"
    distributed.initialize_distributed(args.coordinator, args.num_processes, args.process_id,
                                       backend="gloo" if cpu else None)
    device = resolve_device(args.device)
    mesh = None
    if args.n_data or args.n_tile or distributed.process_count() > 1:
        mesh = distributed.global_mesh(args.n_data, args.n_tile, device=device)
        print(f"mesh: data={mesh.n_data} tile={mesh.n_tile}")
    is_main = mesh is None or mesh.is_main
    stdout = sys.stdout
    install_timestamped_stdout(quiet=args.quiet or not is_main)
    anomaly = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(args.debug_nans or anomaly)
    try:
        if is_main:
            os.makedirs(os.path.dirname(args.result_file) or ".", exist_ok=True)
        out = []
        for name, path, reader, exp_name in scenes:
            if is_main:
                with open(args.result_file, "a") as f:
                    f.write(f"\n{os.path.basename(path)}\n")
            out.append(train_scene(args, name, path, reader, exp_name, device, mesh))
        print("\nTraining complete.")
        return out
    finally:
        torch.autograd.set_detect_anomaly(anomaly)
        sys.stdout = stdout


def main(argv=None):
    args = parse_args(argv)
    return run(args, [(s, os.path.join(args.data_root, f"my_{s}"), read_zju_mocap_refine,
                       f"zju_mocap_refine/my_{s}") for s in args.subjects])


if __name__ == "__main__":
    main()
