"""Train avatars on ZJU-MoCap-Refine subjects with the port (the counterpart
of the repository's train_zju.py, after the reference's train_ZJU.py).

One eager process per subject: read the subject, train, write
point_cloud/iteration_N/ and mlp_ckpt/iteration_N/ at --save_iterations (the
state before step N), chkpnt{N}.npz at --test_iterations (the state after
step N; --resume continues from the newest), append the evals to the result
file ('iter psnr ssim lpips*1000'), then write point_cloud.ply, cfg.json and
cameras.json. Runs on the GPU; --device cpu runs the plain PyTorch path.

    python -m moss_torch.cli.train_zju --data_root /data/zju_mocap \\
        --smpl assets/SMPL_NEUTRAL.pkl --subjects 377 386
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from .. import resolve_device
from ..config import Config, ModelConfig, OptimConfig, PipelineConfig, save_json
from ..data.ply import save_ply
from ..data.readers import autosize_crop, read_zju_mocap_refine
from ..ops import lpips
from ..render.camera import dump_cameras_json
from ..train.checkpoint import save_reference_layout
from ..train.observability import EMALogger, append_result_line, install_timestamped_stdout
from ..train.trainer import Trainer


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", required=True, help="the directory holding my_<subject>/")
    p.add_argument("--smpl", default=None, help="SMPL_NEUTRAL.pkl (else the synthetic rig)")
    p.add_argument("--subjects", nargs="+", default=["377", "386", "387", "392", "393", "394"])
    p.add_argument("--iterations", type=int, default=3000)
    p.add_argument("--test_iterations", nargs="+", type=int, default=[2500, 2700, 3000])
    p.add_argument("--save_iterations", nargs="+", type=int, default=[2500, 2700, 3000],
                   help="reference-layout saves, independent of --test_iterations")
    p.add_argument("--output", default="output/zju_mocap_refine")
    p.add_argument("--result_file", default="result/ZJU.txt")
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
    p.add_argument("--quiet", action="store_true", help="silence stdout")
    p.add_argument("--device", default=None, help="torch device (default: the GPU)")
    return p.parse_args(argv)


def train_subject(args, subject: str, device):
    path = os.path.join(args.data_root, f"my_{subject}")
    print(f"[{subject}] reading {path}")
    scene, train_specs = read_zju_mocap_refine(path, "train", args.white_background,
                                               smpl_path=args.smpl, device=device)
    _, test_specs = read_zju_mocap_refine(path, "test", args.white_background,
                                          smpl_path=args.smpl, device=device)
    crop_hw = (args.crop, args.crop) if args.crop > 0 else autosize_crop(train_specs)
    print(f"[{subject}] loss crop {crop_hw}")
    train_frames = [s.load(crop_hw, device) for s in train_specs]
    # the test split stays lazy: the trainer's evals stream it
    test_hw = test_specs[0].image_size() if test_specs else None
    test_cameras = [s.make_camera(test_hw, device) for s in test_specs]

    cfg = Config(
        model=ModelConfig(white_background=args.white_background, capacity=args.capacity,
                          n_init_points=args.n_init),
        optim=OptimConfig(iterations=args.iterations),
        pipe=PipelineConfig(test_iterations=tuple(args.test_iterations),
                            save_iterations=tuple(args.save_iterations)),
        exp_name=f"zju_mocap_refine/my_{subject}",
        model_path=os.path.join(args.output, f"my_{subject}"))
    save_json(cfg, os.path.join(cfg.model_path, "cfg.json"))
    dump_cameras_json(os.path.join(cfg.model_path, "cameras.json"),
                      test_cameras + [f.camera for f in train_frames])
    lp, _, note = lpips.backbone(args.lpips_weights, device)
    ema, t0 = EMALogger(), time.time()

    def log(it, logs):
        sm = ema.update(logs)
        if it % 100 == 0:
            msg = " ".join(f"{k}={sm[k]:.4f}" for k in ("loss", "l1", "ssim") if k in sm)
            print(f"[{subject}] iter {it} {msg} pts={int(logs['num_points'])} "
                  f"({time.time() - t0:.0f}s)")

    trainer = Trainer(scene, train_frames, test_specs, cfg, lp, crop_hw=crop_hw, log_fn=log,
                      device=device)
    if args.resume:
        resumed = trainer.resume_latest(cfg.model_path)
        if resumed:
            print(f"[{subject}] resumed from iteration {resumed}")
    metrics = trainer.train(
        eval_iters=args.test_iterations, save_iters=args.save_iterations,
        # the state before step N, as the reference's in-loop scene.save
        save_fn=lambda it: save_reference_layout(cfg.model_path, it, trainer.ts),
        # the state after step N, as the reference's torch.save(capture())
        ckpt_fn=lambda it: trainer.save(os.path.join(cfg.model_path, f"chkpnt{it}.npz")))
    for m in metrics:
        append_result_line(args.result_file, m["iteration"], m["psnr"], m["ssim"], m["lpips"],
                           note=note)
        print(f"[{subject}] iter {m['iteration']}: PSNR {m['psnr']:.3f} SSIM {m['ssim']:.5f} "
              f"LPIPSx1e3 {m['lpips'] * 1000:.3f}")
    g, valid = trainer.ts.params["gauss"], trainer.ts.gstate.valid
    save_ply(os.path.join(cfg.model_path, "point_cloud.ply"),
             *(getattr(g, f)[valid] for f in ("xyz", "f_dc", "f_rest", "opacity", "scaling",
                                              "rotation")))
    return metrics


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    stdout = sys.stdout
    install_timestamped_stdout(quiet=args.quiet)
    try:
        os.makedirs(os.path.dirname(args.result_file) or ".", exist_ok=True)
        for subject in args.subjects:
            with open(args.result_file, "a") as f:
                f.write(f"\nmy_{subject}\n")
            train_subject(args, subject, device)
        print("\nTraining complete.")
    finally:
        sys.stdout = stdout


if __name__ == "__main__":
    main()
