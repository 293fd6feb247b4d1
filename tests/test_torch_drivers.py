"""The port's drivers end to end on the CPU: the counterpart of
tests/test_drivers.py::test_train_then_render_cli, run in-process through
main(argv) with --device cpu.

moss_torch.cli.train_zju trains 20 iterations at capacity 512 on
tests/test_readers.py's ZJU fixture (60 frames: 12 train, 8 test), then
moss_torch.cli.render_zju renders the test split with --iterations -1:
the artifacts (chkpnt20.npz, point_cloud.ply and the reference layout,
cfg.json, cameras.json, the result lines with the random-backbone note),
the render's JSON line with raster_overflow 0, its served frames through
the installed pair budgets bitwise the per-frame list's, and its smpl_rot
cache; then a render from the reference layout alone, with LPIPS weights
passed by --lpips_weights.

moss_torch.cli.train_monocap (the counterpart of train_monocap.py) trains 10
iterations on tests/test_torch_readers.py's MonoCap fixture at its full
resolution, with --tensorboard, --gui_port (no viewer connects) and
--debug_nans, then render_zju --reader monocap --novel_view 4 renders four
orbit views about each of the 17 test poses; under --dispatch scan it
reaches Trainer.train with the scan engine and writes queued's checkpoint.
"""
import glob
import json
import os
import socket

import numpy as np

from moss_tpu.ops import lpips_jax
import torch

from moss_torch.cli import render_monocap, render_zju, train_monocap, train_zju
from moss_torch.ops import lpips
from moss_torch.train import checkpoint as ckpt
from test_readers import _write_zju_fixture
from test_torch_readers import write_monocap_fixture
from _torch_threads import two_torch_threads  # noqa: F401


def last_json(out):
    return json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


def test_train_then_render_cli(tmp_path, capsys, monkeypatch):
    data_root, out = tmp_path / "zju", tmp_path / "out"
    result_file = tmp_path / "result" / "ZJU.txt"
    _write_zju_fixture(str(data_root / "my_377"), n_frames=60)
    train_zju.main(["--data_root", str(data_root), "--subjects", "377", "--iterations", "20",
                    "--test_iterations", "20", "--save_iterations", "20", "--crop", "32",
                    "--capacity", "512", "--n_init", "100", "--output", str(out),
                    "--result_file", str(result_file), "--device", "cpu"])
    model_path = out / "my_377"
    for rel in ("chkpnt20.npz", "point_cloud.ply", "point_cloud/iteration_20/point_cloud.ply",
                "mlp_ckpt/iteration_20/ckpt.npz"):
        assert (model_path / rel).exists(), rel
    cams = json.load(open(model_path / "cameras.json"))
    assert len(cams) == 8 + 12 and {"position", "rotation", "fx", "fy"} <= set(cams[0])
    cfg = json.load(open(model_path / "cfg.json"))
    assert cfg["model"]["capacity"] == 512 and cfg["optim"]["iterations"] == 20
    lines = [line for line in open(result_file).read().splitlines() if line.strip()]
    assert lines[0] == "my_377"
    parts = lines[1].split()  # "iter PSNR SSIM LPIPSx1000  # note"
    assert int(parts[0]) == 20 and float(parts[1]) > 0 and lines[1].endswith(lpips.RANDOM_NOTE)
    ts = ckpt.restore_checkpoint(str(model_path / "chkpnt20.npz"), "cpu")
    assert ts.step == 20 and ts.params["gauss"].capacity == 512
    capsys.readouterr()

    # every cached render goes through the installed budgets; each is held
    # to the same render on the per-frame pair list, bit for bit
    served = []

    def spy(*a, **kw):
        out = render_frame(*a, **kw)
        if kw.get("cached_transforms") is not None:
            ref = render_frame(*a, **{**kw, "rasterize_fn": None})
            served.append((kw["rasterize_fn"], out, ref))
        return out

    render_frame = render_zju.render_frame
    monkeypatch.setattr(render_zju, "render_frame", spy)
    render_zju.main(["--data_root", str(data_root), "--subjects", "377", "--iterations", "-1",
                     "--output", str(out), "--device", "cpu"])
    monkeypatch.undo()
    result = last_json(capsys.readouterr().out)
    assert len(served) == 1 + 8  # the warm-up and the eight test frames
    for raster, out_b, ref in served:
        assert raster.keywords["max_tiles_per_gaussian"] >= 16
        assert int(out_b["overflow"]) == 0
        for k in ("render", "render_alpha", "render_depth", "final_T"):
            assert torch.equal(out_b[k], ref[k]), k
    assert result["raster_overflow"] == 0
    assert result["subject"] == "377" and result["iteration"] == 20
    assert result["fps"] > 0 and np.isfinite(result["psnr"]) and result["psnr"] > 5
    assert result["lpips_backbone"] == "random" and result["lpips_note"] == lpips.RANDOM_NOTE
    assert (model_path / "smpl_rot" / "iteration_20" / "smpl_rot.pickle").exists()

    # the reference layout alone, with LPIPS weights from a file
    os.remove(model_path / "chkpnt20.npz")
    weights = str(tmp_path / "lpips.npz")
    jp = lpips_jax.init_random(7)
    np.savez(weights, **{f"conv{i}_{j}_{k}": layer[k] for i, block in enumerate(jp["convs"])
                         for j, layer in enumerate(block) for k in ("w", "b")},
             **{f"lin{i}": lin for i, lin in enumerate(jp["lins"])})
    render_zju.main(["--data_root", str(data_root), "--subjects", "377", "--iterations", "20",
                     "--output", str(out), "--lpips_weights", weights, "--device", "cpu",
                     "--save_images"])
    again = last_json(capsys.readouterr().out)
    assert again["iteration"] == 20 and again["lpips_backbone"] == "pretrained"
    assert "lpips_note" not in again and np.isfinite(again["psnr"])
    assert len(list((model_path / "renders" / "iteration_20").glob("*.png"))) == 8


def test_render_monocap_fills_in_the_monocap_defaults(monkeypatch):
    seen = []
    monkeypatch.setattr(render_zju, "main", seen.append)
    render_monocap.main(["--data_root", "/data/monocap", "--device", "cpu"])
    args = render_zju.parse_args(seen[0])
    assert args.reader == "monocap" and args.output == "output/monocap"
    assert list(zip(args.subjects, args.iterations)) == [
        ("olek_images0812", 3000), ("lan_images620", 3000), ("marc_images35000", 2500),
        ("vlad_images1011", 2500)]


def test_train_monocap_then_render_novel_views(tmp_path, capsys):
    seq = "olek_images0812"
    data_root, out = tmp_path / "monocap", tmp_path / "out"
    result_file = tmp_path / "result" / "monocap.txt"
    write_monocap_fixture(str(data_root / seq))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    train_monocap.main(["--data_root", str(data_root), "--sequences", seq, "--iterations", "10",
                        "--test_iterations", "10", "--save_iterations", "10", "--capacity", "512", "--n_init", "100", "--output", str(out),
                        "--result_file", str(result_file), "--tensorboard", "--gui_port",
                        str(port), "--debug_nans", "--device", "cpu"])
    assert not torch.is_anomaly_enabled()  # the driver restores the anomaly mode
    model_path = out / seq
    for rel in ("chkpnt10.npz", "point_cloud.ply", "cfg.json", "cameras.json",
                "point_cloud/iteration_10/point_cloud.ply", "mlp_ckpt/iteration_10/ckpt.npz"):
        assert (model_path / rel).exists(), rel
    assert glob.glob(str(model_path / "events.out.tfevents.*"))
    lines = [line for line in open(result_file).read().splitlines() if line.strip()]
    assert lines[0] == seq and int(lines[1].split()[0]) == 10
    assert lines[1].endswith(lpips.RANDOM_NOTE)
    capsys.readouterr()

    render_zju.main(["--data_root", str(data_root), "--reader", "monocap", "--subjects", seq,
                     "--iterations", "-1", "--output", str(out), "--novel_view", "4",
                     "--device", "cpu"])
    result = last_json(capsys.readouterr().out)
    assert result["subject"] == seq and result["iteration"] == 10 and result["fps"] > 0
    assert result["novel_views"] == 17 * 4 and result["raster_overflow"] == 0
    img_dir = model_path / "renders" / "novel_view_iteration_10"
    assert result["img_dir"] == str(img_dir)
    assert len(list(img_dir.glob("*.png"))) == 17 * 4


def test_dispatch_parses_in_both_drivers():
    """--dispatch {queued,scan,eager}, queued by default, as train_zju.py:58."""
    for mod in (train_zju, train_monocap):
        assert mod.parse_args(["--data_root", "d"]).dispatch == "queued"
        for engine in ("queued", "scan", "eager"):
            assert mod.parse_args(["--data_root", "d", "--dispatch", engine]).dispatch == engine
        try:
            mod.parse_args(["--data_root", "d", "--dispatch", "fast"])
        except SystemExit as e:
            assert e.code == 2
        else:
            raise AssertionError("--dispatch fast was accepted")


def test_dispatch_reaches_the_trainer(tmp_path, monkeypatch):
    """train_zju hands --dispatch to Trainer.train; the run stops there."""
    from moss_torch.train.trainer import Trainer

    data_root = tmp_path / "zju"
    _write_zju_fixture(str(data_root / "my_377"), n_frames=20)
    seen = {}

    class Stop(Exception):
        pass

    def train(self, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(Trainer, "train", train)
    try:
        train_zju.main(["--data_root", str(data_root), "--subjects", "377", "--iterations", "2",
                        "--crop", "32", "--capacity", "512", "--n_init", "100", "--output",
                        str(tmp_path / "out"), "--result_file", str(tmp_path / "r.txt"),
                        "--device", "cpu", "--dispatch", "scan"])
    except Stop:
        pass
    assert seen["dispatch_engine"] == "scan"


def test_train_monocap_scan_gives_queueds_checkpoint(tmp_path, monkeypatch):
    """train_monocap --dispatch scan reaches Trainer.train with
    dispatch_engine "scan" and writes the queued run's chkpnt, bit for bit."""
    from moss_torch.train.trainer import Trainer

    seq = "olek_images0812"
    data_root = tmp_path / "monocap"
    write_monocap_fixture(str(data_root / seq))
    engines, train = [], Trainer.train

    def spy(self, *a, **kw):
        engines.append(kw["dispatch_engine"])
        return train(self, *a, **kw)

    monkeypatch.setattr(Trainer, "train", spy)
    # each step computes its frame's LPIPS towers (not the 100 frames' up front)
    monkeypatch.setenv("MOSS_LPIPS_GT_CACHE", "0")
    ckpts = {}
    for engine in ("queued", "scan"):
        out = tmp_path / engine
        train_monocap.main(["--data_root", str(data_root), "--sequences", seq, "--iterations", "6",
                            "--test_iterations", "6", "--save_iterations", "6", "--capacity",
                            "512", "--n_init", "100", "--output", str(out), "--result_file",
                            str(tmp_path / f"{engine}.txt"), "--dispatch", engine,
                            "--device", "cpu"])
        with np.load(out / seq / "chkpnt6.npz") as data:
            ckpts[engine] = dict(data)
    assert engines == ["queued", "scan"]
    assert sorted(ckpts["queued"]) == sorted(ckpts["scan"]) and ckpts["scan"][".step"] == 6
    for k, v in ckpts["queued"].items():
        assert v.dtype == ckpts["scan"][k].dtype and np.array_equal(v, ckpts["scan"][k]), k
