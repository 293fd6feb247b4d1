"""The port's drivers end to end on the CPU: the counterpart of
tests/test_drivers.py::test_train_then_render_cli, run in-process through
main(argv) with --device cpu.

moss_torch.cli.train_zju trains 20 iterations at capacity 512 on
tests/test_readers.py's ZJU fixture (60 frames: 12 train, 8 test), then
moss_torch.cli.render_zju renders the test split with --iterations -1:
the artifacts (chkpnt20.npz, point_cloud.ply and the reference layout,
cfg.json, cameras.json, the result lines with the random-backbone note),
the render's JSON line and its smpl_rot cache; then a render from the
reference layout alone, with LPIPS weights passed by --lpips_weights.
"""
import json
import os

import numpy as np

from moss_tpu.ops import lpips_jax
from moss_torch.cli import render_monocap, render_zju, train_zju
from moss_torch.ops import lpips
from moss_torch.train import checkpoint as ckpt
from test_readers import _write_zju_fixture
from _torch_threads import two_torch_threads  # noqa: F401


def last_json(out):
    return json.loads([line for line in out.splitlines() if line.startswith("{")][-1])


def test_train_then_render_cli(tmp_path, capsys):
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

    render_zju.main(["--data_root", str(data_root), "--subjects", "377", "--iterations", "-1",
                     "--output", str(out), "--device", "cpu"])
    result = last_json(capsys.readouterr().out)
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
