"""The reference against the port's CPU path at a small size, the inputs'
seeding, and a measurement that finds no card."""
from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import run
from benchmark.inputs import make_inputs
from benchmark.reference.blend import blend
from benchmark.reference.projection import Projected
from benchmark.tests.small import small

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def random_scene(n=300, H=40, W=56, seed=0):
    g = torch.Generator().manual_seed(seed)
    u = lambda *s: torch.rand(s, generator=g)  # noqa: E731
    a, c = 0.05 + 0.5 * u(n), 0.05 + 0.5 * u(n)
    b = (u(n) - 0.5) * 0.5 * torch.sqrt(a * c)
    conic = torch.stack([a, b, c], 1)
    det = a * c - b * b
    radius = torch.ceil(3 * torch.sqrt(torch.maximum(c, a) / det)).to(torch.int32)
    return Projected(mean2d=torch.stack([u(n) * W, u(n) * H], 1), depth=1 + u(n), conic=conic,
                     radius=radius, color=u(n, 3), opacity=0.1 + 0.89 * u(n),
                     valid=u(n) > 0.1)


@pytest.mark.parametrize("seed", [0, 1])
def test_blend_matches_the_ports_plain_blend(seed):
    """blend.py's images and grads are the port's rasterize_reference's."""
    from moss_torch.ops.rasterize_ref import rasterize_reference

    p = random_scene(seed=seed)
    leaves = {k: getattr(p, k).clone().requires_grad_() for k in
              ("mean2d", "conic", "color", "opacity", "depth")}
    outs = []
    for fn in (blend, lambda q, bg, h, w: rasterize_reference(q, bg, h, w, 16, 16)):
        q = p._replace(**leaves)
        out = fn(q, torch.tensor([0.1, 0.2, 0.3]), 40, 56)
        loss = sum((out[k] * (i + 1)).sin().sum() for i, k in
                   enumerate(("color", "depth", "alpha", "final_T")))
        outs.append((out, torch.autograd.grad(loss, list(leaves.values()))))
    (a, ga), (b, gb) = outs
    for k in ("color", "depth", "alpha", "final_T"):
        torch.testing.assert_close(a[k], b[k], atol=2e-5, rtol=0)
    for x, y in zip(ga, gb):
        assert float((x - y).abs().max()) <= 1e-4 * max(float(y.abs().max()), 1.0)


def test_inputs_follow_the_seed():
    """A seed gives the same inputs twice and other ones than another seed;
    a steady cell's geometry (rig, poses, cloud placement) is its
    geometry_seed's, the poses in the seed's order."""
    c, w = small("zju.steady")
    a, b, d = (make_inputs("zju.steady", s, CPU, config=c, workload=w) for s in (5, 5, 6))
    assert all(torch.equal(a.gauss[k], b.gauss[k]) for k in a.gauss)
    assert all(torch.equal(f.image, g.image) for f, g in zip(a.frames, b.frames))
    assert a.crop_hw == b.crop_hw and [f.crop_y0 for f in a.frames] == [f.crop_y0 for f in b.frames]
    assert torch.equal(a.gauss["xyz"], d.gauss["xyz"]) and torch.equal(a.rig.weights, d.rig.weights)
    assert sorted(f.pose_id for f in a.frames) == sorted(f.pose_id for f in d.frames)
    assert not torch.equal(a.gauss["f_dc"], d.gauss["f_dc"])
    assert not torch.equal(a.lpips["convs"][0][0]["w"], d.lpips["convs"][0][0]["w"])
    assert not any(torch.equal(f.image, g.image) for f, g in zip(a.frames, d.frames))


@pytest.mark.parametrize("cell", ["zju.steady", "monocap.steady"])
def test_reference_agrees_with_the_cpu_path(cell):
    """A whole run at the small size on the CPU (the port's plain path) is
    correct by the cell's limits."""
    c, w = small(cell)
    out, lines = run.measure(bench(), cell, 11, 0.0, False, CPU, config=c, workload_data=w)
    assert out["correct"], lines
    assert out["failed"] == 0 and out["attempted"] == 100


def test_no_card_no_result(capsys, monkeypatch):
    """The measurement path fails where there is no card: no fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "zju.steady", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_forbidden_module_after_the_reference_gives_no_result(monkeypatch):
    """A forbidden module loaded once the window has closed, here by the
    reference, leaves the run without a result."""
    import sys
    import types

    from benchmark import check

    real = check.reference_steps

    def loads_jax(*a, **k):
        monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
        return real(*a, **k)

    monkeypatch.setattr(check, "reference_steps", loads_jax)
    c, w = small("zju.steady")
    out, lines = run.measure(bench(), "zju.steady", 11, 0.0, False, CPU, config=c,
                             workload_data=w)
    assert out is None and "jax" in lines[0]


def test_change_gap_reads_the_worst_groups_median_leaf():
    """change_gap is the worst optimizer group's median leaf: one leaf of a
    larger group off reads 0, a group of one leaf off reads its gap."""
    from benchmark import check

    logs = [{"loss": 1.0, "l1": 1.0, "mask": 0.0, "ssim": 1.0, "lpips": 0.0, "nll": 0.0,
             "s3im": 0.0}]
    names = ["xyz/xyz", "lbs/a", "lbs/b", "lbs/value"]
    ref = {"logs": logs, "grad": {k: 1.0 for k in names}, "change": {k: 1.0 for k in names}}
    weights = type("W", (), dict(w_l1=1.0, w_mask=1.0, w_ssim=1.0, w_lpips=1.0, w_nll=1.0,
                                 w_s3im=1.0))
    prog = {**ref["change"], "lbs/value": 1.5}
    n = check.step_numbers(logs, ref["grad"], prog, ref, weights)
    assert n["change_gap"] == 0.0 and n["_change_gap_worst_leaf"] == 0.5
    prog = {**ref["change"], "xyz/xyz": 1.2}
    n = check.step_numbers(logs, ref["grad"], prog, ref, weights)
    assert abs(n["change_gap"] - 0.2) < 1e-12 and n["_change_group"] == "xyz"
