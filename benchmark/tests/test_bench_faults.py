"""A run with the timed path broken underneath comes out not correct: the
faults a training cell can have, planted in the port, at the small size on
the CPU; and the control (TF32 on) on the card."""
from __future__ import annotations

import json
import os

import pytest
import torch

from benchmark import run
from benchmark.tests.small import small

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(cell="zju.steady", device=CPU):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    c, w = small(cell)
    out, lines = run.measure(bench, cell, 13, 0.0, False, device, config=c, workload_data=w)
    return out


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_fault_is_not_correct(fault):
    from benchmark.control import MODES

    with MODES[fault]():
        assert not measure()["correct"]


@pytest.mark.cuda
def test_control_fails_on_the_card():
    """The program with TF32 on, at the small size on the card: some number
    over its limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from benchmark import check, control

    c, w = small("zju.steady")
    dev = torch.device("cuda", 0)
    lower = [check.judge(control.readings("zju.steady", s, "program", dev, c, w), w["limits"],
                         0)[0] for s in (21, 22, 23)]
    upper = [check.judge(control.readings("zju.steady", s, "tf32", dev, c, w), w["limits"],
                         0)[0] for s in (21, 22, 23)]
    assert all(lower) and not any(upper)
