"""The benchmark's files: every name in BENCHMARK.json resolves to its file,
and a new configuration, cell or per-layer metric is a new file alone."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from benchmark.inputs import HERE, load_json

ROOT = os.path.dirname(HERE)


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_name_loads():
    b = bench()
    for c in b["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert load_json("configs", c["name"])["name"] == c["name"]
    for w in b["workloads"]:
        data = load_json("workloads", w["name"])
        assert data["config"] == w["config"] and data["traffic"] == w["traffic"]
    for m in b["per_layer"]:
        path = os.path.join(HERE, "metrics", f"{m['name']}.py")
        assert os.path.exists(path), path
        for cell in m["workloads"]:
            assert any(w["name"] == cell for w in b["workloads"])


NEW_FILES = '''
import json, os, shutil, sys
root = sys.argv[1]
sys.path.insert(0, root)
from benchmark import run
from benchmark.inputs import load_json
b = json.load(open(os.path.join(root, "BENCHMARK.json")))
c = load_json("configs", "zju_smpl_512"); c["name"] = "zju_copy"
json.dump(c, open(os.path.join(root, "benchmark", "configs", "zju_copy.json"), "w"))
w = load_json("workloads", "zju.steady"); w["config"] = "zju_copy"
json.dump(w, open(os.path.join(root, "benchmark", "workloads", "copy.steady.json"), "w"))
open(os.path.join(root, "benchmark", "metrics", "answer.py"), "w").write(
    "def read(ctx):\\n    return 42.0\\n")
b["workloads"].append({"name": "copy.steady", "config": "zju_copy", "traffic": "steady",
                       "chips": 1, "why": "a copy"})
b["per_layer"].append({"name": "answer", "unit": "%", "better": "higher",
                       "source": "program_counter", "layer": "device",
                       "moves": "train_ms_per_iter", "workloads": ["copy.steady"]})
assert load_json("workloads", "copy.steady")["config"] == "zju_copy"
assert load_json("configs", load_json("workloads", "copy.steady")["config"])["name"] == "zju_copy"
names = [m["name"] for m in run.cell_metrics(b, "copy.steady", "per_layer")]
assert names == ["answer"], names
assert run.read_metric("answer", None) == 42.0
print("ok")
'''


def test_new_files_need_no_edit(tmp_path):
    """In a copy of the checkout, a configuration, a cell and a metric added
    as files are found by name, and no file that was there changes."""
    shutil.copytree(HERE, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    before = {p: open(p, "rb").read() for p in _files(tmp_path)}
    out = subprocess.run([sys.executable, "-c", NEW_FILES, str(tmp_path)], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
    after = {p: open(p, "rb").read() for p in _files(tmp_path)}
    assert all(after[p] == v for p, v in before.items())
    assert len(after) == len(before) + 3


def _files(root):
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs
            if "__pycache__" not in d]


def test_a_split_metric_falls_back_to_its_readers_name():
    """`a.b` without a file of its own is read by benchmark/metrics/a.py."""
    from benchmark import run

    class Trace:
        busy_s, wall_s = 0.9, 1.0

    ctx = type("Ctx", (), {"trace": Trace()})()
    assert run.read_metric("idle_share.serve", ctx) == run.read_metric("idle_share", ctx)
