"""Nothing the benchmark runs loads jax, jaxlib, flax or moss_tpu; the
reference loads nothing of moss_torch (top-level names compared whole)."""
from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PROBE = '''
import importlib, pkgutil, sys
sys.path.insert(0, {root!r})
for m in {mods!r}:
    importlib.import_module(m)
import benchmark.reference as R
if {walk!r}:
    for info in pkgutil.iter_modules(R.__path__):
        importlib.import_module("benchmark.reference." + info.name)
print(sorted({{m.split(".")[0] for m in sys.modules}}))
'''


def top_level(mods, walk=False):
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT, mods=mods, walk=walk)],
                         capture_output=True, text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "USE_FLAX": "0"})
    assert out.returncode == 0, out.stderr
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    names = top_level(["benchmark.run", "benchmark.harness", "benchmark.check",
                       "benchmark.control", "benchmark.trace", "benchmark.work"], walk=True)
    assert "moss_torch" in names and "benchmark" in names
    assert not names & {"jax", "jaxlib", "flax", "moss_tpu"}


def test_reference_loads_no_port():
    names = top_level(["benchmark.reference"], walk=True)
    assert not names & {"moss_torch", "jax", "jaxlib", "flax", "moss_tpu"}
