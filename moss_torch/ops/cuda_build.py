"""Build and load the port's CUDA kernels (moss_torch/csrc/*.cu).

Each source is compiled at first use by nvcc into a shared library with a
plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/moss_torch/<name>-<hash>.so

into build/moss_torch/ beside the package. The library name carries a hash
of the source, so an edited source is rebuilt and a current one is reused.
Several sources build in parallel, one nvcc each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "moss_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: Dict[str, ctypes.CDLL] = {}
# nvcc's output (ptxas register / shared-memory report) of the last build
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build moss_torch's kernels")


def library_path(name: str) -> Path:
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every source not yet built, all nvcc processes at once."""
    names = list(names)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, path in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built if needed, loaded once per process."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build_all([name])[name]))
    return _libs[name]
