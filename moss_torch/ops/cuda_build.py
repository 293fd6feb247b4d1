"""Build and load the port's CUDA kernels (moss_torch/csrc/*.cu).

Each source is compiled at first use by nvcc into a shared library with a
plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/moss_torch/<name>-<hash>.so

into build/moss_torch/ beside the package. The library name carries a hash
of the source and of every csrc/ header it includes, so an edited source or
shared header is rebuilt and a current one is reused. Several sources build
in parallel, one nvcc each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Iterable

import torch

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


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def _sources(path: Path, seen=None):
    """`path` and every csrc/ file it includes with quotes, transitively."""
    seen = [] if seen is None else seen
    if path not in seen:
        seen.append(path)
        for inc in _INCLUDE.findall(path.read_bytes()):
            _sources(path.parent / inc.decode(), seen)
    return seen


def library_path(name: str) -> Path:
    h = hashlib.sha1()
    for src in _sources(CSRC / f"{name}.cu"):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


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


def launch(name: str, symbol: str, argtypes, device, *args):
    """Call the C entry point `symbol` of library `name` with `args` and the
    current stream of `device` appended; raise if it reports a launch error.
    argtypes: the ctypes types of `args` (c_void_p for pointers, c_int for
    ints), the stream's c_void_p excluded."""
    fn = getattr(load(name), symbol)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
