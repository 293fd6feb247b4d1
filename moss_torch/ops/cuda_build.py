"""Build and load the port's CUDA kernels (moss_torch/csrc/*.cu).

Each source is compiled at first use by nvcc into a shared library with a
plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/moss_torch/<name>-<hash>.so

into build/moss_torch/ beside the package, with nvcc's output (ptxas's
register and shared-memory report) as <name>-<hash>.log. The library name
carries a hash of the source and of every csrc/ header it includes, so an
edited source or shared header is rebuilt and a current one is reused.
Several sources build in parallel, one nvcc each.
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
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"{name}:\n{log}")
            else:
                todo[name].with_suffix(".log").write_text(log)
                os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: library_path(n) for n in names}


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")
_LENGTH = re.compile(r"\d+")


def _short(mangled: str) -> str:
    """A kernel's mangled name without its file's anonymous namespace: its
    name, then its mangled template and parameter types."""
    if mangled.startswith("_ZN"):
        n = _LENGTH.match(mangled, 3)
        if n and mangled.startswith("_GLOBAL__N_", n.end()):
            rest = mangled[n.end() + int(n.group()):]
            m = _LENGTH.match(rest)
            if m:
                return f"{rest[m.end():m.end() + int(m.group())]} {rest[m.end() + int(m.group()):]}"
    return mangled


def ptxas_report(name: str):
    """Per kernel of library `name` as ptxas reported its build (the log
    beside the library, built if needed): [{kernel (mangled, its file's
    namespace cut), registers, smem_bytes (static), spill_stores,
    spill_loads}]."""
    out = []
    for line in build_all([name])[name].with_suffix(".log").read_text().splitlines():
        if m := _ENTRY.search(line):
            out.append({"kernel": _short(m.group(1)), "registers": None, "smem_bytes": 0,
                        "spill_stores": None, "spill_loads": None})
        elif out and (m := _SPILL.search(line)):
            out[-1]["spill_stores"], out[-1]["spill_loads"] = int(m.group(1)), int(m.group(2))
        elif out and (m := _USED.search(line)):
            out[-1]["registers"] = int(m.group(1))
            out[-1]["smem_bytes"] = int(m.group(2) or 0)
    return out


_SASS_FUNCTION = re.compile(r"\n\s*Function : (\S+)")
_SASS_OP = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def sass_opcodes(name: str, kernel: str):
    """Static instruction counts of library `name`'s kernels whose short name
    (see ptxas_report) starts with `kernel`, from the toolkit's cuobjdump
    -sass: {kernel: {"total": n, opcode: n, ...}}, opcodes without their
    modifiers, most frequent first."""
    tool = os.path.join(os.path.dirname(_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build_all([name])[name])], check=True,
                          capture_output=True, text=True).stdout
    heads = list(_SASS_FUNCTION.finditer(sass))
    out = {}
    for i, head in enumerate(heads):
        short = _short(head.group(1))
        if not short.startswith(kernel):
            continue
        body = sass[head.end():heads[i + 1].start() if i + 1 < len(heads) else len(sass)]
        ops = {}
        for m in _SASS_OP.finditer(body):
            ops[m.group(1)] = ops.get(m.group(1), 0) + 1
        out[short] = {"total": sum(ops.values()),
                      **dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
    return out


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
