"""Build the port's native sources into shared libraries and load them.

Each `csrc/*.cu` file is compiled on first use with `nvcc` for Hopper
(`sm_90a`) into a shared library with a plain C interface, which `ctypes`
loads; each host `csrc/*.cpp` file (the BVH builder) is compiled the same way
with `g++`. Libraries are named by a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is reused; the key of a `.cu`
library also covers the shared headers (`csrc/*.cuh`). Nothing is built when
a module is imported.

Where the libraries go (`BUILD_DIR`, read from `BSDF_TORCH_BUILD_DIR` when
this module is imported):
  unset          -> `_build/` inside the package
  a path         -> that directory
  empty string   -> a fresh temporary directory for the process, removed at
                    its exit, so every library is rebuilt
"""

from __future__ import annotations

import atexit
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"


def _build_dir() -> Path:
    env = os.environ.get("BSDF_TORCH_BUILD_DIR")
    if env is None:
        return _PKG / "_build"
    if env:
        return Path(env)
    tmp = tempfile.mkdtemp(prefix="bsdf_torch_build-")
    atexit.register(shutil.rmtree, tmp, True)
    return Path(tmp)


BUILD_DIR = _build_dir()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _flags(source: str) -> Tuple[str, ...]:
    return NVCC_FLAGS if source.endswith(".cu") else HOST_FLAGS


def library_path(source: str) -> Path:
    """Where the library of `csrc/<source>` goes, keyed by content (the
    source's and, for CUDA, the headers') and flags."""
    h = hashlib.sha256(" ".join(_flags(source)).encode())
    h.update((CSRC / source).read_bytes())
    if source.endswith(".cu"):
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[str]) -> Dict[str, Path]:
    """Compile every source whose library is missing, one compiler (`nvcc`
    for `.cu`, `g++` for `.cpp`) per source, all started together. Returns
    {source: library path}; the compiler's output (registers, spills) is kept
    beside each library as `.log`."""
    out = {s: library_path(s) for s in sources}
    todo = {s: p for s, p in out.items() if not p.exists()}
    if not todo:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for s, p in todo.items():
        tmp = p.with_name(f"{p.stem}.{os.getpid()}.tmp.so")
        cc = nvcc_path() if s.endswith(".cu") else "g++"
        cmd = [cc, *_flags(s), "-o", str(tmp), str(CSRC / s)]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for s, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        todo[s].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{s}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, todo[s])
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built first if needed."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build([source])[source]))
            _libs[source] = lib
        return lib
