"""Build and load the port's hand-written CUDA kernels.

Each kernel source under paddle_tpu_torch/csrc/ exposes a plain C
interface.  At first use it is compiled with nvcc for Hopper
(`-gencode arch=compute_90a,code=sm_90a`) into a shared library under
`<checkout>/build/paddle_tpu_torch/`, named by a hash of the source, every
header `csrc/*.cuh` (the sources include them, so an edit to a header alone
rebuilds) and the flags, and loaded with ctypes.  Nothing is built at
import time, and a failed build raises with nvcc's output; there is no
fallback.
`build_libraries` compiles several sources at once, one nvcc process each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Sequence, Tuple

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "find_nvcc",
           "build_libraries", "load_library", "build_log"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build",
                         "paddle_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# name -> (seconds the build took, 0.0 when a built library was reused;
#          the compiler's output, with ptxas register/spill lines)
_log: Dict[str, Tuple[float, str]] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then PATH, then PyTorch's CUDA_HOME guess."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the port's CUDA kernels")


def _target(name: str) -> Tuple[str, str]:
    """(source path, library path named by a hash of the source, the
    headers under csrc/ and the flags)."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    digest = hashlib.sha256()
    for path in [src] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" +
                          f.read() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR,
                             f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_libraries(names: Sequence[str]) -> List[str]:
    """Compile csrc/<name>.cu for every name not built yet, all nvcc
    processes running at once, and return the libraries' paths."""
    targets = [_target(n) for n in names]
    jobs = []
    for name, (src, out) in zip(names, targets):
        if os.path.exists(out):
            _log.setdefault(name, (0.0, ""))
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
        jobs.append((name, src, out, tmp, cmd, time.perf_counter(),
                     subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, src, out, tmp, cmd, t0, proc in jobs:
        text, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"building {src} failed ({' '.join(cmd)}):\n"
                          f"{text}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
        _log[name] = (time.perf_counter() - t0, text)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [out for _, out in targets]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build_libraries([name])[0])
            _loaded[name] = lib
        return lib


def build_log(name: str) -> Tuple[float, str]:
    """(build seconds, compiler output) of the library built or reused in
    this process."""
    return _log[name]
