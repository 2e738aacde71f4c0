"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on first
use into `unicorn_torch/csrc/_build/` (listed in .gitignore), as
`<name>-<hash>.so`, where the hash covers the source, the headers
(`csrc/*.cuh`), the flags and the compiler. A build that fails raises:
nothing falls back to the plain PyTorch version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

CSRC = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(CSRC, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source on first use")


def _target(name: str, nvcc: str) -> str:
    # the source and every header of csrc/ (a .cu may include any of them)
    files = [f"{name}.cu"] + sorted(f for f in os.listdir(CSRC)
                                    if f.endswith(".cuh"))
    src = b""
    for fname in files:
        with open(os.path.join(CSRC, fname), "rb") as f:
            src += f.read()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode() + nvcc.encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _compile(name: str) -> str:
    nvcc = nvcc_path()
    out = _target(name, nvcc)
    if os.path.exists(out):
        _logs[name] = "cached"
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{_logs[name]}")
    os.replace(tmp, out)
    return out


def build(names) -> dict[str, str]:
    """Compile the named kernels in parallel, one nvcc each. Returns
    {name: nvcc output} ("cached" for a library already built)."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        for f in [ex.submit(_compile, n) for n in names]:
            f.result()
    return {n: _logs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(_compile(name))
        return lib
