"""Build the port's native libraries and load them with ctypes.

Each `csrc/<name>.cu` (a CUDA kernel, built with nvcc) or `csrc/<name>.cpp`
(host code, built with the system C++ compiler: $CXX, else c++ or g++)
exposes a plain C interface and is compiled on first use into
`unicorn_torch/csrc/_build/` (listed in .gitignore), as `<name>-<hash>.so`,
where the hash covers the source (and, for a .cu, the headers
`csrc/*.cuh`), the flags and the compiler. A build that fails raises:
nothing falls back to the plain PyTorch version or to another library.
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
# no -march=native: a library built on one host may be loaded on another
CXX_FLAGS = ("-std=c++17", "-O3", "-shared", "-fPIC")
# flags a library adds to NVCC_FLAGS: the tracker step's costs and boxes must
# round as PyTorch's separate operations do, so nvcc contracts no
# multiply-add there
EXTRA_NVCC_FLAGS = {"tracker_step": ("--fmad=false",)}

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


def cxx_path() -> str:
    for c in (os.environ.get("CXX"), "c++", "g++"):
        path = shutil.which(c) if c else None
        if path:
            return path
    raise RuntimeError("no C++ compiler found (set CXX); the port's host "
                       "libraries are built from source on first use")


def _source(name: str) -> tuple[str, bool]:
    """(path, host): csrc/<name>.cpp (host code) if it exists, else
    csrc/<name>.cu."""
    cpp = os.path.join(CSRC, f"{name}.cpp")
    if os.path.isfile(cpp):
        return cpp, True
    return os.path.join(CSRC, f"{name}.cu"), False


def _flags(name: str, host: bool) -> tuple:
    return CXX_FLAGS if host else NVCC_FLAGS + EXTRA_NVCC_FLAGS.get(name, ())


def _target(name: str, compiler: str) -> str:
    # the source and, for a .cu, every header of csrc/ (it may include any)
    src, host = _source(name)
    files = [src] if host else [src] + sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(".cuh"))
    data = b""
    for fname in files:
        with open(fname, "rb") as f:
            data += f.read()
    flags = _flags(name, host)
    h = hashlib.sha256(data + " ".join(flags).encode() + compiler.encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _compile(name: str) -> str:
    src, host = _source(name)
    compiler = cxx_path() if host else nvcc_path()
    out = _target(name, compiler)
    if os.path.exists(out):
        _logs[name] = "cached"
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    # written under a name of this process and thread, then renamed: builds
    # racing in parallel workers each replace the file with a whole one
    tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
    cmd = [compiler, *_flags(name, host), "-o", tmp, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    _logs[name] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"{os.path.basename(compiler)} failed for "
                           f"{os.path.basename(src)} (exit {proc.returncode})"
                           f":\n{_logs[name]}")
    os.replace(tmp, out)
    return out


def build(names) -> dict[str, str]:
    """Compile the named libraries in parallel, one compiler process each.
    Returns {name: compiler output} ("cached" for a library already
    built)."""
    names = list(names)
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as ex:
        for f in [ex.submit(_compile, n) for n in names]:
            f.result()
    return {n: _logs[n] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu or .cpp, built first if
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(_compile(name))
        return lib
