"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain ``extern "C"`` interface and is
compiled at first use, from the sources in the checkout alone, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into ``build/torch_kernels/<name>-<hash>/lib<name>.so`` at the repository
root (``.gitignore`` lists ``build/``), keyed by a hash of the source and
the flags, then loaded with ``ctypes``. Nothing builds at import: the CPU
tests import every module and this machine has no ``nvcc``. A build that
fails raises with the compiler's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "build", "torch_kernels")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
# name -> {"seconds", "log", "path", "cached"}: what the last build did, for
# chip_smoke.py's report
BUILD_INFO: dict[str, dict] = {}


def find_nvcc() -> str:
    """nvcc from CUDA_HOME, /usr/local/cuda or PATH; raises if there is none."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels build from source at first use")


def library_path(name: str) -> str:
    """Where ``csrc/<name>.cu`` builds to: keyed by its source and flags."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_ROOT, f"{name}-{digest}", f"lib{name}.so")


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless the keyed library exists; returns
    its path. Safe to call from several processes: the library is written
    under a temporary name and renamed into place."""
    out = library_path(name)
    if os.path.exists(out):
        log = ""
        log_path = os.path.join(os.path.dirname(out), "build.log")
        if os.path.exists(log_path):
            with open(log_path) as f:
                log = f.read()
        BUILD_INFO[name] = {"seconds": 0.0, "log": log, "path": out, "cached": True}
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) building {name}:\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    with open(os.path.join(os.path.dirname(out), "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + log)
    BUILD_INFO[name] = {"seconds": seconds, "log": log, "path": out, "cached": False}
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = _LOADED[name] = ctypes.CDLL(build(name))
        return lib
