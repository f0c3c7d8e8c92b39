"""Build and load the port's host library, the host twin of ``cuda_build.py``.

``csrc/jpeg_io.cc`` (which includes the copied native loader,
``csrc/yamt_loader.cc``) is compiled at first use with ``g++`` and
``native/Makefile``'s flags,

    g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared

into ``build/host/jpeg_io-<hash>/libjpeg_io.so`` at the repository root
(``.gitignore`` lists ``build/``), keyed by a hash of the sources, the flags
and the JPEG library, then loaded with ``ctypes``. It never builds into, or
loads from, the JAX package's ``native/``.

The JPEG library is libjpeg where the host has its header, else nvJPEG from
the CUDA toolkit through libjpeg's API (``csrc/nvjpeg_compat/``): the card's
machine has no libjpeg. A host with neither raises, naming both; a failed
build raises with the compiler's output. Nothing builds at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

from .cuda_build import CSRC_DIR

BUILD_ROOT = os.path.join(os.path.dirname(os.path.dirname(CSRC_DIR)), "build", "host")
NAME = "jpeg_io"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")
COMPAT_DIR = os.path.join(CSRC_DIR, "nvjpeg_compat")

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
# what the last build did, for chip_smoke.py's report
BUILD_INFO: dict = {}


def cuda_home() -> str:
    return os.environ.get("CUDA_HOME") or "/usr/local/cuda"


def find_cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (set CXX or put g++ on PATH); the port's JPEG loader builds from "
                           "csrc/ at first use")
    return cxx


@functools.lru_cache(maxsize=None)
def codec() -> str:
    """``"libjpeg"`` when ``jpeglib.h`` compiles here, else ``"nvjpeg"`` when
    the CUDA toolkit has nvJPEG; raises when the host has neither."""
    probe = subprocess.run([find_cxx(), "-E", "-x", "c++", "-"], input="#include <cstdio>\n#include <jpeglib.h>\n",
                           capture_output=True, text=True, timeout=60, check=False)
    if probe.returncode == 0:
        return "libjpeg"
    home = cuda_home()
    if (os.path.isfile(os.path.join(home, "include", "nvjpeg.h"))
            and os.path.isfile(os.path.join(home, "lib64", "libnvjpeg.so"))):
        return "nvjpeg"
    raise RuntimeError("no JPEG library: neither libjpeg (jpeglib.h on the compiler's include path, -ljpeg) nor "
                       f"nvJPEG ({home}/include/nvjpeg.h, {home}/lib64/libnvjpeg.so) is installed")


def _command(out: str) -> list[str]:
    src = os.path.join(CSRC_DIR, f"{NAME}.cc")
    if codec() == "libjpeg":
        return [find_cxx(), *CXX_FLAGS, "-o", out, src, "-ljpeg", "-lpthread"]
    home = cuda_home()
    lib = os.path.join(home, "lib64")
    return [find_cxx(), *CXX_FLAGS, "-I", COMPAT_DIR, "-I", os.path.join(home, "include"), "-o", out, src,
            os.path.join(COMPAT_DIR, "jpeglib_nvjpeg.cc"), f"-L{lib}", f"-Wl,-rpath,{lib}", "-lnvjpeg", "-lcudart",
            "-lpthread"]


def _sources() -> list[str]:
    names = [f"{NAME}.cc", "yamt_loader.cc"]
    if codec() == "nvjpeg":
        names += ["nvjpeg_compat/jpeglib.h", "nvjpeg_compat/jpeglib_nvjpeg.cc"]
    return [os.path.join(CSRC_DIR, n) for n in names]


def library_path() -> str:
    """Where the library builds to: keyed by its sources, flags and codec."""
    h = hashlib.sha256()
    for path in _sources():
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_command("OUT")).encode())
    return os.path.join(BUILD_ROOT, f"{NAME}-{h.hexdigest()[:16]}", f"lib{NAME}.so")


def build(force: bool = False) -> str:
    """Compile the library unless the keyed one exists (or ``force``);
    returns its path. Safe from several processes at once: it is written
    under a temporary name and renamed into place."""
    out = library_path()
    if os.path.exists(out) and not force:
        BUILD_INFO.update(seconds=0.0, path=out, cached=True, codec=codec())
        return out
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = _command(tmp)
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, check=False)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building {NAME}:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    BUILD_INFO.update(seconds=seconds, path=out, cached=False, codec=codec(), command=" ".join(cmd))
    return out


def load(force: bool = False) -> ctypes.CDLL:
    """The loaded library with the port-only functions declared, built on
    first use; nvJPEG decodes on the current card."""
    with _LOCK:
        lib = _LOADED.get(NAME)
        if lib is None or force:
            lib = ctypes.CDLL(build(force))
            _declare(lib)
            if codec() == "nvjpeg":
                import torch

                if torch.cuda.is_available():
                    lib.yamt_set_device(torch.cuda.current_device())
            _LOADED[NAME] = lib
        return lib


def _declare(lib: ctypes.CDLL) -> None:
    c = ctypes
    u8p, f32p, i32p = c.POINTER(c.c_uint8), c.POINTER(c.c_float), c.POINTER(c.c_int32)
    lib.yamt_decode_batch.restype = c.c_int64
    lib.yamt_decode_batch.argtypes = [
        c.POINTER(c.c_void_p), c.POINTER(c.c_uint64), i32p, c.POINTER(c.c_int64), c.c_int, c.c_int, c.c_int,
        c.c_int, c.c_int, c.c_uint64, f32p, f32p, c.c_float, c.c_float, c.c_float, c.c_float, c.c_float,
        c.c_int, c.c_int, f32p, u8p, i32p, i32p,
    ]
    lib.yamt_jpeg_encode.restype = c.c_int
    lib.yamt_jpeg_encode.argtypes = [u8p, c.c_int, c.c_int, c.c_int, c.POINTER(u8p), c.POINTER(c.c_uint64)]
    lib.yamt_jpeg_decode.restype = c.c_int
    lib.yamt_jpeg_decode.argtypes = [c.c_char_p, c.c_uint64, c.c_int, c.POINTER(u8p), i32p, i32p]
    lib.yamt_free.restype = None
    lib.yamt_free.argtypes = [c.c_void_p]
    lib.yamt_crc32c.restype = c.c_uint32
    lib.yamt_crc32c.argtypes = [c.c_char_p, c.c_uint64, c.c_uint32]
    lib.yamt_codec.restype = c.c_char_p
    lib.yamt_codec.argtypes = []
    lib.yamt_set_device.restype = None
    lib.yamt_set_device.argtypes = [c.c_int]
