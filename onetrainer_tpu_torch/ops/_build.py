"""Build and load the port's CUDA kernels.

The kernels are plain-C-interface `.cu` files under `csrc/`, compiled with
`nvcc` for sm_90a into one shared library at first use and bound with
`ctypes`. The library lands in `<repo>/build/`, named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. Nothing here runs at import time: CPU-only installs (no nvcc) can
import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "flash_fwd.cu", _PKG / "csrc" / "flash_bwd.cu")
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in _SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libot_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists.
    The compiler's report (registers, shared memory, spills) is kept
    beside the library as `<name>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def load_library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ot_flash_fwd.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr,
                                     i32, i32, i32, i32, i32,
                                     ctypes.c_float, ptr]
        lib.ot_flash_fwd.restype = i32
        lib.ot_flash_bwd_dq.argtypes = [ptr] * 8 + [i32] * 5 + [
            ctypes.c_float, ptr]
        lib.ot_flash_bwd_dq.restype = i32
        lib.ot_flash_bwd_dkv.argtypes = [ptr] * 9 + [i32] * 5 + [
            ctypes.c_float, ptr]
        lib.ot_flash_bwd_dkv.restype = i32
        _LIB = lib
    return _LIB
