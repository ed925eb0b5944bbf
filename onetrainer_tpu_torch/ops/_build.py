"""Build and load the port's CUDA kernels.

The kernels are plain-C-interface `.cu` files under `csrc/`: K1
(`flash_fwd.cu`), K2, K3 and K3's delta pre-pass (`flash_bwd.cu`), K4
(`nf4_dequant.cu`) and K5 (`sr_update.cu`); `hopper_mma.cuh` holds the
Hopper building blocks K1 and K3 share. At first use each `.cu` file is
compiled with `nvcc` for sm_90a into an object file, all at once in
parallel processes, and the objects are linked into one shared library
bound with `ctypes`. The library lands in `<repo>/build/`, named by a hash
of every file under `csrc/` (sources and headers) and the flags, so an
edited source or header rebuilds and an unchanged tree is reused.
Nothing here runs at import time: CPU-only installs (no nvcc) can import
every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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


def sources() -> list[Path]:
    """The `.cu` files that are compiled, one object each."""
    return sorted(_CSRC.glob("*.cu"))


def hashed_files() -> list[Path]:
    """Every file under `csrc/` whose bytes name the library."""
    return sorted(p for p in _CSRC.rglob("*") if p.is_file())


def library_path() -> Path:
    digest = hashlib.sha256()
    for path in hashed_files():
        digest.update(path.relative_to(_CSRC).as_posix().encode())
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libot_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library for these sources exists: one
    `nvcc -c` per source, all started together, then one link. The
    compiler's report (registers, shared memory, spills) is kept beside
    the library as `<name>.log`."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    srcs = sources()
    objs = [BUILD_DIR / f"{stem}.{src.stem}.o" for src in srcs]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    reports = [(src.name, *proc.communicate(), proc.returncode)
               for src, proc in zip(srcs, procs)]
    log = "".join(f"== {name}\n{text}" for name, text, _, _ in reports)
    failed = [(name, text, rc) for name, text, _, rc in reports if rc != 0]
    tmp = out.with_name(f"{stem}.tmp.so")
    if not failed:
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log += f"== link\n{link.stdout}{link.stderr}"
        if link.returncode != 0:
            failed = [("link", link.stderr, link.returncode)]
    for obj in objs:
        obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text(log)
    if failed:
        tmp.unlink(missing_ok=True)
        name, text, rc = failed[0]
        raise RuntimeError(f"nvcc failed on {name} ({rc}):\n{text[-4000:]}")
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
        lib.ot_flash_bwd_delta.argtypes = [ptr] * 3 + [i32] * 4 + [ptr]
        lib.ot_flash_bwd_delta.restype = i32
        lib.ot_flash_bwd_dkv.argtypes = [ptr] * 9 + [i32] * 5 + [
            ctypes.c_float, ptr]
        lib.ot_flash_bwd_dkv.restype = i32
        i64 = ctypes.c_longlong
        lib.ot_nf4_dequant.argtypes = [ptr, ptr, ptr, i64, i32, ptr]
        lib.ot_nf4_dequant.restype = i32
        lib.ot_sr_update.argtypes = [ptr, ptr, ptr, i32, ptr, i64, ptr]
        lib.ot_sr_update.restype = i32
        _LIB = lib
    return _LIB
