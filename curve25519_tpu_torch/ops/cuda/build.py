"""Builds and loads the CUDA sources of the port (same pattern as
curve25519_tpu/native/bindings.py: a plain C interface, compiled on demand,
loaded with ctypes).

- ``load_cuda()`` compiles ``csrc/ladder.cu`` with nvcc for sm_90a into
  ``_build/`` (git-ignored) the first time it is called, and again whenever a
  source is newer than the library. ``build_cuda()`` compiles anew and
  returns the build seconds and ptxas's report (registers, spills); the
  full compiler output is kept in ``_build/nvcc.log``.
- ``build_host(out_dir)`` compiles the same sources with g++ into a library
  whose ``x25519_ladder_host`` / ``fe25519_op_host`` run the per-lane kernel
  code on the CPU; the CPU tests load it with ``load_host``.

Nothing is compiled at import time.
"""

import ctypes
import functools
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["build_cuda", "load_cuda", "build_host", "load_host"]

_DIR = Path(__file__).resolve().parent
CSRC = _DIR / "csrc"
BUILD_DIR = _DIR / "_build"
_SOURCES = (CSRC / "ladder.cu", CSRC / "fe25519.cuh")
_CUDA_SO = BUILD_DIR / "libladder_cuda.so"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-Wno-unknown-pragmas",
             "-x", "c++"]


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _stale(lib):
    return (not lib.exists() or
            lib.stat().st_mtime < max(s.stat().st_mtime for s in _SOURCES))


def _parse_ptxas(log):
    """Registers per thread, spill bytes and stack frame of the ladder kernel
    from nvcc's -Xptxas -v report."""
    info = {}
    m = re.search(r"Function properties for \S*x25519_ladder_kernel\S*\s*\n"
                  r"\s*(\d+) bytes stack frame, (\d+) bytes spill stores, "
                  r"(\d+) bytes spill loads", log)
    if m:
        info.update(stack_bytes=int(m.group(1)),
                    spill_store_bytes=int(m.group(2)),
                    spill_load_bytes=int(m.group(3)))
    m = re.search(r"Compiling entry function '\S*x25519_ladder_kernel\S*'"
                  r"[\s\S]*?Used (\d+) registers", log)
    if m:
        info["registers"] = int(m.group(1))
    return info


def build_cuda():
    """Compile ladder.cu for sm_90a into _build/. Returns the build seconds
    and, from ptxas's report, the kernel's registers per thread and its
    spill and stack bytes."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = _CUDA_SO.with_suffix(".so.tmp%d" % os.getpid())
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SOURCES[0])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    (BUILD_DIR / "nvcc.log").write_text(log)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed (%d):\n%s" % (proc.returncode, log))
    os.replace(tmp, _CUDA_SO)
    return {"build_seconds": seconds, **_parse_ptxas(log)}


@functools.cache
def load_cuda():
    """Load (building if missing or stale) the CUDA library; returns the
    ctypes CDLL with its argument types declared."""
    if _stale(_CUDA_SO):
        build_cuda()
    lib = ctypes.CDLL(str(_CUDA_SO))
    vp = ctypes.c_void_p
    lib.x25519_ladder_launch.argtypes = [vp, vp, vp, vp, ctypes.c_int64, vp]
    lib.x25519_ladder_launch.restype = ctypes.c_int
    lib.x25519_cuda_error_string.argtypes = [ctypes.c_int]
    lib.x25519_cuda_error_string.restype = ctypes.c_char_p
    return lib


def build_host(out_dir):
    """Compile the kernel sources with g++ into out_dir; returns the path of
    the shared library."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    so = Path(out_dir) / "libladder_host.so"
    subprocess.run([gxx, *GXX_FLAGS, "-o", str(so), str(_SOURCES[0])],
                   check=True, capture_output=True)
    return so


def load_host(so_path):
    """ctypes CDLL of a library made by build_host, argument types declared."""
    lib = ctypes.CDLL(str(so_path))
    vp = ctypes.c_void_p
    lib.x25519_ladder_host.argtypes = [vp, vp, vp, vp, ctypes.c_int64]
    lib.x25519_ladder_host.restype = None
    lib.fe25519_op_host.argtypes = [ctypes.c_int, vp, vp, vp, ctypes.c_int64]
    lib.fe25519_op_host.restype = ctypes.c_int
    return lib
