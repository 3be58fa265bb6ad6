"""Builds and loads the CUDA sources of the port (same pattern as
curve25519_tpu/native/bindings.py: a plain C interface, compiled on demand,
loaded with ctypes).

- ``load_cuda(name)`` compiles one library (``ladder``, ``basemult``,
  ``sha512``, ``sign``, ``verify``, ``poly``, ``oneshot`` or ``digits``:
  ``csrc/<name>.cu``) with nvcc for sm_90a into
  ``_build/`` (git-ignored) the first time it is called, and again whenever a
  source is newer than the library. ``build_cuda()`` compiles every library
  anew, one nvcc process per source, all started together, and returns per
  library its build seconds and, per kernel, ptxas's registers, spills and
  stack; the compiler output is kept in ``_build/<name>.log``.
- ``build_host(out_dir=None)`` compiles all sources with g++ into one
  library whose ``*_host`` entries run the per-lane kernel code on the CPU
  (unless it is newer than every source); the CPU tests load it with
  ``load_host``. The compiler output is kept in ``libport_host.log``.
  Without ``out_dir`` the library goes to a directory of the system's temp
  directory named by a hash of the sources and flags, so the processes of
  one test run (modules, workers) build it once and share it.

Each build holds an exclusive lock on ``lock`` in its output directory
from the stale check to the last read of its log, so processes that share
a checkout (the ranks of a multi-process run) build a library once and
load that build, and none reads a log that another is writing. Nothing is
compiled at import time.
"""

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from curve25519_tpu_torch.utils import profiling

__all__ = ["LIBRARIES", "build_cuda", "load_cuda", "launch", "build_host",
           "load_host", "nvcc"]

_DIR = Path(__file__).resolve().parent
CSRC = _DIR / "csrc"
BUILD_DIR = _DIR / "_build"

_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int

# library -> (its kernels, as named in ptxas's report; its entries, each
# returning an int, with their argument types; launch entries end with the
# stream)
LIBRARIES = {
    "ladder": (("x25519_ladder_kernel",),
               {"x25519_ladder_launch": [_vp, _vp, _vp, _vp, _i64, _vp],
                "x25519_ladder_products": [_vp]}),
    "basemult": (("basemult_fold8_kernel", "basemult_fold8_limbs_kernel",
                  "basemult_fold4_kernel", "basemult_fold4_limbs_kernel"),
                 {"basemult_launch": [_vp, _vp, _vp, _i64, _vp, _i64, _vp,
                                      _int, _int, _i64, _vp]}),
    "sha512": (("sha512_kernel", "pack_words_kernel"),
               {"sha512_launch": [_vp, _vp, _vp, _i64, _i64, _vp],
                "pack_words_launch": [_vp, _vp, _vp, _i64, _i64, _vp, _i64,
                                      _i64, _vp, _i64, _i64, _i64, _vp]}),
    "sign": (("keygen_kernel", "sign_kernel"),
             {"keygen_launch": [_vp, _vp, _vp, _i64, _vp, _i64, _vp, _i64,
                                _vp, _i64, _vp],
              "sign_launch": [_vp, _vp, _vp, _i64, _vp, _vp, _i64, _vp, _vp,
                              _i64, _vp, _i64, _vp, _i64, _vp, _i64, _vp]}),
    "verify": (("verify_init_kernel",),
               {"verify_init_launch": [_vp, _vp, _vp, _i64, _vp]}),
    "poly": (("poly_kernel", "poly_shared_kernel", "poly_keyed_kernel",
              "key_lookup_kernel"),
             {"poly_launch": [_vp, _vp, _vp, _vp, _int, _vp, _i64, _vp],
              "key_lookup_launch": [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64,
                                    _i64, _vp],
              "poly_keyed_scratch_rows": [_i64, _int],
              "poly_keyed_launch": [_vp, _vp, _vp, _i64, _vp, _vp, _vp, _vp,
                                    _vp, _vp, _vp, _vp, _vp, _i64, _vp]}),
    "oneshot": (("oneshot_kernel",),
                {"oneshot_scratch_rows": [_i64, _int],
                 "oneshot_busiest_warps": [_i64, _i64],
                 "oneshot_launch": [_vp, _vp, _vp, _i64, _vp, _vp, _vp, _vp,
                                    _i64, _vp]}),
    "digits": (("digits_kernel",),
               {"digits_launch": [_vp, _vp, _vp, _i64, _vp, _i64, _i64, _vp]}),
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC", "-Wno-unknown-pragmas",
             "-x", "c++"]


def nvcc():
    """Path of nvcc: CUDA_HOME or CUDA_PATH, /usr/local/cuda, else PATH."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _so(name):
    return BUILD_DIR / ("lib%s_cuda.so" % name)


def _stale(lib):
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return not lib.exists() or lib.stat().st_mtime < newest


@contextlib.contextmanager
def _build_lock(directory):
    """Hold an exclusive flock on directory/lock (made if missing) for the
    block; the kernel drops it if the process dies."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    with open(directory / "lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        yield


def parse_ptxas(log, kernels):
    """Per kernel of `kernels`: registers per thread and spill and stack
    bytes from nvcc's -Xptxas -v report (one chunk per entry function)."""
    info = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        entry = chunk.split("'", 1)[0]
        name = next((k for k in kernels if k in entry), None)
        if name is None:
            continue
        rec = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", chunk)
        if m:
            rec.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", chunk)
        if m:
            rec["registers"] = int(m.group(1))
        info[name] = rec
    return info


def build_cuda(names=None):
    """Compile the named libraries (default: all) for sm_90a into _build/,
    one nvcc process per source, all at once. Returns {"wall_seconds": s,
    name: {"build_seconds": s, "kernels": {kernel: ptxas info}}}."""
    with _build_lock(BUILD_DIR):
        return _build_cuda(names)


def _build_cuda(names):
    names = list(LIBRARIES) if names is None else list(names)
    nvcc_path = nvcc()
    t0 = time.perf_counter()
    running = {}
    for name in names:
        tmp = _so(name).with_suffix(".so.tmp%d" % os.getpid())
        log = open(BUILD_DIR / (name + ".log"), "w")
        cmd = [nvcc_path, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / (name + ".cu"))]
        running[name] = (subprocess.Popen(cmd, stdout=log,
                                          stderr=subprocess.STDOUT), tmp, log)
    report, failed = {}, []
    while running:
        time.sleep(0.05)
        for name, (proc, tmp, log) in list(running.items()):
            if proc.poll() is None:
                continue
            seconds = time.perf_counter() - t0
            del running[name]
            log.close()
            text = (BUILD_DIR / (name + ".log")).read_text()
            if proc.returncode != 0:
                failed.append("%s (%d):\n%s" % (name, proc.returncode, text))
                continue
            os.replace(tmp, _so(name))
            report[name] = {"build_seconds": seconds,
                            "kernels": parse_ptxas(text, LIBRARIES[name][0])}
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    report["wall_seconds"] = time.perf_counter() - t0
    return report


@functools.cache
def load_cuda(name):
    """Load (building if missing or stale) one CUDA library; returns the
    ctypes CDLL with its argument types declared."""
    with profiling.span("build.load_cuda." + name):
        with _build_lock(BUILD_DIR):
            if _stale(_so(name)):
                with profiling.span("build.nvcc." + name):
                    _build_cuda([name])
        lib = ctypes.CDLL(str(_so(name)))
        for fn, argtypes in LIBRARIES[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
    return lib


def launch(name, fn, device, *args, n=None):
    """Call launch entry `fn` of library `name` with `args` and the current
    stream of `device` appended; raises on a nonzero return. The call is
    the span launch.<name>, with `n` (the lanes) as its work count."""
    lib = load_cuda(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        with profiling.span("launch." + name, n):
            rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError("%s failed: %s"
                           % (fn, lib.cuda_error_string(rc).decode()))


def _host_dir():
    """The shared directory of build_host(): under the system's temp
    directory, named by a hash of every source and of the g++ flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    return Path(tempfile.gettempdir()) / "curve25519_tpu_torch_host" / \
        h.hexdigest()[:16]


def build_host(out_dir=None):
    """Compile all kernel sources with g++ into out_dir (default _host_dir()),
    unless its library is newer than every source; returns the path of the
    shared library. A failed build raises with the compiler's output."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    if out_dir is None:
        out_dir = _host_dir()
    so = Path(out_dir) / "libport_host.so"
    with _build_lock(out_dir):
        if not _stale(so):
            return so
        tmp = so.with_suffix(".so.tmp%d" % os.getpid())
        sources = [str(CSRC / (name + ".cu")) for name in LIBRARIES]
        log = so.with_suffix(".log")
        with open(log, "w") as f:
            proc = subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp),
                                   *sources], stdout=f,
                                  stderr=subprocess.STDOUT)
        if proc.returncode != 0:
            raise RuntimeError("g++ failed (%d):\n%s"
                               % (proc.returncode, log.read_text()))
        os.replace(tmp, so)
    return so


def load_host(so_path):
    """ctypes CDLL of a library made by build_host, argument types declared."""
    lib = ctypes.CDLL(str(so_path))
    lib.x25519_ladder_host.argtypes = [_vp, _vp, _vp, _vp, _i64]
    lib.x25519_ladder_host.restype = None
    lib.x25519_ladder_products.argtypes = [_vp]
    lib.x25519_ladder_products.restype = ctypes.c_int
    lib.fe25519_op_host.argtypes = [_int, _vp, _vp, _vp, _i64]
    lib.fe25519_op_host.restype = ctypes.c_int
    lib.fe_wide_op_host.argtypes = [_int, _vp, _vp, _vp, _i64]
    lib.fe_wide_op_host.restype = ctypes.c_int
    lib.sha512_host.argtypes = [_int, _vp, _vp, _vp, _i64, _i64]
    lib.sha512_host.restype = None
    lib.pack_words_host.argtypes = [_vp, _vp, _vp, _i64, _i64, _vp, _i64,
                                    _i64, _vp, _i64, _i64, _i64]
    lib.pack_words_host.restype = None
    lib.basemult_host.argtypes = [_int, _vp, _vp, _vp, _i64, _vp, _i64, _vp,
                                  _int, _int, _i64]
    lib.basemult_host.restype = ctypes.c_int
    lib.keygen_host.argtypes = [_int, _vp, _vp, _vp, _i64, _vp, _i64, _vp,
                                _i64, _vp, _i64]
    lib.keygen_host.restype = None
    lib.sign_host.argtypes = [_vp, _vp, _vp, _i64, _vp, _vp, _i64, _vp, _vp,
                              _i64, _vp, _i64, _vp, _i64, _vp, _i64]
    lib.sign_host.restype = None
    lib.gather_host.argtypes = [_int, _vp, _vp, _vp, _i64]
    lib.gather_host.restype = None
    lib.sc25519_op_host.argtypes = [_int, _vp, _vp, _vp, _vp, _i64]
    lib.sc25519_op_host.restype = ctypes.c_int
    lib.verify_init_host.argtypes = [_vp, _vp, _vp, _i64]
    lib.verify_init_host.restype = None
    lib.poly_host.argtypes = [_vp, _vp, _vp, _vp, _int, _vp, _i64]
    lib.poly_host.restype = None
    lib.key_lookup_host.argtypes = [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64,
                                    _i64]
    lib.key_lookup_host.restype = None
    lib.poly_keyed_host.argtypes = [_vp, _vp, _vp, _i64, _vp, _vp, _vp, _vp,
                                    _i64, _vp, _vp, _vp, _vp, _i64]
    lib.poly_keyed_host.restype = None
    lib.poly_keyed_scratch_rows.argtypes = [_i64, _int]
    lib.poly_keyed_scratch_rows.restype = ctypes.c_int
    lib.oneshot_host.argtypes = [_vp, _vp, _vp, _vp, _vp, _vp, _vp, _i64]
    lib.oneshot_host.restype = None
    lib.oneshot_scratch_rows.argtypes = [_i64, _int]
    lib.oneshot_scratch_rows.restype = ctypes.c_int
    lib.oneshot_busiest_warps.argtypes = [_i64, _i64]
    lib.oneshot_busiest_warps.restype = ctypes.c_int
    lib.oneshot_split_host.argtypes = [_vp, _i64, _i64]
    lib.oneshot_split_host.restype = _i64
    lib.digits_host.argtypes = [_vp, _vp, _vp, _i64, _vp, _i64, _i64]
    lib.digits_host.restype = None
    return lib
