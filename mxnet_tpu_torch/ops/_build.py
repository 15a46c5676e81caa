"""Build and load the port's CUDA kernels.

Each source ``mxnet_tpu_torch/csrc/<name>.cu`` has a plain C interface and
is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/mxnet_tpu_torch/`` at the repository root (git-ignored), then
loaded with ``ctypes``. A source may add flags of its own
(``EXTRA_FLAGS``: the NVRTC shim links ``libnvrtc`` and ``libcuda``, the
flash-attention source ``libcuda`` for its TMA tensor maps). The
build happens at first use; the library's file name carries a hash of its
source and its flags, so an edited source or flag is rebuilt and a
finished build is reused. Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

from ..base import MXNetError, env

__all__ = ["SOURCES", "build", "load"]

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "mxnet_tpu_torch")
SOURCES = ("fused_bn_act", "flash_attention", "rtc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
#: per-source flags after NVCC_FLAGS; they enter the library's hash
EXTRA_FLAGS = {"rtc": ("-lnvrtc", "-lcuda"),
               "flash_attention": ("-lcuda",)}

_lock = threading.Lock()
_loaded: dict = {}
#: seconds from the start of each source's last nvcc run in this process
#: to when build() collected it (the runs overlap)
build_seconds: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(env.raw("CUDA_HOME") or "/usr/local/cuda",
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise MXNetError("nvcc not found: the port's CUDA kernels are built "
                     "from source at first use (CUDA toolkit required)")


def cuda_home() -> str:
    """The CUDA toolkit that holds ``nvcc``."""
    return os.path.dirname(os.path.dirname(os.path.realpath(_nvcc())))


def _lib_path(name: str) -> str:
    flags = NVCC_FLAGS + EXTRA_FLAGS.get(name, ())
    with open(os.path.join(_CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names=SOURCES) -> dict:
    """Compile every named source not built yet, one ``nvcc`` per source,
    all started together. Returns ``{name: path of the .so}``."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        extra = EXTRA_FLAGS.get(n, ())
        # libraries a source links are found at run time in the toolkit
        rpath = ("-Xlinker", "-rpath", "-Xlinker",
                 os.path.join(cuda_home(), "lib64")) if extra else ()
        procs[n] = (tmp, time.perf_counter(), subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp,
             os.path.join(_CSRC, f"{n}.cu"), *extra, *rpath],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    from ..telemetry.registry import note_compile
    for n, (tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        build_seconds[n] = time.perf_counter() - t0
        note_compile("nvcc", build_seconds[n], f"{n}.cu")
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, paths[n])
    if failed:
        raise MXNetError("kernel build failed: " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = _loaded[name] = ctypes.CDLL(build((name,))[name])
        return lib
