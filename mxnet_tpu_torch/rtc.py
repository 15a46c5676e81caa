"""Runtime-compiled CUDA kernels: ``CudaModule`` / ``CudaKernel`` over NVRTC
(ref: python/mxnet/rtc.py and src/common/rtc.cc in the reference MXNet;
the JAX package's ``rtc.py`` ``PallasModule``, whose ``pl.pallas_call``
at ``rtc.py:78`` this replaces).

``CudaModule(source)`` compiles CUDA C++ source with NVRTC for sm_90a when
it is built. ``get_kernel(name, signature)`` takes the kernel's C
parameter list, e.g. ``"const float *x, float *y, float alpha, int n"``.
``CudaKernel.launch(args, ctx, grid_dims, block_dims, shared_mem)`` takes
NDArrays for the pointers and numbers for the scalars, and writes the
non-``const`` pointers' arrays in place, as the reference does. It
launches on PyTorch's current stream of the card, so it is ordered with
torch's own work without a synchronisation.

The compile, load and launch calls are a small C++ shim,
``csrc/rtc.cu``, built by ``ops/_build.py`` with the other kernels. The
source is compiled with ``cuda_fp16.h`` and ``cuda_bf16.h`` included and
the fixed-width integer types defined, so signatures may use the types of
``TYPES``. A kernel is looked up by its lowered name when the module
exports it (``exports=``; only exported names can be fetched then), else
by its own name, which is the symbol of an ``extern "C"`` kernel. Each
module is loaded once per card, into the primary context PyTorch uses.

There is no fallback: without a card, or without nvcc/NVRTC to build the
shim, ``CudaModule`` raises :class:`MXNetError` naming what is missing.
A launch adds one to ``launches[kernel name]``.
"""
from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from . import autograd
from .base import MXNetError, check
from .context import Context
from .ops import _build

__all__ = ["CudaModule", "CudaKernel", "PallasModule", "Param", "TYPES",
           "parse_signature", "launches", "reset_launches"]

#: launches per kernel name since the last reset_launches()
launches: Dict[str, int] = {}

#: C type -> (torch dtype of a pointer's array, ctypes type of a scalar)
TYPES = {
    "float": (torch.float32, ctypes.c_float),
    "double": (torch.float64, ctypes.c_double),
    "__half": (torch.float16, ctypes.c_uint16),
    "__nv_bfloat16": (torch.bfloat16, ctypes.c_uint16),
    "int8_t": (torch.int8, ctypes.c_int8),
    "uint8_t": (torch.uint8, ctypes.c_uint8),
    "int32_t": (torch.int32, ctypes.c_int32),
    "int": (torch.int32, ctypes.c_int32),
    "int64_t": (torch.int64, ctypes.c_int64),
}

_PREAMBLE = """\
#include <cuda_fp16.h>
#include <cuda_bf16.h>
typedef signed char int8_t;
typedef unsigned char uint8_t;
typedef int int32_t;
typedef unsigned int uint32_t;
typedef long long int64_t;
typedef unsigned long long uint64_t;
#line 1 "rtc_source.cu"
"""

_lock = threading.Lock()
_lib_handle = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


class Param(NamedTuple):
    """One kernel parameter of a signature."""
    ctype: str
    pointer: bool
    const: bool
    name: str


def parse_signature(signature: str) -> List[Param]:
    """``"const float *x, float *y, float alpha, int n"`` -> Params.
    Pointers are arrays (non-``const`` ones are written); the rest are
    scalars. Types are those of :data:`TYPES`."""
    params = []
    for i, part in enumerate(p for p in signature.split(",") if p.strip()):
        toks = [t for t in part.replace("*", " * ").split()
                if t not in ("__restrict__", "restrict")]
        stars = toks.count("*")
        const = "const" in toks[:toks.index("*")] if stars else False
        rest = [t for t in toks if t not in ("*", "const")]
        check(stars <= 1 and 1 <= len(rest) <= 2,
              f"signature parameter {i} ({part.strip()!r}): expected "
              "'[const] type [*]name'")
        check(rest[0] in TYPES,
              f"signature parameter {i} ({part.strip()!r}): type "
              f"{rest[0]!r} unsupported; use one of {sorted(TYPES)}")
        params.append(Param(rest[0], stars == 1, const,
                            rest[1] if len(rest) == 2 else f"arg{i}"))
    return params


def _lib():
    """The loaded NVRTC shim, built at first use."""
    global _lib_handle
    with _lock:
        if _lib_handle is not None:
            return _lib_handle
        try:
            lib = _build.load("rtc")
        except OSError as e:
            raise MXNetError(f"the NVRTC shim did not load (is libnvrtc or "
                             f"the CUDA driver missing?): {e}") from None
        p, i, c = ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p
        u = ctypes.c_uint
        lib.mxt_rtc_last_error.argtypes = []
        lib.mxt_rtc_last_error.restype = c
        lib.mxt_rtc_compile.argtypes = [c, c, i, ctypes.POINTER(c), i,
                                        ctypes.POINTER(c), ctypes.POINTER(p)]
        for fn in ("compile", "load", "unload", "get_function", "launch"):
            getattr(lib, f"mxt_rtc_{fn}").restype = i
        lib.mxt_rtc_lowered_name.argtypes = [p, i]
        lib.mxt_rtc_lowered_name.restype = c
        lib.mxt_rtc_free.argtypes = [p]
        lib.mxt_rtc_free.restype = None
        lib.mxt_rtc_load.argtypes = [p, i, ctypes.POINTER(p),
                                     ctypes.POINTER(p)]
        lib.mxt_rtc_unload.argtypes = [p, p]
        lib.mxt_rtc_get_function.argtypes = [p, c, ctypes.POINTER(p)]
        lib.mxt_rtc_launch.argtypes = [p, p, u, u, u, u, u, u, u, p,
                                       ctypes.POINTER(p)]
        _lib_handle = lib
        return lib


def _error(lib) -> str:
    return (lib.mxt_rtc_last_error() or b"").decode(errors="replace")


def _c_strings(items: Sequence[str]):
    return (ctypes.c_char_p * max(1, len(items)))(
        *[s.encode() for s in items])


class CudaModule:
    """CUDA C++ source compiled with NVRTC (ref: mx.rtc.CudaModule).

    source : the kernels' CUDA C++ text.
    options : extra NVRTC options (``-D...``, ``--use_fast_math``...).
    exports : kernel names (or name expressions, e.g. template
        instances) to export; when given, only these can be fetched.
    """

    def __init__(self, source: str, options: Sequence[str] = (),
                 exports: Sequence[str] = ()):
        if not torch.cuda.is_available():
            raise MXNetError("CudaModule needs a CUDA device, and none is "
                             "available: NVRTC kernels run only on the "
                             "card")
        self._lib = lib = _lib()
        inc = os.path.join(_build.cuda_home(), "include")
        opts = ["--gpu-architecture=sm_90a", "--std=c++17", f"-I{inc}",
                *options]
        self._exports = tuple(exports)
        handle = ctypes.c_void_p()
        t0 = time.perf_counter()
        rc = lib.mxt_rtc_compile(
            (_PREAMBLE + source).encode(), b"rtc_source.cu", len(opts),
            _c_strings(opts), len(self._exports),
            _c_strings(self._exports), ctypes.byref(handle))
        #: NVRTC compile time of this module, in ms (host clock)
        self.compile_ms = 1e3 * (time.perf_counter() - t0)
        from .telemetry.registry import note_compile
        note_compile("nvrtc", self.compile_ms / 1e3, "CudaModule")
        if rc != 0:
            # a name in exports that the source lacks fails here too
            with_exports = f" with exports {list(self._exports)}" \
                if self._exports else ""
            raise MXNetError(f"CudaModule: NVRTC could not compile the "
                             f"source{with_exports}:\n{_error(lib)}")
        self._handle = handle
        self._lowered = {e: lib.mxt_rtc_lowered_name(handle, i).decode()
                         for i, e in enumerate(self._exports)}
        self._loaded: Dict[int, tuple] = {}     # card -> (module, context)
        self._functions: Dict[tuple, ctypes.c_void_p] = {}
        #: ms to load the image into each card's context (first launch)
        self.load_ms: Dict[int, float] = {}

    def get_kernel(self, name: str, signature: str) -> "CudaKernel":
        """The kernel ``name`` with C parameter list ``signature`` (ref:
        CudaModule.get_kernel)."""
        if self._exports:
            check(name in self._exports,
                  f"kernel {name!r} not found: the module exports "
                  f"{list(self._exports)}")
        return CudaKernel(self, name, self._lowered.get(name, name),
                          parse_signature(signature))

    def _function(self, device: int, symbol: str):
        key = (device, symbol)
        fn = self._functions.get(key)
        if fn is not None:
            return fn, self._loaded[device][1]
        lib = self._lib
        if device not in self._loaded:
            mod, ctx = ctypes.c_void_p(), ctypes.c_void_p()
            t0 = time.perf_counter()
            if lib.mxt_rtc_load(self._handle, device, ctypes.byref(mod),
                                ctypes.byref(ctx)) != 0:
                raise MXNetError(f"CudaModule: {_error(lib)}")
            self.load_ms[device] = 1e3 * (time.perf_counter() - t0)
            self._loaded[device] = (mod, ctx)
        mod, ctx = self._loaded[device]
        fn = ctypes.c_void_p()
        if lib.mxt_rtc_get_function(mod, symbol.encode(),
                                    ctypes.byref(fn)) != 0:
            raise MXNetError(
                f"kernel {symbol!r} not found in the module ({_error(lib)});"
                " declare it extern \"C\" or pass its name in exports=")
        self._functions[key] = fn
        return fn, ctx

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is None or getattr(self, "_handle", None) is None:
            return
        for mod, ctx in self._loaded.values():
            lib.mxt_rtc_unload(mod, ctx)
        lib.mxt_rtc_free(self._handle)


def _dims(dims, what: str):
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    check(1 <= len(dims) <= 3 and all(isinstance(d, (int, np.integer))
                                      and d > 0 for d in dims),
          f"{what} must be 1 to 3 positive ints, not {dims!r}")
    return tuple(int(d) for d in dims) + (1,) * (3 - len(dims))


def _scalar(p: Param, value, where: str):
    from .ndarray.ndarray import NDArray
    check(not isinstance(value, (NDArray, torch.Tensor, bool)) and
          isinstance(value, (int, float, np.number)),
          f"{where}: {p.ctype} {p.name} is a scalar; pass a number, not "
          f"{type(value).__name__}")
    dtype, ctype = TYPES[p.ctype]
    if not dtype.is_floating_point:
        check(isinstance(value, (int, np.integer)),
              f"{where}: {p.ctype} {p.name} takes an int, not {value!r}")
        return ctype(int(value))
    if p.ctype == "__half":
        return ctype(int(np.array(value, np.float16).view(np.uint16)))
    if p.ctype == "__nv_bfloat16":
        bits = torch.tensor(float(value), dtype=torch.bfloat16).view(
            torch.int16).item()
        return ctype(bits & 0xFFFF)
    return ctype(float(value))


class CudaKernel:
    """A launchable kernel of a :class:`CudaModule` (ref: mx.rtc.CudaKernel).
    """

    def __init__(self, module: CudaModule, name: str, symbol: str,
                 params: List[Param]):
        self._module = module
        self.name = name
        self._symbol = symbol
        self.params = params
        launches.setdefault(name, 0)

    def launch(self, args: Sequence, ctx=None, grid_dims=(1,),
               block_dims=(1,), shared_mem: int = 0) -> None:
        """Launch on ``ctx`` (a gpu Context; by default the first array's)
        with ``grid_dims`` blocks of ``block_dims`` threads and
        ``shared_mem`` bytes of dynamic shared memory. The arrays of
        non-``const`` pointers are written in place."""
        from .ndarray.ndarray import NDArray
        where = f"kernel {self.name}"
        args = list(args) if isinstance(args, (list, tuple)) else [args]
        check(len(args) == len(self.params),
              f"{where} takes {len(self.params)} arguments, got {len(args)}")
        if ctx is None:
            ctx = next((a.context for a in args if isinstance(a, NDArray)),
                       None)
        check(ctx is not None, f"{where}: pass ctx=mx.gpu(i)")
        ctx = Context(ctx)
        check(ctx.device_type == "gpu",
              f"{where}: CUDA kernels launch on a gpu context, not {ctx}")
        device = ctx.torch_device
        grid = _dims(grid_dims, "grid_dims")
        block = _dims(block_dims, "block_dims")
        check(isinstance(shared_mem, (int, np.integer)) and shared_mem >= 0,
              f"{where}: shared_mem must be a byte count >= 0, not "
              f"{shared_mem!r}")
        # kinds and types first, then placement
        for i, (p, a) in enumerate(zip(self.params, args)):
            if not p.pointer:
                continue
            check(isinstance(a, NDArray),
                  f"{where} argument {i} ({p.name}) is a {p.ctype} pointer: "
                  f"pass an NDArray, not {type(a).__name__}")
            dtype = TYPES[p.ctype][0]
            check(a._data.dtype == dtype,
                  f"{where} argument {i} ({p.name}): {p.ctype} needs "
                  f"{dtype}, got {a._data.dtype}")
        values = [None if p.pointer else
                  _scalar(p, a, f"{where} argument {i}")
                  for i, (p, a) in enumerate(zip(self.params, args))]
        written = []
        for i, (p, a) in enumerate(zip(self.params, args)):
            if not p.pointer:
                continue
            t = a._data
            check(t.device == device,
                  f"{where} argument {i} ({p.name}) lives on {a.context}, "
                  f"not on {ctx}")
            check(t.is_contiguous(),
                  f"{where} argument {i} ({p.name}) is not contiguous")
            if not p.const:
                check(not (autograd.is_recording() and t.requires_grad),
                      f"{where} argument {i} ({p.name}) is written in "
                      "place, which autograd does not record: launch it "
                      "outside autograd.record()")
                written.append(t)
            values[i] = ctypes.c_void_p(t.data_ptr())
        fn, cu_ctx = self._module._function(device.index, self._symbol)
        ptrs = (ctypes.c_void_p * max(1, len(values)))(
            *[ctypes.cast(ctypes.pointer(v), ctypes.c_void_p)
              for v in values])
        lib = self._module._lib
        rc = lib.mxt_rtc_launch(
            fn, cu_ctx, *grid, *block, int(shared_mem),
            torch.cuda.current_stream(device).cuda_stream, ptrs)
        if rc != 0:
            raise MXNetError(f"{where}: launch failed: {_error(lib)}")
        # the writes bypass torch: bump the version counters, so that a
        # graph which saved one of these tensors fails instead of using it
        for t in written:
            torch.autograd.graph.increment_version(t)
        launches[self.name] = launches.get(self.name, 0) + 1

    __call__ = launch

    def __repr__(self):
        return f"<CudaKernel {self.name}>"


class PallasModule:
    """The JAX package's TPU facility; the port compiles CUDA instead."""

    def __init__(self, *a, **kw):
        raise MXNetError(
            "PallasModule compiles Pallas kernels for the TPU and exists "
            "only in the JAX package; in mxnet_tpu_torch write runtime "
            "kernels in CUDA C++ with mxnet_tpu_torch.rtc.CudaModule "
            "(NVRTC)")
