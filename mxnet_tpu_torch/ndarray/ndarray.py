"""NDArray: the imperative array type over a ``torch.Tensor`` (ref: the JAX
package's ``ndarray/ndarray.py``; include/mxnet/ndarray.h in the
reference).

``NDArray._data`` is the tensor; the array's context is the tensor's
device. What the JAX package does with immutable ``jax.Array``s and a
version counter, the port does with torch's own machinery:

- Ops go through the registry (:func:`imperative_invoke`). Under
  ``autograd.record()`` they run with torch autograd on and build its
  graph; outside it they run under ``torch.no_grad()``, even on arrays
  with attached gradients, as MXNet records only inside ``record()``.
- An op's output never aliases its inputs: where torch would return a
  view (reshape, slicing, transpose...), the output is copied, so writing
  into one array never changes another (the JAX package's value
  semantics).
- Writes (``+=``, ``x[i] = v``, ``out=``, ``copyto``) go into the
  tensor in place when autograd is not recording, so the tensor keeps its
  storage (a kernel launched through ``rtc`` may hold its pointer) and
  torch's version counter flags a graph that saved it. While recording
  they rebind the array to a new tensor that carries the graph.
- ``asnumpy()`` of a bfloat16 array returns the exact float32 widening:
  numpy has no bfloat16 without ``ml_dtypes``, which the port does not
  use (the JAX package returns an ``ml_dtypes`` array of the same
  values).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as _np
import torch

from .. import autograd
from ..base import MXNetError, check, numpy_dtype, torch_dtype
from ..context import Context, current_context, resolve_device
from ..ops import registry as _reg

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "linspace", "eye", "concatenate", "stack", "from_torch",
           "moveaxis", "waitall", "imperative_invoke"]


class NDArray:
    __slots__ = ("_data", "_grad", "_grad_req", "_fresh_grad", "__weakref__")

    __array_priority__ = 100.0

    def __init__(self, data: torch.Tensor):
        self._data = data
        self._grad: Optional["NDArray"] = None
        self._grad_req: Optional[str] = None
        # set on a gradient buffer when backward writes it, cleared by the
        # optimizer step that consumes it (Trainer's stale-gradient check)
        self._fresh_grad = False

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(self._data.shape)

    @property
    def dtype(self):
        """A numpy dtype; ``torch.bfloat16`` for bfloat16 arrays."""
        return numpy_dtype(self._data.dtype)

    @property
    def size(self) -> int:
        return self._data.numel()

    @property
    def ndim(self) -> int:
        return self._data.dim()

    @property
    def context(self) -> Context:
        return Context(self._data.device)

    ctx = context

    @property
    def stype(self) -> str:
        return "default"

    @property
    def T(self) -> "NDArray":
        return self.transpose()

    @property
    def grad(self) -> Optional["NDArray"]:
        return self._grad

    @property
    def tensor(self) -> torch.Tensor:
        """The underlying ``torch.Tensor`` (shared, not copied)."""
        return self._data

    # ------------------------------------------------------------------
    # writes and synchronisation
    # ------------------------------------------------------------------
    def _write(self, value: torch.Tensor) -> "NDArray":
        """Store ``value`` as this array's contents: in place outside
        recording when shape and dtype allow, else by rebinding."""
        if not autograd.is_recording() and value.shape == self._data.shape \
                and value.dtype == self._data.dtype:
            with torch.no_grad():
                self._data.copy_(value)
        else:
            self._data = value
        return self

    def wait_to_read(self) -> None:
        """Block until the work queued on the array's stream is done (ref:
        ndarray.h WaitToRead)."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    def wait_to_write(self) -> None:
        self.wait_to_read()

    # ------------------------------------------------------------------
    # conversion
    # ------------------------------------------------------------------
    def asnumpy(self) -> _np.ndarray:
        """A numpy copy; bfloat16 comes back as its exact float32
        widening."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            return t.float().cpu().numpy()
        if t.is_cuda:
            return t.cpu().numpy()
        return t.numpy().copy()

    def asscalar(self):
        check(self.size == 1, "The current array is not a scalar")
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    # -- DLPack (ref: MXNDArrayToDLPack / python/mxnet/dlpack.py); the
    # capsule shares the tensor's memory, so writes go both ways, as in
    # the reference
    def __dlpack__(self, **kwargs):
        return self._data.detach().__dlpack__(**kwargs)

    def __dlpack_device__(self):
        return self._data.__dlpack_device__()

    def to_dlpack_for_read(self):
        self.wait_to_read()
        return torch.utils.dlpack.to_dlpack(self._data.detach())

    def to_dlpack_for_write(self):
        return self.to_dlpack_for_read()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        if self.size == 0:
            return False
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __len__(self) -> int:
        check(self.ndim > 0, "len() of a 0-d NDArray")
        return self.shape[0]

    def __repr__(self) -> str:
        return f"\n{self.asnumpy()}\n<NDArray " \
               f"{'x'.join(map(str, self.shape))} @{self.context}>"

    def __array__(self, dtype=None, copy=None):
        a = self.asnumpy()
        return a.astype(dtype) if dtype is not None else a

    def __reduce__(self):
        # pickled through numpy (ref: NDArray __reduce__); bfloat16 travels
        # as float32 and is cast back
        if self._data.dtype == torch.bfloat16:
            return (_unpickle_bf16, (self.asnumpy(),))
        return (array, (self.asnumpy(),))

    def astype(self, dtype, copy: bool = True) -> "NDArray":
        dtype = torch_dtype(dtype)
        if not copy and self._data.dtype == dtype:
            return self
        return imperative_invoke("cast", (self,), {"dtype": dtype})

    def copy(self) -> "NDArray":
        return self.copyto(self.context)

    def copyto(self, other: Union[Context, "NDArray"]) -> "NDArray":
        """Copy into ``other`` (an NDArray, written in place) or onto a
        context (a new NDArray); not recorded, as in the JAX package."""
        src = self._data.detach()
        if isinstance(other, NDArray):
            return other._write(src.to(other._data.device, copy=True))
        return NDArray(src.to(resolve_device(other), copy=True))

    def as_in_context(self, context: Context) -> "NDArray":
        if context == self._data.device:
            return self
        return self.copyto(context)

    as_in_ctx = as_in_context

    def as_nd_ndarray(self):
        return self

    # ------------------------------------------------------------------
    # autograd
    # ------------------------------------------------------------------
    def attach_grad(self, grad_req: str = "write", stype=None) -> None:
        """Allocate a gradient buffer and mark the array as a variable
        (ref: Imperative::MarkVariables). ``grad_req``: write, add or
        null."""
        check(stype in (None, "default"),
              f"attach_grad(stype={stype!r}): sparse gradients are not "
              "ported yet (see ROADMAP.md)")
        grad = NDArray(torch.zeros_like(self._data.detach()))
        autograd.mark_variables([self], [grad], grad_req)

    def detach(self) -> "NDArray":
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph: bool = False,
                 train_mode: bool = True) -> None:
        autograd.backward([self], [out_grad] if out_grad is not None
                          else None, retain_graph=retain_graph,
                          train_mode=train_mode)

    # ------------------------------------------------------------------
    # indexing
    # ------------------------------------------------------------------
    def __getitem__(self, key) -> "NDArray":
        if isinstance(key, (int, _np.integer)):
            n = self.shape[0] if self.ndim > 0 else 0
            if not -n <= key < n:
                raise IndexError(f"index {key} is out of bounds for axis 0 "
                                 f"with size {n}")
        key = _index_key(key, self._data.device)
        return _apply(lambda t: _getitem(t, key), (self,))

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def __setitem__(self, key, value) -> None:
        key = _index_key(key, self._data.device)
        if isinstance(value, NDArray):
            v = value._data.to(self._data.device, self._data.dtype)
        else:
            v = torch.as_tensor(_np.asarray(value), device=self._data.device
                                ).to(self._data.dtype)
        if autograd.is_recording():
            with torch.enable_grad():
                new = self._data.clone()
                _setitem(new, key, v)
            self._data = new
        else:
            with torch.no_grad():
                _setitem(self._data, key, v)

    # ------------------------------------------------------------------
    # arithmetic: the dunders go through the registry as the reference's
    # do; scalar operands take the *_scalar ops
    # ------------------------------------------------------------------
    def _binary(self, other, op: str, scalar_op: str, reverse: bool = False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return imperative_invoke(op, (a, b), {})
        if isinstance(other, (int, float, bool, _np.number)):
            return imperative_invoke(scalar_op, (self,),
                                     {"scalar": float(other),
                                      "reverse": reverse})
        if isinstance(other, _np.ndarray):
            return self._binary(array(other, ctx=self.context), op,
                                scalar_op, reverse)
        return NotImplemented

    def __add__(self, o):  return self._binary(o, "broadcast_add", "_plus_scalar")
    def __radd__(self, o): return self._binary(o, "broadcast_add", "_plus_scalar", True)
    def __sub__(self, o):  return self._binary(o, "broadcast_sub", "_minus_scalar")
    def __rsub__(self, o): return self._binary(o, "broadcast_sub", "_rminus_scalar", True)
    def __mul__(self, o):  return self._binary(o, "broadcast_mul", "_mul_scalar")
    def __rmul__(self, o): return self._binary(o, "broadcast_mul", "_mul_scalar", True)
    def __truediv__(self, o):  return self._binary(o, "broadcast_div", "_div_scalar")
    def __rtruediv__(self, o): return self._binary(o, "broadcast_div", "_rdiv_scalar", True)
    def __mod__(self, o):  return self._binary(o, "broadcast_mod", "_mod_scalar")
    def __rmod__(self, o): return self._binary(o, "broadcast_mod", "_rmod_scalar", True)
    def __pow__(self, o):  return self._binary(o, "broadcast_power", "_power_scalar")
    def __rpow__(self, o): return self._binary(o, "broadcast_power", "_rpower_scalar", True)
    def __matmul__(self, o): return imperative_invoke("dot", (self, o), {})

    def __iadd__(self, o): return self._write(self.__add__(o)._data)
    def __isub__(self, o): return self._write(self.__sub__(o)._data)
    def __imul__(self, o): return self._write(self.__mul__(o)._data)
    def __itruediv__(self, o): return self._write(self.__truediv__(o)._data)

    def __neg__(self):
        return imperative_invoke("negative", (self,), {})

    def __abs__(self):
        return imperative_invoke("abs", (self,), {})

    def __eq__(self, o):  # noqa: an array, as in the reference
        if o is None:
            return False
        return self._binary(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o): return self._binary(o, "broadcast_greater", "_greater_scalar")
    def __ge__(self, o): return self._binary(o, "broadcast_greater_equal", "_greater_equal_scalar")
    def __lt__(self, o): return self._binary(o, "broadcast_lesser", "_lesser_scalar")
    def __le__(self, o): return self._binary(o, "broadcast_lesser_equal", "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    # ------------------------------------------------------------------
    # method forms of common ops
    # ------------------------------------------------------------------
    def reshape(self, *shape, **kwargs) -> "NDArray":
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if not shape:
            shape = kwargs.get("shape", ())
        return imperative_invoke("reshape", (self,), {"shape": tuple(shape)})

    def reshape_like(self, other: "NDArray") -> "NDArray":
        return imperative_invoke("reshape_like", (self, other), {})

    def broadcast_to(self, shape) -> "NDArray":
        return imperative_invoke("broadcast_to", (self,),
                                 {"shape": tuple(shape)})

    def broadcast_like(self, other) -> "NDArray":
        return imperative_invoke("broadcast_like", (self, other), {})

    def transpose(self, *axes, **kwargs) -> "NDArray":
        if "axes" in kwargs:
            check(not axes, "pass axes positionally OR as axes=, not both")
            axes = tuple(kwargs.pop("axes"))
        check(not kwargs, f"unexpected kwargs {sorted(kwargs)}")
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return imperative_invoke("transpose", (self,),
                                 {"axes": tuple(axes)} if axes else {})

    def swapaxes(self, dim1, dim2):
        return imperative_invoke("swapaxes", (self,),
                                 {"dim1": dim1, "dim2": dim2})

    def flatten(self):
        return imperative_invoke("flatten", (self,), {})

    def expand_dims(self, axis):
        return imperative_invoke("expand_dims", (self,), {"axis": axis})

    def squeeze(self, axis=None):
        return imperative_invoke("squeeze", (self,), {"axis": axis})

    def flip(self, axis):
        return imperative_invoke("flip", (self,), {"axis": axis})

    def tile(self, reps):
        return imperative_invoke("tile", (self,), {
            "reps": tuple(reps) if isinstance(reps, (tuple, list))
            else (reps,)})

    def repeat(self, repeats, axis=None):
        return imperative_invoke("repeat", (self,),
                                 {"repeats": repeats, "axis": axis})

    def pad(self, mode, pad_width, constant_value=0):
        return imperative_invoke("Pad", (self,), {
            "mode": mode, "pad_width": tuple(pad_width),
            "constant_value": constant_value})

    def clip(self, a_min, a_max):
        return imperative_invoke("clip", (self,),
                                 {"a_min": a_min, "a_max": a_max})

    def slice_axis(self, axis, begin, end):
        return imperative_invoke("slice_axis", (self,),
                                 {"axis": axis, "begin": begin, "end": end})

    def take(self, indices, axis=0, mode="clip"):
        return imperative_invoke("take", (self, indices),
                                 {"axis": axis, "mode": mode})

    def one_hot(self, depth, on_value=1.0, off_value=0.0, dtype="float32"):
        return imperative_invoke("one_hot", (self,), {
            "depth": depth, "on_value": on_value, "off_value": off_value,
            "dtype": dtype})

    def as_np_ndarray(self):
        return self

    def tostype(self, stype: str) -> "NDArray":
        check(stype == "default", "sparse storage is not ported yet "
                                  "(see ROADMAP.md)")
        return self

    def zeros_like(self):
        return imperative_invoke("zeros_like", (self,), {})

    def ones_like(self):
        return imperative_invoke("ones_like", (self,), {})


# unary / reduce method forms (the JAX package's list; softmax and
# log_softmax are the ops of ops/nn.py)
_UNARY_METHODS = [
    "abs", "sign", "exp", "log", "log2", "log10", "log1p", "expm1", "sqrt",
    "rsqrt", "cbrt", "square", "reciprocal", "sin", "cos", "tan", "arcsin",
    "arccos", "arctan", "sinh", "cosh", "tanh", "arcsinh", "arccosh",
    "arctanh", "sigmoid", "relu", "softsign", "round", "rint", "fix",
    "floor", "ceil", "trunc", "erf", "erfinv", "gamma", "gammaln", "softmax",
    "log_softmax",
]
_REDUCE_METHODS = ["sum", "mean", "prod", "max", "min", "nansum", "nanprod",
                   "argmax", "argmin", "norm"]


def _add_unary_method(name: str) -> None:
    def m(self, **kwargs):
        return imperative_invoke(name, (self,), kwargs)
    m.__name__ = name
    if not hasattr(NDArray, name):
        setattr(NDArray, name, m)


def _add_reduce_method(name: str) -> None:
    def m(self, axis=None, keepdims=False, **kwargs):
        kwargs.update({"axis": axis, "keepdims": keepdims})
        return imperative_invoke(name, (self,), kwargs)
    m.__name__ = name
    if not hasattr(NDArray, name):
        setattr(NDArray, name, m)


for _n in _UNARY_METHODS:
    _add_unary_method(_n)
for _n in _REDUCE_METHODS:
    _add_reduce_method(_n)


# ---------------------------------------------------------------------------
# imperative invoke: front end -> registry -> (torch autograd)
# ---------------------------------------------------------------------------

def _own(out: torch.Tensor, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """``out``, copied if it shares storage with an input (a view)."""
    ptr = out.untyped_storage().data_ptr()
    if any(t.untyped_storage().data_ptr() == ptr for t in inputs):
        return out.clone(memory_format=torch.contiguous_format)
    return out


def _apply(fn, nd_inputs: Sequence[NDArray], differentiable: bool = True):
    """Run ``fn`` on the inputs' tensors, recorded by torch autograd when
    ``autograd.record()`` is on; returns NDArray(s)."""
    tensors = tuple(x._data for x in nd_inputs)
    devices = {t.device for t in tensors}
    check(len(devices) <= 1, f"inputs live on different devices: "
                             f"{sorted(map(str, devices))}")
    record = differentiable and autograd.is_recording()
    with torch.enable_grad() if record else torch.no_grad():
        outs = tuple(_own(o, tensors)
                     for o in _reg.as_tuple_outputs(fn(*tensors)))
    nds = tuple(NDArray(o) for o in outs)
    return nds[0] if len(nds) == 1 else nds


def imperative_invoke(op_name: str, nd_inputs: Sequence, params: dict,
                      out=None):
    """Run a registered op on NDArrays (ref: MXImperativeInvokeEx ->
    Imperative::Invoke). Non-NDArray inputs become arrays on the first
    NDArray input's context. ``out``: NDArray(s) written with the
    result."""
    opdef = _reg.get_op(op_name)
    home = next((x.context for x in nd_inputs if isinstance(x, NDArray)),
                None)
    nd_inputs = tuple(x if isinstance(x, NDArray) else array(x, ctx=home)
                      for x in nd_inputs)
    result = _apply(lambda *ts: _reg.invoke(opdef, ts, params), nd_inputs,
                    opdef.differentiable)
    if out is None:
        return result
    dsts = out if isinstance(out, (tuple, list)) else (out,)
    srcs = result if isinstance(result, tuple) else (result,)
    for dst, src in zip(dsts, srcs):
        dst._write(src._data)
    return out


def _index_key(key, device):
    """An indexing key with arrays as int64 (or bool) tensors on
    ``device``."""
    def conv(k):
        if isinstance(k, NDArray):
            k = k._data
        elif isinstance(k, (list, _np.ndarray)):
            k = torch.as_tensor(_np.asarray(k))
        else:
            return k
        k = k if k.dtype == torch.bool else k.to(torch.int64)
        return k.to(device)
    if isinstance(key, tuple):
        return tuple(conv(k) for k in key)
    return conv(key)


def _negative_steps(key) -> bool:
    return any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in (key if isinstance(key, tuple) else (key,)))


def _flip_negative_steps(t, key):
    """(t with the dims of negative-step slices flipped, the key with each
    of those slices rewritten as the same elements of the flipped dim in
    positive steps): torch slicing takes no negative step."""
    k = key if isinstance(key, tuple) else (key,)

    def width(s):
        if s is None or s is Ellipsis:
            return 0
        if isinstance(s, torch.Tensor) and s.dtype == torch.bool:
            return s.dim()
        return 1

    used = sum(width(s) for s in k)
    out, dims, d = [], [], 0
    for s in k:
        if s is Ellipsis:
            d += t.dim() - used
        elif isinstance(s, slice) and s.step is not None and s.step < 0:
            n = t.shape[d]
            r = range(*s.indices(n))
            j0 = n - 1 - r[0] if len(r) else 0
            s = slice(j0, j0 + (len(r) - 1) * -s.step + 1 if len(r) else 0,
                      -s.step)
            dims.append(d)
        out.append(s)
        d += width(s)
    return t.flip(dims), tuple(out)


def _getitem(t, key):
    if _negative_steps(key):
        t, key = _flip_negative_steps(t, key)
    return t[key]


def _setitem(t, key, v):
    if not _negative_steps(key):
        t[key] = v
        return
    # write through the flat positions that the same key selects
    pos = _getitem(torch.arange(t.numel(), device=t.device).reshape(t.shape),
                   key)
    t.view(-1)[pos.reshape(-1)] = torch.broadcast_to(v, pos.shape).reshape(-1)


# the indexing ops under the reference's registry names (ref: the JAX
# package's ndarray.py:600-615); ``_idx`` is a key as ``x[key]`` takes it

@_reg.register("_index")
def _index_impl(x, _idx=None):
    return _getitem(x, _index_key(_idx, x.device))


@_reg.register("_index_assign")
def _index_assign_impl(x, v, _idx=None):
    out = x.clone()
    _setitem(out, _index_key(_idx, x.device), v.to(x.dtype))
    return out


@_reg.register("_index_assign_scalar")
def _index_assign_scalar_impl(x, _idx=None, _val=None):
    out = x.clone()
    _setitem(out, _index_key(_idx, x.device),
             torch.as_tensor(_np.asarray(_val), device=x.device).to(x.dtype))
    return out


# ---------------------------------------------------------------------------
# creation
# ---------------------------------------------------------------------------

def _unpickle_bf16(np_arr):
    return array(np_arr).astype(torch.bfloat16)


def _device(ctx) -> torch.device:
    return resolve_device(ctx if ctx is not None else current_context())


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def array(source_array, ctx: Optional[Context] = None, dtype=None) -> NDArray:
    """An NDArray copied from an NDArray, tensor or anything numpy takes.
    Without ``dtype``, float64 becomes float32 and int64 int32, as in the
    JAX package."""
    if isinstance(source_array, (NDArray, torch.Tensor)):
        src = source_array._data if isinstance(source_array, NDArray) \
            else source_array
        dev = _device(ctx if ctx is not None else Context(src.device))
        return NDArray(src.detach().to(
            dev, dtype=torch_dtype(dtype) if dtype is not None else None,
            copy=True))
    np_arr = _np.asarray(source_array)
    if dtype is None:
        dtype = {_np.dtype("float64"): "float32",
                 _np.dtype("int64"): "int32"}.get(np_arr.dtype, np_arr.dtype)
    t = torch.from_numpy(_np.array(np_arr, copy=True, order="C"))
    return NDArray(t.to(_device(ctx), dtype=torch_dtype(dtype)))


def from_torch(tensor: torch.Tensor) -> NDArray:
    """An NDArray over ``tensor`` itself (no copy)."""
    return NDArray(tensor)


def empty(shape, ctx=None, dtype=None) -> NDArray:
    return NDArray(torch.empty(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def zeros(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return NDArray(torch.zeros(_shape(shape), dtype=torch_dtype(dtype),
                               device=_device(ctx)))


def ones(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    return NDArray(torch.ones(_shape(shape), dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def full(shape, val, ctx=None, dtype=None, **kwargs) -> NDArray:
    return NDArray(torch.full(_shape(shape), val, dtype=torch_dtype(dtype),
                              device=_device(ctx)))


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    dt = torch_dtype(dtype)
    np_dt = numpy_dtype(dt)
    arr = _np.arange(start, stop, step).astype(
        np_dt if isinstance(np_dt, _np.dtype) else _np.float32)
    if repeat > 1:
        arr = _np.repeat(arr, repeat)
    return array(arr, ctx=ctx, dtype=dt)


def linspace(start, stop, num, endpoint=True, ctx=None,
             dtype=None) -> NDArray:
    return array(_np.linspace(start, stop, num, endpoint=endpoint),
                 ctx=ctx, dtype=torch_dtype(dtype))


def eye(N, M=0, k=0, ctx=None, dtype=None) -> NDArray:
    return array(_np.eye(N, M if M else None, k), ctx=ctx,
                 dtype=torch_dtype(dtype))


def concatenate(arrays, axis=0, always_copy=True) -> NDArray:
    return imperative_invoke("concat", tuple(arrays),
                             {"dim": axis, "num_args": len(arrays)})


def stack(*arrays, axis=0) -> NDArray:
    if len(arrays) == 1 and isinstance(arrays[0], (list, tuple)):
        arrays = tuple(arrays[0])
    return imperative_invoke("stack", tuple(arrays),
                             {"axis": axis, "num_args": len(arrays)})


def moveaxis(tensor, source, destination) -> NDArray:
    return imperative_invoke("moveaxis", (tensor,),
                             {"source": source, "destination": destination})


def waitall() -> None:
    """Wait for all queued work on the cards (ref: Engine::WaitForAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
