"""Gluon Block and HybridBlock as ``torch.nn.Module``s (ref:
python/mxnet/gluon/block.py).

Naming follows MXNet: a block's prefix is its class name, lower-cased with
CamelCase breaks as the JAX package spells them, plus a per-scope counter
(``res_netv10_``); blocks built inside ``with parent.name_scope():`` take
the parent's prefix in front. Parameter names are ``prefix + short name``,
so a port model built in the same order as a JAX model carries the same
names (up to the top-level counter).

Calling a block with ``NDArray``s (the imperative loop: ``record()``,
``net(x)``, ``backward()``) unwraps them, runs ``forward`` on their
tensors and wraps the outputs; torch records a graph only while
``autograd.is_recording()``. Called with tensors (children inside a
forward, ``functional_call``, the trainer), a block is a plain
``nn.Module`` call and pays nothing extra. Layers whose behaviour depends
on the mode (BatchNorm) read ``autograd.is_training()``, never
``nn.Module.training``.

MXNet's user blocks (ref: the JAX package's ``block.py:57-246``):

- a :class:`HybridBlock` subclass that defines ``hybrid_forward(self, F,
  x, ..., **params)`` and no ``forward`` gets a ``forward`` that calls it
  with ``F = mx.nd``, its inputs as NDArrays and each of its own
  parameters (``self.params``, bound by ``params.get``) as an NDArray
  under its short name;
- a :class:`Block` subclass's ``forward`` receives and returns NDArrays.

Called with tensors (the trainers) either one wraps them, runs its
``mx.nd`` ops with recording on exactly when torch has gradients enabled,
and unwraps the outputs: ``SPMDTrainer`` and its CUDA graph get the same
gradients as ``autograd.record()`` / ``backward()``.

Deferred initialisation (ref: the JAX package's ``block.py:211-301``). A
layer built without its input width (``in_units=0``, ``in_channels=0``)
holds parameters whose tensors do not exist yet. On its first call the
block reads the width from its input (``infer_shape_from_inputs``, each
layer's rule as in the JAX package), creates those tensors once on its
device and initialises them with what ``initialize()`` recorded. A block
with nothing deferred pays one attribute test per call.

``hybridize()`` compiles nothing: PyTorch runs the forward eagerly, and
the trainer's CUDA graph (``parallel/spmd.py run_steps``) is the port's
counterpart of a compiled program (``CachedOp`` is ROADMAP A12). Its
``mirror`` is kept: a hybridized block called with gradients enabled runs
through ``util.mirror_wrapper(mirror)`` (``None`` follows
``MXNET_BACKWARD_DO_MIRROR``), resolved at its first call after
``hybridize``. ``export`` and ``SymbolBlock`` need ``symbol/`` and raise
(ROADMAP A14). With ``MXTPU_EFFICIENCY`` on, the outermost hybridized
block's call is one program of the efficiency plane (kind ``cached_op``,
keyed by block and input signature, standing in for the JAX package's
CachedOp programs): counted on its first call, noted on every call, and
its backward likewise at the next ``autograd.backward``
(``telemetry.efficiency.pending_backward``).

Checkpoints: ``save_parameters`` / ``load_parameters`` write and read
``mx.nd.save`` files (the JAX package's format) keyed by the structural
names of ``_collect_params_with_prefix``, so a file of either package
loads in the other.
"""
from __future__ import annotations

import re
import threading

import torch
from torch import nn

from .. import autograd
from ..base import MXNetError, check
from ..context import cpu
from ..ndarray import utils as nd_utils
from ..ndarray.ndarray import NDArray, _own
from ..ops.registry import NotPortedError
from ..telemetry import efficiency as _efficiency
from ..util import mirror_wrapper
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, _Holder)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "name_scope",
           "nn_block_scope"]


class _NameManager(threading.local):
    def __init__(self):
        self.counters = {}
        self.prefix_stack = [""]

    def next_prefix(self, hint: str) -> str:
        scope = self.prefix_stack[-1]
        n = self.counters.get((scope, hint), 0)
        self.counters[(scope, hint)] = n + 1
        return f"{scope}{hint}{n}_"


_names = _NameManager()


class name_scope:
    """Prefix scope for the blocks built inside it (ref: _BlockScope)."""

    def __init__(self, prefix: str):
        self.prefix = prefix

    def __enter__(self):
        _names.prefix_stack.append(self.prefix)
        return self

    def __exit__(self, *exc):
        _names.prefix_stack.pop()


nn_block_scope = name_scope


def _hint(cls_name: str) -> str:
    hint = re.sub("(.)([A-Z][a-z]+)", r"\1_\2", cls_name)
    return re.sub("([a-z0-9])([A-Z])", r"\1\2", hint).lower()


def _wrap(x):
    return NDArray(x) if isinstance(x, torch.Tensor) else x


def _unwrap(out):
    """An output of NDArrays (or a tuple / list of them) as tensors."""
    if isinstance(out, NDArray):
        return out._data
    if isinstance(out, (tuple, list)):
        return type(out)(_unwrap(o) for o in out)
    return out


def _nd_call(fn, args, kwargs):
    """``fn`` on the tensors as NDArrays, its ``mx.nd`` ops recorded when
    torch has gradients enabled (the trainers' forward), its NDArray
    outputs back as tensors."""
    prev = autograd.set_recording(torch.is_grad_enabled())
    try:
        out = fn(*(_wrap(a) for a in args),
                 **{k: _wrap(v) for k, v in kwargs.items()})
    finally:
        autograd.set_recording(prev)
    return _unwrap(out)


class Block(nn.Module):
    """Base block: an ``nn.Module`` with an MXNet prefix and a
    :class:`ParameterDict` of its own parameters (``params=``: a
    dictionary to share parameters from). ``device`` (default: the current
    context) is where its parameters are allocated. A subclass's
    ``forward`` receives and returns NDArrays (see the module
    docstring)."""

    def __init__(self, prefix=None, params=None, device=None):
        super().__init__()
        self._prefix = prefix if prefix is not None \
            else _names.next_prefix(_hint(type(self).__name__))
        self._params = ParameterDict(self._prefix, shared=params,
                                     owner=self)
        self._device = None if device is None else torch.device(device)
        self._deferred = []      # own parameters whose shape is not known

    # -- naming ---------------------------------------------------------
    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def name(self) -> str:
        return self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix

    @property
    def params(self) -> ParameterDict:
        return self._params

    def name_scope(self) -> name_scope:
        return name_scope(self._prefix)

    # -- parameters -----------------------------------------------------
    def __setattr__(self, name, value):
        """``self.x = param`` adopts a :class:`Parameter` (ref: block.py
        __setattr__): the attribute holds the record, the tensor is the
        block's own under the parameter's short name."""
        if isinstance(value, Parameter):
            self._adopt(value)
            object.__setattr__(self, name, value)
            return
        super().__setattr__(name, value)

    def _adopt(self, p: Parameter) -> None:
        """Make ``p`` one of this block's parameters, its tensor registered
        here under its short name: bound now if it is free-standing, moved
        here from its holder, or shared with the block that owns it."""
        if p.name not in self._params:
            self._params[p.name] = p
        short = self._params._short(p.name)
        if p.block is self and p.attr == short:
            return
        if p.block is None:
            p._bind(self, short)
            if not p._shape_known():
                self._deferred.append(p)
            return
        t = p.tensor
        if p._trained:
            self.register_parameter(short, t)
        else:
            self.register_buffer(short, t)
        if isinstance(p.block, _Holder):
            p._block, p._attr = self, short

    def _new_param(self, name, shape, grad_req="write", init=None,
                   dtype=torch.float32, allow_deferred_init=False
                   ) -> Parameter:
        """Declare ``self.<name>`` on this block's device: an
        ``nn.Parameter`` if trained, a buffer if ``grad_req == 'null'``.
        A shape with a 0 (allowed with ``allow_deferred_init``) leaves the
        attribute ``None`` until the first forward knows it. Values are set
        by :meth:`initialize` or by weight conversion."""
        shape = tuple(int(s) for s in shape)
        check(all(s > 0 for s in shape) or allow_deferred_init,
              f"{self._prefix}{name}: shape {shape} must be fully known "
              "(this layer cannot defer it)")
        p = Parameter(self._prefix + name, grad_req=grad_req, shape=shape,
                      dtype=dtype, init=init,
                      allow_deferred_init=allow_deferred_init)
        self._params[p.name] = p
        p._bind(self, name)
        if not p._shape_known():
            self._deferred.append(p)
        return p

    def infer_shape_from_inputs(self, *args, **kwargs) -> None:
        """Fill the deferred parameters' shapes from the inputs (each
        layer's rule; ref: the JAX package's block.py)."""
        raise DeferredInitializationError(
            f"{type(self).__name__} has uninitialized-shape parameters and "
            "no shape inference rule; initialize with explicit shapes")

    def _finish_deferred(self, *args, **kwargs) -> None:
        with torch.no_grad():
            self.infer_shape_from_inputs(*args, **kwargs)
        for p in self._deferred:
            if p.tensor is None:
                p._finish_deferred()
        self._deferred = []

    def register_child(self, block, name=None) -> None:
        self.add_module(name or str(len(self._modules)), block)

    def collect_params(self, select=None) -> ParameterDict:
        """Own parameters, then each child's, in build order; ``select``:
        a regular expression the names must match (ref: block.py
        collect_params)."""
        ret = ParameterDict(self._prefix)
        pattern = re.compile(select) if select is not None else None
        ret.update((k, v) for k, v in self._params.items()
                   if pattern is None or pattern.match(k))
        for child in self.children():
            if isinstance(child, Block):
                ret.update(child.collect_params(select))
        return ret

    def _collect_params_with_prefix(self, prefix: str = "") -> dict:
        """Parameters under structural names (``"0.weight"``,
        ``"features.3.body.1.gamma"``: child attribute names and the
        parameter's short name), which do not depend on the name counters
        (ref: the JAX package's ``block.py``; the checkpoint format)."""
        if prefix:
            prefix += "."
        ret = {prefix + k[len(self._prefix):]: v
               for k, v in self._params.items()}
        for name, child in self.named_children():
            if isinstance(child, Block):
                ret.update(child._collect_params_with_prefix(prefix + name))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False, generator=None) -> None:
        """Fill every parameter not yet set: a parameter's own initializer
        when it has one, else ``init`` (default ``Uniform(0.07)``, MXNet's);
        names decide the bias / gamma / beta / running-stat values as in
        MXNet. Random draws use ``generator`` (default: one seeded with
        ``mx.random.seed``'s last seed, 0 before it is called, per
        device). ``ctx`` moves the parameters there first. A deferred
        parameter keeps the initializer and the generator for its block's
        first forward."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit,
                                         generator)

    def cast(self, dtype) -> None:
        """Cast every parameter of the block and its children to ``dtype``
        in place (``Parameter.cast``)."""
        for p in self.collect_params().values():
            p.cast(dtype)

    def hybridize(self, active: bool = True, **kwargs) -> None:
        """Passed on to the children (a plain Block compiles nothing)."""
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    # -- persistence ----------------------------------------------------
    def save_parameters(self, filename: str) -> None:
        """``mx.nd.save`` of every parameter under its structural name
        (ref: block.py save_parameters)."""
        nd_utils.save(filename, {k: v.data() for k, v in
                                 self._collect_params_with_prefix().items()})

    save_params = save_parameters

    def load_parameters(self, filename: str, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current") -> None:
        """Set the parameters from a :meth:`save_parameters` file (either
        package's), in place. A name of the block missing from the file
        raises unless ``allow_missing``, one of the file missing from the
        block unless ``ignore_extra``. Values take each parameter's dtype;
        with ``cast_dtype`` and ``dtype_source="saved"`` the parameter is
        cast to the file's dtype first. ``ctx``: moved there after."""
        # read onto the host; set_data copies to each parameter's device
        loaded = nd_utils.load(filename, ctx=cpu())
        params = self._collect_params_with_prefix()
        if not allow_missing:
            for name in params:
                check(name in loaded, f"parameter {name} missing in file")
        for name, data in loaded.items():
            if name not in params:
                if ignore_extra:
                    continue
                raise MXNetError(f"parameter {name} not present in Block")
            if cast_dtype and dtype_source == "saved":
                params[name].cast(data.dtype)
            params[name].set_data(data)
        if ctx is not None:
            for p in params.values():
                p.reset_ctx(ctx)

    def load_params(self, filename, ctx=None, **kw) -> None:
        self.load_parameters(filename, ctx=ctx, **kw)

    # -- execution ------------------------------------------------------
    def __call__(self, *args, **kwargs):
        """NDArrays in, NDArrays out; tensors in, tensors out."""
        if any(isinstance(a, NDArray) for a in (*args, *kwargs.values())):
            return self.forward(*args, **kwargs)
        return _nd_call(self.forward, args, kwargs)

    def forward(self, *args):
        raise NotImplementedError

    def infer_shape(self, *args) -> None:
        """Resolve deferred parameter shapes from the inputs: one forward
        in inference mode, recording nothing."""
        with autograd.pause(), torch.no_grad():
            self(*args)

    def summary(self, *inputs) -> None:
        """Run the inputs through and print the parameter count (the JAX
        package's one line)."""
        self(*inputs)
        n = sum(p.tensor.numel() for p in self.collect_params().values()
                if p.tensor is not None)
        print(f"{type(self).__name__}: {n} parameters")

    def export(self, path, epoch=0, *args, **kwargs):
        raise NotPortedError("export writes a symbol graph; symbol/ is not "
                             "ported yet (ROADMAP A14)")

    def extra_repr(self) -> str:
        return f"prefix={self._prefix!r}"


class HybridBlock(Block):
    """A block whose ``forward`` takes and returns tensors, or that defines
    ``hybrid_forward(F, *inputs, **params)`` instead (see the module
    docstring)."""

    def __init__(self, prefix=None, params=None, device=None):
        super().__init__(prefix=prefix, params=params, device=device)
        self._active = False
        self._mirror_arg = None
        self._mirror = None      # util.mirror_wrapper, at the first call

    def __call__(self, *args, **kwargs):
        """NDArrays in, NDArrays out (see the module docstring); tensors
        in, tensors out."""
        if not any(isinstance(a, NDArray) for a in (*args,
                                                      *kwargs.values())):
            if self._deferred:
                self._finish_deferred(*args, **kwargs)
            if self._active and _efficiency.notes_on():
                return _efficiency.observe_block(
                    self, lambda: self._tensor_call(*args, **kwargs),
                    args, kwargs)
            return self._tensor_call(*args, **kwargs)
        args = tuple(a._data if isinstance(a, NDArray) else a for a in args)
        kwargs = {k: v._data if isinstance(v, NDArray) else v
                  for k, v in kwargs.items()}
        inputs = [t for t in (*args, *kwargs.values())
                  if isinstance(t, torch.Tensor)]
        with torch.enable_grad() if autograd.is_recording() \
                else torch.no_grad():
            out = self(*args, **kwargs)
        if isinstance(out, torch.Tensor):
            return NDArray(_own(out, inputs))
        return type(out)(NDArray(_own(o, inputs)) for o in out)

    def _tensor_call(self, *args, **kwargs):
        if self._active and torch.is_grad_enabled():
            if self._mirror is None:
                self._mirror = mirror_wrapper(self._mirror_arg)
            return self._mirror(super(Block, self).__call__)(
                *args, **kwargs)
        return super(Block, self).__call__(*args, **kwargs)

    def forward(self, *args, **kwargs):
        """``hybrid_forward(mx.nd, *inputs, **own parameters)`` on
        NDArrays, for a subclass that defines ``hybrid_forward``."""
        from .. import ndarray as F
        own = {}
        for name in self._params:
            short = self._params._short(name)
            t = self._parameters[short] if short in self._parameters \
                else self._buffers[short]
            if t is None:
                raise DeferredInitializationError(
                    f"parameter {name!r} has deferred initialization")
            own[short] = t
        return _nd_call(lambda *a, **kw: self.hybrid_forward(F, *a, **kw),
                        args, {**kwargs, **own})

    def hybrid_forward(self, F, *args, **kwargs):
        raise NotImplementedError

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, mirror=None,
                  **kwargs) -> None:
        """Keep the flag and ``mirror`` (see the module docstring); the
        children get the same."""
        self._active = active
        self._mirror_arg = mirror
        self._mirror = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, mirror=mirror,
                          **kwargs)


class SymbolBlock(HybridBlock):
    """A block over a symbol graph: needs ``symbol/`` (ROADMAP A14)."""

    def __init__(self, outputs, inputs, params=None):
        raise NotPortedError("SymbolBlock runs a symbol graph; symbol/ is "
                             "not ported yet (ROADMAP A14)")

    @classmethod
    def imports(cls, symbol_file, input_names, param_file=None, ctx=None):
        raise NotPortedError("SymbolBlock.imports loads a symbol graph; "
                             "symbol/ is not ported yet (ROADMAP A14)")
