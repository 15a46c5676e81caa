"""Gluon Block and HybridBlock as ``torch.nn.Module``s (ref:
python/mxnet/gluon/block.py).

Naming follows MXNet: a block's prefix is its class name, lower-cased with
CamelCase breaks as the JAX package spells them, plus a per-scope counter
(``res_netv10_``); blocks built inside ``with parent.name_scope():`` take
the parent's prefix in front. Parameter names are ``prefix + short name``,
so a port model built in the same order as a JAX model carries the same
names (up to the top-level counter).

Calling a block with ``NDArray``s (the imperative loop: ``record()``,
``net(x)``, ``backward()``), also inside lists (a recurrent block's
states), unwraps them, runs ``forward`` on their tensors and wraps the
output tensors; torch records a graph only while
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

``hybridize()`` routes the block's calls through a
:class:`~mxnet_tpu_torch.cached_op.CachedOp`, built at its first call
(ref: the JAX package's ``block.py:201-281``): on a card one CUDA graph
per signature, a forward graph for inference and a forward and a
backward graph under ``autograd.record()``; on the CPU the same cache,
keys and counters over eager runs. Blocks nested in a hybridized block
run inside its graphs. ``hybridize(mirror=)`` recomputes activations in
the backward (``util.mirror_wrapper``; ``None`` follows
``MXNET_BACKWARD_DO_MIRROR``). With ``MXTPU_EFFICIENCY`` on, the
CachedOp's forward and backward programs are the efficiency plane's
``cached_op`` programs.

Symbols (ref: the JAX package's ``block.py:253-270, 298-363``). A block
called with :class:`~mxnet_tpu_torch.symbol.Symbol` inputs returns a
Symbol: ``hybrid_forward(mx.sym, *inputs, **params)`` with each parameter
a variable of its full name (aux when it is not differentiable). A user
block's ``hybrid_forward`` serves as it is; every built-in layer, the
fused BN blocks, the ResNet blocks and the int8 blocks define a
``hybrid_forward`` twin of their tensor ``forward`` that emits the JAX
layer's ops and attributes, so ``export`` (``path-symbol.json`` +
``path-NNNN.params`` with ``arg:`` / ``aux:`` keys) writes the JAX
package's files. :class:`SymbolBlock` runs a symbol graph
(``symbol.executor.walk_inputs``, inference mode as in the JAX package)
with the graph's variables as its parameters; hybridized, it is a
CachedOp like any block.

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
from torch.utils import _pytree as pytree

from .. import autograd
from ..base import MXNetError, check
from ..context import cpu
from ..ndarray import utils as nd_utils
from ..ndarray.ndarray import NDArray, _own
from ..cached_op import CachedOp
from ..symbol.symbol import Symbol
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


def _nested(v) -> bool:
    return isinstance(v, (list, tuple, dict))


def has_ndarray(values) -> bool:
    """Whether an NDArray is among ``values`` or inside a list, tuple or
    dict of them (a recurrent block's list of states)."""
    for v in values:
        if isinstance(v, NDArray) or (_nested(v) and any(
                isinstance(x, NDArray) for x in pytree.tree_leaves(v))):
            return True
    return False


def _unwrap(out):
    """An output of NDArrays (or lists, tuples and dicts of them) as
    tensors."""
    if isinstance(out, NDArray):
        return out._data
    return pytree.tree_map(lambda v: v._data if isinstance(v, NDArray)
                           else v, out) if _nested(out) else out


def ndarray_call(fn, args, kwargs):
    """``fn(*args, **kwargs)`` taking and giving tensors, called with
    NDArrays (also inside lists of states): their tensors in, under
    ``enable_grad`` while ``autograd.record()`` is on and ``no_grad``
    otherwise, and every output tensor wrapped as an NDArray (copied where
    one is a view of an input)."""
    args, kwargs = _unwrap((tuple(args), dict(kwargs)))
    inputs = [t for t in pytree.tree_leaves((args, kwargs))
              if isinstance(t, torch.Tensor)]
    with torch.enable_grad() if autograd.is_recording() \
            else torch.no_grad():
        out = fn(*args, **kwargs)
    if isinstance(out, torch.Tensor):
        return NDArray(_own(out, inputs))
    return pytree.tree_map(lambda v: NDArray(_own(v, inputs))
                           if isinstance(v, torch.Tensor) else v, out)


def _nd_call(fn, args, kwargs):
    """``fn`` on the tensors as NDArrays (also inside lists), its ``mx.nd``
    ops recorded when torch has gradients enabled (the trainers' forward),
    its NDArray outputs back as tensors."""
    prev = autograd.set_recording(torch.is_grad_enabled())
    try:
        out = fn(*(pytree.tree_map(_wrap, a) if _nested(a) else _wrap(a)
                   for a in args),
                 **{k: pytree.tree_map(_wrap, v) if _nested(v) else _wrap(v)
                    for k, v in kwargs.items()})
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
                   dtype=torch.float32, allow_deferred_init=False,
                   stype="default", grad_stype="default",
                   attr=None) -> Parameter:
        """Declare ``self.<name>`` on this block's device: an
        ``nn.Parameter`` if trained, a buffer if ``grad_req == 'null'``.
        A shape with a 0 (allowed with ``allow_deferred_init``) leaves the
        attribute ``None`` until the first forward knows it. Values are set
        by :meth:`initialize` or by weight conversion. ``attr``: the
        attribute that holds the tensor, when it is not ``name``."""
        shape = tuple(int(s) for s in shape)
        check(all(s > 0 for s in shape) or allow_deferred_init,
              f"{self._prefix}{name}: shape {shape} must be fully known "
              "(this layer cannot defer it)")
        p = Parameter(self._prefix + name, grad_req=grad_req, shape=shape,
                      dtype=dtype, init=init,
                      allow_deferred_init=allow_deferred_init, stype=stype,
                      grad_stype=grad_stype)
        self._params[p.name] = p
        p._bind(self, attr or name)
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
        """NDArrays in, NDArrays out; tensors in, tensors out; Symbols in,
        a Symbol out."""
        if any(isinstance(a, Symbol) for a in args):
            return self._symbolic_call(*args)
        if has_ndarray((*args, *kwargs.values())):
            return self.forward(*args, **kwargs)
        return _nd_call(self.forward, args, kwargs)

    def _symbolic_call(self, *args):
        raise MXNetError(f"{type(self).__name__} is a Block: only a "
                         "HybridBlock has a symbolic form")

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

    def export(self, path: str, epoch: int = 0, input_names=("data",)):
        """Write ``path-symbol.json`` and ``path-{epoch:04d}.params``
        (``arg:`` / ``aux:`` keys; ref: block.py export), readable by
        ``SymbolBlock.imports`` of either package. Returns the symbol."""
        from .. import symbol as sym_mod
        for p in self.collect_params().values():
            if p.tensor is None:
                raise DeferredInitializationError(
                    f"export: parameter {p.name!r} is not initialized "
                    "(run a forward first)")
        sym = self._symbolic_call(*[sym_mod.var(n) for n in input_names])
        if isinstance(sym, (list, tuple)):
            sym = sym_mod.Group(list(sym))
        sym.save(f"{path}-symbol.json")
        aux_names = set(sym.list_auxiliary_states())
        payload = {}
        for _, p in sorted(self.collect_params().items()):
            kind = "aux" if p.name in aux_names else "arg"
            payload[f"{kind}:{p.name}"] = p.data()
        nd_utils.save(f"{path}-{epoch:04d}.params", payload)
        return sym

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
        self._cached_op = None   # built at the first call after hybridize

    def __call__(self, *args, **kwargs):
        """NDArrays in, NDArrays out (see the module docstring); tensors
        in, tensors out; Symbols in, a Symbol out."""
        if any(isinstance(a, Symbol) for a in args):
            return self._symbolic_call(*args)
        if has_ndarray((*args, *kwargs.values())):
            return ndarray_call(self._tensor_path, args, kwargs)
        return self._tensor_path(*args, **kwargs)

    def _tensor_path(self, *args, **kwargs):
        if self._deferred:
            self._finish_deferred(*args, **kwargs)
        return self._tensor_call(*args, **kwargs)

    def _tensor_call(self, *args, **kwargs):
        if self._active:
            if self._cached_op is None:
                self._cached_op = CachedOp(self, mirror=self._mirror_arg)
            return self._cached_op.call(args, kwargs)
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

    def _symbolic_call(self, *args):
        """``hybrid_forward(mx.sym, *args, **params)`` with each own
        parameter a variable of its full name (ref: the JAX package's
        ``block.py:253-270``)."""
        from .. import symbol as F
        if type(self).hybrid_forward is HybridBlock.hybrid_forward:
            raise MXNetError(f"{type(self).__name__} defines no "
                             "hybrid_forward: it has no symbolic form")
        params = {}
        for name, p in self._params.items():
            v = F.var(p.name)
            if not p._differentiable:
                v._outputs[0][0].extra["aux"] = True
            params[self._params._short(name)] = v
        return self.hybrid_forward(F, *args, **params)

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, mirror=None,
                  **kwargs) -> None:
        """Route the block's calls through a ``CachedOp`` (see the module
        docstring), built anew at the next call; the children get the
        same flag."""
        self._active = active
        self._mirror_arg = mirror
        self._cached_op = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape, mirror=mirror,
                          **kwargs)


class SymbolBlock(HybridBlock):
    """A block over a symbol graph (ref: block.py SymbolBlock): ``inputs``
    (Symbols or names) are its arguments, every other variable of
    ``outputs`` one of its parameters (aux states with ``grad_req``
    null), without a tensor until ``imports`` or ``set_data`` gives it
    one."""

    def __init__(self, outputs, inputs, params=None, device=None):
        super().__init__(prefix="", params=params, device=device)
        if isinstance(inputs, Symbol):
            inputs = [inputs]
        self._sym_outputs = outputs
        self._sym_inputs = [i.name if isinstance(i, Symbol) else i
                            for i in inputs]
        aux = set(outputs.list_auxiliary_states())
        for name in outputs.list_inputs():
            if name in self._sym_inputs:
                continue
            self.params.get(name, grad_req="null" if name in aux else "write",
                            allow_deferred_init=True,
                            differentiable=name not in aux)

    def _symbolic_call(self, *args):
        # splice the graph into the caller's: inputs composed with its
        # symbols, parameters kept as named variables
        return self._sym_outputs(**dict(zip(self._sym_inputs, args)))

    def forward(self, *args):
        from ..symbol.executor import walk_inputs
        params = {}
        for name in self._params:
            short = self._params._short(name)
            params[name] = self._parameters[short] \
                if short in self._parameters else self._buffers[short]
        return walk_inputs(self._sym_outputs, self._sym_inputs, args,
                           params)

    @classmethod
    def imports(cls, symbol_file, input_names, param_file=None, ctx=None):
        """Load an exported model (either package's files; ref: block.py
        SymbolBlock.imports) on ``ctx`` (default: the current context)."""
        from ..context import Context, current_context
        from ..symbol import symbol as sym_mod
        if isinstance(input_names, str):
            input_names = [input_names]
        device = Context(ctx if ctx is not None else
                         current_context()).torch_device
        net = cls(sym_mod.load(symbol_file), list(input_names),
                  device=device)
        if param_file is not None:
            for k, v in nd_utils.load(param_file, ctx=cpu()).items():
                name = k.split(":", 1)[1] if ":" in k else k
                if name in net._params:
                    p = net._params[name]
                    if p.tensor is None:
                        p._dtype = v._data.dtype   # int8 weights stay int8
                    p.set_data(v)
            net._deferred = [p for p in net._deferred if p.tensor is None]
        return net
