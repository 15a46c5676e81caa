"""Imperative autograd over torch autograd (ref: the JAX package's
``autograd.py``; python/mxnet/autograd.py and src/imperative/imperative.cc
in the reference).

The JAX package keeps its own tape and runs ``jax.vjp`` per op; the port
lets torch record: inside ``record()`` the registry's ops run with torch
autograd on (``ndarray.imperative_invoke``), outside it under
``torch.no_grad()``. A variable (``attach_grad`` / ``mark_variables``) is
a leaf tensor that requires grad, with a hook that moves each gradient
torch accumulates into the variable's own gradient buffer by its
``grad_req``: ``write`` overwrites, ``add`` adds, ``null`` drops; a
delivered buffer is marked fresh (``_fresh_grad``) until an optimizer
step consumes it.

Not ported: ``capture`` (the free-variable probe of
``contrib/control_flow.py``, ROADMAP A14), ``grad_ready_scope``
(comm overlap, A10), ``get_symbol`` (symbol, A14) and row-sparse
gradients (A11).
"""
from __future__ import annotations

import threading
from typing import Optional, Sequence

import torch

from .base import MXNetError, check
from .telemetry import efficiency as _efficiency

__all__ = ["record", "pause", "train_mode", "predict_mode", "is_recording",
           "is_training", "set_recording", "set_training", "mark_variables",
           "backward", "grad", "Function"]


class _State(threading.local):
    def __init__(self):
        self.recording = False
        self.training = False


_state = _State()


def is_recording() -> bool:
    return _state.recording


def is_training() -> bool:
    return _state.training


def set_recording(is_rec: bool) -> bool:
    prev, _state.recording = _state.recording, bool(is_rec)
    return prev


def set_training(train: bool) -> bool:
    prev, _state.training = _state.training, bool(train)
    return prev


class _RecordingStateScope:
    """(ref: python/mxnet/autograd.py _RecordingStateScope)"""

    def __init__(self, is_record: Optional[bool], train_mode: Optional[bool]):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)

    def __exit__(self, *args):
        if self._enter_is_record is not None:
            set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode: bool = True) -> _RecordingStateScope:
    return _RecordingStateScope(True, train_mode)


def pause(train_mode: bool = False) -> _RecordingStateScope:
    return _RecordingStateScope(False, train_mode)


def train_mode() -> _RecordingStateScope:
    return _RecordingStateScope(None, True)


def predict_mode() -> _RecordingStateScope:
    return _RecordingStateScope(None, False)


def _deliver(var):
    """The hook that hands a leaf's accumulated gradient to ``var``'s
    gradient buffer by ``var``'s grad_req, both read when it fires."""
    def hook(leaf: torch.Tensor) -> None:
        g, leaf.grad = leaf.grad, None
        buf, req = var._grad, var._grad_req
        if g is None or buf is None or req == "null":
            return
        with torch.no_grad():
            if req == "add":
                buf._data.add_(g)
            else:
                buf._data.copy_(g)
        buf._fresh_grad = True
    return hook


def mark_variables(variables: Sequence, gradients: Sequence,
                   grad_reqs="write") -> None:
    """Make each array a variable whose gradients land in the matching
    buffer (ref: MXAutogradMarkVariables).

    An array whose tensor is already a leaf that requires grad (a Gluon
    block's ``nn.Parameter``, or an array marked before) keeps that
    tensor: the delivery hook goes onto it, replacing any earlier one, so
    the array and whatever else holds the tensor (the block, a captured
    CUDA graph) stay one tensor. Any other array is rebound to a detached
    leaf of its values."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, g, req in zip(variables, gradients, grad_reqs):
        check(req in ("write", "add", "null"),
              f"grad_req must be write, add or null, not {req!r}")
        leaf = var._data
        check(leaf.is_floating_point(),
              f"only floating-point arrays take gradients, not "
              f"{leaf.dtype}")
        if not (leaf.is_leaf and leaf.requires_grad):
            leaf = var._data = leaf.detach().requires_grad_(True)
        old = getattr(leaf, "_mxt_deliver", None)
        if old is not None:
            old.remove()
        leaf._mxt_deliver = leaf.register_post_accumulate_grad_hook(
            _deliver(var))
        var._grad = g
        var._grad_req = req


def _heads(heads, head_grads):
    from .ndarray.ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    heads = list(heads)
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    check(len(head_grads) == len(heads),
          f"len(head_grads) ({len(head_grads)}) must equal len(heads) "
          f"({len(heads)})")
    for h in heads:
        check(h._data.requires_grad,
              "cannot differentiate: output is not part of the recorded "
              "graph (was it computed under autograd.record()?)")
    outs = [h._data for h in heads]
    grads = [torch.ones_like(t) if hg is None else hg._data.to(t.dtype)
             for t, hg in zip(outs, head_grads)]
    return outs, grads


def _run(fn, *args, **kwargs):
    """``fn``, with torch's freed-graph error as the reference's."""
    try:
        return fn(*args, **kwargs)
    except RuntimeError as e:
        if "second time" in str(e):
            raise MXNetError("graph has already been freed; pass "
                             "retain_graph=True to backward() to reuse "
                             "it") from e
        raise


def backward(heads, head_grads=None, retain_graph: bool = False,
             train_mode: bool = True) -> None:
    """Run the reverse pass into the variables' gradient buffers (ref:
    MXAutogradBackwardEx)."""
    outs, grads = _heads(heads, head_grads)
    with _RecordingStateScope(False, train_mode):
        # a hybridized block's backward is one program of the efficiency
        # plane; with nothing pending this is one attribute read
        _efficiency.run_backward(
            lambda: _run(torch.autograd.backward, outs, grads,
                         retain_graph=retain_graph),
            device=outs[0].device if outs else None)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph: bool = False, train_mode: bool = True):
    """Gradients of ``heads`` with respect to ``variables``, returned as
    new arrays; the variables' gradient buffers are not touched (ref:
    python/mxnet/autograd.py grad). With ``create_graph`` the results are
    recorded, so they can be differentiated again."""
    from .ndarray.ndarray import NDArray
    if isinstance(variables, NDArray):
        variables = [variables]
    for v in variables:
        check(v._data.requires_grad,
              "one of the variables was not marked (call attach_grad())")
    if retain_graph is None:
        retain_graph = create_graph
    outs, grads = _heads(heads, head_grads)
    with _RecordingStateScope(None, train_mode):
        res = _run(torch.autograd.grad, outs, [v._data for v in variables],
                   grads, retain_graph=retain_graph,
                   create_graph=create_graph, allow_unused=True)
    return [NDArray(g if g is not None else torch.zeros_like(v._data))
            for g, v in zip(res, variables)]


class _FunctionBridge(torch.autograd.Function):
    """Carries an :class:`Function` through torch autograd."""

    @staticmethod
    def forward(ctx, fobj, *tensors):
        from .ndarray.ndarray import NDArray
        ctx.fobj = fobj
        with pause():
            outs = fobj.forward(*[NDArray(t) for t in tensors])
        if isinstance(outs, (tuple, list)):
            return tuple(o._data for o in outs)
        return outs._data

    @staticmethod
    def backward(ctx, *out_grads):
        from .ndarray.ndarray import NDArray
        with pause():
            grads = ctx.fobj.backward(*[NDArray(g) for g in out_grads])
        if not isinstance(grads, (tuple, list)):
            grads = (grads,)
        return (None, *[g._data if isinstance(g, NDArray) else g
                        for g in grads])


class Function:
    """User-defined differentiable function (ref: python/mxnet/autograd.py
    Function): subclass it with ``forward(self, *inputs)`` and
    ``backward(self, *output_grads)`` on NDArrays. It becomes a
    ``torch.autograd.Function`` while recording."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *arrays):
        self._saved = arrays

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray.ndarray import NDArray
        if not (is_recording() and any(x._data.requires_grad
                                       for x in inputs)):
            with pause():
                return self.forward(*inputs)
        out = _FunctionBridge.apply(self, *[x._data for x in inputs])
        if isinstance(out, torch.Tensor):
            return NDArray(out)
        return tuple(NDArray(o) for o in out)
