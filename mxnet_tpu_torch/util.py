"""Backward rematerialisation, MXNet's mirror (ref: the JAX package's
``util.py``; ``src/nnvm/gradient.cc`` mirror_fun in the reference).

``mirror_wrapper(explicit)`` resolves the decision when it is called, on
the host, before any CUDA-graph capture: an explicit argument wins, else
``MXNET_BACKWARD_DO_MIRROR``; the policy is ``MXNET_BACKWARD_MIRROR_POLICY``
read at the same moment. With mirroring on it returns a wrapper that runs
a function through ``torch.utils.checkpoint.checkpoint(...,
use_reentrant=False)``; backward then recomputes the function's
activations instead of keeping them. Policies:

- ``full``: save nothing (the function's inputs only);
- ``dots``: save the matmul results (``aten.mm`` / ``bmm`` / ``addmm`` /
  ``matmul``) as ``CheckpointPolicy.MUST_SAVE`` through
  ``create_selective_checkpoint_contexts``, recompute the rest;
- ``convs``: also ``aten.convolution``.

An unknown policy raises :class:`MXNetError`.

The recompute must give the forward's values and leave the state alone, as
the JAX package's functional step does:

- ``is_recomputing()`` is true while a checkpointed function reruns in
  backward; BatchNorm then leaves its running statistics as the forward
  moved them;
- ``replayed(draw)`` runs ``draw()`` in the forward and hands the
  recompute the same result, in call order: Dropout's masks are drawn
  once, from whatever generator they come from. The checkpoint does not
  save or restore generator states (``preserve_rng_state=False``), which
  would read them inside a CUDA-graph capture.

A checkpointed function called inside another one's forward or recompute
runs as it is: nesting adds nothing the outer recompute does not already
do, and the replay order stays one list per outer call.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils import checkpoint as _ckpt

from .base import MXNetError, env

__all__ = ["mirror_enabled", "mirror_wrapper", "apply_mirror",
           "is_recomputing", "replayed"]

_aten = torch.ops.aten
_DOTS = (_aten.mm.default, _aten.bmm.default, _aten.addmm.default,
         _aten.matmul.default, _aten.baddbmm.default)
_CONVS = _DOTS + (_aten.convolution.default,)


def mirror_enabled(explicit=None) -> bool:
    """Whether backward rematerialisation is on: an explicit argument wins,
    else the MXNET_BACKWARD_DO_MIRROR env flag."""
    if explicit is not None:
        return bool(explicit)
    return bool(env.get("MXNET_BACKWARD_DO_MIRROR"))


class _Frames(threading.local):
    def __init__(self):
        self.stack = []


_frames = _Frames()


class _Frame:
    """The forward (``recompute=False``) or the recompute of one
    checkpointed call; both hold the call's list of replayed values."""

    def __init__(self, saved, recompute):
        self.saved = saved
        self.recompute = recompute
        self.pos = 0

    def __enter__(self):
        self.pos = 0
        _frames.stack.append(self)
        return self

    def __exit__(self, *exc):
        _frames.stack.remove(self)


@contextlib.contextmanager
def _both(first, second):
    """Two context managers entered as one (ours, then the selective
    policy's)."""
    with first, second:
        yield


def is_recomputing() -> bool:
    """True while a checkpointed function reruns inside backward."""
    return any(f.recompute for f in _frames.stack)


def replayed(draw):
    """``draw()`` in a checkpointed forward (its result kept for the
    recompute) and outside any; the kept result, in call order, in the
    recompute."""
    if not _frames.stack:
        return draw()
    frame = _frames.stack[0]
    if frame.recompute:
        out = frame.saved[frame.pos]
        frame.pos += 1
        return out
    out = draw()
    frame.saved.append(out)
    return out


def _saving(ops):
    def policy(ctx, op, *args, **kwargs):
        return _ckpt.CheckpointPolicy.MUST_SAVE if op in ops \
            else _ckpt.CheckpointPolicy.PREFER_RECOMPUTE
    return policy


def mirror_wrapper(explicit=None, policy=None):
    """Resolve the mirror decision and the policy NOW and return the
    wrapper to apply (the identity when mirroring is off). ``policy``
    names one and wins over ``MXNET_BACKWARD_MIRROR_POLICY``. Builders of
    a step call this once, outside the step and before any capture."""
    if not mirror_enabled(explicit):
        return lambda fn: fn
    name = policy or env.get("MXNET_BACKWARD_MIRROR_POLICY") or "full"
    if name == "full":
        saving = None
    elif name == "dots":
        saving = _saving(_DOTS)
    elif name == "convs":
        saving = _saving(_CONVS)
    else:
        raise MXNetError(
            f"unknown MXNET_BACKWARD_MIRROR_POLICY {name!r} "
            "(expected 'full', 'dots' or 'convs')")

    def contexts():
        saved = []
        fwd, rec = _Frame(saved, False), _Frame(saved, True)
        if saving is None:
            return fwd, rec
        sfwd, srec = _ckpt.create_selective_checkpoint_contexts(saving)
        return _both(fwd, sfwd), _both(rec, srec)

    def wrap(fn):
        def mirrored(*args, **kwargs):
            if _frames.stack or not torch.is_grad_enabled():
                return fn(*args, **kwargs)
            return _ckpt.checkpoint(fn, *args, use_reentrant=False,
                                    context_fn=contexts,
                                    preserve_rng_state=False, **kwargs)
        return mirrored
    return wrap


def apply_mirror(fn, explicit=None):
    """``fn`` wrapped for rematerialisation when mirroring is on (see
    :func:`mirror_wrapper`, which this resolves at once)."""
    return mirror_wrapper(explicit)(fn)
