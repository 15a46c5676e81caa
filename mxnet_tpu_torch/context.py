"""Devices (ref: python/mxnet/context.py; the JAX package's
``mxnet_tpu/context.py``).

A :class:`Context` names a device as MXNet does (``mx.cpu()``,
``mx.gpu(i)``) and maps onto a ``torch.device``: ``gpu(i)`` is
``cuda:i``. It compares equal to that device, and :func:`resolve_device`
takes a Context, a ``torch.device`` or a string.

The port's default context is ``gpu(0)``, not the JAX package's
``cpu(0)``: every entry point runs on the card unless the caller asks for
the CPU (``with mx.cpu():``, ``ctx=mx.cpu()`` or ``device="cpu"``), and
without a card the default raises rather than carrying on quietly on the
host.

``with ctx:`` keeps the context it replaces on a stack of the thread, not
on the Context object (the JAX package and the reference keep it on the
object): one Context entered twice, nested or from two threads, then
restores what each entry replaced.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError

__all__ = ["Context", "cpu", "gpu", "tpu", "current_context", "num_gpus",
           "default_device", "resolve_device"]


class Context:
    """A device (ref: include/mxnet/base.h Context; devtype ids kept)."""

    devtype2str = {1: "cpu", 2: "gpu"}
    devstr2type = {v: k for k, v in devtype2str.items()}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id: int = 0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        elif isinstance(device_type, torch.device):
            if device_type.type not in ("cpu", "cuda"):
                raise MXNetError(f"unsupported device {device_type}")
            self.device_typeid = 1 if device_type.type == "cpu" else 2
            self.device_id = (device_type.index or 0) \
                if device_type.type == "cuda" else 0
        else:
            if device_type not in Context.devstr2type:
                raise MXNetError(f"unknown device type {device_type!r}")
            self.device_typeid = Context.devstr2type[device_type]
            self.device_id = int(device_id)

    @property
    def device_type(self) -> str:
        return Context.devtype2str[self.device_typeid]

    @property
    def torch_device(self) -> torch.device:
        """``cuda:i`` for ``gpu(i)``; the host for ``cpu``."""
        if self.device_type == "gpu":
            return torch.device("cuda", self.device_id)
        return torch.device("cpu")

    def __eq__(self, other) -> bool:
        if isinstance(other, torch.device):
            return self.torch_device == other
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __repr__(self) -> str:
        return f"{self.device_type}({self.device_id})"

    __str__ = __repr__

    def __enter__(self):
        tls = Context._default_ctx
        if not hasattr(tls, "saved"):
            tls.saved = []
        tls.saved.append(getattr(tls, "value", None))
        tls.value = self
        return self

    def __exit__(self, ptype, value, trace):
        tls = Context._default_ctx
        tls.value = tls.saved.pop()


def cpu(device_id: int = 0) -> Context:
    """The host (MXNet's ``mx.cpu()``)."""
    return Context("cpu", device_id)


def gpu(device_id: int = 0) -> Context:
    """Card ``device_id`` (MXNet's ``mx.gpu(i)``, ``torch.device("cuda",
    i)``)."""
    return Context("gpu", device_id)


def tpu(device_id: int = 0) -> Context:
    """The JAX package's ``mx.tpu()``: the port has no TPU, so it raises
    (recipes that list it beside ``mx.gpu`` still import)."""
    raise MXNetError("mx.tpu(): the port runs on CUDA cards; use "
                     "mx.gpu(i)")


#: the card a distributed rank runs on (``kvstore_server.join_group``)
_process_gpu = [0]


def set_process_device(dev: torch.device) -> None:
    """Make ``gpu(dev.index)`` this process's default context (a rank of
    a group with a card each)."""
    _process_gpu[0] = int(dev.index or 0)


def current_context() -> Context:
    """The innermost ``with ctx:`` scope of this thread, else this
    process's card (``gpu(0)`` unless a distributed rank set another)."""
    ctx = getattr(Context._default_ctx, "value", None)
    return ctx if ctx is not None else Context("gpu", _process_gpu[0])


def num_gpus() -> int:
    """Number of CUDA cards visible (ref: mx.context.num_gpus)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def default_device() -> torch.device:
    return current_context().torch_device


def resolve_device(device=None) -> torch.device:
    """``None`` -> the current context (the card unless a ``with`` scope
    says otherwise); Contexts, strings and devices map to a
    ``torch.device``. A CUDA device without a card raises
    :class:`MXNetError`."""
    if device is None:
        dev = default_device()
    elif isinstance(device, Context):
        dev = device.torch_device
    else:
        dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' (or use "
            "ctx=mx.cpu() / `with mx.cpu():`) to run on the host")
    if dev.type not in ("cuda", "cpu"):
        raise MXNetError(f"unsupported device {dev}")
    return dev
