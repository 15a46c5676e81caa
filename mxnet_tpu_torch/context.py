"""Devices (ref: python/mxnet/context.py).

MXNet's ``mx.cpu()`` / ``mx.gpu(i)`` contexts map onto ``torch.device``.
The port's default device is the card: every entry point takes an explicit
``device`` and, when none is given, uses ``cuda`` — and raises if there is
no card, rather than carrying on quietly on the CPU.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "default_device", "resolve_device"]


def cpu(device_id: int = 0) -> torch.device:
    """The host (MXNet's ``mx.cpu()``; the id is accepted and ignored)."""
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    """Card ``device_id`` (MXNet's ``mx.gpu(i)``)."""
    return torch.device("cuda", device_id)


def default_device() -> torch.device:
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card; strings and devices pass through. A CUDA
    device without a card raises :class:`MXNetError`."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "host")
    if dev.type not in ("cuda", "cpu"):
        raise MXNetError(f"unsupported device {dev}")
    return dev
