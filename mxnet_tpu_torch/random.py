"""Seeded random streams (ref: python/mxnet/random.py).

The JAX package threads PRNG keys; the port hands out explicit
``torch.Generator`` objects, one per device, that callers pass on (the
initializers take one). The two frameworks draw different numbers from the
same seed, so parity tests make their inputs with numpy and carry weights
across with :mod:`mxnet_tpu_torch.convert`.
"""
from __future__ import annotations

import torch

from .context import resolve_device

__all__ = ["seed"]


def seed(seed_state: int, device=None) -> torch.Generator:
    """A new generator on ``device`` (default: the card) seeded with
    ``seed_state``."""
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(seed_state))
    return gen
