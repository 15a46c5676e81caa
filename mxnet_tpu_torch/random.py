"""Seeded random streams (ref: python/mxnet/random.py; the JAX package's
``random.py``).

The stream is PyTorch's default generator of each device (the host's and
every card's): a random op given no ``generator`` draws from it, so a draw
inside a captured CUDA graph (the K-step trainer graph, the megastep)
advances the card's generator on every replay, as Dropout's draws do.
:func:`seed` re-seeds those generators and records the seed; a
``Parameter.initialize`` without a generator draws from a fresh generator
seeded with the recorded seed (0 until :func:`seed` is called), so
``seed(1)`` changes the default weights as it does in the JAX package.

The two frameworks draw different numbers from the same seed, so parity
tests make their inputs with numpy and carry weights across with
:mod:`mxnet_tpu_torch.convert`.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as _np
import torch

from .base import MXNetError, env
from .context import resolve_device

__all__ = ["seed", "default_generator", "init_generator", "np_rng",
           "uniform", "normal", "randint", "gamma", "exponential", "poisson",
           "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle"]

_lock = threading.Lock()
# None until seed() is called (MXNET_ENFORCE_DETERMINISM reads this)
_seed_value: Optional[int] = None


def seed(seed_state: int, ctx=None) -> torch.Generator:
    """Re-seed the default generators (every device's, or only ``ctx``'s)
    and record the seed (ref: python/mxnet/random.py seed). Returns a new
    generator on ``ctx`` (default: the current context, so without a card
    the caller asks for the CPU) seeded with ``seed_state``, for callers
    that pass one on."""
    global _seed_value
    s = int(seed_state)
    dev = resolve_device(ctx)
    with _lock:
        _seed_value = s
        if ctx is None:
            torch.manual_seed(s)        # the host's and every card's
        else:
            default_generator(dev).manual_seed(s)
    gen = torch.Generator(device=dev)
    gen.manual_seed(s)
    return gen


def init_generator(device) -> torch.Generator:
    """A new generator on ``device`` seeded with the last seed given to
    :func:`seed` (0 before the first call): what ``initialize()`` draws
    the weights from when given no generator."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(0 if _seed_value is None else _seed_value)
    return gen


def default_generator(device) -> torch.Generator:
    """PyTorch's default generator of ``device``: what a random op draws
    from when its caller passes no generator. A CUDA graph captures draws
    from it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        idx = dev.index if dev.index is not None \
            else torch.cuda.current_device()
        return torch.cuda.default_generators[idx]
    return torch.default_generator


def np_rng() -> _np.random.Generator:
    """A numpy Generator seeded from the host's stream, for samplers that
    run on the host. Under ``MXNET_ENFORCE_DETERMINISM`` calling it before
    :func:`seed` raises: the run would not be reproducible."""
    if env.get("MXNET_ENFORCE_DETERMINISM") and _seed_value is None:
        raise MXNetError(
            "MXNET_ENFORCE_DETERMINISM is set but mx.random.seed() was "
            "never called — host-side sampling would be irreproducible")
    words = torch.randint(0, 2 ** 31 - 1, (4,),
                          generator=torch.default_generator)
    return _np.random.default_rng(_np.random.SeedSequence(words.tolist()))


# --- the front end (ref: python/mxnet/ndarray/random.py) ---------------------

def _op(name):
    from .ndarray import op
    return getattr(op, name)


def uniform(low=0, high=1, shape=(1,), dtype=None, ctx=None, out=None,
            generator=None):
    return _op("_random_uniform")(low=low, high=high, shape=shape,
                                  dtype=dtype, ctx=ctx, out=out,
                                  generator=generator)


def normal(loc=0, scale=1, shape=(1,), dtype=None, ctx=None, out=None,
           generator=None):
    return _op("_random_normal")(loc=loc, scale=scale, shape=shape,
                                 dtype=dtype, ctx=ctx, out=out,
                                 generator=generator)


def randint(low, high, shape=(1,), dtype="int32", ctx=None, out=None,
            generator=None):
    return _op("_random_randint")(low=low, high=high, shape=shape,
                                  dtype=dtype, ctx=ctx, out=out,
                                  generator=generator)


def gamma(alpha=1, beta=1, shape=(1,), dtype=None, ctx=None, out=None,
          generator=None):
    return _op("_random_gamma")(alpha=alpha, beta=beta, shape=shape,
                                dtype=dtype, ctx=ctx, out=out,
                                generator=generator)


def exponential(scale=1, shape=(1,), dtype=None, ctx=None, out=None,
                generator=None):
    return _op("_random_exponential")(lam=1.0 / scale, shape=shape,
                                      dtype=dtype, ctx=ctx, out=out,
                                      generator=generator)


def poisson(lam=1, shape=(1,), dtype=None, ctx=None, out=None,
            generator=None):
    return _op("_random_poisson")(lam=lam, shape=shape, dtype=dtype,
                                  ctx=ctx, out=out, generator=generator)


def negative_binomial(k=1, p=1, shape=(1,), dtype=None, ctx=None, out=None,
                      generator=None):
    return _op("_random_negative_binomial")(k=k, p=p, shape=shape,
                                            dtype=dtype, ctx=ctx, out=out,
                                            generator=generator)


def generalized_negative_binomial(mu=1, alpha=1, shape=(1,), dtype=None,
                                  ctx=None, out=None, generator=None):
    return _op("_random_generalized_negative_binomial")(
        mu=mu, alpha=alpha, shape=shape, dtype=dtype, ctx=ctx, out=out,
        generator=generator)


def multinomial(data, shape=(), get_prob=False, out=None, dtype="int32",
                generator=None):
    return _op("_sample_multinomial")(data, shape=shape, get_prob=get_prob,
                                      dtype=dtype, out=out,
                                      generator=generator)


def shuffle(data, out=None, generator=None):
    return _op("_shuffle")(data, out=out, generator=generator)
