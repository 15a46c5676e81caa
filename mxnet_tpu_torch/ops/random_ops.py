"""Random samplers (ref: the JAX package's ``ops/random_ops.py``; MXNet
src/operator/random/sample_op.cc, multisample_op.cc, unique_sample_op.cc).

Every op of the JAX module under the same name, aliases and flags. Where
the JAX op takes a PRNG key, the port's takes ``generator``: the draws come
from it, else from the device's default generator (the stream that
``mx.random.seed`` seeds, see :mod:`mxnet_tpu_torch.random`). The
``_random_*`` ops are creation ops: they make their output on ``ctx``
(default: the current context). The ``_sample_*`` ops draw one sample per
element of their parameter arrays, with ``shape`` appended. Output dtypes
follow the JAX ``_dt`` rule: ``dtype`` when given, else float32.
"""
from __future__ import annotations

import numpy as _np
import torch

from ..base import check, torch_dtype
from ..context import resolve_device
from ..random import default_generator
from .registry import register

__all__ = ["out_dtype", "stream", "shape_of", "gamma_draw"]


def out_dtype(dtype, default="float32") -> torch.dtype:
    """The JAX ``_dt`` rule: ``dtype``, else ``default``."""
    if dtype is None or dtype == "None" or dtype == -1:
        dtype = default
    return torch_dtype(dtype)


def stream(generator, device) -> torch.Generator:
    """``generator``, else the default generator of ``device``."""
    return generator if generator is not None else default_generator(device)


def shape_of(shape) -> tuple:
    if shape is None or shape == ():
        return ()
    if isinstance(shape, int):
        return (shape,)
    return tuple(int(s) for s in shape)


def gamma_draw(alpha, gen) -> torch.Tensor:
    """Gamma(alpha, 1) draws, one per element of the f32 tensor ``alpha``."""
    return torch._standard_gamma(alpha, generator=gen)


def _full(shape, value, device):
    return torch.full(shape, float(value), dtype=torch.float32,
                      device=device)


# --- creation-style samplers (no array inputs) -----------------------------

@register("_random_uniform", aliases=("uniform", "random_uniform"),
          creation=True, rng=True, differentiable=False)
def _random_uniform(low=0.0, high=1.0, shape=(1,), dtype=None, ctx=None,
                    generator=None, **_):
    dev = resolve_device(ctx)
    u = torch.rand(shape_of(shape), generator=stream(generator, dev),
                   device=dev, dtype=out_dtype(dtype))
    return u * (high - low) + low


@register("_random_normal", aliases=("normal", "random_normal"),
          creation=True, rng=True, differentiable=False)
def _random_normal(loc=0.0, scale=1.0, shape=(1,), dtype=None, ctx=None,
                   generator=None, **_):
    dev = resolve_device(ctx)
    z = torch.randn(shape_of(shape), generator=stream(generator, dev),
                    device=dev, dtype=out_dtype(dtype))
    return z * scale + loc


@register("_random_gamma", aliases=("gamma_sample", "random_gamma"),
          creation=True, rng=True, differentiable=False)
def _random_gamma(alpha=1.0, beta=1.0, shape=(1,), dtype=None, ctx=None,
                  generator=None, **_):
    dev = resolve_device(ctx)
    g = gamma_draw(_full(shape_of(shape), alpha, dev), stream(generator, dev))
    return (g * beta).to(out_dtype(dtype))


@register("_random_exponential", aliases=("random_exponential",),
          creation=True, rng=True, differentiable=False)
def _random_exponential(lam=1.0, shape=(1,), dtype=None, ctx=None,
                        generator=None, **_):
    dev = resolve_device(ctx)
    e = torch.empty(shape_of(shape), dtype=out_dtype(dtype), device=dev)
    return e.exponential_(1.0, generator=stream(generator, dev)) / lam


@register("_random_poisson", aliases=("random_poisson",),
          creation=True, rng=True, differentiable=False)
def _random_poisson(lam=1.0, shape=(1,), dtype=None, ctx=None,
                    generator=None, **_):
    dev = resolve_device(ctx)
    return torch.poisson(_full(shape_of(shape), lam, dev),
                         generator=stream(generator, dev)) \
        .to(out_dtype(dtype))


@register("_random_negative_binomial", aliases=("random_negative_binomial",),
          creation=True, rng=True, differentiable=False)
def _random_negative_binomial(k=1, p=1.0, shape=(1,), dtype=None, ctx=None,
                              generator=None, **_):
    dev = resolve_device(ctx)
    gen = stream(generator, dev)
    lam = gamma_draw(_full(shape_of(shape), k, dev), gen) * (1 - p) / p
    return torch.poisson(lam, generator=gen).to(out_dtype(dtype))


@register("_random_generalized_negative_binomial",
          aliases=("random_generalized_negative_binomial",),
          creation=True, rng=True, differentiable=False)
def _random_gen_neg_binomial(mu=1.0, alpha=1.0, shape=(1,), dtype=None,
                             ctx=None, generator=None, **_):
    dev = resolve_device(ctx)
    gen = stream(generator, dev)
    lam = gamma_draw(_full(shape_of(shape), 1.0 / alpha, dev), gen) \
        * (mu * alpha)
    return torch.poisson(lam, generator=gen).to(out_dtype(dtype))


@register("_random_randint", aliases=("random_randint",),
          creation=True, rng=True, differentiable=False)
def _random_randint(low=0, high=1, shape=(1,), dtype="int32", ctx=None,
                    generator=None, **_):
    dev = resolve_device(ctx)
    return torch.randint(int(low), int(high), shape_of(shape),
                         generator=stream(generator, dev), device=dev,
                         dtype=out_dtype(dtype, "int32"))


# --- samplers parameterized by input arrays (ref sample_op.cc _sample_*) ---

def _per_element(param, s, dtype):
    """``param`` reshaped to broadcast over the appended sample dims."""
    return param.reshape(param.shape + (1,) * len(s)).to(dtype)


@register("_sample_uniform", aliases=("sample_uniform",), rng=True,
          differentiable=False)
def _sample_uniform(low, high, shape=(), dtype=None, generator=None, **_):
    s = shape_of(shape)
    dt = out_dtype(dtype)
    u = torch.rand(low.shape + s, generator=stream(generator, low.device),
                   device=low.device, dtype=dt)
    b, t = _per_element(low, s, dt), _per_element(high, s, dt)
    return b + u * (t - b)


@register("_sample_normal", aliases=("sample_normal",), rng=True,
          differentiable=False)
def _sample_normal(mu, sigma, shape=(), dtype=None, generator=None, **_):
    s = shape_of(shape)
    dt = out_dtype(dtype)
    z = torch.randn(mu.shape + s, generator=stream(generator, mu.device),
                    device=mu.device, dtype=dt)
    return _per_element(mu, s, dt) + z * _per_element(sigma, s, dt)


@register("_sample_gamma", aliases=("sample_gamma",), rng=True,
          differentiable=False)
def _sample_gamma(alpha, beta, shape=(), dtype=None, generator=None, **_):
    s = shape_of(shape)
    a = _per_element(alpha, s, torch.float32).expand(alpha.shape + s)
    g = gamma_draw(a.contiguous(), stream(generator, alpha.device))
    return (g * _per_element(beta, s, torch.float32)).to(out_dtype(dtype))


@register("_sample_exponential", aliases=("sample_exponential",), rng=True,
          differentiable=False)
def _sample_exponential(lam, shape=(), dtype=None, generator=None, **_):
    s = shape_of(shape)
    dt = out_dtype(dtype)
    e = torch.empty(lam.shape + s, dtype=dt, device=lam.device)
    e.exponential_(1.0, generator=stream(generator, lam.device))
    return e / _per_element(lam, s, dt)


@register("_sample_poisson", aliases=("sample_poisson",), rng=True,
          differentiable=False)
def _sample_poisson(lam, shape=(), dtype=None, generator=None, **_):
    s = shape_of(shape)
    rate = _per_element(lam, s, torch.float32).expand(lam.shape + s)
    return torch.poisson(rate.contiguous(),
                         generator=stream(generator, lam.device)) \
        .to(out_dtype(dtype))


@register("_sample_multinomial", aliases=("sample_multinomial",), rng=True,
          differentiable=False)
def _sample_multinomial(data, shape=(), get_prob=False, dtype="int32",
                        generator=None):
    """Class indices drawn with the probabilities of ``data``'s last axis
    (1-d: one distribution; 2-d: one per row); ``get_prob`` also returns
    the log-probability of each draw."""
    s = shape_of(shape)
    n = int(_np.prod(s)) if s else 1
    probs = torch.clamp(data.float(), min=1e-37)
    rows = probs.reshape(-1, probs.shape[-1])
    idx = torch.multinomial(rows, n, replacement=True,
                            generator=stream(generator, data.device))
    lead = () if data.dim() == 1 else (data.shape[0],)
    out = idx.reshape(lead + s)
    if get_prob:
        lp = torch.log(torch.gather(rows, 1, idx)).reshape(out.shape)
        return out.to(torch_dtype(dtype)), lp.to(data.dtype)
    return out.to(torch_dtype(dtype))


@register("_shuffle", aliases=("shuffle",), rng=True, differentiable=False)
def _shuffle(data, generator=None, **_):
    """``data`` with its first axis permuted."""
    perm = torch.randperm(data.shape[0], device=data.device,
                          generator=stream(generator, data.device))
    return data[perm]


@register("sample_unique_zipfian", creation=True, rng=True, num_outputs=2,
          differentiable=False)
def _sample_unique_zipfian(range_max=1, shape=(1,), ctx=None, generator=None,
                           **_):
    """Unique log-uniform (Zipfian) candidate sampler: rejection-samples
    until the last axis holds distinct classes, and counts the trials.
    Returns (samples, num_tries) as the reference does
    (src/operator/random/unique_sample_op.cc). The loop is data-dependent,
    so it runs on the host, as the JAX package's and the reference's do;
    its numpy generator is seeded from ``generator`` (else the stream)."""
    dev = resolve_device(ctx)
    shape = shape_of(shape)
    range_max = int(range_max)
    batch, n = shape[:-1], shape[-1]
    check(n <= range_max,
          f"cannot draw {n} unique samples from range_max={range_max}")
    gen = stream(generator, dev)
    words = torch.randint(0, 2 ** 31 - 1, (4,), generator=gen,
                          device=gen.device).tolist()
    rng = _np.random.default_rng(_np.random.SeedSequence(words))
    out = _np.empty(shape, _np.int32)
    tries = _np.empty(batch, _np.int32)
    log_rm = _np.log(range_max + 1)
    for idx in _np.ndindex(*batch):
        seen, vals, t = set(), [], 0
        while len(vals) < n:
            v = int(_np.exp(rng.random() * log_rm)) - 1
            v = min(max(v, 0), range_max - 1)
            t += 1
            if v not in seen:
                seen.add(v)
                vals.append(v)
        out[idx] = vals
        tries[idx] = t
    return torch.from_numpy(out).to(dev), torch.from_numpy(tries).to(dev)
