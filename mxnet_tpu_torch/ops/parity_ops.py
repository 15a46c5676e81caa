"""Registry entries the reference registers that the other modules lack
(ref: the dense part of the JAX package's ``ops/parity_ops.py``): the
creation ops (``_zeros``, ``_ones``, ``_full``, ``_eye``, ``_arange``;
``mx.nd.zeros`` and the other helpers shadow them in ``mx.nd``),
``_grad_add``, ``_contrib_div_sqrt_dim`` and the ``_random_*_like``
samplers, which draw an array shaped and typed like their input from
``generator``, else from the input device's stream. The sparse and
``dgl`` names are queue A11's.
"""
from __future__ import annotations

import math

import torch

from ..context import resolve_device
from . import linalg  # noqa: F401  (registers histogram, aliased below)
from .random_ops import gamma_draw, out_dtype, stream
from .registry import alias, register

__all__ = []


# --- init ops (ref: src/operator/tensor/init_op.cc) ------------------------

@register("_zeros", aliases=("zeros",), creation=True, differentiable=False)
def _zeros(shape=(), ctx=None, dtype=None, **_):
    return torch.zeros(tuple(shape), dtype=out_dtype(dtype),
                       device=resolve_device(ctx))


@register("_ones", aliases=("ones",), creation=True, differentiable=False)
def _ones(shape=(), ctx=None, dtype=None, **_):
    return torch.ones(tuple(shape), dtype=out_dtype(dtype),
                      device=resolve_device(ctx))


@register("_full", aliases=("full",), creation=True, differentiable=False)
def _full(shape=(), value=0.0, ctx=None, dtype=None, **_):
    return torch.full(tuple(shape), value, dtype=out_dtype(dtype),
                      device=resolve_device(ctx))


@register("_eye", aliases=("eye",), creation=True, differentiable=False)
def _eye(N=0, M=0, k=0, ctx=None, dtype=None, **_):
    n, m, k = int(N), int(M) if M else int(N), int(k)
    rows = torch.arange(n, device=resolve_device(ctx)).unsqueeze(1)
    cols = torch.arange(m, device=rows.device).unsqueeze(0)
    return (cols - rows == k).to(out_dtype(dtype))


@register("_arange", aliases=("arange",), creation=True,
          differentiable=False)
def _arange(start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
            ctx=None, dtype=None, **_):
    if stop in (None, "None"):
        start, stop = 0.0, start
    # jnp.arange's length and values: start + i * step in f64, then cast
    n = max(0, math.ceil((stop - start) / step))
    out = (start + torch.arange(n, dtype=torch.float64) * step) \
        .to(out_dtype(dtype))
    if int(repeat) > 1:
        out = torch.repeat_interleave(out, int(repeat))
    return out.to(resolve_device(ctx))


# --- gradient-accumulation add + transformer helper ------------------------

@register("_grad_add")
def _grad_add(lhs, rhs):
    """The addition of gradient aggregation under grad_req='add' (ref:
    elemwise_binary_op_basic.cc:105): elemwise_add under its own name."""
    return lhs + rhs


@register("_contrib_div_sqrt_dim")
def _div_sqrt_dim(data):
    """data / sqrt(d), d the trailing dim (ref:
    src/operator/contrib/transformer.cc:33)."""
    return data / torch.sqrt(torch.tensor(float(data.shape[-1]),
                                          dtype=data.dtype,
                                          device=data.device))


# --- _random_*_like (ref: sample_op.cc:210) --------------------------------

@register("_random_uniform_like", rng=True, differentiable=False)
def _random_uniform_like(data, low=0.0, high=1.0, generator=None, **_):
    u = torch.rand(data.shape, generator=stream(generator, data.device),
                   device=data.device, dtype=data.dtype)
    return u * (high - low) + low


@register("_random_normal_like", rng=True, differentiable=False)
def _random_normal_like(data, loc=0.0, scale=1.0, generator=None, **_):
    z = torch.randn(data.shape, generator=stream(generator, data.device),
                    device=data.device, dtype=data.dtype)
    return z * scale + loc


@register("_random_exponential_like", rng=True, differentiable=False)
def _random_exponential_like(data, lam=1.0, generator=None, **_):
    e = torch.empty_like(data)
    return e.exponential_(1.0, generator=stream(generator, data.device)) \
        / lam


def _rate(data, value):
    return torch.full(data.shape, float(value), dtype=torch.float32,
                      device=data.device)


@register("_random_gamma_like", rng=True, differentiable=False)
def _random_gamma_like(data, alpha=1.0, beta=1.0, generator=None, **_):
    g = gamma_draw(_rate(data, alpha), stream(generator, data.device))
    return (g * beta).to(data.dtype)


@register("_random_poisson_like", rng=True, differentiable=False)
def _random_poisson_like(data, lam=1.0, generator=None, **_):
    gen = stream(generator, data.device)
    return torch.poisson(_rate(data, lam), generator=gen).to(data.dtype)


@register("_random_negative_binomial_like", rng=True, differentiable=False)
def _random_negative_binomial_like(data, k=1, p=1.0, generator=None, **_):
    gen = stream(generator, data.device)
    lam = gamma_draw(_rate(data, k), gen) * (1.0 - p) / p
    return torch.poisson(lam, generator=gen).to(data.dtype)


@register("_random_generalized_negative_binomial_like", rng=True,
          differentiable=False)
def _random_gen_neg_binomial_like(data, mu=1.0, alpha=1.0, generator=None,
                                  **_):
    gen = stream(generator, data.device)
    if alpha <= 0:
        return torch.poisson(_rate(data, mu), generator=gen).to(data.dtype)
    lam = gamma_draw(_rate(data, 1.0 / alpha), gen) * (mu * alpha)
    return torch.poisson(lam, generator=gen).to(data.dtype)


# the reference's registered names of the unique log-uniform sampler and
# of histogram
alias("_sample_unique_zipfian", "sample_unique_zipfian")
alias("_histogram", "histogram")
