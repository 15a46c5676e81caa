"""Mixture-of-Experts FFN on one device (ref: the JAX package's
``parallel/moe.py``).

The JAX package's dense Switch / GShard formulation, kept as it is:

- f32 router scores ``x.float() @ gate`` (full f32 on the card: TF32 is
  off for this product, so card and host route tokens alike), then a
  softmax;
- ``k`` rounds of argmax / one-hot / masking (top-1 is Switch, top-2
  GShard); ``torch.argmax`` takes the first maximum, as ``jnp.argmax``
  does;
- each token's 1-based position in its expert's buffer is
  ``cumsum(dispatch) * dispatch``, kept when ``0 < pos <= cap`` with
  ``cap = max(1, ceil(n * capacity_factor * k / e))``;
- the ``(N, E, C)`` dispatch and combine tensors and the four einsums as
  ``torch.matmul`` / ``torch.bmm`` (XLA-lowered code in the reference, so a
  library product is the port);
- the Switch load-balance loss ``e * sum(frac / k * mean_prob)``.

Gradients reach the router only through the combine weights and
``mean_prob``; the dispatch, ``frac``, ``keep`` and the positions carry
none, as in JAX. The dispatch tensors hold ``N * E * C = N^2 *
capacity_factor * k`` elements whatever E is; the temporaries autograd
does not keep are freed as soon as they are used.

``moe_param_specs`` shards over a mesh and raises (ROADMAP A10).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops.registry import NotPortedError

__all__ = ["init_moe_params", "moe_param_specs", "moe_ffn", "route"]


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, dtype=None, device=None
                    ) -> Dict[str, Any]:
    """Stacked expert FFN weights, leading axis the expert: ``gate`` (D, E)
    always f32, ``w_in`` (E, D, F), ``b_in`` (E, F), ``w_out`` (E, F, D),
    ``b_out`` (E, D) in ``dtype`` (default f32); normal * 0.02 for the
    matrices, zeros for the biases, drawn on the generator's device and
    placed on ``device`` (default: the generator's)."""
    dt = dtype or torch.float32
    dev = device if device is not None else generator.device

    def make(name, shape):
        if name.startswith("b_"):
            return torch.zeros(shape, dtype=dt, device=dev)
        w = torch.randn(shape, generator=generator,
                        device=generator.device) * 0.02
        return w.to(device=dev, dtype=torch.float32 if name == "gate"
                    else dt)

    return {name: make(name, shape) for name, shape in
            moe_param_shapes(d_model, d_ff, n_experts).items()}


def moe_param_shapes(d_model: int, d_ff: int, n_experts: int):
    """Names and shapes of ``init_moe_params``'s dict."""
    return {"gate": (d_model, n_experts), "w_in": (n_experts, d_model, d_ff),
            "b_in": (n_experts, d_ff), "w_out": (n_experts, d_ff, d_model),
            "b_out": (n_experts, d_model)}


def moe_param_specs(mesh):
    """Not ported: expert parallelism shards over an 'ep' mesh."""
    raise NotPortedError("moe_param_specs shards the experts over a mesh, "
                         "which is not ported yet (ROADMAP A10)")


@contextlib.contextmanager
def _full_f32(device):
    """TF32 off for the products inside (the router's scores)."""
    if device.type != "cuda":
        yield
        return
    flag = torch.backends.cuda.matmul
    prev = flag.allow_tf32
    flag.allow_tf32 = False
    try:
        yield
    finally:
        flag.allow_tf32 = prev


def route(xf, gate, n_experts: int, capacity_factor: float = 1.25,
          k: int = 1):
    """The routing of tokens ``xf`` (N, D): ``(disp, combine_w, aux)``,
    the (N, E, C) f32 0/1 dispatch of each kept token to its slot, the
    (N, E) f32 combine weights and the f32 load-balance loss."""
    n, e = xf.shape[0], n_experts
    cap = max(1, int(math.ceil(n * capacity_factor * k / e)))
    with _full_f32(xf.device):
        scores = torch.matmul(xf.float(), gate)                # (N, E)
    probs = torch.softmax(scores, dim=-1)

    dispatch = torch.zeros((n, e), dtype=torch.float32, device=xf.device)
    combine_w = torch.zeros_like(dispatch)
    remaining = probs
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)                   # (N,)
        oh = F.one_hot(idx, e).float()                          # (N, E)
        combine_w = combine_w + remaining * oh
        dispatch = dispatch + oh
        remaining = remaining * (1.0 - oh)

    # 1-based position of each token in its expert's buffer
    pos = torch.cumsum(dispatch, dim=0) * dispatch              # (N, E)
    keep = (pos > 0) & (pos <= cap)
    pos0 = torch.clamp(pos - 1.0, 0, cap - 1).long()
    disp = torch.zeros((n, e, cap), dtype=torch.float32, device=xf.device)
    disp.scatter_(2, pos0[..., None], 1.0)                      # one-hot
    disp.mul_(keep[..., None])                                  # (N, E, C)
    del pos, pos0, keep

    frac = dispatch.mean(dim=0)                                 # (E,)
    mean_prob = probs.mean(dim=0)                               # (E,)
    aux = e * torch.sum(frac / max(k, 1) * mean_prob)
    return disp, combine_w, aux


def moe_ffn(x, params: Dict[str, Any], n_experts: int,
            capacity_factor: float = 1.25, k: int = 1,
            act=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, T, D) -> (out (B, T, D), f32 scalar aux loss); ``act``
    defaults to the tanh GELU (``jax.nn.gelu``'s default)."""
    b, t, d = x.shape
    n, e = b * t, n_experts
    xf = x.reshape(n, d)
    disp, combine_w, aux = route(xf, params["gate"], e, capacity_factor, k)
    cap = disp.shape[2]
    ec = e * cap
    xe = torch.matmul(disp.to(x.dtype).reshape(n, ec).t(), xf)  # (E*C, D)
    h = torch.bmm(xe.reshape(e, cap, d), params["w_in"]) \
        + params["b_in"][:, None, :]
    h = act(h) if act is not None else F.gelu(h, approximate="tanh")
    ye = torch.bmm(h, params["w_out"]) + params["b_out"][:, None, :]
    del xe, h
    comb = (disp * combine_w[..., None]).to(x.dtype)            # (N, E, C)
    out = torch.matmul(comb.reshape(n, ec), ye.reshape(ec, d))  # (N, D)
    return out.reshape(b, t, d), aux
