"""Transformer LM on one device (ref: the JAX package's
``models/transformer.py``).

The parameter pytree is a nested dict of plain tensors with the JAX
package's names, shapes and layouts (``w_qkv`` is ``(d, 3d)``, ``embed``
``(V, d)`` and tied to the output projection). Attention goes to the
flash-attention kernel when the JAX package would take its Pallas kernel:
on the card (the JAX package says "on a TPU"), with T a multiple of 128
and a head dim of at least 64; otherwise to the plain ``attention``. The
projections, the FFN and the tied logits are ``torch.matmul``, as the JAX
package leaves them to XLA.

Only ``mesh=None`` is ported: meshes (tp/sp/dp, ring attention), MoE
(``n_experts > 0``), ``remat=True`` and the pipeline step raise
:class:`MXNetError`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..base import MXNetError, check
from ..context import resolve_device
from ..ops.flash_attention import flash_attention
from ..parallel.ring_attention import attention

__all__ = ["TransformerConfig", "init_params", "param_shapes", "forward",
           "loss_fn", "make_train_step", "make_pipeline_train_step"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    d_model: int = 512
    n_heads: int = 8
    n_layers: int = 4
    d_ff: int = 2048
    max_seq_len: int = 2048
    dtype: Any = None  # a torch dtype, e.g. torch.bfloat16; None is float32
    causal: bool = True
    remat: bool = False  # not ported: raises
    # Mixture-of-Experts: not ported, n_experts > 0 raises
    n_experts: int = 0
    moe_every: int = 1
    capacity_factor: float = 1.25
    router_k: int = 1
    aux_loss_coef: float = 0.01


def _dt(config):
    return config.dtype or torch.float32


def _check_ported(config: TransformerConfig, mesh=None) -> None:
    check(mesh is None, "transformer: only mesh=None (one device) is "
          "ported; tp/sp/dp meshes and ring attention are not")
    check(config.n_experts == 0, "transformer: MoE (n_experts > 0) is not "
          "ported")
    check(not config.remat, "transformer: remat=True is not ported")


def param_shapes(config: TransformerConfig) -> Dict[str, Any]:
    """Names and shapes of the parameter pytree, as ``init_params`` makes
    them (the dense layers of the JAX ``init_params``)."""
    d, f = config.d_model, config.d_ff
    shapes: Dict[str, Any] = {"embed": (config.vocab_size, d),
                              "ln_f_scale": (d,), "ln_f_bias": (d,)}
    for i in range(config.n_layers):
        shapes[f"layer{i}"] = {
            "ln1_scale": (d,), "ln1_bias": (d,),
            "w_qkv": (d, 3 * d), "wo": (d, d),
            "ln2_scale": (d,), "ln2_bias": (d,),
            "ffn_in": (d, f), "ffn_in_b": (f,),
            "ffn_out": (f, d), "ffn_out_b": (d,)}
    return shapes


def init_params(generator: torch.Generator, config: TransformerConfig,
                device=None) -> Dict[str, Any]:
    """Random parameters from ``generator``: normal * 0.02 for the matrices
    (``wo`` and ``ffn_out`` also / sqrt(2 * n_layers)), ones for the
    layer-norm scales, zeros for the biases; in ``config.dtype`` on
    ``device`` (default: the card). The draws are made on the generator's
    device."""
    _check_ported(config)
    dev = resolve_device(device)
    dt = _dt(config)
    down = math.sqrt(2 * config.n_layers)

    def make(name, shape):
        if name.endswith("_scale"):
            return torch.ones(shape, dtype=dt, device=dev)
        if name.endswith(("_bias", "_b")):
            return torch.zeros(shape, dtype=dt, device=dev)
        w = torch.randn(shape, generator=generator,
                        device=generator.device) * 0.02
        if name in ("wo", "ffn_out"):
            w = w / down
        return w.to(device=dev, dtype=dt)

    return {k: ({n: make(n, s) for n, s in v.items()}
                if isinstance(v, dict) else make(k, v))
            for k, v in param_shapes(config).items()}


def _pos_encode(tokens, d: int, dtype):
    """Stateless sinusoidal positional encoding, (1, T, d): ``[sin | cos]``
    halves, computed in f32."""
    dev = tokens.device
    pos = torch.arange(tokens.shape[1], device=dev).float()[:, None]
    dim = torch.arange(d // 2, device=dev)[None, :]
    angle = pos / torch.pow(10000.0, (2 * dim).float() / d)
    pe = torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
    return pe[None].to(dtype)


def _layernorm(x, scale, bias, eps=1e-5):
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) / torch.sqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def _block(x, lp, config: TransformerConfig):
    b, t, d = x.shape
    h = config.n_heads
    hd = d // h

    y = _layernorm(x, lp["ln1_scale"], lp["ln1_bias"])
    qkv = torch.matmul(y, lp["w_qkv"])
    q, k, v = (z.reshape(b, t, h, hd) for z in qkv.split(d, dim=-1))
    if q.is_cuda and t % 128 == 0 and hd >= 64:
        attn = flash_attention(q, k, v, causal=config.causal)
    else:
        attn = attention(q, k, v, causal=config.causal)
    x = x + torch.matmul(attn.reshape(b, t, d), lp["wo"])

    y = _layernorm(x, lp["ln2_scale"], lp["ln2_bias"])
    hdn = torch.matmul(y, lp["ffn_in"]) + lp["ffn_in_b"]
    hdn = F.gelu(hdn, approximate="tanh")
    x = x + torch.matmul(hdn, lp["ffn_out"]) + lp["ffn_out_b"]
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def forward(params, tokens, config: TransformerConfig, mesh=None,
            return_aux: bool = False):
    """tokens (B, T) integers -> logits (B, T, vocab), on the device of the
    parameters. With return_aux=True also returns the summed MoE
    load-balance loss (0 for the dense model)."""
    _check_ported(config, mesh)
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device).long()
    x = embed[tokens]  # (B, T, D)
    x = x + _pos_encode(tokens, config.d_model, x.dtype)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(config.n_layers):
        x, a = _block(x, params[f"layer{i}"], config)
        aux = aux + a
    x = _layernorm(x, params["ln_f_scale"], params["ln_f_bias"])
    logits = torch.matmul(x, embed.t())
    return (logits, aux) if return_aux else logits


def loss_fn(params, tokens, targets, config: TransformerConfig, mesh=None):
    """Mean next-token NLL of f32 log-softmax, plus aux_loss_coef * aux."""
    logits, aux = forward(params, tokens, config, mesh, return_aux=True)
    logp = torch.log_softmax(logits.float(), dim=-1)
    targets = torch.as_tensor(targets, device=logp.device).long()
    nll = -logp.gather(-1, targets[..., None])
    return nll.mean() + config.aux_loss_coef * aux


def _flatten(params):
    """[(path, tensor)] of a two-level parameter dict."""
    items = []
    for k, v in params.items():
        if isinstance(v, dict):
            items += [((k, kk), vv) for kk, vv in v.items()]
        else:
            items.append(((k,), v))
    return items


def _unflatten(items):
    out: Dict[str, Any] = {}
    for path, v in items:
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


def make_train_step(config: TransformerConfig, mesh=None, lr: float = 1e-3):
    """Returns ``(step, shard_params)``: ``step(params, tokens, targets) ->
    (loss, params)`` runs forward, backward and SGD ``w - lr * g``;
    ``shard_params`` is the identity (one device).

    The step updates the tensors of ``params`` in place, where the JAX step
    donates them, and returns the same dict. The update rounds as the JAX
    one does: ``lr * g`` in the weight's dtype, then the subtraction."""
    _check_ported(config, mesh)

    def step(params, tokens, targets):
        items = _flatten(params)
        ws = [w.detach().requires_grad_() for _, w in items]
        loss = loss_fn(_unflatten([(p, w) for (p, _), w in zip(items, ws)]),
                       tokens, targets, config)
        grads = torch.autograd.grad(loss, ws)
        with torch.no_grad():
            torch._foreach_sub_(ws, torch._foreach_mul(grads, lr))
        return loss.detach(), params

    return step, lambda p: p


def make_pipeline_train_step(config: TransformerConfig, mesh,
                             lr: float = 1e-3,
                             n_microbatches: Optional[int] = None):
    """Not ported: pipeline parallelism needs a 'pp' mesh."""
    raise MXNetError("transformer: make_pipeline_train_step (pipeline "
                     "parallelism over a 'pp' mesh) is not ported")
