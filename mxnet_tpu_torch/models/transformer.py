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

Mixture-of-Experts layers (``n_experts > 0``, every ``moe_every``-th
layer) run ``parallel/moe.py moe_ffn`` in place of the dense FFN and add
their load-balance loss to ``aux``; their parameters sit under
``layer<i>/moe`` with the JAX package's names, shapes and dtypes (the
router ``gate`` is f32 in every model). ``remat=True`` runs each layer
through ``util.mirror_wrapper``'s ``full`` policy
(``torch.utils.checkpoint``), as the JAX package wraps ``_block`` in a
plain ``jax.checkpoint``: backward recomputes a layer's activations, flash
attention included, from its input. The mirror env flags do not apply to
the LM: ``config.remat`` alone decides.

Only ``mesh=None`` is ported: meshes (tp/sp/dp, ring attention) and the
pipeline step raise :class:`MXNetError` (ROADMAP A10).
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
from ..parallel.moe import init_moe_params, moe_ffn, moe_param_shapes
from ..parallel.ring_attention import attention
from ..util import mirror_wrapper

__all__ = ["TransformerConfig", "init_params", "param_shapes",
           "param_dtypes", "flat_params", "nest_params", "forward",
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
    remat: bool = False  # recompute each layer in backward
    # Mixture-of-Experts (parallel/moe.py); n_experts=0: dense FFN everywhere
    n_experts: int = 0
    moe_every: int = 1   # layer i uses MoE when (i+1) % moe_every == 0
    capacity_factor: float = 1.25
    router_k: int = 1    # top-k routing (1=Switch, 2=GShard)
    aux_loss_coef: float = 0.01

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and (i + 1) % self.moe_every == 0


def _dt(config):
    return config.dtype or torch.float32


def _check_ported(config: TransformerConfig, mesh=None) -> None:
    check(mesh is None, "transformer: only mesh=None (one device) is "
          "ported; tp/sp/dp meshes and ring attention are not (ROADMAP "
          "A10)")


def param_shapes(config: TransformerConfig) -> Dict[str, Any]:
    """Names and shapes of the parameter pytree, as ``init_params`` makes
    them (the JAX ``init_params``): an MoE layer holds ``moe`` in place of
    the dense FFN."""
    d, f = config.d_model, config.d_ff
    shapes: Dict[str, Any] = {"embed": (config.vocab_size, d),
                              "ln_f_scale": (d,), "ln_f_bias": (d,)}
    for i in range(config.n_layers):
        lp = {"ln1_scale": (d,), "ln1_bias": (d,),
              "w_qkv": (d, 3 * d), "wo": (d, d),
              "ln2_scale": (d,), "ln2_bias": (d,)}
        if config.is_moe_layer(i):
            lp["moe"] = moe_param_shapes(d, f, config.n_experts)
        else:
            lp.update({"ffn_in": (d, f), "ffn_in_b": (f,),
                       "ffn_out": (f, d), "ffn_out_b": (d,)})
        shapes[f"layer{i}"] = lp
    return shapes


def param_dtypes(config: TransformerConfig) -> Dict[str, Any]:
    """``param_shapes``' tree with each leaf's dtype: ``config.dtype``
    (default f32), and f32 for every MoE router ``gate``."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict)
                else torch.float32 if k == "gate" else _dt(config)
                for k, v in tree.items()}
    return walk(param_shapes(config))


def init_params(generator: torch.Generator, config: TransformerConfig,
                device=None) -> Dict[str, Any]:
    """Random parameters from ``generator``: normal * 0.02 for the matrices
    (``wo`` and ``ffn_out`` also / sqrt(2 * n_layers)), ones for the
    layer-norm scales, zeros for the biases; in ``config.dtype`` on
    ``device`` (default: the card), the MoE layers' from ``init_moe_params``
    (after the layer's other draws). The draws are made on the generator's
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

    def layer(shapes):
        lp = {n: make(n, s) for n, s in shapes.items() if n != "moe"}
        if "moe" in shapes:
            lp["moe"] = init_moe_params(generator, config.d_model,
                                        config.d_ff, config.n_experts,
                                        dtype=dt, device=dev)
        return lp

    return {k: layer(v) if isinstance(v, dict) else make(k, v)
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
    if "moe" in lp:
        ff, aux = moe_ffn(y, lp["moe"], config.n_experts,
                          capacity_factor=config.capacity_factor,
                          k=config.router_k)
        return x + ff, aux
    hdn = torch.matmul(y, lp["ffn_in"]) + lp["ffn_in_b"]
    hdn = F.gelu(hdn, approximate="tanh")
    x = x + torch.matmul(hdn, lp["ffn_out"]) + lp["ffn_out_b"]
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# the whole layer recomputed, saving only its inputs: jax.checkpoint with
# no policy
@mirror_wrapper(True, policy="full")
def _remat_block(x, lp, config: TransformerConfig):
    return _block(x, lp, config)


def forward(params, tokens, config: TransformerConfig, mesh=None,
            return_aux: bool = False):
    """tokens (B, T) integers -> logits (B, T, vocab), on the device of the
    parameters. With return_aux=True also returns the summed MoE
    load-balance loss (0 for the dense model). With ``config.remat`` each
    layer is recomputed in backward (``_remat_block``)."""
    _check_ported(config, mesh)
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device).long()
    x = embed[tokens]  # (B, T, D)
    x = x + _pos_encode(tokens, config.d_model, x.dtype)
    blk = _remat_block if config.remat else _block
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(config.n_layers):
        x, a = blk(x, params[f"layer{i}"], config)
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


def flat_params(params, prefix: str = "") -> Dict[str, Any]:
    """``{"layer1/moe/w_in": leaf, ...}`` of a nested parameter dict, at any
    depth, in the dict's order. Any leaf type (tensors, arrays, shapes)."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(flat_params(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def nest_params(flat) -> Dict[str, Any]:
    """The inverse of :func:`flat_params`."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        *heads, leaf = key.split("/")
        node = out
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = v
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
        ws = {k: w.detach().requires_grad_()
              for k, w in flat_params(params).items()}
        loss = loss_fn(nest_params(ws), tokens, targets, config)
        grads = torch.autograd.grad(loss, list(ws.values()))
        with torch.no_grad():
            torch._foreach_sub_(list(ws.values()),
                                torch._foreach_mul(grads, lr))
        return loss.detach(), params

    return step, lambda p: p


def make_pipeline_train_step(config: TransformerConfig, mesh,
                             lr: float = 1e-3,
                             n_microbatches: Optional[int] = None):
    """Not ported: pipeline parallelism needs a 'pp' mesh."""
    raise MXNetError("transformer: make_pipeline_train_step (pipeline "
                     "parallelism over a 'pp' mesh) is not ported")
