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

**Over a mesh** (``parallel/mesh.py``, one rank a mesh slot): every rank
holds its local blocks of the parameters under :func:`param_specs` (the
JAX package's Megatron specs) and of the tokens (``P(dp, sp)``), and the
collectives are explicit:

- ``tp``: column-parallel ``w_qkv`` / ``ffn_in``, row-parallel ``wo`` /
  ``ffn_out`` followed by an all-reduce over ``tp``; each rank runs its
  ``n_heads / tp`` heads (through the flash kernel on the card). The
  spec of ``w_qkv`` is the JAX one, ``P(None, "tp")``, but a contiguous
  column split of ``[q | k | v]`` would hand rank 0 all of q and half of
  k, so the port's local block of ``w_qkv`` holds the q, k and v columns
  of its own heads, ``[q_r | k_r | v_r]``: :func:`shard_params`,
  :func:`gather_params` and ``convert.from_transformer_params(mesh=)``
  go through that layout, and the global parameter stays the JAX one.
  The tied embedding ``P("tp", None)`` is vocab-parallel: the lookup
  masks the tokens outside the rank's rows and all-reduces, the logits
  stay vocab-sharded, and the cross-entropy all-reduces the max and the
  sum of exponentials over ``tp`` (the logits are never gathered).
- ``sp``: the sequence splits over ``sp``, positions are global, and
  attention is ``parallel/ring_attention.py`` in place of flash, as in
  JAX.
- ``dp``: the batch splits over ``dp``.
- ``ep``: MoE layers run expert parallel (``parallel/moe.py``); an MoE
  layer under ``dp`` or ``sp`` gathers the tokens first, so its routing is
  the one over the whole batch, as GSPMD computes it.

The gradients are those of the global loss: each rank seeds backward
with its own share (its tokens' NLL over the global token count, divided
by the number of ranks that compute the same tokens' loss), the
collectives' backwards are their transposes, and each parameter's
gradient is summed over the mesh axes its spec does not split.
:func:`make_train_step` returns a step over local blocks that takes the
global tokens (each rank takes its block) and returns the global mean
loss; :func:`make_pipeline_train_step` runs the layers as ``pp`` stages
(``parallel/pipeline.py``, GPipe).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..base import check
from ..context import resolve_device
from ..ops.flash_attention import flash_attention
from ..parallel.moe import init_moe_params, moe_ffn, moe_param_shapes
from ..parallel.ring_attention import attention
from ..util import mirror_wrapper

__all__ = ["TransformerConfig", "init_params", "param_shapes",
           "param_dtypes", "flat_params", "nest_params", "forward",
           "loss_fn", "make_train_step", "make_pipeline_train_step",
           "param_specs", "shard_params", "gather_params"]


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


def _check_mesh(mesh) -> None:
    check(mesh is None or (hasattr(mesh, "axis_size") and
                           hasattr(mesh, "group")),
          f"transformer: mesh must be a parallel.mesh.Mesh, got "
          f"{type(mesh).__name__}")


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


def _pos_encode(tokens, d: int, dtype, offset: int = 0):
    """Stateless sinusoidal positional encoding, (1, T, d): ``[sin | cos]``
    halves, computed in f32; ``offset`` is the global position of the
    first token (a sequence-parallel block)."""
    dev = tokens.device
    pos = (torch.arange(tokens.shape[1], device=dev) + offset
           ).float()[:, None]
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


def forward(params, tokens, config: TransformerConfig, mesh=None,
            return_aux: bool = False):
    """tokens (B, T) integers -> logits (B, T, vocab), on the device of the
    parameters. With return_aux=True also returns the summed MoE
    load-balance loss (0 for the dense model). With ``config.remat`` each
    layer is recomputed in backward (``_remat_block``). With a mesh,
    ``params`` and ``tokens`` are this rank's blocks and the logits are
    its block ``(B/dp, T/sp, V/tp)`` (module docstring)."""
    _check_mesh(mesh)
    return _forward(params, tokens, config, mesh, return_aux)


def loss_fn(params, tokens, targets, config: TransformerConfig, mesh=None):
    """Mean next-token NLL of f32 log-softmax, plus aux_loss_coef * aux.
    With a mesh: the global mean over local blocks, the same value on
    every rank."""
    _check_mesh(mesh)
    if mesh is not None:
        return _global_value(_mesh_seed(params, tokens, targets, config,
                                        mesh))
    logits, aux = _forward(params, tokens, config, None, return_aux=True)
    return _nll(logits, targets, None, None).mean() + \
        config.aux_loss_coef * aux


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


# ----------------------------------------------------------------------
# Specs, local blocks, and the forward and loss (one device or a mesh)
# ----------------------------------------------------------------------

def _single_layer_specs(config: TransformerConfig, mesh, i: int):
    """Megatron-style tp specs of one layer (the JAX function): qkv and
    ffn_in column-parallel, wo and ffn_out row-parallel; MoE layers take
    ``moe_param_specs`` (ep x tp)."""
    from ..parallel.moe import moe_param_specs
    from ..parallel.sharding import P
    names = mesh.axis_names if mesh is not None else ()
    tp = "tp" if "tp" in names else None
    vec = P()
    lsp = {"ln1_scale": vec, "ln1_bias": vec, "w_qkv": P(None, tp),
           "wo": P(tp, None), "ln2_scale": vec, "ln2_bias": vec}
    if config.is_moe_layer(i):
        lsp["moe"] = moe_param_specs(mesh)
    else:
        lsp.update({"ffn_in": P(None, tp), "ffn_in_b": P(tp),
                    "ffn_out": P(tp, None), "ffn_out_b": vec})
    return lsp


def param_specs(config: TransformerConfig, mesh) -> Dict[str, Any]:
    """The whole model's specs: the embedding split over the vocabulary
    on tp, the layers per :func:`_single_layer_specs`."""
    from ..parallel.sharding import P
    _check_mesh(mesh)
    tp = "tp" if "tp" in mesh.axis_names else None
    specs: Dict[str, Any] = {"embed": P(tp, None), "ln_f_scale": P(),
                             "ln_f_bias": P()}
    for i in range(config.n_layers):
        specs[f"layer{i}"] = _single_layer_specs(config, mesh, i)
    return specs


def _qkv_heads(w, tp: int, r: int):
    """Rank r's ``[q_r | k_r | v_r]`` columns of a global ``(d, 3d)``."""
    d = w.shape[1] // 3
    cols = d // tp
    return torch.cat([w[:, j * d + r * cols: j * d + (r + 1) * cols]
                      for j in range(3)], dim=1).contiguous()


def _block_of(name, x, spec, mesh):
    from ..parallel.sharding import local_block
    if name.endswith("w_qkv") and mesh.axis_size("tp") > 1:
        return _qkv_heads(x, mesh.axis_size("tp"), mesh.axis_index("tp"))
    return local_block(x, spec, mesh)


def shard_params(params, config: TransformerConfig, mesh,
                 specs=None) -> Dict[str, Any]:
    """Global parameters -> this rank's blocks under ``specs`` (default
    :func:`param_specs`), ``w_qkv`` in the head-wise layout (module
    docstring)."""
    specs = flat_params(specs if specs is not None
                        else param_specs(config, mesh))
    return nest_params({k: _block_of(k, v, specs[k], mesh)
                        for k, v in flat_params(params).items()})


def gather_params(params, config: TransformerConfig, mesh,
                  specs=None) -> Dict[str, Any]:
    """This rank's blocks -> the global parameters (every rank gets them;
    the inverse of :func:`shard_params`)."""
    from ..parallel.sharding import gather
    specs = flat_params(specs if specs is not None
                        else param_specs(config, mesh))
    tp = mesh.axis_size("tp")
    out = {}
    for k, v in flat_params(params).items():
        g = gather(v, specs[k], mesh)
        if k.endswith("w_qkv") and tp > 1:
            # [q0 k0 v0 | q1 k1 v1 ...] -> [q0 q1 .. | k0 k1 .. | v0 ..]
            parts = g.chunk(3 * tp, dim=1)
            g = torch.cat([parts[r * 3 + j] for j in range(3)
                           for r in range(tp)], dim=1)
        out[k] = g
    return nest_params(out)


def _size(mesh, axis):
    return mesh.axis_size(axis) if mesh is not None else 1


def _embed_lookup(embed, tokens, mesh):
    """The (vocab-parallel under tp) embedding lookup."""
    from ..parallel.collectives import allreduce
    tp = _size(mesh, "tp")
    if tp == 1:
        return embed[tokens]
    v_loc = embed.shape[0]
    local = tokens - mesh.axis_index("tp") * v_loc
    inside = (local >= 0) & (local < v_loc)
    x = embed[local.clamp(0, v_loc - 1)] * inside[..., None].to(embed.dtype)
    return allreduce(x, mesh, "tp")


def _block(x, lp, config: TransformerConfig, mesh):
    """One layer on this rank's blocks; ``x`` ``(B/dp, T/sp, d)`` is the
    same on every rank of tp, ep and pp. With ``mesh`` None every axis
    has size 1: the whole layer on one device."""
    from ..parallel.collectives import allgather, allreduce
    from ..parallel.ring_attention import ring_attention
    b, t, d = x.shape
    tp, sp = _size(mesh, "tp"), _size(mesh, "sp")
    hd = d // config.n_heads
    h_loc = config.n_heads // tp
    y = _layernorm(x, lp["ln1_scale"], lp["ln1_bias"])
    qkv = torch.matmul(y, lp["w_qkv"])
    q, k, v = (z.reshape(b, t, h_loc, hd)
               for z in qkv.split(h_loc * hd, dim=-1))
    if sp > 1:
        attn = ring_attention(q, k, v, mesh, axis="sp", causal=config.causal)
    elif q.is_cuda and t % 128 == 0 and hd >= 64:
        attn = flash_attention(q, k, v, causal=config.causal)
    else:
        attn = attention(q, k, v, causal=config.causal)
    o = torch.matmul(attn.reshape(b, t, h_loc * hd), lp["wo"])
    if tp > 1:
        o = allreduce(o, mesh, "tp")
    x = x + o
    y = _layernorm(x, lp["ln2_scale"], lp["ln2_bias"])
    if "moe" in lp:
        dp = _size(mesh, "dp")
        yf = y
        if sp > 1:
            yf = allgather(yf, mesh, "sp", tiled_axis=1)
        if dp > 1:
            yf = allgather(yf, mesh, "dp", tiled_axis=0)
        ff, aux = moe_ffn(yf, lp["moe"], config.n_experts,
                          capacity_factor=config.capacity_factor,
                          k=config.router_k, mesh=mesh)
        if dp > 1:
            ff = ff.chunk(dp, dim=0)[mesh.axis_index("dp")]
        if sp > 1:
            ff = ff.chunk(sp, dim=1)[mesh.axis_index("sp")]
        return x + ff, aux
    hdn = torch.matmul(y, lp["ffn_in"]) + lp["ffn_in_b"]
    hdn = F.gelu(hdn, approximate="tanh")
    o = torch.matmul(hdn, lp["ffn_out"])
    if tp > 1:
        o = allreduce(o, mesh, "tp")
    x = x + o + lp["ffn_out_b"]
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


@mirror_wrapper(True, policy="full")
def _remat_block(x, lp, config: TransformerConfig, mesh):
    return _block(x, lp, config, mesh)


def _embed_in(params, tokens, config, mesh):
    embed = params["embed"]
    tokens = torch.as_tensor(tokens, device=embed.device).long()
    x = _embed_lookup(embed, tokens, mesh)
    off = mesh.axis_index("sp") * tokens.shape[1] if mesh is not None else 0
    return x + _pos_encode(tokens, config.d_model, x.dtype, offset=off)


def _forward(params, tokens, config, mesh, return_aux=False):
    x = _embed_in(params, tokens, config, mesh)
    blk = _remat_block if config.remat else _block
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(config.n_layers):
        x, a = blk(x, params[f"layer{i}"], config, mesh)
        aux = aux + a
    x = _layernorm(x, params["ln_f_scale"], params["ln_f_bias"])
    logits = torch.matmul(x, params["embed"].t())
    return (logits, aux) if return_aux else logits


def _nll(logits, targets, mesh, vocab_axis):
    """Per-token NLL of f32 log-softmax; with ``vocab_axis`` the logits are
    this rank's vocabulary slice and the max and the sum of exponentials
    are all-reduced over it (the logits are never gathered)."""
    from ..parallel.collectives import allreduce
    lf = logits.float()
    n = _size(mesh, vocab_axis) if vocab_axis else 1
    targets = torch.as_tensor(targets, device=lf.device).long()
    if n == 1:
        logp = torch.log_softmax(lf, dim=-1)
        return -logp.gather(-1, targets[..., None])[..., 0]
    v_loc = lf.shape[-1]
    mx = allreduce(lf.detach().amax(dim=-1), mesh, vocab_axis, op="max")
    se = allreduce(torch.exp(lf - mx[..., None]).sum(dim=-1), mesh,
                   vocab_axis)
    local = targets - mesh.axis_index(vocab_axis) * v_loc
    inside = (local >= 0) & (local < v_loc)
    tl = lf.gather(-1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
    tl = allreduce(tl * inside.to(tl.dtype), mesh, vocab_axis)
    return torch.log(se) + mx - tl


def _data_axes(mesh):
    return [a for a in ("dp", "sp") if _size(mesh, a) > 1]


def _mesh_seed(params, tokens, targets, config, mesh, logits_aux=None):
    """This rank's share of the global loss (module docstring): the sum
    of the shares over every rank is the JAX ``loss_fn``."""
    logits, aux = logits_aux if logits_aux is not None else \
        _forward(params, tokens, config, mesh, return_aux=True)
    nll = _nll(logits, targets, mesh, "tp" if _size(mesh, "tp") > 1
               else None)
    n_data = 1
    for a in _data_axes(mesh):
        n_data *= mesh.axis_size(a)
    repl = mesh.size // n_data        # ranks computing the same tokens
    n_tok = nll.numel() * n_data
    return nll.sum() / (n_tok * repl) + \
        config.aux_loss_coef * aux / mesh.size


def _global_value(seed):
    """The sum of every rank's share, on every rank (detached)."""
    from ..parallel.collectives import cross_process_allreduce
    return cross_process_allreduce(seed.detach().clone())


def _token_block(tokens, mesh, device, dp_only=False):
    from ..parallel.sharding import P, local_block
    t = torch.as_tensor(tokens)
    spec = P("dp" if "dp" in mesh.axis_names else None,
             None if dp_only or "sp" not in mesh.axis_names else "sp")
    return local_block(t, spec, mesh).to(device)


def make_train_step(config: TransformerConfig, mesh=None, lr: float = 1e-3):
    """Returns ``(step, shard_params)``: ``step(params, tokens, targets) ->
    (loss, params)`` runs forward, backward and SGD ``w - lr * g``.

    The step updates the tensors of ``params`` in place, where the JAX step
    donates them, and returns the same dict. The update rounds as the JAX
    one does: ``lr * g`` in the weight's dtype, then the subtraction.

    With a mesh: ``shard_params(global)`` gives this rank's blocks;
    ``step`` takes them with the **global** tokens and targets (each rank
    takes its ``P(dp, sp)`` block, as the JAX step's in-shardings place
    them) and returns the global mean loss, the same on every rank."""
    _check_mesh(mesh)
    from ..parallel.sharding import reduce_unsplit
    specs = flat_params(param_specs(config, mesh)) if mesh is not None \
        else None

    def step(params, tokens, targets):
        flat = flat_params(params)
        ws = {k: w.detach().requires_grad_() for k, w in flat.items()}
        if mesh is None:
            loss = loss_fn(nest_params(ws), tokens, targets, config)
            grads = torch.autograd.grad(loss, list(ws.values()))
        else:
            dev = next(iter(ws.values())).device
            tok = _token_block(tokens, mesh, dev)
            tgt = _token_block(targets, mesh, dev)
            seed = _mesh_seed(nest_params(ws), tok, tgt, config, mesh)
            grads = torch.autograd.grad(seed, list(ws.values()))
            grads = reduce_unsplit(grads, [specs[k] for k in ws], mesh)
            loss = _global_value(seed)
        with torch.no_grad():
            torch._foreach_sub_(list(ws.values()),
                                torch._foreach_mul(list(grads), lr))
        return loss.detach(), params

    if mesh is None:
        return step, lambda p: p
    return step, lambda p: shard_params(p, config, mesh)


# ----------------------------------------------------------------------
# Pipeline parallelism: layers stage-stacked over the 'pp' mesh axis
# ----------------------------------------------------------------------

def make_pipeline_train_step(config: TransformerConfig, mesh,
                             lr: float = 1e-3,
                             n_microbatches: Optional[int] = None):
    """Pipelined train step over a mesh with a ``pp`` axis (the JAX
    function). The ``L`` layers form ``S = |pp|`` stages of ``L / S``
    (uniform layers: all dense or all MoE). Returns ``(step, prepare)``:
    ``prepare(global params)`` gives this rank's ``{"embed", "ln_f_*",
    "stages"}``: the embedding and final norm whole (replicated, as the
    JAX top specs ``P(None, None)`` have them) and ``stages`` its own
    stage's layers, a list of layer dicts (under tp, their tp blocks).
    ``step(pparams, tokens, targets)`` takes the global tokens (each rank
    takes its dp block) and runs the GPipe forward
    (``parallel/pipeline.py``), backward and SGD; it returns the global
    mean loss. As in JAX, the MoE load-balance loss is not threaded
    through the pipeline."""
    from ..parallel.pipeline import pipeline_apply
    from ..parallel.sharding import reduce_unsplit
    _check_mesh(mesh)
    S = mesh.axis_size("pp")
    L = config.n_layers
    check(L % max(S, 1) == 0,
          f"n_layers={L} must divide over {S} pipeline stages")
    lps = L // max(S, 1)
    if config.n_experts > 0:
        moe_flags = [config.is_moe_layer(i) for i in range(L)]
        check(all(moe_flags) or not any(moe_flags),
              "pipeline stacking needs uniform layers (set moe_every=1)")
    check(_size(mesh, "sp") == 1, "the pipeline step takes no sp axis")
    from ..parallel.sharding import P
    layer_specs = flat_params(_single_layer_specs(config, mesh, 0))
    stage = mesh.axis_index("pp")

    def prepare(params):
        out = {"embed": params["embed"], "ln_f_scale": params["ln_f_scale"],
               "ln_f_bias": params["ln_f_bias"], "stages": []}
        for j in range(lps):
            lp = flat_params(params[f"layer{stage * lps + j}"])
            out["stages"].append(nest_params(
                {k: _block_of(k, v, layer_specs[k], mesh)
                 for k, v in lp.items()}))
        return out

    def names_specs(pparams):
        names, specs = [], {}
        for k in ("embed", "ln_f_scale", "ln_f_bias"):
            names.append(k)
            specs[k] = P()
        for j, lp in enumerate(pparams["stages"]):
            for k in flat_params(lp):
                name = f"stages/{j}/{k}"
                names.append(name)
                specs[name] = P("pp", *layer_specs[k])
        return names, specs

    def stage_fn(layers, xm):
        for lp in layers:
            xm, _ = _block(xm, lp, config, mesh)
        return xm

    def step(pparams, tokens, targets):
        names, specs = names_specs(pparams)
        leaves = [pparams[k] for k in ("embed", "ln_f_scale", "ln_f_bias")]
        for lp in pparams["stages"]:
            leaves += list(flat_params(lp).values())
        ws = [w.detach().requires_grad_() for w in leaves]
        top = dict(zip(("embed", "ln_f_scale", "ln_f_bias"), ws[:3]))
        layers, off = [], 3
        for lp in pparams["stages"]:
            keys = list(flat_params(lp))
            layers.append(nest_params(dict(zip(keys, ws[off:off + len(keys)]))))
            off += len(keys)
        dev = ws[0].device
        tok = _token_block(tokens, mesh, dev, dp_only=True)
        tgt = _token_block(targets, mesh, dev, dp_only=True)
        x = top["embed"][tok] + _pos_encode(tok, config.d_model,
                                            top["embed"].dtype)
        x = pipeline_apply(stage_fn, layers, x, mesh, axis="pp",
                           n_microbatches=n_microbatches)
        x = _layernorm(x, top["ln_f_scale"], top["ln_f_bias"])
        logits = torch.matmul(x, top["embed"].t())
        nll = _nll(logits, tgt, mesh, None)
        n_data = _size(mesh, "dp")
        seed = nll.sum() / (nll.numel() * n_data * (mesh.size // n_data))
        grads = torch.autograd.grad(seed, ws)
        grads = reduce_unsplit(grads, [specs[k] for k in names], mesh)
        with torch.no_grad():
            torch._foreach_sub_(leaves, torch._foreach_mul(list(grads), lr))
        return _global_value(seed), pparams

    return step, prepare
