"""Carry weights from a JAX-package model to its port.

``from_mxnet_tpu_params(net, params)`` takes the JAX net's
``collect_params()`` values as numpy arrays (``{name: array}``), running
statistics included, and copies them into the port's ``net``. Names are
matched exactly; pass ``prefix`` (the JAX net's ``prefix``) when the two
top-level blocks were numbered differently, and that prefix is swapped for
the port net's own.

Layouts: MXNet's channel-last convolutions keep their weight as OHWI, and
so does the port's parameter (it becomes the OIHW ``channels_last`` view
the convolution wants at the call, without a copy), so arrays are copied
as they are. A missing, extra or mis-shaped name raises; a deferred
parameter (a 0 in its shape) takes the array's extent there and its
tensor is created from it. Values are written in place into each block's
tensor (``Parameter.set_data``), so a CUDA graph the trainer captured over
the net stays valid. A fused RNN layer (``gluon.rnn.RNN`` / ``LSTM`` /
``GRU``) takes its per-layer parameters by name, or one flat vector under
``<layer prefix>parameters``: an ``mx.rnn.FusedRNNCell``'s
``parameters`` argument (rename its prefix with ``prefix``), split by the
fused op's packing (``ops/rnn_op.py layer_weights``).

``from_transformer_params(params, config, device=None)`` takes the JAX
``models.transformer.init_params`` pytree as numpy arrays and returns the
port's nested dict on ``device`` (default: the card). The layouts are the
JAX package's (``w_qkv`` ``(d, 3d)``, ``embed`` ``(V, d)`` ...), so nothing
is transposed; MoE layers' leaves sit a level deeper
(``layer1/moe/w_in``). Names, shapes and each leaf's dtype
(``param_dtypes``: ``config.dtype`` as float32 arrays or the ``bfloat16``
arrays that ``np.asarray`` makes of JAX bf16 arrays, and float32 for every
MoE router ``gate``) must match exactly, or it raises.

``load_embedding_plane(plane, npz_or_dict, states=None)`` takes a JAX
``EmbeddingPlane``'s shards in its ``save_npz`` layout (``meta`` = rows,
dim, world and ``shard_<r>``) and, where given, each rank's optimizer
state (a tuple of arrays per rank, the rule's slot order, None for a rank
no step touched) into the port's plane of the same layout.
``sparse_from_parts`` makes a port ``CSRNDArray`` from ``(data, indices,
indptr)`` or a ``RowSparseNDArray`` from ``(data, indices)`` numpy arrays
(a JAX sparse array's ``.data`` / ``.indices`` / ``.indptr``).
"""
from __future__ import annotations

import numpy as np
import torch

from .base import MXNetError
from .context import resolve_device
from .models.transformer import (flat_params, nest_params,
                                 param_dtypes, param_shapes)

__all__ = ["from_mxnet_tpu_params", "from_transformer_params",
           "load_embedding_plane", "sparse_from_parts"]


def from_mxnet_tpu_params(net, params, prefix=None) -> None:
    if prefix is not None:
        renamed = {}
        for k, v in params.items():
            if not k.startswith(prefix):
                raise MXNetError(f"parameter {k!r} does not start with "
                                 f"{prefix!r}")
            renamed[net.prefix + k[len(prefix):]] = v
        params = renamed
    params = _split_fused(net, params)
    ours = net.collect_params()
    missing = sorted(set(ours) - set(params))
    extra = sorted(set(params) - set(ours))
    if missing or extra:
        raise MXNetError(f"parameter names differ: missing {missing[:5]}, "
                         f"extra {extra[:5]}")
    for name, p in ours.items():
        arr = np.asarray(params[name], dtype=np.float32)
        if arr.ndim != len(p.shape) or any(
                s not in (0, a) for s, a in zip(p.shape, arr.shape)):
            raise MXNetError(f"parameter {name}: shape {tuple(arr.shape)} "
                             f"does not match {p.shape}")
        p.set_data(arr)


def _split_fused(net, params) -> dict:
    """``params`` with each fused RNN layer's flat ``<prefix>parameters``
    vector replaced by that layer's per-layer arrays."""
    from .gluon.rnn.rnn_layer import _RNNLayer
    from .ops.rnn_op import _GATES, layer_weights, rnn_param_size
    out = dict(params)
    for block in net.modules():
        key = getattr(block, "prefix", "") + "parameters"
        if not isinstance(block, _RNNLayer) or key not in out:
            continue
        flat = np.asarray(out.pop(key), dtype=np.float32).reshape(-1)
        h, d, n_l, mode = (block._hidden_size, block._dir,
                           block._num_layers, block._mode)
        bid = d == 2
        # the first layer's input width is what the size leaves for it
        first = d * _GATES[mode] * h
        rest = rnn_param_size(n_l, h * d, h, bid, mode) - \
            first * (h * d + h + 2)
        in_sz = (flat.size - rest) // first - h - 2
        if in_sz <= 0 or rnn_param_size(n_l, in_sz, h, bid, mode) != \
                flat.size:
            raise MXNetError(f"{key}: {flat.size} elements do not pack a "
                             f"{n_l}-layer {mode} of width {h}")
        for idx, slots in enumerate(layer_weights(n_l, in_sz, h, bid,
                                                  mode)):
            suffix = ["l", "r"][idx % d] + str(idx // d)
            for k, (off, shape) in zip(("i2h_weight", "h2h_weight",
                                        "i2h_bias", "h2h_bias"), slots):
                size = int(np.prod(shape))
                out[f"{block.prefix}{suffix}_{k}"] = \
                    flat[off:off + size].reshape(shape)
    return out


def from_transformer_params(params, config, device=None, mesh=None) -> dict:
    """The JAX transformer's parameter pytree (numpy leaves) as the port's
    tensors, checked against the configuration's names, shapes and
    dtypes. ``mesh``: this rank's blocks under ``param_specs`` (``w_qkv``
    in the head-wise layout of ``models/transformer.py``)."""
    if mesh is not None:
        from .models.transformer import shard_params
        whole = from_transformer_params(params, config, device="cpu")
        return {k: v for k, v in _to(shard_params(whole, config, mesh),
                                     resolve_device(device)).items()}
    dev = resolve_device(device)
    got = flat_params(params)
    shapes = flat_params(param_shapes(config))
    dtypes = flat_params(param_dtypes(config))
    missing = sorted(set(shapes) - set(got))
    extra = sorted(set(got) - set(shapes))
    if missing or extra:
        raise MXNetError(f"parameter names differ: missing {missing[:5]}, "
                         f"extra {extra[:5]}")
    out = {}
    for name, shape in shapes.items():
        arr = np.asarray(got[name])
        if tuple(arr.shape) != shape:
            raise MXNetError(f"parameter {name}: shape {tuple(arr.shape)} "
                             f"does not match {shape}")
        want_dtype = str(dtypes[name]).replace("torch.", "")
        if str(arr.dtype) != want_dtype:
            raise MXNetError(f"parameter {name}: dtype {arr.dtype} is not "
                             f"the configured {want_dtype}")
        out[name] = torch.from_numpy(arr.astype(np.float32)).to(
            device=dev, dtype=dtypes[name])
    return nest_params(out)


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def load_embedding_plane(plane, arrays, states=None) -> None:
    """Load a JAX plane's ``save_npz`` arrays (a path or a mapping) and
    optional per-rank states into ``plane``; the layout must match."""
    if isinstance(arrays, (str, bytes)):
        with np.load(arrays) as z:
            arrays = {k: z[k] for k in z.files}
    rows, dim, world = (int(x) for x in np.asarray(arrays["meta"]))
    if (rows, dim, world) != (plane.rows, plane.dim, plane.world):
        raise MXNetError(f"plane layout {(rows, dim, world)} does not match "
                         f"{(plane.rows, plane.dim, plane.world)}")
    plane.load_arrays([np.asarray(arrays[f"shard_{r}"])
                       for r in range(world)], states)


def sparse_from_parts(data, indices, indptr=None, shape=None, ctx=None):
    """A port sparse array from its parts: csr with ``indptr``, else
    row_sparse."""
    from .ndarray import sparse as _sp
    if shape is None:
        raise MXNetError("sparse_from_parts needs the array's shape")
    if indptr is not None:
        return _sp.csr_matrix((np.asarray(data), np.asarray(indices),
                               np.asarray(indptr)), shape=shape, ctx=ctx)
    return _sp.row_sparse_array((np.asarray(data), np.asarray(indices)),
                                shape=shape, ctx=ctx)
