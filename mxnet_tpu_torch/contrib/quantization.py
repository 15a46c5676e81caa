"""Model quantization (ref: the JAX package's ``contrib/quantization.py``;
python/mxnet/contrib/quantization.py and quantize_graph_pass.cc).

Two flows, as in the JAX package:

- **Gluon** (:func:`quantize_net`): fold inference BatchNorm into the
  convolution before it (:func:`fold_batchnorm`, exact), record each
  Conv2D / Dense input's range over calibration batches (naive absmax or
  entropy, the KL search with the clip-mass rail of ``ADVICE.md``), then
  replace each layer with its int8 twin (:class:`QuantizedConv2D`,
  :class:`QuantizedDense`): per-output-channel int8 weights, a static
  input scale, the int8 products of ``ops/quantization.py``. The port's
  blocks compute with tensors, so the calibration hooks are forward
  pre-hooks where the JAX package patches ``hybrid_forward``. It
  calibrates before it changes anything, and keeps and restores each
  block's hybridize state, dropping stale CachedOps.
- **Symbol** (:func:`quantize_model`, :func:`calib_graph`): a Symbol DAG
  rewrite of FullyConnected nodes into ``_contrib_quantize_v2`` ->
  ``_quantized_fc_static`` with int8 weights under
  ``<name>_quantized``, calibrated through the executor's walk.

The calibration statistics are numpy, the JAX package's code as it is, so
both packages choose the same thresholds from the same activations.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as _np
import torch

from ..base import MXNetError, check

__all__ = ["quantize_model", "calib_graph", "CalibrationCollector",
           "HistogramCollector", "get_optimal_threshold", "fold_batchnorm",
           "quantize_net", "QuantizedConv2D", "QuantizedDense"]

_QUANTIZABLE = {"FullyConnected"}


class CalibrationCollector:
    """Collects per-tensor (min, max) over calibration batches
    (ref: _LayerOutputMinMaxCollector)."""

    def __init__(self):
        self.min_max: Dict[str, Tuple[float, float]] = {}

    def collect(self, name: str, arr) -> None:
        a = _np.asarray(arr)
        mn, mx = float(a.min()), float(a.max())
        if name in self.min_max:
            omn, omx = self.min_max[name]
            self.min_max[name] = (min(mn, omn), max(mx, omx))
        else:
            self.min_max[name] = (mn, mx)


class HistogramCollector:
    """Per-tensor symmetric histograms for KL calibration
    (ref: _LayerHistogramCollector). The bin range is pinned to the first
    batch's absmax; later outliers accumulate into the edge bins."""

    def __init__(self, num_bins: int = 8001):
        self.num_bins = num_bins
        self.hists: Dict[str, Tuple[_np.ndarray, float]] = {}

    def collect(self, name: str, arr) -> None:
        a = _np.asarray(arr, _np.float64).reshape(-1)
        if name not in self.hists:
            th = max(float(_np.abs(a).max()), 1e-8)
            # adapt bin count to the sample size: the KL search degrades
            # on near-empty histograms (a few samples across 8001 bins)
            # floor 1025: at 257 bins there is exactly ONE KL candidate
            # (the full range) and entropy mode degrades to absmax; 1025
            # gives a 4x search range while the bulk-mass guard handles
            # sparsity
            bins = int(min(self.num_bins, max(1025, a.size // 4)))
            bins |= 1  # keep a center bin
            hist, _ = _np.histogram(_np.clip(a, -th, th),
                                    bins=bins, range=(-th, th))
            self.hists[name] = (hist.astype(_np.float64), th)
        else:
            hist, th = self.hists[name]
            new, _ = _np.histogram(_np.clip(a, -th, th),
                                   bins=hist.size, range=(-th, th))
            self.hists[name] = (hist + new, th)


def get_optimal_threshold(hist, threshold, num_quantized_bins=255):
    """KL-divergence threshold search (ref: quantization.py
    _get_optimal_threshold, the TensorRT calibration algorithm): pick the
    symmetric clip threshold whose 255-level quantized distribution is
    closest (min KL) to the original."""
    hist = _np.asarray(hist, _np.float64)
    num_bins = hist.size
    zero = num_bins // 2
    best_div = _np.inf
    best_th = threshold
    step = threshold / zero
    # Clip-mass rail: restrict the search to thresholds discarding at
    # most 0.01% of the NONZERO mass (the zero bin quantizes exactly to
    # 0 at any threshold, so it is excluded from the budget). Why: on
    # post-ReLU activations the histogram is a giant zero spike plus a
    # sparse decisive tail; the KL objective gains more from finely
    # resolving the spike than it loses from clipping the
    # small-in-count tail, and picks thresholds 6-10x below absmax that
    # collapse model accuracy (measured: ResNet-50 int8 top-1 1.00 ->
    # 0.55 on chip, tools/accuracy_int8_resnet50.py). Genuine lone
    # outliers are far below the budget and still get clipped — the
    # point of KL calibration.
    nz_hist = hist.copy()
    nz_hist[zero] = 0.0
    total_nz = nz_hist.sum()
    # floor of 2: small calibration tensors must still be able to clip
    # a lone extreme outlier (1e-4 of a 96-sample tensor is < 1 count,
    # which would forbid ALL clipping and return raw absmax) — but never
    # more than 5% of the nonzero mass, so a near-dead channel with 1-2
    # real activations keeps them instead of clipping everything
    budget = min(max(1e-4 * total_nz, 2.0), 0.05 * total_nz)
    if total_nz < 2 * num_quantized_bins:
        # too sparse for the KL statistic (well under one count per
        # quantized level: the divergence is dominated by histogram
        # sampling noise, not by clipping) — apply the budget as a
        # percentile rule directly: the tightest threshold discarding
        # at most `budget` nonzero counts
        for i in range(num_quantized_bins // 2 + 1, zero + 1):
            clipped = nz_hist[:zero - i].sum() + nz_hist[zero + i + 1:].sum()
            if clipped <= budget:
                return (i + 0.5) * step
        return threshold
    for i in range(num_quantized_bins // 2 + 1, zero + 1):
        clipped_nz = nz_hist[:zero - i].sum() + nz_hist[zero + i + 1:].sum()
        if total_nz > 0 and clipped_nz > budget:
            continue
        sliced = hist[zero - i:zero + i + 1]
        p = sliced.copy()
        p[0] += hist[:zero - i].sum()
        p[-1] += hist[zero + i + 1:].sum()
        if p.sum() == 0:
            continue
        # q models the 255-level quantization of the UNCLIPPED slice
        # only (reference semantics: the clipped outlier mass lives in
        # p's edge bins but NOT in q, so clipping the bulk is penalized
        # by the KL — a round-5 fix: building q from p instead silently
        # removed that penalty and let the search pick thresholds that
        # clip real activations, collapsing model-scale int8 top-1)
        idx = (_np.arange(sliced.size) * num_quantized_bins
               // sliced.size)
        counts = _np.bincount(idx, weights=sliced,
                              minlength=num_quantized_bins)
        nonzero = _np.bincount(idx,
                               weights=(sliced > 0).astype(_np.float64),
                               minlength=num_quantized_bins)
        with _np.errstate(divide="ignore", invalid="ignore"):
            expanded = _np.where(nonzero[idx] > 0,
                                 counts[idx] / nonzero[idx], 0.0)
        q = _np.where(sliced > 0, expanded, 0.0)
        # smooth (ref: _smooth_distribution) so KL stays finite
        eps = 1e-4
        for d in (p, q):
            zeros = d == 0
            nz = ~zeros
            n_nz = int(nz.sum())
            if n_nz == 0:
                continue
            d[zeros] = eps
            d[nz] -= eps * zeros.sum() / n_nz
        ps = p / p.sum()
        qs = q / q.sum()
        div = float(_np.sum(ps * _np.log(_np.maximum(ps, 1e-12) /
                                         _np.maximum(qs, 1e-12))))
        if div < best_div:
            best_div = div
            best_th = (i + 0.5) * step
    return best_th


def _host(v):
    """A tensor or NDArray as a host numpy array."""
    t = getattr(v, "_data", v)
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else _np.asarray(t)


def calib_graph(symbol, arg_map, aux_map, calib_batches,
                mode: str = "naive", include=None) -> Dict[str, Tuple]:
    """Per-layer calibration ranges over batches: naive (min, max) or
    entropy (KL-optimal symmetric thresholds); ``include`` restricts them
    to the named internal outputs (ref: the reference's include_layer)."""
    from ..symbol.executor import _walk
    collector = CalibrationCollector() if mode == "naive" \
        else HistogramCollector()
    internals = symbol.get_internals()
    names = internals.list_outputs()
    include = set(include) if include is not None else None
    aux = {k: getattr(v, "_data", v) for k, v in aux_map.items()}
    for batch in calib_batches:
        feed = {k: getattr(v, "_data", v)
                for k, v in {**arg_map, **batch}.items()}
        with torch.no_grad():
            outs = _walk(internals, feed, aux, False)
        for name, val in zip(names, outs):
            if include is None or name in include:
                collector.collect(name, _host(val))
    if mode == "naive":
        return collector.min_max
    out = {}
    for name, (hist, th) in collector.hists.items():
        opt = get_optimal_threshold(hist, th)
        out[name] = (-opt, opt)
    return out


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   ctx=None, excluded_sym_names=(), calib_mode="naive",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", **kwargs):
    """Quantize a symbolic model for int8 inference (ref:
    contrib/quantization.py quantize_model); ``num_calib_examples`` counts
    examples, not batches.

    Returns (qsym, qarg_params, aux_params): FullyConnected nodes become
    quantize_v2 -> _quantized_fc_static chains with pre-quantized int8
    weights stored under '<name>_quantized'.
    """
    from ..symbol.symbol import _Node, Symbol
    from ..ndarray import ndarray as _nd
    from ..ops import registry as _reg

    excluded = set(excluded_sym_names)
    qarg_params = dict(arg_params)

    # calibrated activation thresholds: entropy (KL) or naive min/max,
    # baked into the inserted quantize nodes as static ranges so inference
    # needs no per-batch min/max reductions (ref: calib_mode semantics)
    calib_thresholds: Dict[str, Tuple[float, float]] = {}
    if calib_data is not None and calib_mode in ("naive", "entropy"):
        batches = list(calib_data)
        if num_calib_examples is not None:
            # reference semantics: example COUNT, not batch count
            kept, seen = [], 0
            for b in batches:
                kept.append(b)
                first = next(iter(b.values()))
                seen += int(getattr(first, "shape", (1,))[0])
                if seen >= int(num_calib_examples):
                    break
            batches = kept
        # only the data inputs of quantizable nodes consume thresholds
        needed = set()
        for node in sym._topo():
            if node.is_variable or node.op.name not in _QUANTIZABLE or \
                    node.name in excluded:
                continue
            inp, slot = node.inputs[0]
            needed.add(f"{inp.name}_output" if inp.num_outputs() == 1
                       else f"{inp.name}_output{slot}")
        calib_thresholds = calib_graph(sym, arg_params, aux_params or {},
                                       batches, mode=calib_mode,
                                       include=needed)

    weight_meta: Dict[str, Tuple[float, float]] = {}
    for node in sym._topo():
        if node.is_variable or node.op.name not in _QUANTIZABLE or \
                node.name in excluded:
            continue
        w_node = node.inputs[1][0]
        if not w_node.is_variable or w_node.name not in arg_params:
            continue
        w = arg_params[w_node.name]
        q, mn, mx = _nd.imperative_invoke("_contrib_quantize_v2", (w,), {})
        qarg_params[w_node.name + "_quantized"] = q
        weight_meta[w_node.name] = (float(mn.asscalar()),
                                    float(mx.asscalar()))
        del qarg_params[w_node.name]

    memo: Dict[int, _Node] = {}

    def conv(node: _Node) -> _Node:
        c = memo.get(id(node))
        if c is not None:
            return c
        new_inputs = [(conv(i), k) for i, k in node.inputs]
        if not node.is_variable and node.op.name in _QUANTIZABLE and \
                node.name not in excluded and \
                node.inputs[1][0].name in weight_meta:
            wname = node.inputs[1][0].name
            w_min, w_max = weight_meta[wname]
            in_node = node.inputs[0][0]
            in_key = f"{in_node.name}_output" if in_node.num_outputs() == 1 \
                else f"{in_node.name}_output{node.inputs[0][1]}"
            q_attrs = {}
            if in_key in calib_thresholds:
                lo, hi = calib_thresholds[in_key]
                q_attrs = {"min_calib_range": float(lo),
                           "max_calib_range": float(hi)}
            qd = _Node(_reg.get_op("_contrib_quantize_v2"),
                       node.name + "_quantize", q_attrs, [new_inputs[0]])
            wq_var = _Node(None, wname + "_quantized", {}, [])
            attrs = dict(node.attrs)
            inputs = [(qd, 0), (qd, 1), (qd, 2), (wq_var, 0)]
            no_bias = bool(attrs.get("no_bias", False))
            if not no_bias and len(new_inputs) > 2:
                inputs.append(new_inputs[2])
            c = _Node(_reg.get_op("_quantized_fc_static"), node.name,
                      {"w_min": w_min, "w_max": w_max,
                       "num_hidden": attrs.get("num_hidden", 1),
                       "no_bias": no_bias,
                       "flatten": attrs.get("flatten", True)}, inputs)
        else:
            c = _Node(node.op, node.name, dict(node.attrs), new_inputs)
            c.extra = dict(node.extra)
        memo[id(node)] = c
        return c

    qsym = Symbol([(conv(n), i) for n, i in sym._outputs])
    return qsym, qarg_params, dict(aux_params)


# ---------------------------------------------------------------------------
# Gluon int8 inference: fold_batchnorm + quantize_net
# ---------------------------------------------------------------------------

def _walk_blocks(block):
    """(parent, child key, child) over the whole block tree."""
    for key, child in list(block._modules.items()):
        if child is not None:
            yield block, key, child
            yield from _walk_blocks(child)


def _replace_child(parent, key, old, new):
    parent._modules[key] = new


def _param(block, short):
    return block.params[block.prefix + short]


def _dtype_name(dtype) -> str:
    return str(dtype).split(".")[-1]


def fold_batchnorm(net):
    """Fold inference BatchNorm into the convolution before it, in place:
    for each adjacent (Conv2D, BatchNorm) pair of a sequential container,
    ``W' = W * gamma / sqrt(var + eps)`` per output channel and
    ``b' = beta - mean * gamma / sqrt(var + eps)``; the BatchNorm becomes
    the identity, or the relu / add+relu tail of a fused epilogue block.
    A SpaceToDepthStem folds into its inner conv (``_tail_conv``). Exact
    at inference. Returns the number of pairs folded."""
    from ..gluon import nn as _gnn
    from ..gluon.nn.conv_layers import _Conv

    def conv_of(block):
        # a conv with a fused activation is not conv(x) before the BN
        if isinstance(block, _Conv) and not block._transpose \
                and block._activation is None:
            return block
        if getattr(block, "_tail_conv", False):
            inner = getattr(block, "conv", None)
            if isinstance(inner, _Conv) and not inner._transpose \
                    and inner._activation is None:
                return inner
        return None

    def containers(block, acc):
        if isinstance(block, _gnn.HybridSequential):
            acc.append(block)
        for child in block.children():
            containers(child, acc)
        return acc

    n_folded = 0
    # only sequential containers guarantee declaration order == dataflow
    for parent in containers(net, []):
        kids = list(parent._modules.items())
        for (k1, b1), (k2, b2) in zip(kids, kids[1:]):
            conv = conv_of(b1)
            if conv is None or not isinstance(b2, _gnn.BatchNorm):
                continue
            ndim = len(conv._kwargs["kernel"]) + 2
            if b2._axis % ndim != conv._channel_axis % ndim:
                continue    # BN normalises a non-channel axis
            wp = _param(conv, "weight")
            if wp.tensor is None or _param(b2, "running_var").tensor is None:
                raise MXNetError(
                    "fold_batchnorm: parameters not initialized (run a "
                    "forward pass first)")

            def host(block, short):
                return _param(block, short).data().asnumpy().astype(
                    _np.float64)

            gamma = host(b2, "gamma") if b2._scale else 1.0
            beta = host(b2, "beta") if b2._center else 0.0
            mean, var = host(b2, "running_mean"), host(b2, "running_var")
            s = gamma / _np.sqrt(var + b2._epsilon)
            w = wp.data().asnumpy().astype(_np.float64)
            new_w = w * s.reshape((-1,) + (1,) * (w.ndim - 1))
            new_b = beta - mean * s
            if conv._use_bias:
                new_b = new_b + host(conv, "bias") * s
            wp.set_data(new_w.astype(_np.float32))   # cast to the weight's

            if not conv._use_bias:
                bp = conv._new_param("bias", (new_b.size,), init="zeros")
                bp.reset_ctx(wp.list_ctx()[0])
                conv._use_bias = True
                conv._kwargs["no_bias"] = False
            _param(conv, "bias").set_data(new_b.astype(_np.float32))
            # a fused epilogue block leaves its relu / add+relu tail
            epi = getattr(b2, "_epilogue", None)
            if epi == "relu":
                repl = _gnn.Activation("relu")
            elif epi == "add_relu":
                repl = _gnn.HybridLambda(
                    lambda F, x, r: F.Activation(x + r, act_type="relu"))
            else:
                repl = _gnn.HybridLambda(lambda F, x: x)
            _replace_child(parent, k2, b2, repl)
            n_folded += 1
    if n_folded:
        # a hybridized net would replay the stale conv+BN graph
        for blk in [net] + [c for _, _, c in _walk_blocks(net)]:
            if getattr(blk, "_cached_op", None) is not None:
                blk._cached_op = None
    return n_folded


from ..gluon.block import HybridBlock as _HybridBlock  # noqa: E402


def _null_param(block, name, np_data):
    """A frozen (aux) parameter of ``block`` holding ``np_data``."""
    p = block.params.get(name, shape=np_data.shape,
                         dtype=str(np_data.dtype), grad_req="null",
                         differentiable=False)
    p.set_data(np_data)
    return p


class _QuantizedLayer(_HybridBlock):
    """The calibrated int8 blocks' base: per-output-channel symmetric int8
    weights (``qweight``, scales ``wscale``), a static input scale, and an
    optional f32 (BN-folded) ``bias``, all frozen, on the source layer's
    device."""

    def __init__(self, src, in_scale, prefix=None, params=None):
        wp = _param(src, "weight")
        super().__init__(prefix=prefix, params=params,
                         device=wp.tensor.device)
        self._in_scale = float(in_scale)
        self._activation = src._activation
        # the output dtype of an export trace (Symbols carry none); the
        # tensor path follows the input's dtype
        self._default_out_dtype = _dtype_name(wp.tensor.dtype)
        w32 = _np.asarray(wp.data().asnumpy(), _np.float32)
        absmax = _np.abs(w32).reshape(w32.shape[0], -1).max(axis=1)
        scale = _np.maximum(absmax, 1e-8) / 127.0
        q = _np.clip(_np.round(w32 / scale.reshape((-1,) + (1,) *
                                                   (w32.ndim - 1))),
                     -127, 127).astype(_np.int8)
        _null_param(self, "qweight", q)
        _null_param(self, "wscale", scale.astype(_np.float32))
        self._has_bias = bool(getattr(src, "_use_bias", False))
        if self._has_bias:
            _null_param(self, "bias", _np.asarray(
                _param(src, "bias").data().asnumpy(), _np.float32))

    def forward(self, x):
        from ..ops import nn as _ops
        from ..ops import quantization as _q
        qx = _q.quantize_static(x, scale=self._in_scale)
        bias = (self._buffers["bias"],) if self._has_bias else ()
        out = self._invoke(getattr(_q, self._OP), qx,
                           self._buffers["qweight"], self._buffers["wscale"],
                           *bias, out_dtype=_dtype_name(x.dtype))
        if self._activation:
            out = _ops.activation(out, act_type=self._activation)
        return out

    def hybrid_forward(self, F, x, qweight, wscale, bias=None):
        qx = F._internal._quantize_static(x, scale=self._in_scale)
        args = (qx, qweight, wscale) + (() if bias is None else (bias,))
        out = self._invoke(getattr(F._internal, "_" + self._OP), *args,
                           out_dtype=self._default_out_dtype)
        if self._activation:
            out = F.Activation(out, act_type=self._activation)
        return out


class QuantizedConv2D(_QuantizedLayer):
    """Calibrated int8 convolution, emitted by :func:`quantize_net` in
    place of a Conv2D (``_quantized_conv_v2``)."""

    def __init__(self, conv, in_scale, prefix=None, params=None):
        self._conv_kwargs = {k: conv._kwargs[k] for k in
                             ("kernel", "stride", "dilate", "pad",
                              "num_filter", "num_group", "layout")}
        super().__init__(conv, in_scale, prefix=prefix, params=params)

    _OP = "quantized_conv_v2"

    def _invoke(self, fn, qx, qweight, wscale, *bias, out_dtype):
        return fn(qx, qweight, wscale, *bias, **self._conv_kwargs,
                  in_scale=self._in_scale, no_bias=not bias,
                  out_dtype=out_dtype)

    def extra_repr(self):
        return (f"{self._conv_kwargs['num_filter']}, "
                f"kernel={self._conv_kwargs['kernel']}, "
                f"in_scale={self._in_scale:.4g}")


class QuantizedDense(_QuantizedLayer):
    """Calibrated int8 FullyConnected block (``_quantized_dense_v2``)."""

    def __init__(self, dense, in_scale, prefix=None, params=None):
        self._units = dense._units
        self._flatten = dense._flatten
        super().__init__(dense, in_scale, prefix=prefix, params=params)

    _OP = "quantized_dense_v2"

    def _invoke(self, fn, qx, qweight, wscale, *bias, out_dtype):
        return fn(qx, qweight, wscale, *bias, num_hidden=self._units,
                  flatten=self._flatten, in_scale=self._in_scale,
                  no_bias=not bias, out_dtype=out_dtype)

    def extra_repr(self):
        return f"{self._units}, in_scale={self._in_scale:.4g}"


def quantize_net(net, calib_data, calib_mode: str = "naive",
                 exclude=(), quantize_dense: bool = True,
                 fold_bn: bool = True, logger=None):
    """Quantize a Gluon network for int8 inference, in place (ref: the JAX
    package's ``quantize_net``): fold BatchNorm into the convolutions,
    record each Conv2D / Dense input's range over ``calib_data`` (batches
    of NDArrays, tensors or arrays; naive absmax or entropy), and replace
    each with its int8 twin. ``exclude``: block-name substrings kept in
    float. Returns the net."""
    from ..gluon import nn as _gnn
    from ..gluon.nn.conv_layers import _Conv
    from .. import autograd as _ag
    from ..ndarray.ndarray import NDArray

    check(calib_mode in ("naive", "entropy"),
          f"calib_mode must be naive|entropy, got {calib_mode!r}")
    check(not isinstance(exclude, str),
          "exclude must be a collection of name substrings, not a bare "
          "string (a string would match per-character)")
    # a hybridized net would replay its float graphs past the hooks: run
    # imperatively, then restore each block's state (flag and mirror)
    hyb_state = [(b, b._active, b._mirror_arg)
                 for b in [net] + [c for _, _, c in _walk_blocks(net)]
                 if isinstance(b, _HybridBlock)]
    was_hybridized = any(active for _, active, _ in hyb_state)
    if was_hybridized:
        net.hybridize(False)

    def _restore_hyb():
        for b, active, mirror in hyb_state:
            b._active, b._mirror_arg, b._cached_op = active, mirror, None

    sites = []     # every (parent, key) occurrence of a shared block
    uniq = {}      # id(block) -> block, calibrated and quantized once
    for parent, key, child in _walk_blocks(net):
        is_conv = (isinstance(child, _Conv) and not child._transpose
                   and len(child._kwargs["kernel"]) == 2)
        is_dense = quantize_dense and isinstance(child, _gnn.Dense)
        if not (is_conv or is_dense):
            continue
        if any(pat in child.name for pat in exclude):
            continue
        uniq[id(child)] = child
        sites.append((parent, key, child))
    targets = list(uniq.values())

    # --- calibration: each target's input, before anything changes -----
    collector = CalibrationCollector() if calib_mode == "naive" \
        else HistogramCollector()

    def hook_of(name):
        def hook(_module, args):
            collector.collect(name, _host(args[0]))
        return hook

    handles = [blk.register_forward_pre_hook(hook_of(blk.name))
               for blk in targets]

    def in_scale_of(name):
        seen = collector.min_max if calib_mode == "naive" \
            else collector.hists
        check(name in seen,
              f"no calibration data reached layer {name!r}: pass calib "
              "batches that exercise every quantized layer (or add it to "
              "`exclude`)")
        if calib_mode == "naive":
            mn, mx = collector.min_max[name]
            return max(abs(mn), abs(mx), 1e-8) / 127.0
        hist, th = collector.hists[name]
        return get_optimal_threshold(hist, th) / 127.0

    n_batches = 0
    try:
        try:
            home = next((p.tensor.device for p in
                         net.collect_params().values()
                         if p.tensor is not None), None)
            with _ag.pause(), torch.no_grad():
                for batch in calib_data:
                    if not isinstance(batch, (NDArray, torch.Tensor)):
                        batch = torch.as_tensor(_np.asarray(batch),
                                                device=home)
                    net(batch)
                    n_batches += 1
        finally:
            for h in handles:
                h.remove()
        check(n_batches > 0,
              "quantize_net: calib_data yielded no calibration batches — "
              "pass at least one batch that exercises every quantized "
              "layer")
        scales = {id(blk): in_scale_of(blk.name) for blk in targets}
    except Exception:
        if was_hybridized:
            _restore_hyb()
        raise

    # folding is exact, so the recorded input ranges still hold; the
    # twins capture the folded weights
    if fold_bn:
        n = fold_batchnorm(net)
        if logger:
            logger.info("fold_batchnorm: folded %d conv+BN pairs", n)
    qblocks = {}
    for blk in targets:
        scale = scales[id(blk)]
        qblocks[id(blk)] = QuantizedDense(blk, scale) \
            if isinstance(blk, _gnn.Dense) else QuantizedConv2D(blk, scale)
        if logger:
            logger.info("quantized %s (in_scale=%.5g)", blk.name, scale)
    for parent, key, blk in sites:
        _replace_child(parent, key, blk, qblocks[id(blk)])
    if was_hybridized:
        _restore_hyb()
        for q in qblocks.values():
            q.hybridize(True)
    return net
