"""SPMDTrainer on one device (ref: the JAX package's parallel/spmd.py).

The JAX trainer traces loss + gradients + optimizer update into one XLA
program per step, and ``run_steps`` scans K of them in one dispatch. Here
``step`` runs eagerly: forward, ``torch.autograd.grad``, then a
multi-tensor update in place. ``run_steps`` on the card is one replay of
a CUDA graph that holds K whole steps, the port's counterpart of the one
dispatch. The numerics follow the JAX step:

- the forward runs in training mode: ``autograd.set_training(True)``
  around it, the previous mode restored after (BatchNorm reads it);
- mixed precision: with ``dtype`` set, every trainable f32 master (BatchNorm
  gamma and beta included) is cast to ``dtype`` for the forward and the
  data is cast too; the aux running statistics stay f32. Gradients come
  back through the casts to the f32 masters;
- the loss is the f32 mean of the per-sample losses;
- SGD: ``m = momentum * m - lr * (g + wd * w); w = w + m`` (without
  momentum ``w = w - lr * (g + wd * w)``);
- Adam: ``g' = g + wd * w``, ``m = b1 m + (1 - b1) g'``, ``v = b2 v +
  (1 - b2) g'^2``, ``w = w - lr_t m / (sqrt(v) + eps)`` with ``lr_t = lr
  sqrt(1 - b2^t) / (1 - b1^t)``; the step count ``t`` is a device tensor
  that every step increments, so the bias correction moves on inside a
  graph too.

The graph (``run_steps`` with the parameters on a CUDA device). One graph
per ``("multi", shapes, dtypes)`` of ``(data, label)``, the JAX package's
cache key, with static ``(K, batch, ...)`` data and label buffers, a
static ``(K,)`` loss buffer and a CUDA stream of its own:

- every call first copies ``data`` / ``label`` into the static buffers on
  the caller's stream, outside the graph;
- the first call for a signature runs its K steps eagerly on the graph's
  stream: they are real steps of the trajectory, and they warm autograd,
  cuDNN and the BN reductions' ticket counters up on the stream that then
  captures. The capture that follows executes nothing; later calls replay.
  So calls 1, 2, ... follow the trajectory of K * n ``step()`` calls;
- weights, optimizer state, ``t`` and BatchNorm's running statistics are
  read and written in place inside the graph, the bf16 recast of every
  master included. Anything that writes them in place (``step()``,
  ``Parameter.set_data``, ``convert``) keeps the graph valid; rebinding a
  parameter's tensor does not, and a replay raises if it finds one
  rebound;
- replays run on the graph's stream, after the caller's stream and before
  it continues, so two replays of one graph never overlap (the graph
  holds the ticket counters of its capture stream);
- a failed capture raises ``MXNetError`` with its cause; nothing falls
  back to the eager loop.

Each call returns a clone of the static losses. On the CPU ``run_steps``
is a loop over ``step``. Only ``mesh=None`` is ported.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from .. import autograd
from ..base import MXNetError, check
from ..ndarray.ndarray import NDArray

__all__ = ["SPMDTrainer"]


class _StepGraph:
    """A CUDA graph of K steps and the static buffers it reads and
    writes."""

    def __init__(self, data, label, device):
        self.data = torch.empty(data.shape, dtype=data.dtype, device=device)
        self.label = torch.empty(label.shape, dtype=label.dtype,
                                 device=device)
        self.losses = torch.empty((data.shape[0],), dtype=torch.float32,
                                  device=device)
        self.stream = torch.cuda.Stream(device)
        self.graph = None
        self.ptrs = None      # data pointers of the state it captured


class SPMDTrainer:
    def __init__(self, block, loss_fn, mesh=None, optimizer: str = "sgd",
                 optimizer_params=None, dtype=None):
        check(mesh is None, "SPMDTrainer: only mesh=None (one device) is "
              "ported")
        check(optimizer in ("sgd", "adam"),
              f"SPMDTrainer supports sgd/adam, not {optimizer!r}")
        opt = dict(optimizer_params or {})
        self.block = block
        self.loss_fn = loss_fn
        self.optimizer = optimizer
        self.lr = float(opt.get("learning_rate", 0.01))
        self.momentum = float(opt.get("momentum", 0.0))
        self.wd = float(opt.get("wd", 0.0))
        self.beta1 = float(opt.get("beta1", 0.9))
        self.beta2 = float(opt.get("beta2", 0.999))
        self.epsilon = float(opt.get("epsilon", 1e-8))
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        self._compute_dtype = dtype
        self._trainable = None   # [(name, Parameter, module path)]
        self._aux = None         # Parameters of the aux states
        self._state = None       # sgd: momenta or None; adam: (m, v)
        self._t = None           # adam: device step count (int32)
        self._graphs = {}        # signature -> _StepGraph

    def _collect(self):
        items = sorted(self.block.collect_params().items())
        missing = [n for n, p in items if not p.initialized]
        check(not missing, f"SPMDTrainer: parameters not initialized: "
              f"{missing[:3]}... (call initialize() or convert weights)")
        # module paths, as functional_call names the tensors; aux states
        # (grad_req 'null') are updated in place by their blocks
        paths = {id(m): path for path, m in self.block.named_modules()}
        self._trainable = []
        for name, p in items:
            if p.grad_req == "null":
                continue
            path = paths[id(p.block)]
            self._trainable.append(
                (name, p, f"{path}.{p.attr}" if path else p.attr))
        self._aux = [p for _, p in items if p.grad_req == "null"]
        weights = self._weights()
        if self.optimizer == "adam":
            self._state = ([torch.zeros_like(w) for w in weights],
                           [torch.zeros_like(w) for w in weights])
            self._t = torch.zeros((), dtype=torch.int32,
                                  device=weights[0].device)
        elif self.momentum != 0.0:
            self._state = [torch.zeros_like(w) for w in weights]

    def _weights(self):
        return [p.tensor for _, p, _ in self._trainable]

    @property
    def optimizer_state(self) -> dict:
        """Parameter name -> momentum buffer (sgd; empty without momentum)
        or ``(mean, var)`` (adam)."""
        if self._state is None:
            return {}
        names = [n for n, _, _ in self._trainable]
        if self.optimizer == "adam":
            return {n: (m, v) for n, m, v in zip(names, *self._state)}
        return dict(zip(names, self._state))

    # ------------------------------------------------------------------
    # one step
    # ------------------------------------------------------------------
    def _loss(self, data, label):
        dt = self._compute_dtype
        prev = autograd.set_training(True)
        try:
            if dt is None:
                out = self.block(data)
            else:
                params = {}
                for _, p, path in self._trainable:
                    w = p.tensor
                    params[path] = w.to(dt) if w.dtype == torch.float32 \
                        else w
                out = functional_call(self.block, params, (data.to(dt),))
        finally:
            autograd.set_training(prev)
        return self.loss_fn(out, label).float().mean()

    def _update(self, weights, grads):
        """The optimizer step, in place on the weights and the state."""
        if self.wd:
            grads = torch._foreach_add(grads, weights, alpha=self.wd)
        if self.optimizer == "adam":
            means, vars_ = self._state
            t = self._t
            t.add_(1)
            bc1 = 1.0 - torch.pow(self.beta1, t)
            bc2 = 1.0 - torch.pow(self.beta2, t)
            lr_t = self.lr * torch.sqrt(bc2) / bc1
            torch._foreach_mul_(means, self.beta1)
            torch._foreach_add_(means, grads, alpha=1.0 - self.beta1)
            sq = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(vars_, self.beta2)
            torch._foreach_add_(vars_, sq, alpha=1.0 - self.beta2)
            denom = torch._foreach_sqrt(vars_)
            torch._foreach_add_(denom, self.epsilon)
            step = torch._foreach_mul(means, lr_t)
            torch._foreach_div_(step, denom)
            torch._foreach_sub_(weights, step)
            return
        step = torch._foreach_mul(grads, self.lr)
        if self._state is None:
            torch._foreach_sub_(weights, step)
        else:
            torch._foreach_mul_(self._state, self.momentum)
            torch._foreach_sub_(self._state, step)
            torch._foreach_add_(weights, self._state)

    def _step(self, data, label):
        weights = self._weights()
        loss = self._loss(data, label)
        grads = list(torch.autograd.grad(loss, weights))
        with torch.no_grad():
            self._update(weights, grads)
        return loss.detach()

    def _inputs(self, data, label):
        if self._trainable is None:
            self._collect()
        return tuple(a._data if isinstance(a, NDArray)
                     else a if isinstance(a, torch.Tensor)
                     else torch.as_tensor(np.asarray(a))
                     for a in (data, label))

    def step(self, data, label):
        """One training step, eager; returns the (device) scalar f32 loss.
        ``data`` / ``label`` may be tensors, NDArrays or numpy arrays."""
        data, label = self._inputs(data, label)
        dev = self._trainable[0][1].tensor.device
        return self._step(data.to(dev, non_blocking=True),
                          label.to(dev, non_blocking=True))

    # ------------------------------------------------------------------
    # K steps
    # ------------------------------------------------------------------
    def run_steps(self, data, label):
        """``K = data.shape[0]`` steps over ``data`` / ``label`` of shape
        ``(K, batch, ...)``; returns the ``(K,)`` losses on the device. On
        a CUDA device, one replay of the signature's CUDA graph (see the
        module docstring)."""
        data, label = self._inputs(data, label)
        dev = self._trainable[0][1].tensor.device
        if dev.type != "cuda":
            return torch.stack([self._step(data[k].to(dev),
                                           label[k].to(dev))
                                for k in range(data.shape[0])])
        return self._graph_steps(data, label, dev)

    def _k_steps(self, g):
        for k in range(g.data.shape[0]):
            g.losses[k].copy_(self._step(g.data[k], g.label[k]))

    def _state_tensors(self):
        state = self._state or []
        if self.optimizer == "adam":
            state = [*state[0], *state[1], self._t]
        return [*self._weights(), *(p.tensor for p in self._aux), *state]

    def _graph_steps(self, data, label, dev):
        sig = ("multi", tuple((tuple(a.shape), a.dtype)
                              for a in (data, label)))
        g = self._graphs.get(sig)
        first = g is None
        if first:
            g = _StepGraph(data, label, dev)
        else:
            now = [t.data_ptr() for t in self._state_tensors()]
            check(now == g.ptrs, "SPMDTrainer.run_steps: a parameter's "
                  "tensor was rebound after the CUDA graph captured it; "
                  "write parameters in place (Parameter.set_data)")
        cur = torch.cuda.current_stream(dev)
        g.data.copy_(data, non_blocking=True)
        g.label.copy_(label, non_blocking=True)
        g.stream.wait_stream(cur)
        with torch.cuda.stream(g.stream):
            if first:
                self._k_steps(g)      # the warm-up: K real steps
                graph = torch.cuda.CUDAGraph()
                try:
                    with torch.cuda.graph(graph, stream=g.stream):
                        self._k_steps(g)
                except Exception as e:
                    raise MXNetError(
                        f"SPMDTrainer.run_steps: CUDA graph capture of "
                        f"{data.shape[0]} steps failed: {e}") from e
                g.graph = graph
                g.ptrs = [t.data_ptr() for t in self._state_tensors()]
                self._graphs[sig] = g
            else:
                g.graph.replay()
        cur.wait_stream(g.stream)
        return g.losses.clone()
