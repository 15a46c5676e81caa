"""SPMDTrainer on one device (ref: the JAX package's parallel/spmd.py).

The JAX trainer traces loss + gradients + optimizer update into one XLA
program per step (``run_steps`` scans K of them). Here the step runs
eagerly: forward, ``torch.autograd.grad``, then a multi-tensor SGD update
in place. The numerics follow the JAX step:

- mixed precision: with ``dtype`` set, every trainable f32 master (BatchNorm
  gamma and beta included) is cast to ``dtype`` for the forward and the
  data is cast too; the aux running statistics stay f32. Gradients come
  back through the casts to the f32 masters;
- the loss is the f32 mean of the per-sample losses;
- SGD: ``m = momentum * m - lr * (g + wd * w); w = w + m`` (without
  momentum ``w = w - lr * (g + wd * w)``).

``run_steps`` is a Python loop over the K leading microbatches; capturing
the step in a CUDA graph is later work. Only ``mesh=None`` and SGD are
ported.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import functional_call

from ..base import check

__all__ = ["SPMDTrainer"]


class SPMDTrainer:
    def __init__(self, block, loss_fn, mesh=None, optimizer: str = "sgd",
                 optimizer_params=None, dtype=None):
        check(mesh is None, "SPMDTrainer: only mesh=None (one device) is "
              "ported")
        check(optimizer == "sgd", "SPMDTrainer: only sgd is ported")
        opt = dict(optimizer_params or {})
        self.block = block
        self.loss_fn = loss_fn
        self.lr = float(opt.get("learning_rate", 0.01))
        self.momentum = float(opt.get("momentum", 0.0))
        self.wd = float(opt.get("wd", 0.0))
        if isinstance(dtype, str):
            dtype = getattr(torch, dtype)
        self._compute_dtype = dtype
        self._trainable = None   # [(name, Parameter, module path)]
        self._mom = None

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
        if self.momentum != 0.0:
            self._mom = [torch.zeros_like(p.data())
                         for _, p, _ in self._trainable]

    @property
    def optimizer_state(self) -> dict:
        """Parameter name -> momentum buffer (empty without momentum)."""
        if self._mom is None:
            return {}
        return {n: m for (n, _, _), m in zip(self._trainable, self._mom)}

    def _loss(self, data, label):
        dt = self._compute_dtype
        if dt is None:
            out = self.block(data)
        else:
            params = {}
            for _, p, path in self._trainable:
                w = p.data()
                params[path] = w.to(dt) if w.dtype == torch.float32 else w
            out = functional_call(self.block, params, (data.to(dt),))
        return self.loss_fn(out, label).float().mean()

    def _as_device(self, a):
        dev = self._trainable[0][1].data().device
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return a.to(dev, non_blocking=True)

    def step(self, data, label):
        """One training step; returns the (device) scalar f32 loss."""
        if self._trainable is None:
            self._collect()
        data, label = self._as_device(data), self._as_device(label)
        self.block.train()
        weights = [p.data() for _, p, _ in self._trainable]
        loss = self._loss(data, label)
        grads = list(torch.autograd.grad(loss, weights))
        with torch.no_grad():
            if self.wd:
                grads = torch._foreach_add(grads, weights, alpha=self.wd)
            step = torch._foreach_mul(grads, self.lr)
            if self._mom is None:
                torch._foreach_sub_(weights, step)
            else:
                torch._foreach_mul_(self._mom, self.momentum)
                torch._foreach_sub_(self._mom, step)
                torch._foreach_add_(weights, self._mom)
        return loss.detach()

    def run_steps(self, data, label):
        """``K = data.shape[0]`` steps over ``data`` / ``label`` of shape
        ``(K, batch, ...)``; returns the ``(K,)`` losses on the device."""
        return torch.stack([self.step(data[k], label[k])
                            for k in range(data.shape[0])])
