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

Deferred parameters (a layer built without its input width) are resolved
before anything else, as in the JAX package: one probe forward on the
first batch (``data[0]`` for ``run_steps``), in f32, on the parameters'
device, under ``autograd.pause()`` and ``torch.no_grad()``. The mode is
then inference, so BatchNorm's running statistics do not move. The
optimizer state is allocated after the probe, and any graph is captured
after it.

Rematerialisation (``remat``, ref: the JAX trainer's ``mirror_wrapper``).
``remat=None`` follows ``MXNET_BACKWARD_DO_MIRROR``; the decision and
``MXNET_BACKWARD_MIRROR_POLICY`` are resolved once, when the trainer first
builds its step (the first ``step`` / ``run_steps``), through
``util.mirror_wrapper``, which then wraps the whole forward + loss as the
JAX trainer wraps ``loss_of``. Backward recomputes the forward from the
data; the recompute leaves BatchNorm's running statistics as the forward
moved them and replays the forward's Dropout masks (``util``), in
``step()``, in the eager steps of a graph's first call and inside the
captured graph alike.

User blocks written with ``hybrid_forward`` or as a ``gluon.Block`` run
their ``mx.nd`` ops with recording on whenever the trainer's forward has
gradients enabled (``gluon/block.py``), so their parameters get gradients
here as under ``autograd.record()``.

Each call returns a clone of the static losses. On the CPU ``run_steps``
is a loop over ``step``.

Over a mesh (``mesh=``, ``parallel/mesh.py``; ``plan=``, a
``sharding.ShardingPlan``). ``step`` / ``run_steps`` take the **global**
batch (``run_steps``: ``(K, batch, ...)``) and each rank trains on its
``dp`` block (``sharding.shard_batch``, batch axis 0, or 1 for
``run_steps``), as the JAX trainer's ``shard_batch`` places it. A
parameter whose plan spec splits it over a mesh axis is held as this
rank's block (its optimizer state too) and gathered for the forward with
the differentiable ``collectives.allgather``, so its gradient comes back
as the sum over that axis; every gradient is then summed over the mesh
axes its spec does not split (all of them for a replicated parameter).
BatchNorm computes global-batch statistics over ``dp``, as GSPMD does for
the JAX trainer: the forward runs in ``ops.fused_bn_act.sync_scope``, so
the fused kernels' ``(2, C)`` sums (and the plain BatchNorm's) are
all-reduced over ``dp`` before they normalise. Each rank's loss is its
share of the global mean; the returned loss is the global mean.
``run_steps`` over a mesh of more than one rank runs its K steps eagerly,
one after another, and says so: ``run_steps_mode`` is ``"eager"`` and
``eager_mesh_steps`` counts the steps run that way (a gloo collective
cannot be captured in a CUDA graph, and NCCL at a world above 1 is
unverified). :meth:`SPMDTrainer.sync_block_params` writes the gathered
global values of the plan-sharded parameters back into the block's
parameters.

Telemetry. The first call of a signature (the K eager steps before the
capture; on the CPU the first loop) runs under a counting scope
(``telemetry.efficiency``): :meth:`SPMDTrainer.program_stats` reads the
K-step program's cost and footprint (and, ``step=True``, its first
step's, kept on the trainer), and the program registry holds the
program (kind ``spmd``). The
capture's seconds land in the registry's compile counters; with
``MXTPU_EFFICIENCY`` on every call is one dispatch note.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch
from torch.func import functional_call

from .. import autograd
from ..base import MXNetError, check
from ..cached_op import capture_graph, inline_scope, on_stream
from ..ndarray.ndarray import NDArray
from ..telemetry import efficiency as _efficiency
from ..telemetry import memory as _memory
from ..telemetry.registry import note_compile
from ..util import mirror_wrapper

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
                 optimizer_params=None, plan=None, dtype=None, remat=None):
        check(mesh is None or (hasattr(mesh, "axis_size") and
                               hasattr(mesh, "group")),
              f"SPMDTrainer: mesh must be a parallel.mesh.Mesh, got "
              f"{type(mesh).__name__}")
        check(plan is None or mesh is not None,
              "SPMDTrainer: plan= needs a mesh")
        self.mesh = mesh
        self.plan = plan
        self._blocks = {}        # name -> this rank's block (plan-sharded)
        self._specs = {}         # name -> spec
        #: "graph" (one CUDA graph of K steps on the card), "loop" (the
        #: CPU), or "eager" (a mesh over more than one rank)
        self.run_steps_mode = None
        #: steps run_steps ran eagerly over a mesh of several ranks
        self.eager_mesh_steps = 0
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
        self.remat = remat
        self._mirror = None      # util.mirror_wrapper, resolved at build
        self._trainable = None   # [(name, Parameter, module path)]
        self._aux = None         # Parameters of the aux states
        self._state = None       # sgd: momenta or None; adam: (m, v)
        self._t = None           # adam: device step count (int32)
        self._graphs = {}        # signature -> _StepGraph
        self._programs = {}      # signature -> (label, stats, 1st step's)
        self._last_program = None

    def _collect(self, sample):
        items = sorted(self.block.collect_params().items())
        missing = [n for n, p in items
                   if not p.initialized and p._deferred_init is None]
        check(not missing, f"SPMDTrainer: parameters not initialized: "
              f"{missing[:3]}... (call initialize() or convert weights)")
        if any(not p.initialized for _, p in items):
            self._probe(sample, items[0][1].device)
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
        if self.mesh is not None:
            self._place()
        weights = self._weights()
        if self.optimizer == "adam":
            self._state = ([torch.zeros_like(w) for w in weights],
                           [torch.zeros_like(w) for w in weights])
            self._t = torch.zeros((), dtype=torch.int32,
                                  device=weights[0].device)
        elif self.momentum != 0.0:
            self._state = [torch.zeros_like(w) for w in weights]

    def _probe(self, sample, device):
        """Resolve the deferred parameters with one inference forward (the
        JAX package's ``_collect`` probe)."""
        x = sample.to(device)
        if x.is_floating_point():
            x = x.float()
        with autograd.pause(), torch.no_grad():
            self.block(x)

    def _weights(self):
        """The masters the optimizer updates: a plan-sharded parameter's
        block, else the parameter's tensor."""
        return [self._blocks.get(n, p.tensor) for n, p, _ in self._trainable]

    # ------------------------------------------------------------------
    # mesh
    # ------------------------------------------------------------------
    def _place(self):
        """Specs of the trainable parameters and this rank's blocks of
        those the plan splits over an axis of size > 1."""
        from .sharding import P, _axes_of, local_block
        for name, p, _ in self._trainable:
            spec = self.plan.spec_for(name, tuple(p.tensor.shape)) \
                if self.plan is not None else P()
            self._specs[name] = spec
            if any(self.mesh.axis_size(a) > 1
                   for e in tuple(spec) for a in _axes_of(e)):
                self._blocks[name] = local_block(
                    p.tensor.detach(), spec, self.mesh).clone() \
                    .requires_grad_()

    def _full(self, name, w):
        """The global value of a master for the forward (differentiable)."""
        from .collectives import allgather
        from .sharding import _axes_of
        if name not in self._blocks:
            return w
        spec = tuple(self._specs[name])
        for dim in reversed(range(len(spec))):
            for ax in reversed(_axes_of(spec[dim])):
                if self.mesh.axis_size(ax) > 1:
                    w = allgather(w, self.mesh, ax, tiled_axis=dim)
        return w

    def _bn_scope(self):
        """Global-batch BatchNorm over dp (a no-op scope without one)."""
        import contextlib
        from ..ops.fused_bn_act import sync_scope
        from .collectives import _raw_allreduce
        if self.mesh is None or self.mesh.axis_size("dp") == 1:
            return contextlib.nullcontext()
        group = self.mesh.group("dp")
        return sync_scope(lambda t: _raw_allreduce(t, group),
                          self.mesh.axis_size("dp"))

    def sync_block_params(self) -> None:
        """Write the global values of the plan-sharded parameters into the
        block's parameters, in place (every rank of the mesh calls it)."""
        from .sharding import gather
        with torch.no_grad():
            for name, p, _ in self._trainable:
                if name in self._blocks:
                    p.tensor.copy_(gather(self._blocks[name],
                                          self._specs[name], self.mesh))

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
    def _loss(self, data, label, weights=None):
        dt = self._compute_dtype
        prev = autograd.set_training(True)
        try:
            if dt is None and not self._blocks:
                with self._bn_scope():
                    out = self.block(data)
            else:
                params = {}
                for (name, p, path), w in zip(self._trainable,
                                              weights or self._weights()):
                    w = self._full(name, w)
                    params[path] = w.to(dt) if dt is not None and \
                        w.dtype == torch.float32 else w
                with self._bn_scope():
                    out = functional_call(
                        self.block, params,
                        (data.to(dt) if dt is not None else data,))
        finally:
            autograd.set_training(prev)
        per = self.loss_fn(out, label).float()
        if self.mesh is None:
            return per.mean()
        # this rank's share of the global mean: its samples over the global
        # batch, over the ranks outside dp that compute the same samples
        return per.sum() / (per.shape[0] * self.mesh.size)

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
        # wrapped per call: a wrapped bound method kept on the trainer would
        # tie it into a reference cycle that holds its device memory. A
        # hybridized block runs inline: the step is the trainer's program
        with inline_scope():
            loss = self._mirror(self._loss)(data, label, weights)
        grads = list(torch.autograd.grad(loss, weights))
        if self.mesh is not None:
            from .sharding import reduce_unsplit
            grads = reduce_unsplit(
                grads, [self._specs[n] for n, _, _ in self._trainable],
                self.mesh)
        with torch.no_grad():
            self._update(weights, grads)
        if self.mesh is not None:
            from .collectives import cross_process_allreduce
            loss = cross_process_allreduce(loss.detach().clone())
        return loss.detach()

    def _inputs(self, data, label, steps):
        """``(data, label)`` as tensors; the first call also collects the
        parameters (resolving deferred ones on the first batch)."""
        data, label = (a._data if isinstance(a, NDArray)
                       else a if isinstance(a, torch.Tensor)
                       else torch.as_tensor(np.asarray(a))
                       for a in (data, label))
        if self._trainable is None:
            with inline_scope():
                self._collect(data[0] if steps else data)
            self._mirror = mirror_wrapper(self.remat)
        return data, label

    def step(self, data, label):
        """One training step, eager; returns the (device) scalar f32 loss.
        ``data`` / ``label`` may be tensors, NDArrays or numpy arrays."""
        data, label = self._inputs(data, label, steps=False)
        dev = self._trainable[0][1].tensor.device
        data, label = self._shard(data, label, 0)
        return self._step(data.to(dev, non_blocking=True),
                          label.to(dev, non_blocking=True))

    def _shard(self, data, label, batch_dim):
        """This rank's dp block of a global batch (as it is without a
        mesh)."""
        if self.mesh is None or self.mesh.axis_size("dp") == 1:
            return data, label
        from .sharding import P, local_block
        out = []
        for a in (data, label):
            spec = [None] * a.dim()
            spec[batch_dim] = "dp"
            out.append(local_block(a, P(*spec), self.mesh))
        return tuple(out)

    # ------------------------------------------------------------------
    # K steps
    # ------------------------------------------------------------------
    def run_steps(self, data, label):
        """``K = data.shape[0]`` steps over ``data`` / ``label`` of shape
        ``(K, batch, ...)``; returns the ``(K,)`` losses on the device. On
        a CUDA device, one replay of the signature's CUDA graph (see the
        module docstring)."""
        data, label = self._inputs(data, label, steps=True)
        dev = self._trainable[0][1].tensor.device
        data, label = self._shard(data, label, 1)
        sig = ("multi", tuple((tuple(a.shape), a.dtype)
                              for a in (data, label)))
        eager = self.mesh is not None and self.mesh.size > 1
        if eager:
            # a mesh of several ranks: K eager steps (module docstring)
            self.run_steps_mode = "eager"
            out = []
            for k in range(data.shape[0]):
                out.append(self._step(data[k].to(dev), label[k].to(dev)))
                self.eager_mesh_steps += 1
            losses = torch.stack(out)
            self._last_program = None
            return losses
        self.run_steps_mode = "graph" if dev.type == "cuda" else "loop"
        if dev.type != "cuda":
            def loop(count_first=False):
                out, first = [], None
                for k in range(data.shape[0]):
                    d, lb = data[k].to(dev), label[k].to(dev)
                    if count_first and k == 0:
                        with _efficiency.counting(dev) as c1:
                            out.append(self._step(d, lb))
                        first = (c1, (d, lb), out[-1:])
                    else:
                        out.append(self._step(d, lb))
                return torch.stack(out), first
            if sig in self._programs:
                losses = loop()[0]
            else:
                with _efficiency.counting(dev) as c, \
                        _efficiency.program_scope():
                    losses, first = loop(count_first=True)
                self._record(sig, (c, (data, label), (losses,)), first)
        else:
            losses = self._graph_steps(data, label, dev, sig)
        self._last_program = sig
        if _efficiency.notes_on():
            lbl = self._programs[sig][0]
            _efficiency.note_dispatch(
                ("spmd", id(self), sig), "spmd", lbl,
                lambda: _memory.get_program("spmd", lbl))
        return losses

    def _record(self, sig, program, first) -> None:
        """Keep a counted K-step run, ``program``, and its counted first
        step, ``first`` (each ``(counter, inputs, outputs)``), on the
        trainer, and record the K-step program in the program registry
        (kind ``spmd``). The first step is part of that program, so it is
        not a registry record of its own. The label holds everything that
        sets the program apart: the block's
        ``efficiency.block_signature``, the loss, the optimizer and its
        state, remat, and the data's shapes and dtypes."""
        key = (sig, _efficiency.block_signature(self.block),
               type(self.loss_fn).__name__, self.optimizer,
               self.momentum != 0.0, self.remat)
        lbl = f"{type(self.block).__name__}:" + \
            hashlib.md5(repr(key).encode()).hexdigest()[:12]
        state = self._state_tensors()
        stats = [c.stats([*state, *inputs], outputs)
                 for c, inputs, outputs in (program, first)]
        self._programs[sig] = (lbl, *stats)
        _memory.record_program("spmd", lbl, stats[0])

    def program_stats(self, step: bool = False) -> dict:
        """Counted cost of the most recent ``run_steps`` program (the
        K-step CUDA graph on a card), from its first call's observed run:
        ``{"flops", "bytes_accessed", "argument_bytes", "temp_bytes"}``
        (the JAX package's keys). ``step=True``: its first step alone."""
        if self._last_program is None:
            raise MXNetError(
                "program_stats: no fused step program dispatched yet — "
                "call run_steps() first")
        _lbl, program, first = self._programs[self._last_program]
        stats = first if step else program
        return {"flops": float(stats["flops"]),
                "bytes_accessed": float(stats["bytes_accessed"]),
                "argument_bytes": int(stats["argument_bytes"]),
                "temp_bytes": int(stats["temp_bytes"])}

    def _k_steps(self, g, count_first=False):
        """The K steps over the static buffers; with ``count_first`` the
        first runs in a counting scope of its own, which is returned."""
        c1 = None
        for k in range(g.data.shape[0]):
            if count_first and k == 0:
                with _efficiency.counting(g.data.device) as c1:
                    loss = self._step(g.data[k], g.label[k])
            else:
                loss = self._step(g.data[k], g.label[k])
            g.losses[k].copy_(loss)
        return c1

    def _state_tensors(self):
        state = self._state or []
        if self.optimizer == "adam":
            state = [*state[0], *state[1], self._t]
        return [*self._weights(), *(p.tensor for p in self._aux), *state]

    def _graph_steps(self, data, label, dev, sig):
        g = self._graphs.get(sig)
        first = g is None
        if first:
            g = _StepGraph(data, label, dev)
        else:
            now = [t.data_ptr() for t in self._state_tensors()]
            check(now == g.ptrs, "SPMDTrainer.run_steps: a parameter's "
                  "tensor was rebound after the CUDA graph captured it; "
                  "write parameters in place (Parameter.set_data)")
        g.data.copy_(data, non_blocking=True)
        g.label.copy_(label, non_blocking=True)
        with on_stream(g.stream):
            if first:
                # the warm-up: K real steps, counted
                with _efficiency.counting(dev) as c, \
                        _efficiency.program_scope():
                    c1 = self._k_steps(g, count_first=True)
                self._record(sig, (c, (g.data, g.label), (g.losses,)),
                             (c1, (g.data[0], g.label[0]), (g.losses[0],)))
                g.graph, _, secs = capture_graph(
                    lambda: self._k_steps(g), g.stream,
                    f"SPMDTrainer.run_steps' {data.shape[0]} steps")
                note_compile("graph_capture", secs, self._programs[sig][0])
                g.ptrs = [t.data_ptr() for t in self._state_tensors()]
                self._graphs[sig] = g
            else:
                g.graph.replay()
        return g.losses.clone()
