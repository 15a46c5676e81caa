"""Optimizers (ref: python/mxnet/optimizer/optimizer.py; the JAX package's
``optimizer/optimizer.py``).

The registry, ``lr_mult`` / ``wd_mult`` resolution, ``multi_precision``
and the 15 optimizers of the JAX package, with the same update math.
SGD, NAG, Adam and RMSProp run the multi-tensor rules of
``ops/optimizer_ops.py`` on one tensor, the same code the ``mx.nd`` ops
and the grouped update run; the others are written out op by op in the
JAX package's order. Where the JAX package rebinds a weight or a state
to a new array, the port writes the new values into the tensor in place
(``commit``): the block's parameter and every state tensor keep their
storage, so ``Parameter.data()`` and anything that holds the tensor stay
valid. Updates run under ``torch.no_grad()``.

Row-sparse gradients (ref: optimizer_op.cc SGDUpdateRspImpl /
AdamUpdateRspImpl): SGD and Adam with ``lazy_update=True`` (the default)
update only the gradient's rows of the weight and of their state: the
dense update's rule on the gathered rows, written back with
``index_copy_`` (``_run_rule``, ``ops/sparse_ops.step_rows``);
``lazy_update=False`` densifies the gradient first, as in the JAX
package. The other optimizers take the densified gradient, with the
storage-fallback warning. SGLD draws its noise from a
``torch.Generator`` (``generator=``, else the weight's device's default
generator): the two packages' random streams differ.
"""
from __future__ import annotations

import math
import pickle
from typing import Any, Dict

import torch

from ..base import MXNetError
from ..context import Context
from ..ndarray import ndarray as _nd
from ..ops import optimizer_ops as _ops
from ..ops import registry as _reg
from ..ops import sparse_ops as _sparse
from .. import random as _random
from ..telemetry import memory as _memory

__all__ = ["Optimizer", "SGD", "Adam", "NAG", "RMSProp", "AdaGrad",
           "AdaDelta", "Ftrl", "FTML", "Signum", "SignSGD", "LBSGD",
           "DCASGD", "SGLD", "Nadam", "Test", "create", "register",
           "Updater", "get_updater"]


def _dense(grad, who: str):
    """``grad`` as a dense array: a row-sparse one densified, with the
    storage-fallback warning (an optimizer without a lazy update)."""
    if getattr(grad, "stype", "default") == "default":
        return grad
    _reg.storage_fallback_warn(f"{who}.update", (grad.stype,))
    return grad.todense()


def _lazy(grad, lazy_update: bool):
    """``grad`` for SGD / Adam: a row-sparse one as it is when the update
    is lazy (``_run_rule`` steps its rows), densified otherwise."""
    if getattr(grad, "stype", "default") != "row_sparse" or lazy_update:
        return grad
    return grad.todense()


class Optimizer:
    """Base optimizer with the reference's registry / lr-mult machinery."""

    opt_registry: Dict[str, type] = {}

    @staticmethod
    def register(klass):
        name = klass.__name__.lower()
        Optimizer.opt_registry[name] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() not in Optimizer.opt_registry:
            raise MXNetError(f"unknown optimizer {name!r}")
        return Optimizer.opt_registry[name.lower()](**kwargs)

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult: Dict[Any, float] = {}
        self.wd_mult: Dict[Any, float] = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count: Dict[int, int] = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
        self.idx2name = param_idx2name.copy() if param_idx2name else {}
        self.param_dict = param_dict if param_dict else {}

    # -- state ----------------------------------------------------------
    def create_state(self, index, weight):
        return None

    def _mp_active(self, weight) -> bool:
        return bool(self.multi_precision) and \
            weight._data.dtype != torch.float32

    def create_state_multi_precision(self, index, weight):
        if self._mp_active(weight):
            w32 = weight.astype("float32")
            return (self.create_state(index, w32), w32)
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def update_multi_precision(self, index, weight, grad, state):
        if self._mp_active(weight):
            inner_state, w32 = state
            self.update(index, w32, grad.astype("float32"), inner_state)
            with torch.no_grad():
                weight._data.copy_(w32._data.to(weight._data.dtype))
        else:
            self.update(index, weight, grad, state)

    # -- hyper-param resolution ----------------------------------------
    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("cannot set lr directly when lr_scheduler is set")
        self.lr = lr

    @property
    def learning_rate(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler(self.num_update)
        return self.lr

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = args_lr_mult.copy()

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = args_wd_mult.copy()

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index], self.num_update)

    def _get_lr(self, index):
        lr = self.lr_scheduler(self.num_update) if self.lr_scheduler else self.lr
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def __getstate__(self):
        d = self.__dict__.copy()
        d.pop("param_dict", None)
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.param_dict = {}


register = Optimizer.register
create = Optimizer.create_optimizer


def _clip(cg):
    return -1.0 if cg is None else cg


def _zeros(weight, dtype=None):
    return _nd.zeros(weight.shape, ctx=weight.context,
                     dtype=weight._data.dtype if dtype is None else dtype)


def _run_rule(rule, weight, grad, states, lr, wd, rescale, **statics):
    """One tensor through a multi-tensor rule, written in place. A
    row-sparse ``grad`` steps only its rows of the weight and the states
    (the lazy update, ``sparse_ops.step_rows``)."""
    with torch.no_grad():
        if getattr(grad, "stype", "default") == "row_sparse":
            tables = [weight._data] + [s._data for s in states]
            rows = grad._indices
            _, new = _sparse.step_rows(rule, tables, rows, grad._data, lr,
                                       wd, rescale, **statics)
            for t, n in zip(tables, new):
                t.index_copy_(0, rows, n.to(t.dtype))
            return
        nw, ns = rule([weight._data], [grad._data],
                      [[s._data] for s in states], [lr], [wd], rescale,
                      **statics)
        _ops.commit([weight._data] + [s._data for s in states],
                    list(nw) + [s[0] for s in ns])


def _set(dst, value) -> None:
    with torch.no_grad():
        dst._data.copy_(value)


@register
class SGD(Optimizer):
    """SGD w/ momentum + multi-precision (ref: optimizer.py:511)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        clip = _clip(self.clip_gradient)
        grad = _lazy(grad, self.lazy_update)
        if state is None:
            _run_rule(_ops.sgd, weight, grad, (), lr, wd, self.rescale_grad,
                      clip=clip)
        else:
            _run_rule(_ops.sgd_mom, weight, grad, (state,), lr, wd,
                      self.rescale_grad, momentum=self.momentum, clip=clip)


@register
class SGLD(Optimizer):
    """Stochastic Gradient Langevin Dynamics (ref: optimizer.py SGLD):
    ``w - lr / 2 * (g + wd * w) + N(0, lr)``. The noise comes from
    ``generator`` (a ``torch.Generator`` on the weight's device), else from
    the device's default generator."""

    def __init__(self, generator=None, **kwargs):
        super().__init__(**kwargs)
        self.generator = generator

    def __getstate__(self):
        d = super().__getstate__()
        d["generator"] = None       # a generator does not pickle
        return d

    def update(self, index, weight, grad, state):
        grad = _dense(grad, type(self).__name__)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        with torch.no_grad():
            g = grad._data * self.rescale_grad
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            gen = self.generator if self.generator is not None \
                else _random.default_generator(w.device)
            noise = torch.randn(w.shape, generator=gen, device=w.device,
                                dtype=w.dtype) * math.sqrt(lr)
            _set(weight, w - lr / 2 * (g + wd * w) + noise)


@register
class Signum(Optimizer):
    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        grad = _dense(grad, type(self).__name__)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  clip_gradient=_clip(self.clip_gradient))
        with torch.no_grad():
            if state is None:
                _set(weight, _ops._signsgd_update(weight._data, grad._data,
                                                  **kw))
            else:
                nw, nm = _ops._signum_update(
                    weight._data, grad._data, state._data,
                    momentum=self.momentum, wd_lh=self.wd_lh, **kw)
                _set(weight, nw)
                _set(state, nm)


@register
class SignSGD(Signum):
    def __init__(self, **kwargs):
        kwargs.setdefault("momentum", 0.0)
        super().__init__(**kwargs)


@register
class NAG(Optimizer):
    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros(weight)

    def update(self, index, weight, grad, state):
        grad = _dense(grad, type(self).__name__)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        clip = _clip(self.clip_gradient)
        if state is None:
            _run_rule(_ops.sgd, weight, grad, (), lr, wd, self.rescale_grad,
                      clip=clip)
        else:
            _run_rule(_ops.nag_mom, weight, grad, (state,), lr, wd,
                      self.rescale_grad, momentum=self.momentum, clip=clip)


def adam_lr(lr, beta1, beta2, t):
    """Adam's bias-corrected rate, a host float64 as in the JAX package:
    ``lr * sqrt(1 - beta2^t) / (1 - beta1^t)``."""
    return lr * math.sqrt(1 - beta2 ** t) / (1 - beta1 ** t)


@register
class Adam(Optimizer):
    """(ref: optimizer.py:1120)"""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros(weight), _zeros(weight))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr_t = adam_lr(lr, self.beta1, self.beta2, t)
        grad = _lazy(grad, self.lazy_update)
        _run_rule(_ops.adam, weight, grad, state, lr_t, wd,
                  self.rescale_grad, beta1=self.beta1, beta2=self.beta2,
                  epsilon=self.epsilon, clip=_clip(self.clip_gradient))


@register
class Nadam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def update(self, index, weight, grad, state):
        grad = _dense(grad, type(self).__name__)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        w = weight._data
        with torch.no_grad():
            g = grad._data * self.rescale_grad + wd * w
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            m_t = self.beta1 * (1 - 0.5 * 0.96 ** (t * self.schedule_decay))
            m_t1 = self.beta1 * (1 - 0.5 * 0.96 **
                                 ((t + 1) * self.schedule_decay))
            self.m_schedule *= m_t
            sched_next = self.m_schedule * m_t1
            mean, var = state
            _set(mean, self.beta1 * mean._data + (1 - self.beta1) * g)
            _set(var, self.beta2 * var._data + (1 - self.beta2) * g * g)
            g_prime = _ops.div(g, 1 - self.m_schedule)
            m_prime = _ops.div(mean._data, 1 - sched_next)
            v_prime = _ops.div(var._data, 1 - self.beta2 ** t)
            m_bar = (1 - m_t) * g_prime + m_t1 * m_prime
            _set(weight, w - lr * m_bar / (_ops.sqrt(v_prime)
                                           + self.epsilon))


@register
class AdaGrad(Optimizer):
    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros(weight, torch.float32)

    def update(self, index, weight, grad, state):
        grad = _dense(grad, type(self).__name__)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        with torch.no_grad():
            g = grad._data * self.rescale_grad
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            g = g + wd * w
            _set(state, state._data + g * g)
            _set(weight, w - lr * g / (_ops.sqrt(state._data)
                                       + self.float_stable_eps))


@register
class AdaDelta(Optimizer):
    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def update(self, index, weight, grad, state):
        grad = _dense(grad, type(self).__name__)
        self._update_count(index)
        wd = self._get_wd(index)
        w = weight._data
        with torch.no_grad():
            g = grad._data * self.rescale_grad
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            acc_g, acc_delta = state
            _set(acc_g, self.rho * acc_g._data + (1 - self.rho) * g * g)
            delta = _ops.sqrt(acc_delta._data + self.epsilon) / \
                _ops.sqrt(acc_g._data + self.epsilon) * g
            _set(acc_delta, self.rho * acc_delta._data
                 + (1 - self.rho) * delta * delta)
            _set(weight, w - delta - wd * w)


@register
class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1, self.gamma2 = gamma1, gamma2
        self.epsilon = epsilon
        self.centered = centered
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros(weight, torch.float32),
                    _zeros(weight, torch.float32),
                    _zeros(weight, torch.float32))
        return _zeros(weight, torch.float32)

    def update(self, index, weight, grad, state):
        grad = _dense(grad, type(self).__name__)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        kw = dict(gamma1=self.gamma1, epsilon=self.epsilon,
                  clip=_clip(self.clip_gradient),
                  clip_weights=_clip(self.clip_weights))
        if not self.centered:
            _run_rule(_ops.rmsprop, weight, grad, (state,), lr, wd,
                      self.rescale_grad, **kw)
        else:
            _run_rule(_ops.rmspropalex, weight, grad, state, lr, wd,
                      self.rescale_grad, gamma2=self.gamma2, **kw)


@register
class Ftrl(Optimizer):
    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.lamda1 = lamda1
        self.beta = beta

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32))

    def update(self, index, weight, grad, state):
        grad = _dense(grad, type(self).__name__)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        z, n = state
        with torch.no_grad():
            nw, nz, nn_ = _ops._ftrl_update(
                weight._data, grad._data, z._data, n._data, lr=lr,
                lamda1=self.lamda1, beta=self.beta, wd=wd,
                rescale_grad=self.rescale_grad,
                clip_gradient=_clip(self.clip_gradient))
            _ops.commit([weight._data, z._data, n._data], [nw, nz, nn_])


@register
class FTML(Optimizer):
    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def create_state(self, index, weight):
        return (_zeros(weight, torch.float32), _zeros(weight, torch.float32),
                _zeros(weight, torch.float32))

    def update(self, index, weight, grad, state):
        grad = _dense(grad, type(self).__name__)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        d, v, z = state
        w = weight._data
        with torch.no_grad():
            nw, nd_, nv = _ops._ftml_update(
                w, grad._data, d._data, v._data, z._data, lr=lr,
                beta1=self.beta1, beta2=self.beta2, epsilon=self.epsilon,
                t=t, wd=wd, rescale_grad=self.rescale_grad,
                clip_grad=_clip(self.clip_gradient))
            # the op returns weight, d and v; z follows from them, as in
            # the JAX package
            g = grad._data * self.rescale_grad + wd * w
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            sigma = nd_ - self.beta1 * d._data
            _set(z, self.beta1 * z._data + (1 - self.beta1) * g - sigma * w)
            _ops.commit([w, d._data, v._data], [nw, nd_, nv])


@register
class DCASGD(Optimizer):
    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous: Dict[Any, Any] = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        mom = None if self.momentum == 0.0 else \
            _zeros(weight, torch.float32)
        return (mom, weight.copy())

    def update(self, index, weight, grad, state):
        grad = _dense(grad, type(self).__name__)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        w = weight._data
        with torch.no_grad():
            g = grad._data * self.rescale_grad
            if self.clip_gradient is not None:
                g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
            mom, prev = state
            comp = g + self.lamda * g * g * (w - prev._data)
            step = -lr * (comp + wd * w)
            if mom is not None:
                _set(mom, self.momentum * mom._data + step)
                step = mom._data
            new_w = w + step
            _set(prev, w)
            _set(weight, new_w)


@register
class LBSGD(SGD):
    """Large-batch SGD (ref: optimizer.py LBSGD): the JAX package's takes
    the warm-up arguments and updates as SGD does."""

    def __init__(self, warmup_strategy="linear", warmup_epochs=5,
                 batch_scale=1, updates_per_epoch=32, begin_epoch=0,
                 num_epochs=60, **kwargs):
        super().__init__(**kwargs)


@register
class Test(Optimizer):
    def create_state(self, index, weight):
        return _zeros(weight, torch.float32)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            _set(weight, weight._data + grad._data * self.rescale_grad)
            _set(state, weight._data)


ccSGD = SGD  # deprecated alias (ref keeps it)


def _states_context(updater):
    """Where restored states go: the device of the optimizer's first
    parameter, else of a state already held, else the current context."""
    for p in getattr(updater.optimizer, "param_dict", {}).values():
        t = getattr(p, "tensor", None)
        if t is not None:
            return Context(t.device)
    for s in updater.states.values():
        for a in (s if isinstance(s, (tuple, list)) else (s,)):
            if isinstance(a, (tuple, list)):
                a = next((x for x in a if x is not None), None)
            if isinstance(a, _nd.NDArray):
                return Context(a._data.device)
    return None


class Updater:
    """KVStore updater closure (ref: optimizer.py get_updater)."""

    def __init__(self, optimizer: Optimizer):
        self.optimizer = optimizer
        self.states: Dict[Any, Any] = {}
        self.states_synced: Dict[Any, bool] = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = \
                self.optimizer.create_state_multi_precision(index, weight)
            _memory.track_optimizer_state(self, index, self.states[index],
                                          weight=weight)
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    #: reserved keys carrying the optimizer's host-side step counters in
    #: the state dict's pickle, so Adam's bias-correction ``t`` (and any
    #: lr scheduler) resumes exactly; string keys cannot collide with
    #: integer state indices
    COUNTS_KEY = "__index_update_counts__"
    NUM_UPDATE_KEY = "__num_update__"

    def states_payload(self, indices=None) -> dict:
        """What :meth:`get_states` pickles: the state dict (its arrays
        themselves, not copies) and copies of the step counters;
        ``indices`` restricts it to those slots."""
        states = self.states if indices is None else \
            {i: s for i, s in self.states.items() if i in indices}
        counts = self.optimizer._index_update_count
        if indices is not None:
            counts = {i: c for i, c in counts.items() if i in indices}
        payload = dict(states)
        payload[self.COUNTS_KEY] = dict(counts)
        payload[self.NUM_UPDATE_KEY] = int(self.optimizer.num_update)
        return payload

    def get_states(self, dump_optimizer=False, indices=None):
        """The pickled state dict (NDArrays travel as numpy arrays), with
        the step counters; ``indices`` restricts it to those slots."""
        payload = self.states_payload(indices)
        return pickle.dumps((payload, self.optimizer)
                            if dump_optimizer else payload)

    def set_states(self, states, keep=None):
        """Replace the state dict (and the counters) with a pickled one.
        Its arrays are restored on the device of the optimizer's
        parameters (see :func:`_states_context`)."""
        ctx = _states_context(self)
        if ctx is not None:
            with ctx:
                states = pickle.loads(states)
        else:
            states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2 and \
                isinstance(states[1], Optimizer):
            param_dict = self.optimizer.param_dict
            self.states, self.optimizer = states
            self.optimizer.param_dict = param_dict
        else:
            self.states = states
        self.states = dict(self.states)
        counts = self.states.pop(self.COUNTS_KEY, None)
        num_update = self.states.pop(self.NUM_UPDATE_KEY, None)
        if counts is not None:
            self.optimizer._index_update_count = dict(counts)
            self.optimizer.num_update = max(
                int(num_update or 0), self.optimizer.begin_num_update)
        if keep is not None:
            self.states = {i: s for i, s in self.states.items()
                           if i in keep}
        # the restored dict replaces the old one wholesale: drop the old
        # entries, then ledger every restored state
        _memory.drop_updater_states(self)
        for index, state in self.states.items():
            _memory.track_optimizer_state(self, index, state)


def get_updater(optimizer: Optimizer) -> Updater:
    return Updater(optimizer)
