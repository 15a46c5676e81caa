"""Optimizer-update ops (ref: the JAX package's ``ops/optimizer_ops.py``;
src/operator/optimizer_op.cc in the reference: ``sgd_update`` :318,
``sgd_mom_update`` :351, ``adam_update`` :506, ``multi_sgd_update`` :654).

The update math of the grouped optimizers (sgd, sgd with momentum, nag,
adam, rmsprop and its centered form) is written once, over lists of
tensors, with PyTorch's multi-tensor ``torch._foreach_*`` ops: a *rule*
``rule(ws, gs, states, lrs, wds, rescale, **statics)`` takes the
weights, gradients, the state tensors slot by slot (``states[k][i]`` is
slot k of weight i) and per-weight learning rates and weight decays, and
returns the new weights and the new state slots as new tensors. The
registered one-tensor op (``sgd_mom_update``) is the rule on lists of one,
the ``multi_*`` op the rule on the whole group, and the optimizers
(``optimizer/optimizer.py``) and the grouped update
(``optimizer/grouped.py``) run the same rule and write its results into
the weight and state tensors in place (:func:`commit`). So an update
aggregated over a bucket and the same update one parameter at a time are
the same operations element by element, bit for bit.

Rounding follows the JAX ops op by op: each expression of the JAX
function is one PyTorch op here, in the same order (no fused
multiply-adds such as ``add(a, b, alpha=)``), and every Python scalar is
first rounded to float32 and then to the tensors' dtype, as JAX rounds a
weak-typed scalar (:func:`scalar`). With bfloat16 tensors each op then
rounds in bfloat16, as XLA does when it may not keep excess precision.

The registered ops keep the JAX package's names, aliases, ``num_outputs``
and ``variadic``. As in the JAX package they return new tensors; ``mx.nd``
writes them into ``out=`` arrays when asked. ``_sparse_adagrad_update``
needs row-sparse gradients and raises ``NotPortedError`` (ROADMAP A11).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .registry import NotPortedError, register

__all__ = ["scalar", "sqrt", "div", "commit", "prep_grad", "sgd", "sgd_mom", "nag_mom",
           "adam", "rmsprop", "rmspropalex", "mp"]


# ---------------------------------------------------------------------------
# scalars and the in-place write
# ---------------------------------------------------------------------------

def _bf16(x: np.float32) -> float:
    """Round a float32 to bfloat16 (nearest, ties to even)."""
    if not np.isfinite(x):
        return float(x)
    b = int(np.array(x, np.float32).view(np.uint32))
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return float(np.array(b, np.uint32).view(np.float32))


@functools.lru_cache(maxsize=4096)
def _round(v: float, dtype: torch.dtype) -> float:
    x = np.float32(v)
    if dtype == torch.bfloat16:
        return _bf16(x)
    if dtype == torch.float16:
        return float(np.float16(x))
    return float(x)


def scalar(v, dtype: torch.dtype) -> float:
    """``v`` rounded to float32, then to ``dtype``: the value a JAX
    weak-typed scalar takes in an op on ``dtype`` arrays."""
    return _round(float(v), dtype)


def _scalars(vs, dtype):
    return [_round(float(v), dtype) for v in vs]


def sqrt(x):
    """The correctly rounded square root, the same on every device:
    ``torch.sqrt`` in f32 is one rounding off it in a fraction of elements
    (0.7 % of uniform inputs on the CPU, fewer and others on an H100),
    which Ftrl's cancelling z turns into differences of 4e-6 at values of
    1e-2 between the card and the host. The root of the float64 value,
    rounded to float32 and then to x's dtype, is correctly rounded
    (float64 has more than twice float32's bits); float64 keeps its own
    root. The multi-tensor rules keep ``torch._foreach_sqrt``: nothing
    after their roots cancels."""
    r = torch.sqrt(x.double())
    return r if x.dtype == torch.float64 else r.float().to(x.dtype)


def div(x, s):
    """``x / s`` for a Python scalar ``s`` as a true division on every
    device: CUDA would multiply by the reciprocal of a host scalar, one
    rounding off the JAX package's (and the CPU's) quotient."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def commit(dsts, news, ok=None) -> None:
    """Write ``news`` into ``dsts`` in place. With ``ok`` (a 0-d bool
    tensor on the device) each tensor takes ``where(ok, new, old)``, with
    no host sync: a non-finite step leaves every tensor as it was."""
    if ok is None:
        torch._foreach_copy_(list(dsts), list(news))
        return
    for d, n in zip(dsts, news):
        d.copy_(torch.where(ok, n, d))


# ---------------------------------------------------------------------------
# the multi-tensor rules
# ---------------------------------------------------------------------------

def _clip(gs, clip, dt):
    if clip is not None and clip > 0:
        c = scalar(clip, dt)
        torch._foreach_clamp_min_(gs, -c)
        torch._foreach_clamp_max_(gs, c)
    return gs


def prep_grad(ws, gs, wds, rescale, clip):
    """``g * rescale``, clipped to [-clip, clip] when clip > 0, ``+ wd *
    w`` (the JAX package's ``_prep_grad`` order)."""
    dt = ws[0].dtype
    g = _clip(torch._foreach_mul(gs, scalar(rescale, dt)), clip, dt)
    return torch._foreach_add(g, torch._foreach_mul(ws, _scalars(wds, dt)))


def sgd(ws, gs, states, lrs, wds, rescale, clip=-1.0):
    """w - lr * g"""
    g = prep_grad(ws, gs, wds, rescale, clip)
    lr = _scalars(lrs, ws[0].dtype)
    return torch._foreach_sub(ws, torch._foreach_mul(g, lr)), []


def sgd_mom(ws, gs, states, lrs, wds, rescale, momentum=0.0, clip=-1.0):
    """m = momentum * m - lr * g; w + m"""
    dt = ws[0].dtype
    (ms,) = states
    g = prep_grad(ws, gs, wds, rescale, clip)
    nm = torch._foreach_sub(torch._foreach_mul(ms, scalar(momentum, dt)),
                            torch._foreach_mul(g, _scalars(lrs, dt)))
    return torch._foreach_add(ws, nm), [nm]


def nag_mom(ws, gs, states, lrs, wds, rescale, momentum=0.0, clip=-1.0):
    """m = momentum * m + g; w - lr * (g + momentum * m)"""
    dt = ws[0].dtype
    (ms,) = states
    mu = scalar(momentum, dt)
    g = prep_grad(ws, gs, wds, rescale, clip)
    nm = torch._foreach_add(torch._foreach_mul(ms, mu), g)
    step = torch._foreach_add(g, torch._foreach_mul(nm, mu))
    return (torch._foreach_sub(ws, torch._foreach_mul(
        step, _scalars(lrs, dt))), [nm])


def adam(ws, gs, states, lrs, wds, rescale, beta1=0.9, beta2=0.999,
         epsilon=1e-8, clip=-1.0):
    """m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
    w - lr * m / (sqrt(v) + eps), with ``lr`` already bias-corrected."""
    dt = ws[0].dtype
    means, vars_ = states
    g = prep_grad(ws, gs, wds, rescale, clip)
    m = torch._foreach_add(torch._foreach_mul(means, scalar(beta1, dt)),
                           torch._foreach_mul(g, scalar(1 - beta1, dt)))
    v = torch._foreach_add(
        torch._foreach_mul(vars_, scalar(beta2, dt)),
        torch._foreach_mul(torch._foreach_mul(g, g), scalar(1 - beta2, dt)))
    den = torch._foreach_add(torch._foreach_sqrt(v), scalar(epsilon, dt))
    step = torch._foreach_div(torch._foreach_mul(m, _scalars(lrs, dt)), den)
    return torch._foreach_sub(ws, step), [m, v]


def rmsprop(ws, gs, states, lrs, wds, rescale, gamma1=0.95, epsilon=1e-8,
            clip=-1.0, clip_weights=-1.0):
    """n = g1 n + (1 - g1) g^2; w - lr * g / sqrt(n + eps), clipped to
    [-clip_weights, clip_weights] when that is > 0."""
    dt = ws[0].dtype
    (ns,) = states
    g = prep_grad(ws, gs, wds, rescale, clip)
    nn_ = torch._foreach_add(
        torch._foreach_mul(ns, scalar(gamma1, dt)),
        torch._foreach_mul(torch._foreach_mul(g, g), scalar(1 - gamma1, dt)))
    den = torch._foreach_sqrt(torch._foreach_add(nn_, scalar(epsilon, dt)))
    nw = torch._foreach_sub(ws, torch._foreach_div(
        torch._foreach_mul(g, _scalars(lrs, dt)), den))
    return _clip(nw, clip_weights, dt), [nn_]


def rmspropalex(ws, gs, states, lrs, wds, rescale, gamma1=0.95, gamma2=0.9,
                epsilon=1e-8, clip=-1.0, clip_weights=-1.0):
    """Centered RMSProp (Graves): n, g_avg and delta; ``clip_weights`` is
    taken and unused, as in the JAX op."""
    dt = ws[0].dtype
    ns, gavgs, deltas = states
    g = prep_grad(ws, gs, wds, rescale, clip)
    g1, one_g1 = scalar(gamma1, dt), scalar(1 - gamma1, dt)
    nn_ = torch._foreach_add(torch._foreach_mul(ns, g1), torch._foreach_mul(
        torch._foreach_mul(g, g), one_g1))
    ng = torch._foreach_add(torch._foreach_mul(gavgs, g1),
                            torch._foreach_mul(g, one_g1))
    den = torch._foreach_sqrt(torch._foreach_add(
        torch._foreach_sub(nn_, torch._foreach_mul(ng, ng)),
        scalar(epsilon, dt)))
    nd_ = torch._foreach_sub(
        torch._foreach_mul(deltas, scalar(gamma2, dt)),
        torch._foreach_div(torch._foreach_mul(g, _scalars(lrs, dt)), den))
    return torch._foreach_add(ws, nd_), [nn_, ng, nd_]


def mp(rule):
    """Multi-precision form of ``rule`` (the JAX package's ``_wrap_mp`` and
    ``Optimizer.update_multi_precision``): the last state slot holds the
    f32 master weights; the gradient is cast to f32, the rule steps the
    masters, and the weights become the new masters cast to their
    dtype."""
    def k(ws, gs, states, lrs, wds, rescale, **statics):
        w32s = states[-1]
        g32 = [g.to(w.dtype) for g, w in zip(gs, w32s)]
        nw32, ns = rule(w32s, g32, states[:-1], lrs, wds, rescale, **statics)
        return [a.to(w.dtype) for a, w in zip(nw32, ws)], ns + [nw32]
    return k


# ---------------------------------------------------------------------------
# the registered ops
# ---------------------------------------------------------------------------

def _one(rule, w, g, states, lr, wd, rescale, **statics):
    nw, ns = rule([w], [g], [[s] for s in states], [lr], [wd], rescale,
                  **statics)
    return (nw[0],) + tuple(s[0] for s in ns)


@register("sgd_update")
def _sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                clip_gradient=-1.0, lazy_update=True):
    return _one(sgd, weight, grad, (), lr, wd, rescale_grad,
                clip=clip_gradient)[0]


@register("sgd_mom_update", num_outputs=2)
def _sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0, lazy_update=True):
    return _one(sgd_mom, weight, grad, (mom,), lr, wd, rescale_grad,
                momentum=momentum, clip=clip_gradient)


@register("mp_sgd_update", num_outputs=2)
def _mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0, lazy_update=True):
    return _one(mp(sgd), weight, grad, (weight32,), lr, wd, rescale_grad,
                clip=clip_gradient)


@register("mp_sgd_mom_update", num_outputs=3)
def _mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                       lazy_update=True):
    return _one(mp(sgd_mom), weight, grad, (mom, weight32), lr, wd,
                rescale_grad, momentum=momentum, clip=clip_gradient)


@register("nag_mom_update", num_outputs=2)
def _nag_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    return _one(nag_mom, weight, grad, (mom,), lr, wd, rescale_grad,
                momentum=momentum, clip=clip_gradient)


@register("adam_update", num_outputs=3)
def _adam_update(weight, grad, mean, var, lr=0.01, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                 lazy_update=True):
    return _one(adam, weight, grad, (mean, var), lr, wd, rescale_grad,
                beta1=beta1, beta2=beta2, epsilon=epsilon,
                clip=clip_gradient)


def _raw_grad(grad, rescale, clip):
    """``grad * rescale``, clipped when clip > 0 (no weight decay)."""
    dt = grad.dtype
    g = grad * scalar(rescale, dt)
    if clip is not None and clip > 0:
        c = scalar(clip, dt)
        g = torch.clamp(g, -c, c)
    return g


def _f32(*vs):
    """The product of ``vs`` in float32 arithmetic, as JAX computes one of
    traced (dynamic) scalars."""
    out = np.float32(vs[0])
    for v in vs[1:]:
        out = out * np.float32(v)
    return float(out)


@register("signsgd_update")
def _signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    dt = weight.dtype
    g = _raw_grad(grad, rescale_grad, clip_gradient)
    return weight - scalar(lr, dt) * (torch.sign(g) + scalar(wd, dt) * weight)


@register("signum_update", num_outputs=2)
def _signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    dt = weight.dtype
    g = _raw_grad(grad, rescale_grad, clip_gradient)
    new_mom = scalar(momentum, dt) * mom - scalar(1 - momentum, dt) * g
    step = scalar(lr, dt) * torch.sign(new_mom)
    if wd_lh > 0:
        w = scalar(float(np.float32(1) - np.float32(_f32(lr, wd_lh))),
                   dt) * weight + step
    else:
        w = weight + step
    return w - scalar(_f32(lr, wd), dt) * weight, new_mom


@register("rmsprop_update", num_outputs=2)
def _rmsprop_update(weight, grad, n, lr=0.01, gamma1=0.95, epsilon=1e-8,
                    wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                    clip_weights=-1.0):
    return _one(rmsprop, weight, grad, (n,), lr, wd, rescale_grad,
                gamma1=gamma1, epsilon=epsilon, clip=clip_gradient,
                clip_weights=clip_weights)


@register("rmspropalex_update", num_outputs=4)
def _rmspropalex_update(weight, grad, n, g_avg, delta, lr=0.01, gamma1=0.95,
                        gamma2=0.9, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                        clip_gradient=-1.0, clip_weights=-1.0):
    return _one(rmspropalex, weight, grad, (n, g_avg, delta), lr, wd,
                rescale_grad, gamma1=gamma1, gamma2=gamma2, epsilon=epsilon,
                clip=clip_gradient, clip_weights=clip_weights)


@register("ftrl_update", num_outputs=3)
def _ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                 rescale_grad=1.0, clip_gradient=-1.0):
    dt = weight.dtype
    g = _raw_grad(grad, rescale_grad, clip_gradient)
    lr_, l1 = scalar(lr, dt), scalar(lamda1, dt)
    new_n = n + g * g
    sigma = div(sqrt(new_n) - sqrt(n), lr_)
    new_z = z + g - sigma * weight
    w = torch.where(
        torch.abs(new_z) > l1,
        -(new_z - torch.sign(new_z) * l1)
        / (div(scalar(beta, dt) + sqrt(new_n), lr_) + scalar(wd, dt)),
        torch.zeros((), dtype=dt, device=weight.device))
    return w, new_z, new_n


@register("ftml_update", num_outputs=3)
def _ftml_update(weight, grad, d, v, z, lr=0.01, beta1=0.6, beta2=0.999,
                 epsilon=1e-8, t=1, wd=0.0, rescale_grad=1.0,
                 clip_grad=-1.0):
    dt = weight.dtype
    g = grad * scalar(rescale_grad, dt) + scalar(wd, dt) * weight
    if clip_grad is not None and clip_grad > 0:
        c = scalar(clip_grad, dt)
        g = torch.clamp(g, -c, c)
    new_v = scalar(beta2, dt) * v + scalar(1 - beta2, dt) * (g * g)
    # (1 - b1^t) / lr and 1 - b2^t in float32, as JAX computes them from
    # the traced lr and t
    f = np.float32
    d_scale = float((f(1) - f(beta1) ** f(t)) / f(lr))
    beta2_t = float(f(1) - f(beta2) ** f(t))
    d_t = scalar(d_scale, dt) * (sqrt(div(new_v, scalar(beta2_t, dt)))
                                 + scalar(epsilon, dt))
    sigma = d_t - scalar(beta1, dt) * d
    new_z = scalar(beta1, dt) * z + scalar(1 - beta1, dt) * g \
        - sigma * weight
    return -new_z / d_t, d_t, new_v


def _loss_scale_ok(rescale_grad_t):
    """The dynamic loss scale is usable: finite and non-zero (ref:
    adamw.cc:44)."""
    return torch.isfinite(rescale_grad_t).all() & \
        (rescale_grad_t != 0).all()


def _adamw_math(weight, grad, mean, var, rescale_grad_t, lr, beta1, beta2,
                epsilon, wd, eta, clip_gradient):
    dt = weight.dtype
    g = grad * rescale_grad_t
    if clip_gradient is not None and clip_gradient > 0:
        c = scalar(clip_gradient, dt)
        g = torch.clamp(g, -c, c)
    m = scalar(beta1, dt) * mean + scalar(1 - beta1, dt) * g
    v = scalar(beta2, dt) * var + scalar(1 - beta2, dt) * (g * g)
    w = weight - scalar(eta, dt) * (
        scalar(lr, dt) * m / (sqrt(v) + scalar(epsilon, dt))
        + scalar(wd, dt) * weight)
    return w, m, v


@register("_adamw_update", aliases=("adamw_update",), num_outputs=3)
def _adamw_update(weight, grad, mean, var, rescale_grad_t, lr=0.01,
                  beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0, eta=1.0,
                  clip_gradient=-1.0):
    w, m, v = _adamw_math(weight, grad, mean, var, rescale_grad_t, lr, beta1,
                          beta2, epsilon, wd, eta, clip_gradient)
    ok = _loss_scale_ok(rescale_grad_t)
    return (torch.where(ok, w, weight), torch.where(ok, m, mean),
            torch.where(ok, v, var))


@register("_mp_adamw_update", aliases=("mp_adamw_update",), num_outputs=4)
def _mp_adamw_update(weight, grad, mean, var, weight32, rescale_grad_t,
                     lr=0.01, beta1=0.9, beta2=0.999, epsilon=1e-8, wd=0.0,
                     eta=1.0, clip_gradient=-1.0):
    """Multi-precision AdamW: f32 master weights, decoupled weight decay,
    tensor-valued rescale_grad for dynamic loss scaling."""
    w32, m, v = _adamw_math(weight32, grad.to(weight32.dtype), mean, var,
                            rescale_grad_t, lr, beta1, beta2, epsilon, wd,
                            eta, clip_gradient)
    ok = _loss_scale_ok(rescale_grad_t)
    return (torch.where(ok, w32.to(weight.dtype), weight),
            torch.where(ok, m, mean), torch.where(ok, v, var),
            torch.where(ok, w32, weight32))


def _multi(rule, tensors, per, num_weights, lrs, wds, rescale, **statics):
    """Run ``rule`` over ``num_weights`` interleaved groups of ``per``
    tensors (weight, grad, states...); outputs are all new weights, then
    each state slot's new tensors."""
    groups = [tensors[per * i:per * i + per] for i in range(num_weights)]
    ws = [t[0] for t in groups]
    gs = [t[1] for t in groups]
    states = [[t[2 + k] for t in groups] for k in range(per - 2)]
    nw, ns = rule(ws, gs, states, list(lrs), list(wds), rescale, **statics)
    return tuple(nw) + tuple(x for slot in ns for x in slot)


def _nout(per, mult):
    def n(n_inputs, params):
        return mult * int(params.get("num_weights", n_inputs // per))
    return n


@register("multi_sgd_update", num_outputs=_nout(2, 1), variadic=True)
def _multi_sgd_update(*tensors, lrs=(), wds=(), rescale_grad=1.0,
                      clip_gradient=-1.0, num_weights=1):
    """One update of a whole parameter group (ref: optimizer_op.cc:654
    multi_sgd_update): (weight, grad) pairs."""
    return _multi(sgd, tensors, 2, num_weights, lrs, wds, rescale_grad,
                  clip=clip_gradient)


@register("multi_sgd_mom_update", num_outputs=_nout(3, 2), variadic=True)
def _multi_sgd_mom_update(*tensors, lrs=(), wds=(), momentum=0.0,
                          rescale_grad=1.0, clip_gradient=-1.0,
                          num_weights=1):
    return _multi(sgd_mom, tensors, 3, num_weights, lrs, wds, rescale_grad,
                  momentum=momentum, clip=clip_gradient)


@register("multi_mp_sgd_update", num_outputs=_nout(3, 2), variadic=True)
def _multi_mp_sgd_update(*tensors, lrs=(), wds=(), rescale_grad=1.0,
                         clip_gradient=-1.0, num_weights=1):
    """(weight, grad, weight32) triplets."""
    return _multi(mp(sgd), tensors, 3, num_weights, lrs, wds, rescale_grad,
                  clip=clip_gradient)


@register("multi_mp_sgd_mom_update", num_outputs=_nout(4, 3), variadic=True)
def _multi_mp_sgd_mom_update(*tensors, lrs=(), wds=(), momentum=0.0,
                             rescale_grad=1.0, clip_gradient=-1.0,
                             num_weights=1):
    """(weight, grad, mom, weight32) quadruplets."""
    return _multi(mp(sgd_mom), tensors, 4, num_weights, lrs, wds,
                  rescale_grad, momentum=momentum, clip=clip_gradient)


@register("multi_adam_update", num_outputs=_nout(4, 3), variadic=True)
def _multi_adam_update(*tensors, lrs=(), wds=(), beta1=0.9, beta2=0.999,
                       epsilon=1e-8, rescale_grad=1.0, clip_gradient=-1.0,
                       num_weights=1):
    """(weight, grad, mean, var) quadruplets; ``lrs`` arrive
    bias-corrected, as for the one-tensor op."""
    return _multi(adam, tensors, 4, num_weights, lrs, wds, rescale_grad,
                  beta1=beta1, beta2=beta2, epsilon=epsilon,
                  clip=clip_gradient)


@register("multi_nag_mom_update", num_outputs=_nout(3, 2), variadic=True)
def _multi_nag_mom_update(*tensors, lrs=(), wds=(), momentum=0.0,
                          rescale_grad=1.0, clip_gradient=-1.0,
                          num_weights=1):
    """(weight, grad, mom) triplets."""
    return _multi(nag_mom, tensors, 3, num_weights, lrs, wds, rescale_grad,
                  momentum=momentum, clip=clip_gradient)


@register("multi_rmsprop_update", num_outputs=_nout(3, 2), variadic=True)
def _multi_rmsprop_update(*tensors, lrs=(), wds=(), gamma1=0.95,
                          epsilon=1e-8, rescale_grad=1.0,
                          clip_gradient=-1.0, clip_weights=-1.0,
                          num_weights=1):
    """(weight, grad, n) triplets."""
    return _multi(rmsprop, tensors, 3, num_weights, lrs, wds, rescale_grad,
                  gamma1=gamma1, epsilon=epsilon, clip=clip_gradient,
                  clip_weights=clip_weights)


@register("_contrib_group_adagrad_update",
          aliases=("group_adagrad_update",), num_outputs=2)
def _group_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                          clip_gradient=-1.0, epsilon=1e-5):
    """Group AdaGrad: one accumulator per row (ref:
    contrib/optimizer_op-inl.h GroupAdagradDnsRspKernel)."""
    dt = weight.dtype
    g = _raw_grad(grad, rescale_grad, clip_gradient)
    row_dims = tuple(range(1, g.dim()))
    sq = g * g
    # an empty dim tuple means every dim to torch, none to jnp.mean
    new_hist = history + (torch.mean(sq, dim=row_dims) if row_dims else sq)
    denom = sqrt(new_hist + scalar(epsilon, dt)).reshape(
        (-1,) + (1,) * len(row_dims))
    return weight - scalar(lr, dt) * g / denom, new_hist


@register("_sparse_adagrad_update", aliases=("sparse_adagrad_update",),
          num_outputs=2)
def _sparse_adagrad_update(weight, grad, history, lr=0.01, rescale_grad=1.0,
                           clip_gradient=-1.0, epsilon=1e-7, wd=0.0):
    raise NotPortedError(
        "_sparse_adagrad_update takes row-sparse gradients, which are not "
        "ported yet (ROADMAP.md, queue A11)")
