"""Pipeline parallelism over the ``pp`` mesh axis, the GPipe schedule
(ref: the JAX package's ``parallel/pipeline.py``).

Each rank of the ``pp`` axis owns one stage's parameters (its local
block of the stage-stacked pytree). With S stages and M microbatches the
schedule runs M + S - 1 ticks: every tick each stage applies its layers
to its input buffer, hands the result to the next stage (a ring shift
over ``pp``), stage 0 loads the next microbatch, and the last stage keeps
the microbatch that left the pipe. At the end the last stage's outputs
reach every stage through a masked sum over ``pp``, as the JAX
function's ``psum`` does. Stages run on zeros during the fill and drain
ticks, as in JAX.

The schedule is one ``torch.autograd.Function`` whose backward runs the
ticks in reverse: the sum's backward (a sum over ``pp``), then each tick
receives its output's gradient from the next stage (the inverse shift),
adds the last stage's output gradient, and back-propagates the stage
through the graph its forward kept. Every rank issues the same
collectives in the same order, forward and backward: left to autograd,
stage 0 (which never reads the shifted activations) would skip the
shifts' backwards that the other stages wait in.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from ..base import check
from .mesh import axis_size

__all__ = ["pipeline_apply"]


def pipeline_apply(stage_fn: Callable, stage_params: Any, x, mesh,
                   axis: str = "pp", n_microbatches: Optional[int] = None):
    """Run ``x`` through the S pipeline stages.

    ``stage_fn(stage_params, x_mb) -> y_mb`` keeps shape and dtype.
    ``stage_params``: this rank's stage (a tensor, or a list / dict tree
    of tensors). ``x``: ``(B, ...)`` activations, the same on every
    stage. Returns ``(B, ...)``, the last stage's outputs, on every
    stage; differentiable in ``x`` and in the stage's parameters."""
    S = axis_size(mesh, axis)
    if S == 1:
        return stage_fn(stage_params, x)
    M = int(n_microbatches or S)
    B = x.shape[0]
    check(B % M == 0, f"batch {B} not divisible by {M} microbatches")
    leaves, rebuild = _flatten(stage_params)
    return _GPipe.apply(stage_fn, rebuild, mesh, axis, M, x, *leaves)


def _flatten(tree):
    """``(leaves, rebuild)`` of a tensor / list / dict tree."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda ls: ls[0]
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    else:
        keys = None
        parts = [_flatten(v) for v in tree]
    sizes = [len(p[0]) for p in parts]
    leaves = [leaf for p in parts for leaf in p[0]]

    def rebuild(ls):
        out, off = [], 0
        for (_, rb), n in zip(parts, sizes):
            out.append(rb(ls[off:off + n]))
            off += n
        return dict(zip(keys, out)) if keys is not None else out
    return leaves, rebuild


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, rebuild, mesh, axis, M, x, *leaves):
        from .collectives import _raw_allreduce, _raw_ppermute
        S = axis_size(mesh, axis)
        stage = mesh.axis_index(axis)
        mb = x.reshape(M, x.shape[0] // M, *x.shape[1:])
        params = [p.detach().requires_grad_(p.requires_grad)
                  for p in leaves]
        tree = rebuild(params)
        ticks = []                   # (input leaf, output) per tick
        outs = torch.zeros_like(mb)
        in_buf = mb[0] if stage == 0 else torch.zeros_like(mb[0])
        for t in range(M + S - 1):
            inp = in_buf.detach().requires_grad_()
            with torch.enable_grad():
                y = stage_fn(tree, inp)
            ticks.append((inp, y))
            y_prev = _raw_ppermute(y.detach(), mesh, axis, 1)
            in_buf = mb[min(t + 1, M - 1)] if stage == 0 else y_prev
            if stage == S - 1 and t >= S - 1:
                outs[t - (S - 1)] = y.detach()
        if stage != S - 1:
            outs.zero_()
        out = _raw_allreduce(outs, mesh.group(axis))
        ctx.state = (mesh, axis, M, S, stage, ticks, params, x.shape)
        return out.reshape(x.shape[0], *out.shape[2:])

    @staticmethod
    def backward(ctx, g_out):
        from .collectives import _raw_allreduce, _raw_ppermute
        mesh, axis, M, S, stage, ticks, params, xshape = ctx.state
        g = _raw_allreduce(g_out.contiguous(), mesh.group(axis))
        g = g.reshape(M, xshape[0] // M, *xshape[1:])
        g_params = [None] * len(params)
        g_mb = torch.zeros_like(g)
        g_next = None                # gradient of the next tick's input
        for t in reversed(range(M + S - 1)):
            inp, y = ticks[t]
            if g_next is None:
                g_y = torch.zeros_like(y)
            else:
                # the next stage read this tick's output as its input
                recv = _raw_ppermute(g_next, mesh, axis, -1)
                g_y = recv if stage != S - 1 else torch.zeros_like(y)
            if stage == S - 1 and t >= S - 1:
                g_y = g_y + g[t - (S - 1)]
            wants = [inp] + [p for p in params if p.requires_grad]
            got = torch.autograd.grad(y, wants, g_y, allow_unused=True)
            g_in, got = got[0], iter(got[1:])
            for j, p in enumerate(params):
                if p.requires_grad:
                    gp = next(got)
                    if gp is not None:
                        g_params[j] = gp if g_params[j] is None \
                            else g_params[j] + gp
            g_in = torch.zeros_like(inp) if g_in is None else g_in
            if stage == 0:
                # stage 0 read microbatch min(t, M - 1) at tick t
                g_mb[min(t, M - 1)] += g_in
            g_next = g_in
        ctx.state = None
        return (None, None, None, None, None,
                g_mb.reshape(xshape), *g_params)
