"""Fused bottleneck epilogue: training-mode BatchNorm(+residual add)+ReLU
over channel-last activations, forward and backward (ref: the JAX
package's ``ops/pallas_kernels.py`` ``fused_bn_act`` and its four Pallas
kernels).

Two passes each way over the (R, C) view of the conv output (R = N*H*W):

    forward   bn_stats      -> per-channel [sum x, sum x^2]   (f32)
              bn_apply      -> out = relu(x*coef0 + coef1 [+ res])
    backward  bn_bwd_stats  -> [sum g, sum g*xhat]            (f32)
              bn_bwd_apply  -> dx [, dres = g]

with g the ReLU-masked cotangent re-derived from the saved output, so it is
never stored. The kernels are hand-written CUDA in ``csrc/fused_bn_act.cu``.
The activations are float32, bfloat16 or float16 (the Pallas kernels take
any float); every kernel computes in f32 and rounds as the plain versions
do, so the elementwise ones are bit-identical to them in all three.

The two reductions are one launch each. Blocks of a (channel tiles) x (row
chunks) grid sum their rows; each thread-block cluster of ``_CLUSTER``
consecutive chunks adds its blocks' sums through shared memory and writes
one (2, C) partial, and a ticket counter per column tile lets the last
cluster to arrive sum the partials in a fixed order, so the sums do not
depend on which block finishes last. The counters live in an int32
workspace per (device, stream), zeroed when it is allocated; every launch
leaves them at 0, so no memset runs per call, and reductions launched on
different streams never share a counter.

Device rule: each wrapper runs its kernel for CUDA tensors and its plain
PyTorch version (``_bn_stats_plain`` ...) for CPU tensors; any other device
raises. Nothing falls back from the kernel to the plain version. Each
wrapper adds one to ``launches[<name>]`` when it launches its kernel, and
reports the launch's bytes (``kernel_cost.bn_report``) to any open
counting scope of the efficiency plane (one flag check when none is
open); the plain version's ops are counted by the scope itself.

Under CUDA-graph capture (``SPMDTrainer.run_steps``). A wrapper called
while its stream captures records its kernel into the graph and launches
nothing, so it counts nothing; a replay launches the kernels without
calling the wrappers, so replays add nothing to ``launches`` either. What
a graph launched is read on the device (``torch.profiler``'s kernel
counts). A graph keeps the ticket counters of the stream it was captured
on. They must exist before capture begins (the wrapper raises rather than
allocate them into the graph's private pool), so the same calls run once
eagerly on that stream first; replays of one graph must not overlap on
two streams (the trainer replays each graph on its own stream). Counters
that a larger C replaces are kept alive, since a graph may hold them. A
launch error during capture raises like any other.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError, check
from ..telemetry import efficiency as _efficiency
from . import _build, kernel_cost

__all__ = ["fused_bn_act", "bn_stats", "bn_apply", "bn_bwd_stats",
           "bn_bwd_apply", "launches", "reset_launches"]

#: launches of each kernel since the last reset_launches()
launches = {"bn_stats": 0, "bn_apply": 0, "bn_bwd_stats": 0,
            "bn_bwd_apply": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_PACK = {torch.float32: 4, torch.bfloat16: 8,   # elements per 16 bytes
         torch.float16: 8}
_H100_SXM_SMS = 132
_APPLY_BLOCKS_PER_SM = 8       # apply blocks in flight (256 threads)
_STATS_BLOCKS_PER_SM = 1       # blocks of a reduction (256 threads each)
_CLUSTER = 8                   # chunks per thread-block cluster (CLUSTER)
_bound = False
_sms: dict = {}                # device index -> streaming multiprocessors
_tickets: dict = {}            # (device index, stream) -> int32 counters
_retired: list = []            # replaced counters a graph may still hold


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, and the card-side reference)
# ---------------------------------------------------------------------------

def _bn_stats_plain(x2d):
    x = x2d.float()
    return torch.stack([x.sum(0), (x * x).sum(0)])


def _bn_apply_plain(x2d, res2d, coef):
    y = x2d.float() * coef[0] + coef[1]
    if res2d is not None:
        y = y + res2d.float()
    return torch.relu(y).to(x2d.dtype)


def _masked_g_xhat(dy2d, out2d, x2d, coef):
    g = torch.where(out2d > 0, dy2d.float(), 0.0)
    xhat = (x2d.float() - coef[0]) * coef[1]
    return g, xhat


def _bn_bwd_stats_plain(dy2d, out2d, x2d, coef):
    g, xhat = _masked_g_xhat(dy2d, out2d, x2d, coef)
    return torch.stack([g.sum(0), (g * xhat).sum(0)])


def _bn_bwd_apply_plain(dy2d, out2d, x2d, coef, has_res):
    g, xhat = _masked_g_xhat(dy2d, out2d, x2d, coef)
    dx = (coef[2] * (g - coef[3] - xhat * coef[4])).to(x2d.dtype)
    return (dx, g.to(x2d.dtype)) if has_res else dx


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _lib():
    global _bound
    lib = _build.load("fused_bn_act")
    if not _bound:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for fn, args in (
                (lib.mxt_bn_stats,
                 [p, p, p, p, ll, i, i, i, i, i, i, ll, p]),
                (lib.mxt_bn_apply, [p, p, p, p, ll, i, i, i, i, i, i, ll,
                                    p]),
                (lib.mxt_bn_bwd_stats,
                 [p, p, p, p, p, p, p, ll, i, i, i, i, i, i, ll, p]),
                (lib.mxt_bn_bwd_apply,
                 [p, p, p, p, p, p, ll, i, i, i, i, i, i, ll, p])):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        _bound = True
    return lib


def _check_rows(name, *ts):
    """Validate the (R, C) activations of one call; returns the device
    kind ('cpu' or 'cuda')."""
    x = ts[0]
    for t in ts:
        check(isinstance(t, torch.Tensor) and t.dim() == 2,
              f"{name}: expected 2-D (R, C) tensors")
        check(t.dtype in _DTYPE_CODE,
              f"{name}: dtype {t.dtype} unsupported (float32, bfloat16 "
              "or float16)")
        check(t.dtype == x.dtype and t.shape == x.shape
              and t.device == x.device,
              f"{name}: all activations must share dtype, shape and device")
        check(t.is_contiguous(), f"{name}: activations must be contiguous")
    check(x.shape[0] > 0 and x.shape[1] > 0, f"{name}: empty input")
    if x.device.type not in ("cpu", "cuda"):
        raise MXNetError(f"{name}: unsupported device {x.device}")
    return x.device.type


def _check_coef(name, coef, rows, x):
    check(isinstance(coef, torch.Tensor) and coef.dtype == torch.float32
          and tuple(coef.shape) == (rows, x.shape[1])
          and coef.is_contiguous() and coef.device == x.device,
          f"{name}: coef must be a contiguous float32 ({rows}, C) tensor on "
          f"{x.device}")


def _wide(*ts) -> int:
    """1 when every tensor can move in 16-byte packs along C."""
    c = ts[0].shape[1]
    return int(c % _PACK[ts[0].dtype] == 0
               and all(t.data_ptr() % 16 == 0 for t in ts))


def _device_sms(device) -> int:
    """Streaming multiprocessors of a CUDA device, read once per device."""
    n = _sms.get(device.index)
    if n is None:
        n = _sms[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _reduce_config(r, c, wide, dtype, sms=_H100_SXM_SMS,
                   blocks_per_sm=_APPLY_BLOCKS_PER_SM):
    """(tx, ty, chunks, rows_per_chunk) of the row-tiled bn_apply and
    bn_bwd_apply: tx threads across C (each one pack), ty rows in flight,
    at least 4 rows per thread (their unroll), and enough row chunks for
    ``blocks_per_sm`` blocks on each of ``sms``."""
    pack = _PACK[dtype] if wide else 1
    cols = -(-c // pack)
    tx = min(32, cols)
    ty = max(1, 256 // tx)
    grid_x = -(-cols // tx)
    target = blocks_per_sm * sms
    chunks = max(1, min(-(-r // (4 * ty)), -(-target // grid_x)))
    rows_per_chunk = -(-r // chunks)
    chunks = -(-r // rows_per_chunk)
    return tx, ty, chunks, rows_per_chunk


def _reduce_stats_config(r, c, wide, dtype, sms):
    """(tx, ty, chunks, rows_per_chunk) of a one-launch reduction: tx
    threads across C (each one pack), ty row slots, chunks of a multiple
    of ty rows (every row slot of a full chunk walks as many rows), about
    ``_STATS_BLOCKS_PER_SM`` blocks per SM in all, and a multiple of
    ``_CLUSTER`` chunks (the chunks past R that fill the last cluster read
    no rows)."""
    pack = _PACK[dtype] if wide else 1
    cols = -(-c // pack)
    tx = min(32, cols)
    ty = max(1, 256 // tx)
    grid_x = -(-cols // tx)
    target = _STATS_BLOCKS_PER_SM * sms
    chunks = max(1, min(-(-r // ty), -(-target // grid_x)))
    rows_per_chunk = -(-r // (chunks * ty)) * ty
    chunks = -(-r // rows_per_chunk)
    return tx, ty, -(-chunks // _CLUSTER) * _CLUSTER, rows_per_chunk


def _stream(x):
    return ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)


def _ok(name, err, x2d, has_res=False):
    """Raise on a failed launch; count a launch that ran (not one
    recorded into a CUDA graph) and report its cost to an open counting
    scope."""
    if err != 0:
        raise MXNetError(f"{name}: CUDA kernel launch failed "
                         f"(cudaError {err})")
    if not torch.cuda.is_current_stream_capturing():
        launches[name] += 1
        if _efficiency.OPEN[0]:
            r, c = x2d.shape
            _efficiency.report_kernel(*kernel_cost.bn_report(
                name, r, c, x2d.element_size(), has_res), name)


def _reduction_args(*rows):
    """The arguments of one reduction launch over the (R, C) tensors
    ``rows`` after its input pointers: partial, sums, tickets, R, C, dtype,
    wide, tx, ty, chunks, rows_per_chunk and the stream. The ticket
    counters (one per column tile) belong to the device and its current
    stream; they are zeroed when allocated and every launch leaves them
    at 0."""
    x2d = rows[0]
    r, c = x2d.shape
    wide = _wide(*rows)
    tx, ty, chunks, rpc = _reduce_stats_config(
        r, c, wide, x2d.dtype, _device_sms(x2d.device))
    partial = torch.empty((chunks // _CLUSTER, 2, c), dtype=torch.float32,
                          device=x2d.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=x2d.device)
    stream = _stream(x2d)
    need = -(-c // (tx * (_PACK[x2d.dtype] if wide else 1)))
    key = (x2d.device.index, stream.value)
    tickets = _tickets.get(key)
    if tickets is None or tickets.numel() < need:
        if torch.cuda.is_current_stream_capturing():
            raise MXNetError(
                "BN reduction under CUDA-graph capture: the capturing "
                "stream has no ticket counters for this shape yet; run the "
                "same calls once on that stream before capture")
        if tickets is not None:
            _retired.append(tickets)
        tickets = _tickets[key] = torch.zeros(max(need, 64),
                                              dtype=torch.int32,
                                              device=x2d.device)
    return sums, (partial.data_ptr(), sums.data_ptr(), tickets.data_ptr(),
                  r, c, _DTYPE_CODE[x2d.dtype], wide, tx, ty, chunks, rpc,
                  stream)


def bn_stats(x2d):
    """(R, C) -> (2, C) f32 per-channel [sum x, sum x^2]
    (ref: pallas_kernels.py _bn_stats_call)."""
    if _check_rows("bn_stats", x2d) == "cpu":
        return _bn_stats_plain(x2d)
    with torch.cuda.device(x2d.device):
        sums, args = _reduction_args(x2d)
        err = _lib().mxt_bn_stats(x2d.data_ptr(), *args)
        _ok("bn_stats", err, x2d)
    return sums


def bn_apply(x2d, res2d, coef):
    """out = relu(x * coef[0] + coef[1] [+ res]) in x's dtype
    (ref: pallas_kernels.py _bn_apply_call)."""
    rows = (x2d,) if res2d is None else (x2d, res2d)
    kind = _check_rows("bn_apply", *rows)
    _check_coef("bn_apply", coef, 2, x2d)
    if kind == "cpu":
        return _bn_apply_plain(x2d, res2d, coef)
    r, c = x2d.shape
    out = torch.empty_like(x2d)
    wide = _wide(*rows, out)
    tx, ty, chunks, rpc = _reduce_config(r, c, wide, x2d.dtype,
                                         _device_sms(x2d.device))
    with torch.cuda.device(x2d.device):
        err = _lib().mxt_bn_apply(
            x2d.data_ptr(), None if res2d is None else res2d.data_ptr(),
            coef.data_ptr(), out.data_ptr(), r, c, _DTYPE_CODE[x2d.dtype],
            wide, tx, ty, chunks, rpc, _stream(x2d))
        _ok("bn_apply", err, x2d, res2d is not None)
    return out


def bn_bwd_stats(dy2d, out2d, x2d, coef):
    """(2, C) f32 [sum g, sum g*xhat]; g = dy where out > 0 else 0, xhat =
    (x - coef[0]) * coef[1] (ref: pallas_kernels.py _bn_bwd_stats_call)."""
    kind = _check_rows("bn_bwd_stats", x2d, dy2d, out2d)
    _check_coef("bn_bwd_stats", coef, 2, x2d)
    if kind == "cpu":
        return _bn_bwd_stats_plain(dy2d, out2d, x2d, coef)
    with torch.cuda.device(x2d.device):
        sums, args = _reduction_args(x2d, dy2d, out2d)
        err = _lib().mxt_bn_bwd_stats(dy2d.data_ptr(), out2d.data_ptr(),
                                      x2d.data_ptr(), coef.data_ptr(), *args)
        _ok("bn_bwd_stats", err, x2d)
    return sums


def bn_bwd_apply(dy2d, out2d, x2d, coef, has_res):
    """dx = coef[2] * (g - coef[3] - xhat * coef[4]); with ``has_res`` also
    dres = g from the same pass, returned as ``(dx, dres)``
    (ref: pallas_kernels.py _bn_bwd_apply_call)."""
    kind = _check_rows("bn_bwd_apply", x2d, dy2d, out2d)
    _check_coef("bn_bwd_apply", coef, 5, x2d)
    if kind == "cpu":
        return _bn_bwd_apply_plain(dy2d, out2d, x2d, coef, has_res)
    r, c = x2d.shape
    dx = torch.empty_like(x2d)
    dres = torch.empty_like(x2d) if has_res else None
    outs = (dx,) if dres is None else (dx, dres)
    wide = _wide(x2d, dy2d, out2d, *outs)
    tx, ty, chunks, rpc = _reduce_config(r, c, wide, x2d.dtype,
                                         _device_sms(x2d.device))
    with torch.cuda.device(x2d.device):
        err = _lib().mxt_bn_bwd_apply(
            dy2d.data_ptr(), out2d.data_ptr(), x2d.data_ptr(),
            coef.data_ptr(), dx.data_ptr(),
            None if dres is None else dres.data_ptr(), r, c,
            _DTYPE_CODE[x2d.dtype], wide, tx, ty, chunks, rpc, _stream(x2d))
        _ok("bn_bwd_apply", err, x2d, has_res)
    return (dx, dres) if has_res else dx


# ---------------------------------------------------------------------------
# the op: forward + hand-fused backward
# ---------------------------------------------------------------------------

class _FusedBNAct(torch.autograd.Function):
    """Replaces ``_build_fused_bn_act``'s ``jax.custom_vjp``. Saves x, out,
    mean, inv and gamma; returns ``dx[, dres], dgamma = sum g*xhat,
    dbeta = sum g``. mean/var carry no gradient (they feed the running-stat
    update only)."""

    @staticmethod
    def forward(ctx, x2d, res2d, g32, beta32, eps):
        n = float(x2d.shape[0])
        sums = bn_stats(x2d)
        mean = sums[0] / n
        var = torch.clamp_min(sums[1] / n - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        scale = inv * g32
        coef = torch.stack([scale, beta32 - mean * scale])
        out2d = bn_apply(x2d, res2d, coef)
        ctx.save_for_backward(x2d, out2d, mean, inv, g32)
        ctx.has_res = res2d is not None
        ctx.mark_non_differentiable(mean, var)
        return out2d, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x2d, out2d, mean, inv, g32 = ctx.saved_tensors
        n = float(x2d.shape[0])
        dy2d = dout.to(x2d.dtype).contiguous()
        sums = bn_bwd_stats(dy2d, out2d, x2d, torch.stack([mean, inv]))
        sum_g, sum_gxhat = sums[0], sums[1]
        coef = torch.stack([mean, inv, g32 * inv, sum_g / n, sum_gxhat / n])
        if ctx.has_res:
            dx, dres = bn_bwd_apply(dy2d, out2d, x2d, coef, True)
        else:
            dx, dres = bn_bwd_apply(dy2d, out2d, x2d, coef, False), None
        return dx, dres, sum_gxhat, sum_g, None


def fused_bn_act(data, residual, gamma32, beta32, eps):
    """Fused training-mode ``BatchNorm [+ add(residual)] + ReLU``.

    ``data``: channel-last activation (the conv output); ``residual``: same
    shape or None; ``gamma32`` / ``beta32``: f32 ``(C,)``. Returns ``(out,
    mean, var)``: out in data's dtype, f32 batch statistics
    (ref: pallas_kernels.py fused_bn_act)."""
    c = data.shape[-1]
    check(gamma32.dtype == torch.float32 and beta32.dtype == torch.float32,
          "fused_bn_act: gamma and beta must be float32")
    x2d = data.contiguous().view(-1, c)
    res2d = None if residual is None \
        else residual.to(data.dtype).contiguous().view(-1, c)
    out2d, mean, var = _FusedBNAct.apply(x2d, res2d, gamma32, beta32,
                                         float(eps))
    return out2d.view(data.shape), mean, var

