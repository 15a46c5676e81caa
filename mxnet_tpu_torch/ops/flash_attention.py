"""Fused attention: the flash-attention forward kernel and its op (ref: the
JAX package's ``ops/pallas_kernels.py`` ``_build_flash`` and
``flash_attention``).

The forward is one of two hand-written CUDA kernels in
``csrc/flash_attention.cu``, chosen by shape (``flash_route``):

- ``"tc"``, the tensor-core kernel ``mxt_flash_fwd_tc`` (wgmma, TMA, P
  rounded to the input type): bf16 or f16 with D a multiple of 8 up to 256
  and 16-byte aligned pointers and (b, t, h) strides. An element is within
  ``2e-5 + 2^-7 |want| + 2^-8 max|v|`` of the plain version in bf16 and
  ``2e-5 + 2^-10 |want| + 2^-11 max|v|`` in f16;
- ``"general"``, the kernel ``mxt_flash_fwd`` for every other call: f32,
  and f16 or bf16 at other D or through unaligned views, any T >= 1 and
  any D >= 1. Its products run on the tensor cores in TF32 with f32
  operands split in two (3xTF32), within 2e-5 of the plain version in f32
  (plus one unit in the last place of a 16-bit output).

Like the JAX kernel, both take f32, bf16 and f16 and return q's dtype; any
other dtype raises. The backward is not a kernel, as in the JAX package: it
recomputes through the plain ``parallel.ring_attention.attention`` with
torch autograd, as the JAX ``custom_vjp`` recomputes through its plain
attention.

Device rule: ``flash_fwd`` runs a kernel for CUDA tensors and its plain
PyTorch version ``_flash_plain`` for CPU tensors; any other device raises.
Nothing falls back from a kernel to the plain version or to the other
kernel. The wrapper adds one to ``launches["flash_fwd"]`` for every kernel
launch and one to ``launches["flash_fwd_tc"]`` or
``launches["flash_fwd_general"]`` for its route, and reports the launch's
cost (``kernel_cost.flash_report``) to any open counting scope of the
efficiency plane.

Registry names (ref: ``pallas_kernels.py:170-185, 471-480``):
``_contrib_flash_attention`` / ``flash_attention`` is this op, so
``mx.nd.contrib.flash_attention`` reaches the kernels by ``flash_route``;
``_contrib_interleaved_matmul_selfatt_qk`` / ``_valatt`` are plain matmuls
over the interleaved (T, B, 3 H D) projection, as in the JAX package.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError, check
from ..telemetry import efficiency as _efficiency
from . import _build, kernel_cost
from .registry import register

__all__ = ["flash_attention", "flash_fwd", "flash_route", "launches",
           "launch_heads", "reset_launches"]

#: kernel launches since the last reset_launches(): every launch, and those
#: of each route
launches = {"flash_fwd": 0, "flash_fwd_tc": 0, "flash_fwd_general": 0}
#: launches since the last reset_launches(), by the head count H they ran
#: at (a tensor-parallel rank runs its own heads)
launch_heads = {}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_TC_MAX_D = 256
_bound = False


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    launch_heads.clear()


def _flash_plain(q, k, v, causal, scale):
    """The Pallas kernel's math on (B, T, H, D): f32 scores, the -1e30
    causal mask, one full-row softmax, ``(p @ v) / l`` cast to q's dtype."""
    logits = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
    if causal:
        t, s = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((t, s), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, -1e30)
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhts,bshd->bthd", p, v.float())
    return (o / p.sum(dim=-1).transpose(1, 2)[..., None]).to(q.dtype)


def _lib():
    global _bound
    lib = _build.load("flash_attention")
    if not _bound:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mxt_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i,
                                      ctypes.c_float, i, i, i, p]
        lib.mxt_flash_fwd.restype = ctypes.c_int
        lib.mxt_flash_fwd_tc.argtypes = [p, p, p, p, p, i, i, i, i,
                                         ctypes.c_float, i, i, p]
        lib.mxt_flash_fwd_tc.restype = ctypes.c_int
        _bound = True
    return lib


def _check(q, k, v):
    """Validate a call; returns the device kind ('cpu' or 'cuda')."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check(isinstance(t, torch.Tensor) and t.dim() == 4,
              f"flash_fwd: {name} must be a 4-D (B, T, H, D) tensor")
        check(t.dtype in _DTYPE_CODE,
              f"flash_fwd: dtype {t.dtype} unsupported (float32, bfloat16 "
              "or float16)")
        check(t.dtype == q.dtype and t.shape == q.shape
              and t.device == q.device,
              "flash_fwd: q, k and v must share dtype, shape and device")
        check(t.stride(-1) == 1,
              f"flash_fwd: the last dim of {name} must be contiguous")
    check(q.numel() > 0, "flash_fwd: empty input")
    if q.device.type not in ("cpu", "cuda"):
        raise MXNetError(f"flash_fwd: unsupported device {q.device}")
    return q.device.type


def _unit(ts) -> int:
    """Bytes per copy of the general kernel's loads: the largest of 16, 8
    and 4 that divides every pointer and every (b, t, h) stride in bytes,
    else the element size (16-bit views that are not 4-byte aligned)."""
    size = ts[0].element_size()
    for unit in (16, 8, 4):
        if all(x.data_ptr() % unit == 0 for x in ts) and all(
                s * size % unit == 0 for x in ts for s in x.stride()[:3]):
            return unit
    return size


def flash_route(q, k, v) -> str:
    """The kernel a call takes, by shape: ``"tc"`` (the tensor-core kernel)
    for bf16 or f16 with D a multiple of 8 up to 256 whose pointers and
    (b, t, h) strides are all 16-byte aligned, else ``"general"``."""
    d = q.shape[-1]
    if q.dtype in (torch.bfloat16, torch.float16) and d % 8 == 0 \
            and d <= _TC_MAX_D and _unit((q, k, v)) == 16:
        return "tc"
    return "general"


def flash_fwd(q, k, v, causal: bool, scale: float):
    """softmax(q k^T * scale [causal -1e30 mask]) v over (B, T, H, D),
    output in q's dtype (ref: pallas_kernels.py _build_flash). q, k and v
    are f32, bf16 or f16 and share dtype and shape; any T and D.

    Route rule (``flash_route``, dispatch by shape, never a fallback):
    bf16 or f16 with D a multiple of 8 up to 256 and 16-byte aligned
    pointers and (b, t, h) strides goes to the tensor-core kernel, whose
    products run in the input type with f32 accumulation and P rounded to
    it; an element of its output is within
    ``2e-5 + 2^-7 |want| + 2^-8 max|v|`` of ``_flash_plain``'s ``want`` in
    bf16 (P's rounding moves the output by at most 2^-8 max|v|) and
    ``2e-5 + 2^-10 |want| + 2^-11 max|v|`` in f16. Everything else (f32,
    other D, unaligned views) goes to the general kernel, whose products
    run on the tensor cores in TF32 with f32 operands split in two
    (3xTF32), within 2e-5 of ``want`` in f32 plus one unit in the last
    place of a 16-bit output (2^-7 |want| in bf16, 2^-10 |want| in f16). A
    failed build or launch on either route raises ``MXNetError``."""
    if _check(q, k, v) == "cpu":
        return _flash_plain(q, k, v, causal, scale)
    b, t, h, d = q.shape
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    ts = (q, k, v, o)
    strides = (ctypes.c_longlong * 12)(
        *[s for x in ts for s in x.stride()[:3]])
    route = flash_route(q, k, v)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if route == "tc":
            err = _lib().mxt_flash_fwd_tc(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                strides, b, t, h, d, float(scale), int(bool(causal)),
                _DTYPE_CODE[q.dtype], stream)
        else:
            err = _lib().mxt_flash_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                strides, b, t, h, d, float(scale), int(bool(causal)),
                _DTYPE_CODE[q.dtype], _unit((q, k, v)), stream)
    _ok(route, err, q)
    return o


def _ok(route, err, q):
    """Raise on a failed launch; count a launch that ran and report its
    cost to an open counting scope."""
    if err != 0:
        raise MXNetError(f"flash_fwd: CUDA kernel launch failed on the "
                         f"{route} route (cudaError {err})")
    launches["flash_fwd"] += 1
    launches[f"flash_fwd_{route}"] += 1
    launch_heads[q.shape[2]] = launch_heads.get(q.shape[2], 0) + 1
    if _efficiency.OPEN[0]:
        _efficiency.report_kernel(*kernel_cost.flash_report(
            *q.shape, q.element_size()), f"flash_fwd_{route}")


class _FlashAttention(torch.autograd.Function):
    """Replaces ``flash_attention``'s ``jax.custom_vjp``: the forward is the
    kernel, the backward recomputes through the plain ``attention`` with
    the same scale and takes its vector-Jacobian product."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale = causal, scale
        return flash_fwd(q, k, v, causal, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.profiler.record_function("mxt::flash_attention_backward"), \
                torch.enable_grad():
            # imported here: the parallel package imports mx.nd, which
            # imports this module to register its op names
            from ..parallel.ring_attention import attention
            qkv = [x.detach().requires_grad_() for x in (q, k, v)]
            out = attention(*qkv, causal=ctx.causal, scale=ctx.scale)
            grads = torch.autograd.grad(out, qkv, g)
        return (*grads, None, None)


def flash_attention(q, k, v, causal: bool = False, scale=None):
    """Fused attention. q, k, v: (B, T, H, D) -> (B, T, H, D); ``scale``
    defaults to 1/sqrt(D) (ref: pallas_kernels.py flash_attention)."""
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(sc))


@register("_contrib_flash_attention", aliases=("flash_attention",))
def _flash_attention_op(q, k, v, causal=False, scale=None):
    return flash_attention(q, k, v, causal=causal, scale=scale)


def _interleaved(qkv, heads, which):
    """Part ``which`` (0 q, 1 k, 2 v) of the (T, B, 3 H D) interleaved
    projection as (B H, T, D)."""
    t, b, three_hd = qkv.shape
    d = three_hd // (3 * heads)
    x = qkv.reshape(t, b, heads, 3, d)[:, :, :, which]
    return x.permute(1, 2, 0, 3).reshape(b * heads, t, d)


@register("_contrib_interleaved_matmul_selfatt_qk")
def _interleaved_qk(qkv, heads=1):
    """(ref: src/operator/contrib/transformer.cc) qkv: (T, B, 3 H D)
    interleaved -> (B H, T, T) scores q kᵀ / sqrt(D)."""
    q, k = _interleaved(qkv, heads, 0), _interleaved(qkv, heads, 1)
    return torch.matmul(q, k.transpose(1, 2)) / math.sqrt(q.shape[-1])


@register("_contrib_interleaved_matmul_selfatt_valatt")
def _interleaved_valatt(qkv, att, heads=1):
    """att (B H, T, T) times the interleaved values -> (T, B, H D)."""
    t, b, _ = qkv.shape
    out = torch.matmul(att, _interleaved(qkv, heads, 2))   # (B H, T, D)
    return out.reshape(b, heads, t, -1).permute(2, 0, 1, 3) \
        .reshape(t, b, -1)
