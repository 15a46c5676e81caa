"""Fused attention: the flash-attention forward kernel and its op (ref: the
JAX package's ``ops/pallas_kernels.py`` ``_build_flash`` and
``flash_attention``).

The forward is the hand-written CUDA kernel in ``csrc/flash_attention.cu``
(online softmax over K/V tiles, f32 arithmetic). The backward is not a
kernel, as in the JAX package: it recomputes through the plain
``parallel.ring_attention.attention`` with torch autograd, as the JAX
``custom_vjp`` recomputes through its plain attention.

Device rule: ``flash_fwd`` runs the kernel for CUDA tensors and its plain
PyTorch version ``_flash_plain`` for CPU tensors; any other device raises.
Nothing falls back from the kernel to the plain version. The wrapper adds
one to ``launches["flash_fwd"]`` when it launches the kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..base import MXNetError, check
from ..parallel.ring_attention import attention
from . import _build

__all__ = ["flash_attention", "flash_fwd", "launches", "reset_launches"]

#: launches of the kernel since the last reset_launches()
launches = {"flash_fwd": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 256
_bound = False


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
        _bound = True
    return lib


def _check(q, k, v):
    """Validate a call; returns the device kind ('cpu' or 'cuda')."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        check(isinstance(t, torch.Tensor) and t.dim() == 4,
              f"flash_fwd: {name} must be a 4-D (B, T, H, D) tensor")
        check(t.dtype in _DTYPE_CODE,
              f"flash_fwd: dtype {t.dtype} unsupported (float32 or "
              "bfloat16)")
        check(t.dtype == q.dtype and t.shape == q.shape
              and t.device == q.device,
              "flash_fwd: q, k and v must share dtype, shape and device")
        check(t.stride(-1) == 1,
              f"flash_fwd: the last dim of {name} must be contiguous")
    b, t, h, d = q.shape
    check(b > 0 and t > 0 and h > 0, "flash_fwd: empty input")
    check(0 < d <= _MAX_D and d % 8 == 0,
          f"flash_fwd: head dim {d} unsupported (a multiple of 8, at most "
          f"{_MAX_D})")
    if q.device.type not in ("cpu", "cuda"):
        raise MXNetError(f"flash_fwd: unsupported device {q.device}")
    return q.device.type


def flash_fwd(q, k, v, causal: bool, scale: float):
    """softmax(q k^T * scale [causal -1e30 mask]) v over (B, T, H, D), f32
    math, output in q's dtype (ref: pallas_kernels.py
    _build_flash)."""
    if _check(q, k, v) == "cpu":
        return _flash_plain(q, k, v, causal, scale)
    b, t, h, d = q.shape
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    ts = (q, k, v, o)
    strides = (ctypes.c_longlong * 12)(
        *[s for x in ts for s in x.stride()[:3]])
    size = q.element_size()
    vec = int(all(x.data_ptr() % 16 == 0 for x in ts)
              and all(s * size % 16 == 0 for x in ts for s in x.stride()[:3]))
    with torch.cuda.device(q.device):
        err = _lib().mxt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides,
            b, t, h, d, float(scale), int(bool(causal)),
            _DTYPE_CODE[q.dtype], vec,
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise MXNetError(f"flash_fwd: CUDA kernel launch failed "
                         f"(cudaError {err})")
    launches["flash_fwd"] += 1
    return o


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
            qkv = [x.detach().requires_grad_() for x in (q, k, v)]
            out = attention(*qkv, causal=ctx.causal, scale=ctx.scale)
            grads = torch.autograd.grad(out, qkv, g)
        return (*grads, None, None)


def flash_attention(q, k, v, causal: bool = False, scale=None):
    """Fused attention. q, k, v: (B, T, H, D) -> (B, T, H, D); ``scale``
    defaults to 1/sqrt(D) (ref: pallas_kernels.py flash_attention)."""
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return _FlashAttention.apply(q, k, v, bool(causal), float(sc))
