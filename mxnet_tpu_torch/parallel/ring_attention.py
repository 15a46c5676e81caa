"""Plain softmax attention (ref: the JAX package's
``parallel/ring_attention.py`` ``attention``).

Only the one-device ``attention`` is ported; ring attention over a
sequence-parallel mesh axis is not. The order of roundings is the JAX
function's: the logits einsum runs in the input dtype and is scaled there,
causal positions get ``-1e30``, the softmax runs in f32 and the
probabilities are cast to ``v.dtype`` before the second einsum.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention"]


def attention(q, k, v, causal: bool = False, scale: Optional[float] = None):
    """Plain softmax attention. q, k, v: (B, T, H, D) -> (B, T, H, D)."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("bthd,bshd->bhts", q, k) * scale
    if causal:
        t, s = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((t, s), dtype=torch.bool, device=q.device).tril()
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.einsum("bhts,bshd->bthd", probs.to(v.dtype), v)
