"""Plain softmax attention and ring attention over a sequence-parallel
mesh axis (ref: the JAX package's ``parallel/ring_attention.py``).

``attention``: the order of roundings is the JAX function's: the logits
einsum runs in the input dtype and is scaled there, causal positions get
``-1e30``, the softmax runs in f32 and the probabilities are cast to
``v.dtype`` before the second einsum.

``ring_attention``: each rank of the ``sp`` axis holds one block of the
sequence (its local ``(B, T/n, H, D)`` q, k and v). The K / V blocks
rotate around the ring with ``collectives.ppermute_ring`` while each rank
accumulates its queries' attention with an online softmax in f32
(blockwise attention, Liu et al. 2310.01889), causal by global position
(``sp`` index times the block length). XLA-lowered code in the JAX
package, ordinary PyTorch here: autograd runs back through the rotations
(the inverse shift). A rank's heads are whatever it holds: under ``tp``
its local heads.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["attention", "ring_attention"]


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


def ring_attention(q, k, v, mesh, axis: str = "sp", causal: bool = False,
                   scale: Optional[float] = None):
    """Ring attention over this rank's sequence block: q, k, v
    ``(B, T_local, H, D)`` -> ``(B, T_local, H, D)`` in q's dtype."""
    from .collectives import ppermute_ring
    n = mesh.axis_size(axis)
    if n == 1:
        return attention(q, k, v, causal=causal, scale=scale)
    sc = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    b, t_loc, h, d = q.shape
    my = mesh.axis_index(axis)
    q32 = q.float()
    o = q32.new_zeros((b, h, t_loc, d))
    m = q32.new_full((b, h, t_loc), -math.inf)
    l_sum = q32.new_zeros((b, h, t_loc))
    qpos = my * t_loc + torch.arange(t_loc, device=q.device)
    k_cur, v_cur = k, v
    for i in range(n):
        src = (my - i) % n          # whose block this rank holds now
        logits = torch.einsum("bthd,bshd->bhts", q32, k_cur.float()) * sc
        mask = None
        if causal:
            kpos = src * t_loc + torch.arange(t_loc, device=q.device)
            mask = (qpos[:, None] >= kpos[None, :])[None, None]
            logits = torch.where(mask, logits, -1e30)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        p = torch.exp(logits - m_new[..., None])
        if mask is not None:
            # fully masked rows: kill the exp(0) = 1 artifact
            p = p * mask.to(p.dtype)
        corr = torch.exp(m - m_new)
        l_sum = l_sum * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum(
            "bhts,bshd->bthd", p, v_cur.float()).transpose(1, 2)
        m = m_new
        if i < n - 1:
            k_cur = ppermute_ring(k_cur, mesh, axis)
            v_cur = ppermute_ring(v_cur, mesh, axis)
    out = o / l_sum[..., None]
    return out.transpose(1, 2).to(q.dtype)
