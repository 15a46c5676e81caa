"""Connectionist Temporal Classification loss (ref: the JAX package's
``ops/ctc.py``; src/operator/nn/ctc_loss.cc in the reference).

The JAX op is a log-domain ``lax.scan`` of the forward (alpha) recursion
over time; here it is a Python loop in the same structure, and the
gradient is autograd's of that recursion, as the JAX op's is.

- ``data``: (T, B, A) activations, log-softmaxed inside in f32; the loss
  is cast back to the data's dtype.
- ``label``: (B, L) classes. ``blank_label`` ``"first"``: blank 0,
  padding 0; ``"last"``: blank A - 1, padding -1. Without
  ``label_lengths`` the non-padding entries are packed to the front of
  each row by a stable sort, mid-row padding included.
- ``data_lengths`` / ``label_lengths`` inputs, gated by
  ``use_data_lengths`` / ``use_label_lengths``; past its data length an
  example's alpha is carried unchanged.
- Output: (B,) negative log likelihood. Log-zero is the finite
  ``_NEG = -1e30``, so an infeasible alignment gives a huge finite loss
  (where ``torch.nn.functional.ctc_loss`` gives inf) and no NaN
  gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import check
from .registry import register

__all__ = ["ctc_loss"]

_NEG = -1e30


def _ctc_nll(log_probs, labels, data_len, label_len, blank):
    """Batched log-domain CTC forward pass. log_probs (T, B, A) f32;
    labels (B, L) int64; data_len, label_len (B,) int64. Returns the
    (B,) negative log likelihood."""
    t_len, b, a = log_probs.shape
    n_lab = labels.shape[1]
    s = 2 * n_lab + 1
    dev = log_probs.device
    s_idx = torch.arange(s, device=dev)
    lab_idx = torch.clamp(torch.div(s_idx - 1, 2, rounding_mode="floor"),
                          0, max(n_lab - 1, 0))
    ext = torch.where(s_idx[None, :] % 2 == 0, blank,
                      torch.clamp(labels, 0, a - 1)[:, lab_idx])    # (B, S)
    # the skip s-2 -> s is allowed at odd s when the two labels differ
    ext_m2 = torch.roll(ext, 2, dims=1)
    can_skip = (s_idx[None, :] >= 2) & (s_idx[None, :] % 2 == 1) \
        & (ext != ext_m2)
    valid_s = s_idx[None, :] < (2 * label_len + 1)[:, None]
    # log p of each extended symbol at every time step: (T, B, S)
    emit = torch.gather(log_probs, 2, ext.unsqueeze(0).expand(t_len, b, s))
    neg = torch.full((), _NEG, dtype=log_probs.dtype, device=dev)
    alpha = torch.where((s_idx[None, :] <= 1) & valid_s, emit[0], neg)
    for t in range(1, t_len):
        a1 = F.pad(alpha, (1, 0), value=_NEG)[:, :s]
        a2 = torch.where(can_skip, F.pad(alpha, (2, 0), value=_NEG)[:, :s],
                         neg)
        new = torch.logaddexp(torch.logaddexp(alpha, a1), a2) + emit[t]
        new = torch.where(valid_s, new, neg)
        # past the end of this example's sequence, alpha is carried
        alpha = torch.where((t < data_len)[:, None], new, alpha)
    rows = torch.arange(b, device=dev)
    end_blank = alpha[rows, torch.clamp(2 * label_len, 0, s - 1)]
    end_label = torch.where(
        label_len > 0, alpha[rows, torch.clamp(2 * label_len - 1, 0, s - 1)],
        neg)
    return -torch.logaddexp(end_blank, end_label)


@register("CTCLoss", aliases=("ctc_loss", "_contrib_CTCLoss",
                              "_contrib_ctc_loss"))
def ctc_loss(data, label, *maybe_lengths, use_data_lengths=False,
             use_label_lengths=False, blank_label="first"):
    """CTC negative log likelihood (ref: src/operator/nn/ctc_loss.cc)."""
    check(blank_label in ("first", "last"),
          f"blank_label must be 'first' or 'last', got {blank_label!r}")
    t_len, b, a = data.shape
    blank = 0 if blank_label == "first" else a - 1
    pad = 0 if blank_label == "first" else -1
    rest = list(maybe_lengths)
    data_len = rest.pop(0) if use_data_lengths else None
    label_len = rest.pop(0) if use_label_lengths else None
    if data_len is None:
        data_len = torch.full((b,), t_len, dtype=torch.int64,
                              device=data.device)
    else:
        data_len = data_len.detach().to(torch.int32).to(torch.int64)
    labels = label.detach().to(torch.int32).to(torch.int64)
    if label_len is None:
        # pack non-pad entries to the front, mid-row padding included
        # (ref: ctc_loss.cc LabelTensorToPackedVector); the stable sort on
        # the pad mask keeps the labels' order
        is_pad = labels == pad
        order = torch.sort(is_pad.to(torch.int32), dim=1, stable=True)[1]
        labels = torch.gather(labels, 1, order)
        label_len = (~is_pad).to(torch.int64).sum(dim=1)
    else:
        label_len = label_len.detach().to(torch.int32).to(torch.int64)
    log_probs = torch.log_softmax(data.to(torch.float32), dim=-1)
    return _ctc_nll(log_probs, labels, data_len, label_len,
                    blank).to(data.dtype)
