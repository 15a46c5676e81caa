"""Linear-algebra operators (ref: the JAX package's ``ops/linalg.py``;
MXNet src/operator/tensor/la_op.cc): the ``_linalg_*`` family with batch
dims leading and the lower-triangular convention, plus ``moments`` and
``histogram``.

``gelqf`` is the QR of Aᵀ and ``syevd`` returns the eigenvectors as rows,
as in the JAX package. On the host torch and JAX both call LAPACK; on the
card cuSOLVER may choose other signs for the columns of Q and the
eigenvectors, so those two outputs are held by their invariants there
(L·Q = A, Q Qᵀ = I, Vᵀ diag(w) V = A), with no sign normalisation the JAX
package lacks.
"""
from __future__ import annotations

import math

import torch

from .registry import register

__all__ = []


def _t(x):
    return x.transpose(-1, -2)


@register("_linalg_gemm2", aliases=("linalg_gemm2",))
def _gemm2(a, b, transpose_a=False, transpose_b=False, alpha=1.0, axis=-2):
    x = _t(a) if transpose_a else a
    y = _t(b) if transpose_b else b
    return alpha * torch.matmul(x, y)


@register("_linalg_gemm", aliases=("linalg_gemm",))
def _gemm(a, b, c, transpose_a=False, transpose_b=False, alpha=1.0,
          beta=1.0, axis=-2):
    return _gemm2(a, b, transpose_a, transpose_b, alpha) + beta * c


@register("_linalg_potrf", aliases=("linalg_potrf",))
def _potrf(a, lower=True):
    l = torch.linalg.cholesky(a)
    return l if lower else _t(l)


@register("_linalg_potri", aliases=("linalg_potri",))
def _potri(l, lower=True):
    """A⁻¹ from A's Cholesky factor L: (L Lᵀ)⁻¹ = L⁻ᵀ L⁻¹."""
    eye = torch.eye(l.shape[-1], dtype=l.dtype, device=l.device) \
        .expand(l.shape)
    linv = torch.linalg.solve_triangular(l, eye, upper=False)
    return torch.matmul(_t(linv), linv)


@register("_linalg_trsm", aliases=("linalg_trsm",))
def _trsm(a, b, transpose=False, rightside=False, lower=True, alpha=1.0):
    """X with op(A) X = alpha B, or X op(A) = alpha B when ``rightside``;
    op(A) is Aᵀ when ``transpose``. Only A's ``lower`` (or upper) triangle
    is read."""
    tri = _t(a) if transpose else a
    upper = lower if transpose else not lower
    return torch.linalg.solve_triangular(tri, alpha * b, upper=upper,
                                         left=not rightside)


@register("_linalg_trmm", aliases=("linalg_trmm",))
def _trmm(a, b, transpose=False, rightside=False, lower=True, alpha=1.0):
    tri = torch.tril(a) if lower else torch.triu(a)
    if transpose:
        tri = _t(tri)
    return alpha * (torch.matmul(b, tri) if rightside
                    else torch.matmul(tri, b))


@register("_linalg_syrk", aliases=("linalg_syrk",))
def _syrk(a, transpose=False, alpha=1.0):
    return alpha * (torch.matmul(_t(a), a) if transpose
                    else torch.matmul(a, _t(a)))


@register("_linalg_gelqf", aliases=("linalg_gelqf",), num_outputs=2)
def _gelqf(a):
    """LQ: A = L Q with Q's rows orthonormal, through the QR of Aᵀ."""
    q, r = torch.linalg.qr(_t(a))
    return _t(r), _t(q)


@register("_linalg_syevd", aliases=("linalg_syevd",), num_outputs=2)
def _syevd(a):
    """(V, w): A = Vᵀ diag(w) V, eigenvalues ascending."""
    w, v = torch.linalg.eigh(a)
    return _t(v), w


@register("_linalg_sumlogdiag", aliases=("linalg_sumlogdiag",))
def _sumlogdiag(a):
    return torch.log(torch.diagonal(a, dim1=-2, dim2=-1)).sum(-1)


@register("_linalg_extractdiag", aliases=("linalg_extractdiag",))
def _extractdiag(a, offset=0):
    return torch.diagonal(a, offset=int(offset), dim1=-2, dim2=-1)


@register("_linalg_makediag", aliases=("linalg_makediag",))
def _makediag(a, offset=0):
    return torch.diag_embed(a, offset=int(offset), dim1=-2, dim2=-1)


def _trian_indices(n, offset, lower, device):
    fn = torch.tril_indices if lower else torch.triu_indices
    return fn(n, n, int(offset), device=device)


@register("_linalg_extracttrian", aliases=("linalg_extracttrian",))
def _extracttrian(a, offset=0, lower=True):
    rows, cols = _trian_indices(a.shape[-1], offset, lower, a.device)
    return a[..., rows, cols]


@register("_linalg_maketrian", aliases=("linalg_maketrian",))
def _maketrian(a, offset=0, lower=True):
    """The (n, n) matrix whose ``lower`` (or upper) triangle at
    ``offset`` holds ``a``; n comes from a's length as in the JAX package:
    len = n(n+1)/2 for offset 0, plus |offset|."""
    ln = a.shape[-1]
    n = int((math.sqrt(8 * ln + 1) - 1) / 2) + abs(int(offset))
    rows, cols = _trian_indices(n, offset, lower, a.device)
    out = a.new_zeros(a.shape[:-1] + (n, n))
    out[..., rows, cols] = a
    return out


@register("_linalg_inverse", aliases=("linalg_inverse", "inverse"))
def _inverse(a):
    return torch.linalg.inv(a)


@register("_linalg_det", aliases=("linalg_det", "det"))
def _det(a):
    return torch.linalg.det(a)


@register("_linalg_slogdet", aliases=("linalg_slogdet", "slogdet"),
          num_outputs=2)
def _slogdet(a):
    sign, logdet = torch.linalg.slogdet(a)
    return sign, logdet


@register("moments", num_outputs=2)
def _moments(data, axes=None, keepdims=False):
    """(mean, population variance) over ``axes`` (all when None)."""
    dims = tuple(axes) if axes is not None else tuple(range(data.dim()))
    return (data.mean(dim=dims, keepdim=bool(keepdims)),
            data.var(dim=dims, correction=0, keepdim=bool(keepdims)))


@register("histogram", differentiable=False, num_outputs=2)
def _histogram(data, *maybe_bins, bin_cnt=None, range=None):
    """(counts, edges) of ``jnp.histogram``: the bins as an array of
    edges, or ``bin_cnt`` equal bins over ``range`` (default: the data's
    min and max). A value on the last edge counts in the last bin; values
    outside the edges are not counted. Counts are float, like the data."""
    x = data.reshape(-1)
    fdt = data.dtype if data.is_floating_point() else torch.float32
    if maybe_bins:
        edges = maybe_bins[0].to(fdt)
    else:
        lo, hi = range if range is not None else (float(x.min()),
                                                  float(x.max()))
        # jnp.linspace's arithmetic: lo (1 - i/n) + hi i/n, then hi itself;
        # XLA divides by the constant n as a product with its reciprocal
        n = int(bin_cnt)
        step = torch.arange(n, dtype=fdt, device=data.device) * \
            torch.tensor(1.0 / n, dtype=fdt, device=data.device)
        edges = torch.cat([float(lo) * (1 - step) + float(hi) * step,
                           torch.full((1,), float(hi), dtype=fdt,
                                      device=data.device)])
    xf = x.to(fdt)
    idx = torch.searchsorted(edges, xf, right=True)
    idx = torch.where(xf == edges[-1], edges.numel() - 1, idx)
    counts = torch.zeros(edges.numel() + 1, dtype=fdt, device=data.device)
    counts.index_add_(0, idx, torch.ones_like(xf))
    return counts[1:edges.numel()], edges
