"""The port's fused BN(+add)+ReLU epilogue (mxnet_tpu_torch/ops/
fused_bn_act.py) against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their kernels' plain PyTorch versions
(the CUDA kernels themselves are held against those plain versions on the
card by chip_smoke.py). The JAX side runs the Pallas kernels in interpret
mode, as tests/test_fused_epilogue.py does. Same numpy inputs for both.
Tolerances are test_fused_epilogue.py's: 2e-5 in f32, 2e-2 in bf16; 2e-3 in
f16 (both sides compute in f32 and round to f16, whose unit roundoff is
2^-11).
"""
import ast
import importlib.util
import os
import re

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import fused_bn_act as tk

EPS = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(2, 7, 5, 9), (2, 4, 4, 256)]


def _tol(dtype):
    t = {"float32": 2e-5, "bfloat16": 2e-2, "float16": 2e-3}[dtype]
    return dict(rtol=t, atol=t)


def _inputs(shape, dtype, has_res, seed):
    rs = np.random.RandomState(seed)
    c = shape[-1]
    x = rs.randn(*shape).astype(np.float32)
    res = rs.randn(*shape).astype(np.float32) if has_res else None
    g = (rs.rand(c) + 0.5).astype(np.float32)
    b = rs.randn(c).astype(np.float32)
    dy = rs.randn(*shape).astype(np.float32)
    return x, res, g, b, dy


def _jax(a, dtype):
    import jax.numpy as jnp
    return None if a is None else jnp.asarray(a).astype(jnp.dtype(dtype))


def _torch(a, dtype):
    return None if a is None else torch.from_numpy(a).to(getattr(torch,
                                                                 dtype))


def _np(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.detach().float().numpy()


@pytest.mark.parametrize("shape", SHAPES, ids=["ragged", "c256"])
@pytest.mark.parametrize("has_res", [False, True], ids=["relu", "add_relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_fused_bn_act_matches_pallas(shape, has_res, dtype):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.pallas_kernels import fused_bn_act as jfused
    x, res, g, b, dy = _inputs(shape, dtype, has_res, 7)
    tol = _tol(dtype)

    jargs = [_jax(x, dtype), _jax(res, dtype), jnp.asarray(g),
             jnp.asarray(b)]
    if not has_res:
        jargs.pop(1)

    def jf(*a):
        return jfused(a[0], a[1] if has_res else None, a[-2], a[-1], EPS)

    (jo, jm, jv), vjp = jax.vjp(jf, *jargs)
    jgrads = vjp((_jax(dy, dtype), jnp.zeros_like(jm), jnp.zeros_like(jv)))

    tx = _torch(x, dtype).requires_grad_()
    tr = _torch(res, dtype).requires_grad_() if has_res else None
    tg = torch.from_numpy(g).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    to, tm, tv = tk.fused_bn_act(tx, tr, tg, tb, EPS)
    assert to.dtype == tx.dtype and to.shape == tx.shape
    assert tm.dtype == torch.float32 and tv.dtype == torch.float32
    np.testing.assert_allclose(_np(to), _np(jo), **tol)
    np.testing.assert_allclose(_np(tm), _np(jm), **tol)
    np.testing.assert_allclose(_np(tv), _np(jv), **tol)

    to.backward(_torch(dy, dtype))
    names = ("dx", "dres", "dgamma", "dbeta") if has_res \
        else ("dx", "dgamma", "dbeta")
    ours = (tx.grad, tr.grad, tg.grad, tb.grad) if has_res \
        else (tx.grad, tg.grad, tb.grad)
    for name, mine, ref in zip(names, ours, jgrads):
        assert mine.dtype == (tx.dtype if name in ("dx", "dres")
                              else torch.float32), name
        np.testing.assert_allclose(_np(mine), _np(ref), err_msg=name, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("kernel", ["stats", "apply", "apply_res",
                                    "bwd_stats", "bwd_apply",
                                    "bwd_apply_res"])
def test_each_plain_kernel_matches_its_pallas_kernel(kernel, dtype):
    """Each wrapper (on CPU: its plain version) against the Pallas kernel
    it replaces, called directly at a ragged (R, C)."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import pallas_kernels as pk
    rs = np.random.RandomState(11)
    r, c = 37, 24
    x, dy, out, res = (rs.randn(r, c).astype(np.float32) for _ in range(4))
    out = np.maximum(out, 0)            # a ReLU output: zeros mask g
    coef2 = np.stack([rs.randn(c), rs.rand(c) + 0.5]).astype(np.float32)
    coef5 = rs.randn(5, c).astype(np.float32)
    j = lambda a: _jax(a, dtype)        # noqa: E731
    t = lambda a: _torch(a, dtype)      # noqa: E731
    tc = torch.from_numpy
    if kernel == "stats":
        want = pk._bn_stats_call(j(x), True)
        got = tk.bn_stats(t(x))
    elif kernel.startswith("apply"):
        rr = res if kernel == "apply_res" else None
        want = pk._bn_apply_call(j(x), j(rr), jnp.asarray(coef2), True)
        got = tk.bn_apply(t(x), t(rr), tc(coef2))
    elif kernel == "bwd_stats":
        want = pk._bn_bwd_stats_call(j(dy), j(out), j(x), jnp.asarray(coef2),
                                     True)
        got = tk.bn_bwd_stats(t(dy), t(out), t(x), tc(coef2))
    else:
        has_res = kernel == "bwd_apply_res"
        want = pk._bn_bwd_apply_call(j(dy), j(out), j(x), jnp.asarray(coef5),
                                     has_res, True)
        got = tk.bn_bwd_apply(t(dy), t(out), t(x), tc(coef5), has_res)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(want) == len(got)
    for w, g in zip(want, got):
        # stats sum 37 rows: scale the tolerance by the magnitude of a sum
        tol = _tol(dtype) if g.shape[0] == r else \
            dict(rtol=_tol(dtype)["rtol"], atol=_tol(dtype)["atol"] * r)
        np.testing.assert_allclose(_np(g), _np(w), **tol)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CHIP_SMOKE = _chip_smoke()


def _path_sites():
    """chip_smoke.py's ResNet-50 epilogue sites (R, C): the shapes the main
    path gives bn_bwd_apply."""
    return [(r, c, "bfloat16") for r, c, _, _ in CHIP_SMOKE.path_sites()]


BWD_APPLY_SITES = _path_sites() + [(100003, 512, "bfloat16"),
                                   (1001, 9, "bfloat16"),
                                   (25088, 256, "float32")]


@pytest.mark.parametrize("r,c,dtype", BWD_APPLY_SITES,
                         ids=[f"{r}x{c}_{d}" for r, c, d in BWD_APPLY_SITES])
def test_bwd_apply_grid_covers_each_row_and_pack_once(r, c, dtype):
    """The row-tiled bn_bwd_apply's grid, as launch_bwd_apply builds it
    from ``_reduce_config``: block (bx, by) thread (x, y) owns the pack
    at column (bx * tx + x) * pack and the rows r0 + y, r0 + y + ty, ...
    of its chunk [by * rows_per_chunk, min(... + rows_per_chunk, R)).
    Every (row, pack) is covered exactly once, wide (16-byte packs) and
    narrow (VEC = 1, the unaligned or C-not-a-multiple path)."""
    dt = getattr(torch, dtype)
    for wide in ((1, 0) if c % tk._PACK[dt] == 0 else (0,)):
        tx, ty, chunks, rpc = tk._reduce_config(r, c, wide, dt)
        pack = tk._PACK[dt] if wide else 1
        assert tx >= 1 and ty >= 1 and tx * ty <= 256
        assert 1 <= chunks <= 65535 and (chunks - 1) * rpc < r
        grid_x = -(-c // (tx * pack))
        cols = (np.arange(grid_x)[:, None] * tx
                + np.arange(tx)[None, :]).ravel() * pack
        cols = cols[cols < c]
        assert np.array_equal(np.sort(cols), np.arange(0, c, pack))
        hits = np.zeros(r, np.int32)
        for by in range(chunks):
            r0 = by * rpc
            r1 = min(r0 + rpc, r)
            for y in range(ty):
                hits[r0 + y:r1:ty] += 1
        assert (hits == 1).all()


APPLY_SITES = sorted(set(BWD_APPLY_SITES
                         + [(r, c, "bfloat16") for r, c, _, _
                            in CHIP_SMOKE.v2_path_sites()]
                         + [(r, c, "float16") for r, c, _ in _path_sites()]
                         + [(6272 * 32 // 128, 256, "float32"),
                            (7, 64, "float16"), (1, 9, "float32"),
                            (100003, 24, "float16")]))


@pytest.mark.parametrize("kernel", ["bn_apply", "bn_bwd_apply"])
@pytest.mark.parametrize("r,c,dtype", APPLY_SITES,
                         ids=[f"{r}x{c}_{d}" for r, c, d in APPLY_SITES])
def test_apply_grid_walk_covers_each_row_and_pack_once(r, c, dtype, kernel):
    """The row-tiled bn_apply and bn_bwd_apply as their kernels walk the
    grid ``_reduce_config`` sizes: thread (x, y) of block (bx, by) owns the
    pack at column (bx * tx + x) * pack and reads rows r0 + y, r0 + y + ty,
    ... of its chunk in groups of ``APPLY_UNROLL`` (all loads issued
    first), then one guarded group of the rest. Every (row, pack) is
    written exactly once, wide and narrow, at the v1, v2, f16 and f32 path
    sites and the edge cases."""
    dt = getattr(torch, dtype)
    unroll = _unroll("apply")
    for wide in ((1, 0) if c % tk._PACK[dt] == 0 else (0,)):
        tx, ty, chunks, rpc = tk._reduce_config(r, c, wide, dt)
        pack = tk._PACK[dt] if wide else 1
        assert tx >= 1 and ty >= 1 and tx * ty <= 256
        assert 1 <= chunks <= 65535 and (chunks - 1) * rpc < r
        grid_x = -(-c // (tx * pack))
        cols = (np.arange(grid_x)[:, None] * tx
                + np.arange(tx)[None, :]).ravel() * pack
        cols = cols[cols < c]
        assert np.array_equal(np.sort(cols), np.arange(0, c, pack))
        hits = np.zeros(r, np.int32)
        for by in range(chunks):
            r0 = by * rpc
            r1 = min(r0 + rpc, r)
            for y in range(ty):
                groups, tail = _walk(r0, r1, y, ty, unroll)
                assert len(tail) < unroll
                for rows in groups + [tail]:
                    hits[np.asarray(rows, np.int64)] += 1
        assert (hits == 1).all()


def _walk(r0, r1, y, ty, unroll):
    """The rows thread row y of a reduction block reads in its chunk [r0,
    r1), as the kernel's loop reads them: whole groups of ``unroll`` rows
    (all loads issued before the first is used), then one guarded group of
    the rows left over. Returns (groups, tail)."""
    r = r0 + y
    groups = []
    while r + (unroll - 1) * ty < r1:
        groups.append([r + u * ty for u in range(unroll)])
        r += unroll * ty
    return groups, [r + u * ty for u in range(unroll - 1) if r + u * ty < r1]


def _finish_ranges(n, ty):
    """The pieces [y * per, min(n, (y + 1) * per)) of the last block's sum
    over n cluster partials, one per row of threads, per = ceil(n / ty)."""
    per = -(-n // ty)
    return [range(y * per, min(n, (y + 1) * per)) for y in range(ty)]


def _unroll(kernel):
    """Rows a reduction thread loads at a time, read from the source."""
    name = {"bn_stats": "STATS_UNROLL", "bn_bwd_stats": "BWD_STATS_UNROLL",
            "apply": "APPLY_UNROLL"}
    src = open(os.path.join(ROOT, "mxnet_tpu_torch", "csrc",
                            "fused_bn_act.cu")).read()
    n = name[kernel]   # a constant, or a build switch's default
    return int(re.search(rf"(?:constexpr int {n} =|#define MXT_{n}) (\d+)",
                         src).group(1))


STATS_SITES = [(r, c, d, k) for r, c, d in BWD_APPLY_SITES
               for k in ("bn_stats", "bn_bwd_stats")]


@pytest.mark.parametrize("r,c,dtype,kernel", STATS_SITES,
                         ids=[f"{k}_{r}x{c}_{d}"
                              for r, c, d, k in STATS_SITES])
def test_stats_grid_covers_each_row_and_pack_once(r, c, dtype, kernel):
    """The one-launch reductions' grid, as ``_reduce_stats_config`` sizes it
    for a 132-SM card: every (row, pack) is read exactly once, the groups of
    ``unroll`` rows and the guarded tail together cover each chunk, every
    row slot of a full chunk walks as many rows, the chunks fill whole
    clusters with only the
    last cluster holding chunks past R, and the last block's split of the
    cluster partials over its rows of threads covers each partial once.
    Wide (16-byte packs) and narrow (VEC = 1)."""
    dt = getattr(torch, dtype)
    unroll = _unroll(kernel)
    for wide in ((1, 0) if c % tk._PACK[dt] == 0 else (0,)):
        tx, ty, chunks, rpc = tk._reduce_stats_config(r, c, wide, dt, 132)
        pack = tk._PACK[dt] if wide else 1
        assert tx >= 1 and ty >= 1 and tx * ty <= 256
        assert 1 <= chunks <= 65535 and chunks % tk._CLUSTER == 0
        assert (chunks - tk._CLUSTER) * rpc < r
        assert rpc % ty == 0
        grid_x = -(-c // (tx * pack))
        cols = (np.arange(grid_x)[:, None] * tx
                + np.arange(tx)[None, :]).ravel() * pack
        cols = cols[cols < c]
        assert np.array_equal(np.sort(cols), np.arange(0, c, pack))
        hits = np.zeros(r, np.int32)
        for by in range(chunks):
            r0 = by * rpc
            r1 = min(r0 + rpc, r)
            for y in range(ty):
                groups, tail = _walk(r0, r1, y, ty, unroll)
                assert len(tail) < unroll
                if r1 == r0 + rpc:                 # a full chunk
                    assert unroll * len(groups) + len(tail) == rpc // ty
                for rows in groups + [tail]:
                    hits[np.asarray(rows, np.int64)] += 1
        assert (hits == 1).all()
        clusters = chunks // tk._CLUSTER
        seen = np.zeros(clusters, np.int32)
        for piece in _finish_ranges(clusters, ty):
            seen[np.asarray(list(piece), np.int64)] += 1
        assert (seen == 1).all()


def _kernel_order_sums(terms, r, cfg, unroll):
    """The one-launch kernels' order of addition, in plain torch. ``terms``
    is (2, rows, C) f32 with rows >= r; a row is added only if a thread's
    walk reads it, so rows past r never enter (the kernels never read
    them). Each thread adds its rows in the order of its walk; the block
    adds its ty row slots in order of y; each cluster adds its blocks in
    order of rank (chunk order); the last block adds the pieces of the
    cluster partials in order, each piece in order. f32 throughout; the
    kernel may fuse x * x + acc into one rounding, which this does not."""
    _, ty, chunks, rpc = cfg
    c = terms.shape[2]
    seqs = []
    for ch in range(chunks):
        r0 = ch * rpc
        r1 = min(r0 + rpc, r)
        for y in range(ty):
            groups, tail = _walk(r0, r1, y, ty, unroll)
            seqs.append([row for g in groups for row in g] + tail)
    width = max(1, max(len(q) for q in seqs))
    idx = torch.full((len(seqs), width), -1, dtype=torch.int64)
    for i, q in enumerate(seqs):
        idx[i, :len(q)] = torch.tensor(q, dtype=torch.int64)
    vals = terms[:, idx.clamp(min=0)]                  # (2, threads, L, C)
    vals = torch.where((idx >= 0)[None, :, :, None], vals,
                       torch.zeros((), dtype=torch.float32))
    acc = torch.zeros((2, len(seqs), c))
    for k in range(width):
        acc = acc + vals[:, :, k]
    acc = acc.view(2, chunks, ty, c)
    block = torch.zeros((2, chunks, c))
    for y in range(ty):
        block = block + acc[:, :, y]
    block = block.view(2, chunks // tk._CLUSTER, tk._CLUSTER, c)
    part = block[:, :, 0]
    for q in range(1, tk._CLUSTER):
        part = part + block[:, :, q]
    if part.shape[1] == 1:
        return part[:, 0]
    pieces = []
    for piece in _finish_ranges(part.shape[1], ty):
        s = torch.zeros((2, c))
        for i in piece:
            s = s + part[:, i]
        pieces.append(s)
    out = torch.zeros((2, c))
    for s in pieces:
        out = out + s
    return out


ORDER_CASES = [(60000, 24, "float32"), (60000, 24, "bfloat16"),
               (1001, 9, "bfloat16"), (3001, 40, "float32"),
               (7, 64, "bfloat16")]


@pytest.mark.parametrize("kernel", ["bn_stats", "bn_bwd_stats"])
@pytest.mark.parametrize("r,c,dtype,pad_inf",
                         [case + (False,) for case in ORDER_CASES]
                         + [(60000, 24, "bfloat16", True)],
                         ids=[f"{r}x{c}_{d}" for r, c, d in ORDER_CASES]
                         + ["60000x24_bfloat16_inf_past_R"])
def test_kernel_summation_order_matches_pallas(kernel, r, c, dtype,
                                               pad_inf):
    """The reductions' order of addition (per-thread walk, the block's row
    slots, the cluster's blocks in rank order, the chunk-ordered last sum
    over cluster partials, and a single cluster) against the Pallas kernel
    it replaces, in interpret mode, within 1e-5 of the sum of magnitudes
    plus 1e-6, the reductions' tolerance on the card. With ``pad_inf`` the
    buffer holds 37 rows past R with x = dy = Inf and out = 0: 0 * Inf
    would be NaN, so a finite, matching result shows that no row past R
    enters a sum (the product mask)."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import pallas_kernels as pk
    rs = np.random.RandomState(5)
    rows = r + (37 if pad_inf else 0)
    x, dy, out = (rs.randn(rows, c).astype(np.float32) for _ in range(3))
    out = np.maximum(out, 0)
    if pad_inf:
        x[r:] = dy[r:] = np.inf
        out[r:] = 0
    coef = np.stack([rs.randn(c), rs.rand(c) + 0.5]).astype(np.float32)
    xt, dyt, outt = (_torch(a, dtype) for a in (x, dy, out))
    j = lambda a: _jax(a[:r], dtype)        # noqa: E731
    dt = getattr(torch, dtype)
    cfg = tk._reduce_stats_config(r, c, tk._wide(xt), dt, 132)
    xf = xt.float()
    if kernel == "bn_stats":
        terms = torch.stack([xf, xf * xf])
        want = pk._bn_stats_call(j(x), True)
    else:
        g, xhat = tk._masked_g_xhat(dyt, outt, xt, torch.from_numpy(coef))
        terms = torch.stack([g, g * xhat])
        want = pk._bn_bwd_stats_call(j(dy), j(out), j(x), jnp.asarray(coef),
                                     True)
    got = _kernel_order_sums(terms, r, cfg, _unroll(kernel))
    scale = terms[:, :r].double().abs().sum(1)
    assert torch.isfinite(got).all()
    diff = (got.double() - torch.from_numpy(np.asarray(want, np.float64)))
    assert (diff.abs() <= 1e-5 * scale + 1e-6).all(), \
        float((diff.abs() / (scale + 1e-6)).max())


def test_cpu_tensors_use_plain_versions_and_count_no_launch():
    tk.reset_launches()
    x = torch.randn(6, 8)
    out = tk.bn_apply(x, None, torch.stack([torch.ones(8), torch.zeros(8)]))
    torch.testing.assert_close(out, torch.relu(x))
    tk.bn_stats(x)
    assert all(v == 0 for v in tk.launches.values())


@pytest.mark.parametrize("bad", ["dtype", "float64", "shape", "noncontig",
                                 "coef", "device", "ndim"])
def test_wrappers_validate_their_inputs(bad):
    """Inputs the kernels do not take raise (f32, bf16 and f16 are taken:
    test_f16_goes_through_every_wrapper)."""
    x = torch.randn(8, 4)
    coef = torch.randn(2, 4)
    if bad == "dtype":
        args = (x.to(torch.int32), None, coef)
    elif bad == "float64":
        args = (x.double(), None, coef)
    elif bad == "shape":
        args = (x, torch.randn(8, 5), coef)
    elif bad == "noncontig":
        args = (torch.randn(4, 8).t(), None, coef)
    elif bad == "coef":
        args = (x, None, coef.double())
    elif bad == "device":
        args = (x.to("meta"), None, coef.to("meta"))
    else:
        args = (x.reshape(2, 4, 4), None, coef)
    with pytest.raises(MXNetError):
        tk.bn_apply(*args)


def test_f16_goes_through_every_wrapper():
    """float16 activations: each wrapper's plain version in f16 (outputs
    in f16, sums in f32), the elementwise ones bit for bit against the
    f32 arithmetic rounded once to f16; the dtype table and the pack of 8
    that the card's kernels use."""
    assert tk._DTYPE_CODE[torch.float16] == 2 and \
        tk._PACK[torch.float16] == 8
    rs = np.random.RandomState(3)
    x, dy, res = (torch.from_numpy(rs.randn(33, 16).astype(np.float32))
                  .half() for _ in range(3))
    coef2 = torch.from_numpy(np.stack([rs.rand(16) + 0.5, rs.randn(16)])
                             .astype(np.float32))
    coef5 = torch.from_numpy(rs.randn(5, 16).astype(np.float32))
    out = tk.bn_apply(x, res, coef2)
    assert out.dtype == torch.float16
    want = torch.relu(x.float() * coef2[0] + coef2[1] + res.float()).half()
    assert torch.equal(out, want)
    assert tk.bn_stats(x).dtype == torch.float32
    assert tk.bn_bwd_stats(dy, out, x, coef2).dtype == torch.float32
    dx, dres = tk.bn_bwd_apply(dy, out, x, coef5, True)
    assert dx.dtype == dres.dtype == torch.float16
    assert torch.equal(dres, torch.where(out > 0, dy, 0.0).half())
    assert all(v == 0 for v in tk.launches.values())


def test_build_rule_points_at_the_cuda_source():
    """The ctypes bindings name exactly the source's C entry points, and
    each kernel's source names the TPU function it replaces."""
    from mxnet_tpu_torch.ops import _build
    src = open(os.path.join(ROOT, "mxnet_tpu_torch", "csrc",
                            "fused_bn_act.cu")).read()
    for fn, tpu in (("mxt_bn_stats", "_bn_stats_call"),
                    ("mxt_bn_apply", "_bn_apply_call"),
                    ("mxt_bn_bwd_stats", "_bn_bwd_stats_call"),
                    ("mxt_bn_bwd_apply", "_bn_bwd_apply_call")):
        assert f"int {fn}(" in src and tpu in src
        assert fn in open(tk.__file__).read()
    # deterministic reductions: the one atomic is the unsigned ticket, no
    # float atomics, and each reduction is one kernel launch
    assert re.findall(r"atomic\w*\(", src) == ["atomicAdd("]
    assert "atomicAdd(counter, 1u)" in src
    # f16: dtype code 2, packs of 8 halves, every kernel instantiated
    assert "FN<__half, 8>" in src and "__float2half_rn" in src
    # bn_apply is row-tiled: no 64-bit modulo per pack
    body = src[src.index("__global__ void bn_apply("):]
    assert "%" not in body[:body.index("\n}\n")]
    # the wrapper's grid arithmetic uses the source's cluster size
    assert f"constexpr int CLUSTER = {tk._CLUSTER};" in src
    for fn in ("launch_stats", "launch_bwd_stats"):
        body = src[src.index(f"void {fn}("):]
        assert body[:body.index("\n}\n")].count("<<<") == 1, fn
    assert "sm_90a" in " ".join(_build.NVCC_FLAGS)
    assert _build.BUILD_DIR.startswith(os.path.join(ROOT, "build"))


def test_port_imports_neither_jax_nor_the_jax_package():
    """An AST scan of every module of the port and of chip_smoke.py."""
    pkg = os.path.join(ROOT, "mxnet_tpu_torch")
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(pkg):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    for path in paths:
        f = os.path.relpath(path, ROOT)
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib",
                                               "mxnet_tpu"), \
                    f"{f} imports {n}"
    assert len(paths) >= 16
