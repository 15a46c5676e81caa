"""The port's fused BN(+add)+ReLU epilogue (mxnet_tpu_torch/ops/
fused_bn_act.py) against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their kernels' plain PyTorch versions
(the CUDA kernels themselves are held against those plain versions on the
card by chip_smoke.py). The JAX side runs the Pallas kernels in interpret
mode, as tests/test_fused_epilogue.py does. Same numpy inputs for both.
Tolerances are test_fused_epilogue.py's: 2e-5 in f32, 2e-2 in bf16.
"""
import ast
import os

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import fused_bn_act as tk

EPS = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [(2, 7, 5, 9), (2, 4, 4, 256)]


def _tol(dtype):
    return dict(rtol=2e-5, atol=2e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
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


def test_cpu_tensors_use_plain_versions_and_count_no_launch():
    tk.reset_launches()
    x = torch.randn(6, 8)
    out = tk.bn_apply(x, None, torch.stack([torch.ones(8), torch.zeros(8)]))
    torch.testing.assert_close(out, torch.relu(x))
    tk.bn_stats(x)
    assert all(v == 0 for v in tk.launches.values())


@pytest.mark.parametrize("bad", ["dtype", "shape", "noncontig", "coef",
                                 "device", "ndim"])
def test_wrappers_validate_their_inputs(bad):
    x = torch.randn(8, 4)
    coef = torch.randn(2, 4)
    if bad == "dtype":
        args = (x.half(), None, coef)
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
    assert "atomicAdd" not in src            # deterministic reductions
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
