"""The port's flash attention (mxnet_tpu_torch/ops/flash_attention.py) and
plain attention (mxnet_tpu_torch/parallel/ring_attention.py) against the
JAX package's.

On the CPU the port's ``flash_fwd`` runs its kernel's plain PyTorch version
(the CUDA kernel itself is held against that plain version on the card by
chip_smoke.py). The JAX side runs its Pallas kernel in interpret mode, as
tests/test_pallas_ops.py does. Same numpy inputs for both. Tolerances are
test_pallas_ops.py's: 2e-3 forward and 5e-3 gradients in f32; 2e-2 in bf16
(test_fused_epilogue.py's bf16 tolerance).
"""
import os

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import MXNetError
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.parallel import attention as tattention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _qkv(b, t, h, d, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(b, t, h, d).astype(np.float32) for _ in range(3)]


def _jax(a, dtype):
    import jax.numpy as jnp
    return jnp.asarray(a).astype(jnp.dtype(dtype))


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


def _np(a):
    return a.detach().float().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a, np.float32)


@pytest.mark.parametrize("t", [32, 200], ids=["t32", "ragged_t200"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_forward_matches_pallas(dtype, causal, t):
    from mxnet_tpu.ops.pallas_kernels import flash_attention as jflash
    q, k, v = _qkv(2, t, 2, 16, 3)
    want = jflash(*(_jax(a, dtype) for a in (q, k, v)), causal=causal)
    got = fa.flash_attention(*(_torch(a, dtype) for a in (q, k, v)),
                             causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    tol = 2e-3 if dtype == "float32" else 2e-2
    assert np.isfinite(_np(want)).all()
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("t", [16, 200], ids=["t16", "ragged_t200"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_gradients_match_the_jax_custom_vjp(causal, t):
    import jax
    from mxnet_tpu.ops.pallas_kernels import flash_attention as jflash
    q, k, v = _qkv(1, t, 2, 8, 4)
    w = np.random.RandomState(5).randn(*q.shape).astype(np.float32)
    jgrads = jax.grad(
        lambda *a: (jflash(*a, causal=causal, scale=0.3) * w).sum(),
        argnums=(0, 1, 2))(*(_jax(a, "float32") for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, scale=0.3)
    out.backward(torch.from_numpy(w))
    for name, mine, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        np.testing.assert_allclose(_np(mine), _np(ref), rtol=5e-3,
                                   atol=5e-3, err_msg=name)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_attention_matches_jax(dtype, causal):
    """The port's plain attention (the CPU model path and the backward's
    recompute) against mxnet_tpu.parallel.ring_attention.attention, forward
    and gradients."""
    import jax
    from mxnet_tpu.parallel.ring_attention import attention as jattention
    q, k, v = _qkv(2, 24, 2, 8, 6)
    w = np.random.RandomState(7).randn(*q.shape).astype(np.float32)
    jargs = [_jax(a, dtype) for a in (q, k, v)]
    want, vjp = jax.vjp(lambda *a: jattention(*a, causal=causal), *jargs)
    jgrads = vjp(_jax(w, dtype))
    targs = [_torch(a, dtype).requires_grad_() for a in (q, k, v)]
    got = tattention(*targs, causal=causal)
    got.backward(_torch(w, dtype))
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    for name, mine, ref in zip("qkv", targs, jgrads):
        assert mine.grad.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(_np(mine.grad), _np(ref), rtol=tol,
                                   atol=tol, err_msg=name)


def test_plain_version_takes_strided_views_and_counts_no_launch():
    """The q/k/v views of a fused qkv projection go in as they are; CPU
    tensors never count as a kernel launch."""
    fa.reset_launches()
    b, t, h, d = 2, 40, 2, 8
    qkv = torch.randn(b, t, 3 * h * d, generator=torch.Generator()
                      .manual_seed(0))
    q, k, v = (z.reshape(b, t, h, d) for z in qkv.split(h * d, dim=-1))
    assert not q.is_contiguous()
    got = fa.flash_fwd(q, k, v, True, 0.25)
    want = fa.flash_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                        True, 0.25)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got, tattention(q, k, v, True, 0.25),
                               rtol=2e-5, atol=2e-5)
    assert fa.launches == {"flash_fwd": 0}


@pytest.mark.parametrize("bad", ["dtype", "rank", "d_not_8", "d_too_big",
                                 "shapes", "last_dim", "device"])
def test_flash_fwd_validates_its_inputs(bad):
    q = torch.randn(1, 8, 2, 16)
    k, v = q.clone(), q.clone()
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "rank":
        q, k, v = q[0], k[0], v[0]
    elif bad == "d_not_8":
        q, k, v = (torch.randn(1, 8, 2, 12) for _ in range(3))
    elif bad == "d_too_big":
        q, k, v = (torch.randn(1, 8, 1, 264) for _ in range(3))
    elif bad == "shapes":
        k = torch.randn(1, 9, 2, 16)
    elif bad == "last_dim":
        q = torch.randn(1, 8, 16, 2).transpose(2, 3)
    else:
        q, k, v = q.to("meta"), k.to("meta"), v.to("meta")
    with pytest.raises(MXNetError):
        fa.flash_fwd(q, k, v, False, 0.25)


def test_build_rule_names_the_flash_source():
    from mxnet_tpu_torch.ops import _build
    assert "flash_attention" in _build.SOURCES
    src = open(os.path.join(ROOT, "mxnet_tpu_torch", "csrc",
                            "flash_attention.cu")).read()
    assert "int mxt_flash_fwd(" in src and "_build_flash" in src
    assert "mxt_flash_fwd" in open(fa.__file__).read()
    assert "atomicAdd" not in src and "cudaMalloc" not in src
