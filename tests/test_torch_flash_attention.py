"""The port's flash attention (mxnet_tpu_torch/ops/flash_attention.py) and
plain attention (mxnet_tpu_torch/parallel/ring_attention.py) against the
JAX package's.

On the CPU the port's ``flash_fwd`` runs its kernel's plain PyTorch version
(the CUDA kernel itself is held against that plain version on the card by
chip_smoke.py). The JAX side runs its Pallas kernel in interpret mode, as
tests/test_pallas_ops.py does. Same numpy inputs for both. Tolerances are
test_pallas_ops.py's: 2e-3 forward and 5e-3 gradients in f32; 2e-2 in bf16
(test_fused_epilogue.py's bf16 tolerance); 5e-3 forward and 2e-2 gradients
in f16 (its unit roundoff is 2^-11, bf16's 2^-8). Both kernels' own
algorithms are emulated tile by tile in plain torch here and held to the JAX
kernel at their route's tolerance: the tensor-core route (P rounded to the
input type, D padded to a multiple of 64) and the general route (3xTF32
products, TF32 emulated by rounding away the low 13 bits of the
significand).
"""
import math
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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_forward_matches_pallas(dtype, causal, t):
    from mxnet_tpu.ops.pallas_kernels import flash_attention as jflash
    q, k, v = _qkv(2, t, 2, 16, 3)
    want = jflash(*(_jax(a, dtype) for a in (q, k, v)), causal=causal)
    got = fa.flash_attention(*(_torch(a, dtype) for a in (q, k, v)),
                             causal=causal)
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    tol = {"float32": 2e-3, "bfloat16": 2e-2, "float16": 5e-3}[dtype]
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


def _grads_against_jax(q, k, v, w, dtype, causal, scale):
    """Gradients of sum(flash_attention * w) in both packages."""
    import jax
    from mxnet_tpu.ops.pallas_kernels import flash_attention as jflash
    jgrads = jax.grad(
        lambda *a: (jflash(*a, causal=causal, scale=scale).astype("float32")
                    * w).sum(), argnums=(0, 1, 2))(
        *(_jax(a, dtype) for a in (q, k, v)))
    tq, tk, tv = (_torch(a, dtype).requires_grad_() for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal, scale=scale)
    out.backward(_torch(w, dtype))
    return (tq.grad, tk.grad, tv.grad), jgrads


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_flash_f16_gradients_match_the_jax_custom_vjp(causal):
    """f16 forward and gradients (both packages recompute the backward
    through plain attention in f16) at 2e-2, ragged T 40."""
    from mxnet_tpu.ops.pallas_kernels import flash_attention as jflash
    q, k, v = _qkv(1, 40, 2, 16, 9)
    w = np.random.RandomState(10).randn(*q.shape).astype(np.float32)
    want = jflash(*(_jax(a, "float16") for a in (q, k, v)), causal=causal,
                  scale=0.3)
    got = fa.flash_attention(*(_torch(a, "float16") for a in (q, k, v)),
                             causal=causal, scale=0.3)
    assert got.dtype == torch.float16
    np.testing.assert_allclose(_np(got), _np(want), rtol=5e-3, atol=5e-3)
    mine, ref = _grads_against_jax(q, k, v, w, "float16", causal, 0.3)
    for name, g, r in zip("qkv", mine, ref):
        assert g.dtype == torch.float16 and str(r.dtype) == "float16"
        np.testing.assert_allclose(_np(g), _np(r), rtol=2e-2, atol=2e-2,
                                   err_msg=name)


@pytest.mark.parametrize("d", [12, 100, 320, 512])
def test_flash_takes_any_head_dim_as_pallas_does(d):
    """f32 at head dims the tensor-core route never sees (not a multiple of
    8, above 256): forward at 2e-3 and gradients at 5e-3 against the
    Pallas kernel in interpret mode, causal, ragged T 40."""
    from mxnet_tpu.ops.pallas_kernels import flash_attention as jflash
    q, k, v = _qkv(1, 40, 2, d, 11)
    w = np.random.RandomState(12).randn(*q.shape).astype(np.float32)
    scale = 1.0 / math.sqrt(d)
    want = jflash(*(_jax(a, "float32") for a in (q, k, v)), causal=True,
                  scale=scale)
    got = fa.flash_fwd(*(_torch(a, "float32") for a in (q, k, v)), True,
                       scale)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-3, atol=2e-3)
    mine, ref = _grads_against_jax(q, k, v, w, "float32", True, scale)
    for name, g, r in zip("qkv", mine, ref):
        np.testing.assert_allclose(_np(g), _np(r), rtol=5e-3, atol=5e-3,
                                   err_msg=name)


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
    assert fa.launches == {"flash_fwd": 0, "flash_fwd_tc": 0,
                           "flash_fwd_general": 0}


def _offset_view(b, t, h, d, dtype):
    """A contiguous (B, T, H, D) view one element off 16-byte alignment."""
    buf = torch.zeros(b * t * h * d + 1, dtype=dtype)
    return buf[1:].view(b, t, h, d)


ROUTE_CASES = [
    ("bf16_d64", "tc"), ("bf16_d128", "tc"), ("bf16_d64_qkv_views", "tc"),
    ("f16_d64", "tc"), ("f16_d128_qkv_views", "tc"), ("bf16_d8", "tc"),
    ("bf16_d32", "tc"), ("f16_d80", "tc"), ("bf16_d96", "tc"),
    ("bf16_d256", "tc"), ("f16_d256", "tc"),
    ("f32_d64", "general"), ("f32_d128", "general"),
    ("bf16_d100", "general"), ("f16_d12", "general"),
    ("bf16_d264", "general"), ("f32_d512", "general"),
    ("bf16_d64_offset_view", "general"), ("f16_d80_offset_view", "general"),
    ("f16_d36_qkv_views", "general")]


@pytest.mark.parametrize("case,route", ROUTE_CASES,
                         ids=[f"{c}-{r}" for c, r in ROUTE_CASES])
def test_route_rule_dispatches_by_shape(case, route):
    """bf16 or f16 with D a multiple of 8 up to 256 and 16-byte aligned
    pointers and (b, t, h) strides takes the tensor-core kernel; everything
    else (f32, other D, unaligned views: qkv views of D 36 have 216-byte
    strides) the general one."""
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
             "f16": torch.float16}[case.split("_")[0]]
    d = int(case.split("_d")[1].split("_")[0])
    if case.endswith("qkv_views"):
        qkv = torch.zeros(2, 40, 3 * 2 * d, dtype=dtype)
        q, k, v = (z.reshape(2, 40, 2, d)
                   for z in qkv.split(2 * d, dim=-1))
    elif case.endswith("offset_view"):
        q = k = v = _offset_view(2, 40, 2, d, dtype)
    else:
        q = k = v = torch.zeros(2, 40, 2, d, dtype=dtype)
    assert fa.flash_route(q, k, v) == route


def test_general_route_copy_unit_follows_alignment():
    """The general kernel's copy width: the largest of 16, 8 and 4 bytes
    that divides every pointer and (b, t, h) stride, else the element."""
    f32 = torch.zeros(2, 40, 2, 12)
    assert fa._unit((f32,) * 3) == 16
    assert fa._unit((_offset_view(2, 40, 2, 12, torch.float32),) * 3) == 4
    bf = torch.zeros(2, 40, 2, 100, dtype=torch.bfloat16)
    assert fa._unit((bf,) * 3) == 8
    assert fa._unit((_offset_view(2, 40, 2, 64, torch.float16),) * 3) == 2


def _tc_emulation(q, k, v, causal, scale):
    """The tensor-core kernel's algorithm in plain torch: D padded with
    zeros to a multiple of 64 (TMA's fill past the true D), 128-row query
    tiles, K/V tiles of 128 rows for D <= 128 and 64 above (causal: up to
    the tile that holds the query tile's last row), f32 scores of the
    16-bit inputs, a running max m and sum l in base 2 with the scale
    folded into log2(e), P rounded to the input type for the P V product
    (f32 accumulation), O / l in q's dtype and the true D at the end."""
    b, t, h, d = q.shape
    dp = -(-d // 64) * 64
    bn = 128 if dp <= 128 else 64
    qf, kf, vf = (torch.nn.functional.pad(x.float(), (0, dp - d))
                  .transpose(1, 2) for x in (q, k, v))
    c = scale * math.log2(math.e)
    out = torch.empty(b, h, t, dp)
    for q0 in range(0, t, 128):
        rows = torch.arange(q0, min(q0 + 128, t))
        qi = qf[:, :, q0:q0 + 128]
        m = torch.full(qi.shape[:3], -math.inf)
        l = torch.zeros(qi.shape[:3])
        o = torch.zeros(qi.shape)
        k_end = min(q0 + 128, t) if causal else t
        for k0 in range(0, k_end, bn):
            cols = torch.arange(k0, min(k0 + bn, t))
            x = qi @ kf[:, :, k0:k0 + bn].transpose(-1, -2) * c
            if causal:
                x = torch.where(cols[None, :] > rows[:, None], -1e30, x)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            o = o * alpha[..., None] + \
                p.to(q.dtype).float() @ vf[:, :, k0:k0 + bn]
            m = m_new
        out[:, :, q0:q0 + 128] = o / l[..., None]
    return out[..., :d].transpose(1, 2).to(q.dtype)


def _tc_tolerance(want, v):
    """The tensor-core route's tolerance: 2e-5 + 2^-7 |want| + 2^-8 max|v|
    in bf16, 2e-5 + 2^-10 |want| + 2^-11 max|v| in f16."""
    rel, pv = (2.0 ** -7, 2.0 ** -8) if v.dtype == torch.bfloat16 \
        else (2.0 ** -10, 2.0 ** -11)
    return 2e-5 + rel * np.abs(want) + pv * float(v.float().abs().max())


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_tensor_core_algorithm_is_within_its_tolerance_of_pallas(causal, d):
    """The tile-wise emulation of the tensor-core route against the JAX
    Pallas kernel (interpret mode) on bf16 inputs, ragged T 200, within the
    route's stated tolerance: |got - want| <= 2e-5 + 2^-7 |want| + 2^-8
    max|v| (P in bf16 moves the output by at most 2^-8 max|v|)."""
    from mxnet_tpu.ops.pallas_kernels import flash_attention as jflash
    q, k, v = _qkv(2, 200, 2, d, 8)
    scale = 1.0 / math.sqrt(d)
    want = _np(jflash(*(_jax(a, "bfloat16") for a in (q, k, v)),
                      causal=causal, scale=scale))
    tq, tk, tv = (_torch(a, "bfloat16") for a in (q, k, v))
    got = _np(_tc_emulation(tq, tk, tv, causal, scale))
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= _tc_tolerance(want, tv)).all()
    # the emulation is the algorithm, not the plain version renamed
    assert not np.array_equal(got, _np(fa.flash_fwd(tq, tk, tv, causal,
                                                    scale)))


TC_CASES = [("float16", 64), ("float16", 128), ("bfloat16", 80),
            ("float16", 96), ("float16", 256)]


@pytest.mark.parametrize("dtype,d", TC_CASES,
                         ids=[f"{a}_d{d}" for a, d in TC_CASES])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_tensor_core_algorithm_at_f16_and_padded_d_is_within_tolerance(
        causal, dtype, d):
    """The same emulation in f16 (P rounded to f16) and at head dims padded
    to the next multiple of 64 (80 and 96 to 128; 256 with 64-key tiles)
    against the Pallas kernel on the same 16-bit inputs, ragged T 200,
    within the route's tolerance for the dtype."""
    from mxnet_tpu.ops.pallas_kernels import flash_attention as jflash
    q, k, v = _qkv(1, 200, 2, d, 13)
    scale = 1.0 / math.sqrt(d)
    want = _np(jflash(*(_jax(a, dtype) for a in (q, k, v)), causal=causal,
                      scale=scale))
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    got = _np(_tc_emulation(tq, tk, tv, causal, scale))
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= _tc_tolerance(want, tv)).all()
    assert not np.array_equal(got, _np(fa.flash_fwd(tq, tk, tv, causal,
                                                    scale)))


def _tf32(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 rounds: to nearest, ties away
    from zero, by adding half a unit of the 13 low bits of the significand
    to the magnitude and masking them off."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm3(a, b, passes):
    """a @ b with TF32 operands: 3 passes (hi*lo + lo*hi + hi*hi of the
    split operands), 2 (b exact in TF32: a's two halves) or 1 (both
    rounded once). Products are exact and summed in float64, as the
    tensor cores add exact products, then rounded to f32."""
    if passes == 1:
        return (_tf32(a).double() @ _tf32(b).double()).float()
    ah, al = _split(a)
    if passes == 2:
        return (al.double() @ b.double() + ah.double() @ b.double()).float()
    bh, bl = _split(b)
    return (al.double() @ bh.double() + ah.double() @ bl.double()
            + ah.double() @ bh.double()).float()


def _general_emulation(q, k, v, causal, scale, passes=3):
    """The general kernel's algorithm in plain torch: 64-row query tiles,
    64-key tiles (causal: up to the diagonal tile), S from TF32 products
    (3 passes for f32 inputs, 1 for 16-bit ones, which are exact in TF32),
    the online softmax in f32 with exp, P V from the split P (3 passes
    against f32 V, 2 against 16-bit V), O / l in q's dtype. ``passes=1``
    rounds every operand to TF32 once instead."""
    b, t, h, d = q.shape
    exact = q.dtype != torch.float32
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    out = torch.empty(b, h, t, d)
    for q0 in range(0, t, 64):
        rows = torch.arange(q0, min(q0 + 64, t))
        qi = qf[:, :, q0:q0 + 64]
        m = torch.full(qi.shape[:3], -math.inf)
        l = torch.zeros(qi.shape[:3])
        o = torch.zeros(qi.shape[:3] + (d,))
        k_end = min(q0 + 64, t) if causal else t
        for k0 in range(0, k_end, 64):
            cols = torch.arange(k0, min(k0 + 64, t))
            kt = kf[:, :, k0:k0 + 64].transpose(-1, -2)
            x = (qi @ kt if exact and passes == 3
                 else _mm3(qi, kt, passes)) * scale
            if causal:
                x = torch.where(cols[None, :] > rows[:, None], -1e30, x)
            m_new = torch.maximum(m, x.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(x - m_new[..., None])
            l = l * alpha + p.sum(-1)
            vt = vf[:, :, k0:k0 + 64]
            o = o * alpha[..., None] + _mm3(
                p, vt, 1 if passes == 1 else (2 if exact else 3))
            m = m_new
        out[:, :, q0:q0 + 64] = o / l[..., None]
    return out.transpose(1, 2).to(q.dtype)


@pytest.mark.parametrize("d", [12, 64, 100, 512])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_3xtf32_algorithm_is_within_2e5_of_pallas(causal, d):
    """The general route's emulation on f32 inputs against the Pallas
    kernel (interpret mode), ragged T 150: every element within 2e-5
    absolute, the f32 tolerance on the card. One TF32 pass instead of
    three misses it at D 512, so the split is what holds it."""
    from mxnet_tpu.ops.pallas_kernels import flash_attention as jflash
    q, k, v = _qkv(1, 150, 2, d, 14)
    scale = 1.0 / math.sqrt(d)
    want = _np(jflash(*(_jax(a, "float32") for a in (q, k, v)),
                      causal=causal, scale=scale))
    tq, tk, tv = (_torch(a, "float32") for a in (q, k, v))
    got = _np(_general_emulation(tq, tk, tv, causal, scale))
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 2e-5
    if d == 512:
        one = _np(_general_emulation(tq, tk, tv, causal, scale, passes=1))
        assert np.abs(one - want).max() > 2e-5


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_general_algorithm_on_16bit_inputs_is_within_tolerance(dtype):
    """The general route on 16-bit inputs (one pass for Q K^T, two for
    P V) at D 100, causal, against Pallas: 2e-5 plus one unit in the last
    place of the output (2^-7 |want| in bf16, 2^-10 |want| in f16)."""
    from mxnet_tpu.ops.pallas_kernels import flash_attention as jflash
    q, k, v = _qkv(1, 150, 2, 100, 15)
    scale = 0.1
    want = _np(jflash(*(_jax(a, dtype) for a in (q, k, v)), causal=True,
                      scale=scale))
    tq, tk, tv = (_torch(a, dtype) for a in (q, k, v))
    got = _np(_general_emulation(tq, tk, tv, True, scale))
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -10
    assert (np.abs(got - want) <= 2e-5 + ulp * np.abs(want)).all()


@pytest.mark.parametrize("bad", ["dtype", "float64", "rank", "d_not_8",
                                 "d_too_big", "shapes", "last_dim",
                                 "device"])
def test_flash_fwd_validates_its_inputs(bad):
    """Bad inputs raise; the head dims the route rule once refused (D 12,
    D 264) are inputs like any other now and compute the plain result."""
    q = torch.randn(1, 8, 2, 16)
    k, v = q.clone(), q.clone()
    if bad == "dtype":
        q, k, v = (x.to(torch.int32) for x in (q, k, v))
    elif bad == "float64":
        q, k, v = q.double(), k.double(), v.double()
    elif bad == "rank":
        q, k, v = q[0], k[0], v[0]
    elif bad in ("d_not_8", "d_too_big"):
        shape = (1, 8, 2, 12) if bad == "d_not_8" else (1, 8, 1, 264)
        q, k, v = (torch.randn(*shape) for _ in range(3))
        got = fa.flash_fwd(q, k, v, False, 0.25)
        torch.testing.assert_close(got, tattention(q, k, v, False, 0.25),
                                   rtol=2e-5, atol=2e-5)
        return
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
    assert "int mxt_flash_fwd_tc(" in src and "wgmma.mma_async" in src
    assert "mma.sync.aligned.m16n8k8" in src and "mma3(" in src
    assert "0xFFFFE000u" in src   # TF32 rounding clears the low 13 bits
    assert "cp.async.ca.shared.global" in src
    assert "CU_TENSOR_MAP_DATA_TYPE_FLOAT16" in src
    wrapper = open(fa.__file__).read()
    assert "mxt_flash_fwd" in wrapper and "mxt_flash_fwd_tc" in wrapper
    assert "atomicAdd" not in src and "cudaMalloc" not in src
    # TMA tensor maps come from the driver API
    assert "-lcuda" in _build.EXTRA_FLAGS["flash_attention"]
    for rule in ("2^-8 max|v|", "2^-11 max|v|", "3xTF32"):
        assert rule in fa.flash_fwd.__doc__
