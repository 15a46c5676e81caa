"""The flash-attention registry op through ``mx.nd`` in both packages:
``mx.nd.contrib.flash_attention`` (and ``mx.nd.flash_attention``) and the
two interleaved self-attention ops, forward and gradients under
``autograd.record()``.

The JAX op runs its Pallas kernel in interpret mode on the CPU, as
tests/test_torch_flash_attention.py runs it; the port's op runs the
kernels' plain PyTorch version on CPU tensors and counts no launch (the
CUDA kernels are held to that plain version on the card by
chip_smoke.py's ``flash_registry`` phase). Tolerances are that file's:
2e-3 forward and 5e-3 gradients in f32, 2e-2 in bf16.
"""
import numpy as np
import pytest

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.ops import flash_attention as fa


def _inputs(shapes, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*s).astype(np.float32) for s in shapes]


def _run(nd, ag, fn, arrays, head, dtype):
    xs = [nd.array(a).astype(dtype) for a in arrays]
    for x in xs:
        x.attach_grad()
    with ag.record():
        out = fn(nd, *xs)
    out.backward(nd.array(head).astype(dtype))
    f32 = [out] + [x.grad for x in xs]
    return [a.astype("float32").asnumpy() for a in f32]


def _both(fn, arrays, dtype="float32"):
    out = fn(jnd, *[jnd.array(a) for a in arrays])
    head = np.random.RandomState(1).randn(*out.shape).astype(np.float32)
    want = _run(jnd, jag, fn, arrays, head, dtype)
    before = dict(fa.launches)
    with mt.cpu():
        got = _run(tnd, tag, fn, arrays, head, dtype)
    assert dict(fa.launches) == before       # the plain version: no launch
    return got, want


def _close(got, want, fwd_tol, grad_tol):
    np.testing.assert_allclose(got[0], want[0], rtol=fwd_tol, atol=fwd_tol)
    for k, (g, w) in enumerate(zip(got[1:], want[1:])):
        np.testing.assert_allclose(g, w, rtol=grad_tol, atol=grad_tol,
                                   err_msg=f"gradient {k}")


@pytest.mark.parametrize("t", [16, 40], ids=["t16", "ragged_t40"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_contrib_flash_attention_matches_jax(causal, t):
    arrays = _inputs([(2, t, 2, 8)] * 3, 3)
    got, want = _both(lambda nd, q, k, v: nd.contrib.flash_attention(
        q, k, v, causal=causal), arrays)
    _close(got, want, 2e-3, 5e-3)


def test_top_level_name_and_scale_match_jax():
    arrays = _inputs([(1, 24, 2, 12)] * 3, 4)
    got, want = _both(lambda nd, q, k, v: nd.flash_attention(
        q, k, v, causal=True, scale=0.2), arrays)
    _close(got, want, 2e-3, 5e-3)


def test_contrib_flash_attention_bf16_matches_jax():
    arrays = _inputs([(1, 32, 2, 16)] * 3, 5)
    got, want = _both(lambda nd, q, k, v: nd.contrib.flash_attention(
        q, k, v, causal=True), arrays, "bfloat16")
    _close(got, want, 2e-2, 2e-2)


@pytest.mark.parametrize("heads", [1, 3])
def test_interleaved_selfatt_ops_match_jax(heads):
    t, b, d = 5, 2, 4
    qkv, = _inputs([(t, b, 3 * heads * d)], 6)

    def chain(nd, x):
        att = nd.contrib.interleaved_matmul_selfatt_qk(x, heads=heads)
        att = nd.softmax(att, axis=-1)
        return nd.contrib.interleaved_matmul_selfatt_valatt(x, att,
                                                            heads=heads)

    got, want = _both(chain, [qkv])
    _close(got, want, 1e-5, 1e-5)
    scores = _both(lambda nd, x: nd.contrib.interleaved_matmul_selfatt_qk(
        x, heads=heads), [qkv])
    assert scores[0][0].shape == (b * heads, t, t)
    _close(*scores, 1e-5, 1e-5)
