"""8-bit residuals (``MXNET_RESID_DTYPE``) and int8 training convolutions
(``MXNET_CONV_COMPUTE=int8``): the port's ``ops/resid8.py`` against the
JAX package's on the CPU.

- ``_sat_cast`` stores the JAX package's fp8 bytes for both formats,
  outliers beyond the format's range and NaN included;
- the fp8-residual convolution's forward is the plain one bit for bit,
  its dx is the plain dx bit for bit, its dW the JAX package's within
  1e-5 of the largest (both read the same fp8 input);
- the ReLU's mask comes from its fp8 copy, and the convolution after it
  saves that same copy (one fp8 tensor per activation, as XLA's CSE keeps
  in the JAX package);
- the composed BatchNorm core saves fp8 xhat: its gradients are the JAX
  fp8 core's within 1e-5;
- ``conv_int8_train``: forward and both gradients against the JAX
  package's, f32 within 2e-5, bf16 within 2e-2;
- a small conv net trained one step under each flag, eager and
  hybridized, against the JAX package's step.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import resid8 as jr8
from mxnet_tpu.ops.nn import _make_bn_core

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.ops import resid8 as tr8

DN = ("NHWC", "OHWI", "NHWC")
FP8 = ("float8_e4m3fn", "float8_e5m2")


def _rs(seed):
    return np.random.RandomState(seed)


def _f32(rs, *shape, scale=1.0):
    return ((rs.rand(*shape) - 0.5) * 2 * scale).astype(np.float32)


def _tconv(x, w):
    return tnn.convolution(x, w, kernel=(3, 3), pad=(1, 1),
                           num_filter=w.shape[0], no_bias=True,
                           layout="NHWC")


def _vjp_t(fn, *xs, dy):
    ts = [torch.from_numpy(np.array(x)).requires_grad_() for x in xs]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(np.array(dy)))
    return out.detach(), grads


@pytest.mark.parametrize("rdt", FP8)
def test_sat_cast_stores_the_jax_bytes(rdt):
    m = float(jnp.finfo(jnp.dtype(rdt)).max)
    x = np.concatenate([_f32(_rs(1), 200, scale=m * 1.5),
                        [m * 4, -m * 4, np.nan, np.inf, -np.inf, 0.0,
                         -0.0, 1e-9, m, -m]]).astype(np.float32)
    want = np.asarray(jr8._sat_cast(jnp.asarray(x), jnp.dtype(rdt)))
    got = tr8._sat_cast(torch.from_numpy(x), getattr(torch, rdt))
    gb, wb = got.view(torch.uint8).numpy(), want.view(np.uint8)
    nan = np.isnan(x)
    np.testing.assert_array_equal(gb[~nan], wb[~nan])
    assert torch.isnan(got.float()[torch.from_numpy(nan)]).all()
    assert np.isnan(want.astype(np.float32)[nan]).all()


@pytest.mark.parametrize("rdt", ["fp8", "e5m2"])
def test_conv_forward_plain_dx_exact_dw_as_jax(monkeypatch, rdt):
    rs = _rs(2)
    x, w = _f32(rs, 2, 6, 6, 3, scale=2), _f32(rs, 4, 3, 3, 3)
    dy = _f32(rs, 2, 6, 6, 4)
    y0, (dx0, dw0) = _vjp_t(_tconv, x, w, dy=dy)
    monkeypatch.setenv("MXNET_RESID_DTYPE", rdt)
    y8, (dx8, dw8) = _vjp_t(_tconv, x, w, dy=dy)
    assert torch.equal(y0, y8) and torch.equal(dx0, dx8)
    name = tr8.resid_dtype()
    _, vjp = jax.vjp(lambda d, ww: jr8.conv_resid8(
        d, ww, (1, 1), (1, 1), (1, 1), DN, 1, name), jnp.asarray(x),
        jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(dx8.numpy(), np.asarray(jdx), rtol=0,
                               atol=1e-5 * np.abs(jdx).max())
    np.testing.assert_allclose(dw8.numpy(), np.asarray(jdw), rtol=0,
                               atol=1e-5 * np.abs(jdw).max())
    assert not torch.equal(dw0, dw8)          # dW reads the fp8 input


def test_outliers_saturate_in_conv_and_relu(monkeypatch):
    monkeypatch.setenv("MXNET_RESID_DTYPE", "e5m2")
    big = 57344.0 * 4
    rs = _rs(3)
    x = (rs.rand(2, 6, 6, 3) * big).astype(np.float32)
    _, (dx, dw) = _vjp_t(_tconv, x, _f32(rs, 4, 3, 3, 3),
                         dy=np.ones((2, 6, 6, 4), np.float32))
    assert torch.isfinite(dw).all() and torch.isfinite(dx).all()
    _, (dr,) = _vjp_t(tnn.relu, np.full(8, big, np.float32),
                      dy=np.ones(8, np.float32))
    assert dr.min() == 1.0


def test_relu_mask_and_the_shared_copy(monkeypatch):
    monkeypatch.setenv("MXNET_RESID_DTYPE", "fp8")
    rs = _rs(4)
    x = _f32(rs, 64)
    dy = rs.rand(64).astype(np.float32)
    _, (got,) = _vjp_t(tnn.relu, x, dy=dy)
    _, vjp = jax.vjp(lambda v: jr8.relu_resid8(v, "float8_e4m3fn"),
                     jnp.asarray(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(vjp(
        jnp.asarray(dy))[0]))
    # a ReLU and the convolution after it save one fp8 tensor
    saved = []

    def pack(t):
        saved.append(t)
        return t

    xa = torch.from_numpy(_f32(rs, 2, 6, 6, 3)).requires_grad_()
    w = torch.from_numpy(_f32(rs, 4, 3, 3, 3)).requires_grad_()
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        _tconv(tnn.relu(xa), w).sum().backward()
    fp8 = [t for t in saved if t.dtype == torch.float8_e4m3fn]
    assert len(fp8) == 2 and fp8[0].data_ptr() == fp8[1].data_ptr()
    # and no activation-sized f32 tensor
    assert not any(t.dtype == torch.float32 and t.shape == xa.shape
                   for t in saved)


def test_bn_core_fp8_residual_as_jax(monkeypatch):
    rs = _rs(5)
    xb = (rs.rand(8, 6, 6, 5) * 3 + 1).astype(np.float32)
    g = (rs.rand(5) + 0.5).astype(np.float32)
    b = rs.rand(5).astype(np.float32)
    dy = _f32(rs, 8, 6, 6, 5)
    core = _make_bn_core("float8_e4m3fn")
    _, vjp = jax.vjp(lambda d, gg, bb: core(d, gg, bb, 3, 1e-5)[0],
                     jnp.asarray(xb), jnp.asarray(g), jnp.asarray(b))
    want = vjp(jnp.asarray(dy))
    monkeypatch.setenv("MXNET_RESID_DTYPE", "fp8")

    def f(d, gg, bb):
        return tnn.batch_norm(d, gg, bb, torch.zeros(5), torch.ones(5),
                              eps=1e-5, fix_gamma=False, axis=3,
                              _training=True)[0]

    _, got = _vjp_t(f, xb, g, b, dy=dy)
    for a, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
def test_conv_int8_train_as_jax(monkeypatch, dtype, tol):
    monkeypatch.setenv("MXNET_CONV_COMPUTE", "int8")
    monkeypatch.setenv("MXNET_CONV_INT8_RANGE", "8.0")
    rs = _rs(6)
    x = (rs.rand(2, 6, 6, 3) * 4).astype(np.float32)
    x[0, 0, 0, 0] = 20.0                 # beyond the range: clips
    w, dy = _f32(rs, 8, 3, 3, 3), _f32(rs, 2, 6, 6, 8)
    jdt = jnp.dtype(dtype)
    jx, jw, jdy = (jnp.asarray(a).astype(jdt) for a in (x, w, dy))
    jy, vjp = jax.vjp(lambda d, ww: jr8.conv_int8_train(
        d, ww, (1, 1), (1, 1), (1, 1), DN, 1), jx, jw)
    want = [jy] + list(vjp(jdy))
    tdt = getattr(torch, dtype)
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (x, w)]
    y = _tconv(*ts)
    got = [y] + list(torch.autograd.grad(y, ts,
                                         torch.from_numpy(dy).to(tdt)))
    for name, g, wv in zip(("y", "dx", "dw"), got, want):
        wv = np.asarray(wv.astype(jnp.float32))
        assert g.dtype == tdt, name
        np.testing.assert_allclose(g.detach().float().numpy(), wv, rtol=0,
                                   atol=tol * np.abs(wv).max(),
                                   err_msg=name)


def _convnet(mx, device=None):
    kw = {} if device is None else {"device": device}
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="r8net_", **kw)
    with net.name_scope():
        net.add(nn.Conv2D(8, 3, padding=1, use_bias=False, in_channels=3,
                          layout="NHWC", **kw))
        net.add(nn.BatchNorm(axis=-1, in_channels=8, **kw))
        net.add(nn.Activation("relu", **kw))
        net.add(nn.Conv2D(16, 3, padding=1, use_bias=False, in_channels=8,
                          layout="NHWC", **kw))
        net.add(nn.BatchNorm(axis=-1, in_channels=16, **kw))
        net.add(nn.Activation("relu", **kw))
        net.add(nn.GlobalAvgPool2D(layout="NHWC", **kw))
        net.add(nn.Dense(5, in_units=16, **kw))
    return net


def _jstep(x, y, weights):
    net = _convnet(jmx)
    net.initialize()
    net(jmx.nd.array(x))
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(jmx.nd.array(weights[k]))
    lossfn = jmx.gluon.loss.SoftmaxCrossEntropyLoss()
    with jmx.autograd.record():
        loss = lossfn(net(jmx.nd.array(x)), jmx.nd.array(y))
    loss.backward()
    return float(loss.mean().asnumpy()), {
        k: p.grad().asnumpy() for k, p in
        net._collect_params_with_prefix().items() if p.grad_req != "null"}


def _tstep(x, y, weights, hybridize):
    net = _convnet(mt, "cpu")
    net.initialize()
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(weights[k])
    if hybridize:
        net.hybridize()
    lossfn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with mt.cpu():
        with mt.autograd.record():
            loss = lossfn(net(mt.nd.array(x)), mt.nd.array(y))
        loss.backward()
    return float(loss.mean().asnumpy()), {
        k: p.grad().asnumpy() for k, p in
        net._collect_params_with_prefix().items() if p.grad_req != "null"}


@pytest.mark.parametrize("flag,value", [("MXNET_RESID_DTYPE", "fp8"),
                                        ("MXNET_CONV_COMPUTE", "int8")])
def test_small_net_step_under_the_flag_as_jax(monkeypatch, flag, value):
    rs = _rs(7)
    x = rs.rand(8, 12, 12, 3).astype(np.float32)
    y = rs.randint(0, 5, 8).astype(np.float32)
    weights = {"0.weight": _f32(rs, 8, 3, 3, 3, scale=0.5),
               "3.weight": _f32(rs, 16, 3, 3, 8, scale=0.3),
               "7.weight": _f32(rs, 5, 16, scale=0.5),
               "7.bias": np.zeros(5, np.float32)}
    for k in ("1", "4"):
        c = 8 if k == "1" else 16
        weights.update({f"{k}.gamma": np.ones(c, np.float32),
                        f"{k}.beta": np.zeros(c, np.float32),
                        f"{k}.running_mean": np.zeros(c, np.float32),
                        f"{k}.running_var": np.ones(c, np.float32)})
    plain = _tstep(x, y, weights, False)
    monkeypatch.setenv(flag, value)
    want = _jstep(x, y, weights)
    for hyb in (False, True):
        got = _tstep(x, y, weights, hyb)
        assert abs(got[0] - want[0]) < 1e-5
        for k, g in want[1].items():
            np.testing.assert_allclose(
                got[1][k], g, rtol=0, atol=1e-3 * np.abs(g).max(),
                err_msg=f"{k} hybridize={hyb}")
    # the flag changed the step
    assert any(np.abs(plain[1][k] - g).max() > 1e-6
               for k, g in want[1].items())
