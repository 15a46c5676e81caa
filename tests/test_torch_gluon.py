"""Gluon over ``mx.nd`` in the port against the JAX package: the canonical
imperative loop (``record()``, ``net(x)``, ``backward()``), with each
parameter's ``grad()`` read back as an ``NDArray``.

The same numpy inputs and weights go through mxnet_tpu (JAX on the CPU)
and mxnet_tpu_torch (``ctx=mx.cpu()``). Each case runs the loop twice, so
grad_req 'add' shows the two backward passes summed and 'write' shows
the last one. Tolerances: f32 2e-5 for single layers (summation order
only); for the small ResNet, losses and logits 1e-4 (a dozen layers deep,
as the logits in test_torch_resnet.py), running statistics 1e-4 and
gradients 1e-3 of each tensor's largest value (as test_torch_spmd.py
holds the trainer's f32 state).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, nd
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres

RS = np.random.RandomState(11)
CPU = mt.cpu()


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = prev


def _layer(kind):
    """(jax block, port block, input shape) with the same weights."""
    mx.random.seed(2)
    if kind == "dense":
        jb = jnn.Dense(5, in_units=12)
        tb = tnn.Dense(5, in_units=12, device="cpu")
        shape = (4, 12)
    elif kind == "conv2d":
        jb = jnn.Conv2D(6, kernel_size=3, padding=1, in_channels=3,
                        layout="NHWC")
        tb = tnn.Conv2D(6, kernel_size=3, padding=1, in_channels=3,
                        layout="NHWC", device="cpu")
        shape = (2, 7, 7, 3)
    else:
        jb = jnn.BatchNorm(axis=-1, in_channels=5)
        tb = tnn.BatchNorm(axis=-1, in_channels=5, device="cpu")
        shape = (3, 4, 4, 5)
    jb.initialize(mx.init.Xavier())
    params = {k: p.data().asnumpy() for k, p in jb.collect_params().items()}
    if kind == "batchnorm":   # gamma/beta away from their 1/0 start
        for k in params:
            if k.endswith(("gamma", "beta")):
                params[k] = RS.randn(5).astype(np.float32)
                jb.collect_params()[k].set_data(nd.array(params[k]))
    convert.from_mxnet_tpu_params(tb, params, prefix=jb.prefix)
    return jb, tb, shape


def _resnet():
    mx.random.seed(0)
    spec = ([1, 1, 1, 1], [8, 16, 32, 64, 128])
    jnet = jres.ResNetV1(jres.BottleneckV1, *spec, classes=10,
                         layout="NHWC", stem_s2d=True)
    jnet.initialize(mx.init.Xavier())
    with autograd.pause():
        jnet(nd.array(np.zeros((1, 32, 32, 3), np.float32)))
    tnet = tres.ResNetV1(tres.BottleneckV1, *spec, classes=10,
                         layout="NHWC", stem_s2d=True, device="cpu")
    convert.from_mxnet_tpu_params(
        tnet, {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()},
        prefix=jnet.prefix)
    return jnet, tnet


def _pairs(jb, tb):
    tp = tb.collect_params()
    for k, p in jb.collect_params().items():
        yield k[len(jb.prefix):], p, tp[tb.prefix + k[len(jb.prefix):]]


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= rel * scale


@pytest.mark.parametrize("grad_req", ["write", "add"])
@pytest.mark.parametrize("kind", ["dense", "conv2d", "batchnorm"])
def test_layer_record_backward_matches_jax(kind, grad_req):
    jb, tb, shape = _layer(kind)
    jb.collect_params().setattr("grad_req", grad_req)
    tb.collect_params().setattr("grad_req", grad_req)
    for _ in range(2):
        x = RS.randn(*shape).astype(np.float32)
        with autograd.record():
            jy = jb(nd.array(x))
        with mt.autograd.record():
            ty = tb(mt.nd.array(x, ctx=CPU))
        assert isinstance(ty, mt.nd.NDArray)
        np.testing.assert_allclose(ty.asnumpy(), jy.asnumpy(), rtol=2e-5,
                                   atol=2e-5)
        cot = RS.randn(*jy.shape).astype(np.float32)
        jy.backward(nd.array(cot))
        ty.backward(mt.nd.array(cot, ctx=CPU))
    n = 0
    for name, jp, tp in _pairs(jb, tb):
        np.testing.assert_allclose(tp.data().asnumpy(),
                                   jp.data().asnumpy(), rtol=2e-5,
                                   atol=2e-5, err_msg=name)
        if name.startswith("running_"):     # aux states take no gradient
            assert tp.grad_req == "null"
            continue
        assert tp.grad_req == jp.grad_req == grad_req
        n += 1
        np.testing.assert_allclose(tp.grad().asnumpy(),
                                   jp.grad().asnumpy(), rtol=2e-5,
                                   atol=2e-5, err_msg=name)
    assert n == 2
    tb.collect_params().zero_grad()
    for _, _, tp in _pairs(jb, tb):
        if tp.grad_req != "null":
            assert not tp.grad().asnumpy().any()


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_small_resnet_canonical_loop_matches_jax(grad_req):
    """``record()``, ``net(x)``, loss, ``backward()``, twice, NHWC with
    the fused epilogues; every gradient and running statistic."""
    jnet, tnet = _resnet()
    jnet.collect_params().setattr("grad_req", grad_req)
    tnet.collect_params().setattr("grad_req", grad_req)
    jl, tl = jloss.SoftmaxCrossEntropyLoss(), tloss.SoftmaxCrossEntropyLoss()
    for _ in range(2):
        x = RS.rand(4, 32, 32, 3).astype(np.float32)
        label = RS.randint(0, 10, (4,)).astype(np.float32)
        with autograd.record():
            jloss_v = jl(jnet(nd.array(x)), nd.array(label))
        with mt.autograd.record():
            tout = tnet(mt.nd.array(x, ctx=CPU))
            tloss_v = tl(tout, mt.nd.array(label, ctx=CPU))
        assert isinstance(tout, mt.nd.NDArray)
        assert isinstance(tloss_v, mt.nd.NDArray)
        np.testing.assert_allclose(tloss_v.asnumpy(), jloss_v.asnumpy(),
                                   rtol=1e-4, atol=1e-4)
        jloss_v.backward()
        tloss_v.backward()
    n = 0
    for name, jp, tp in _pairs(jnet, tnet):
        _close(tp.data().asnumpy(), jp.data().asnumpy(), 1e-4)
        if name.endswith(("running_mean", "running_var")):
            assert tp.grad_req == "null"
            continue
        n += 1
        _close(tp.grad().asnumpy(), jp.grad().asnumpy(), 1e-3)
    assert n > 40
    # the moving statistics predict outside record()
    x = RS.rand(2, 32, 32, 3).astype(np.float32)
    np.testing.assert_allclose(tnet(mt.nd.array(x, ctx=CPU)).asnumpy(),
                               jnet(nd.array(x)).asnumpy(), rtol=1e-4,
                               atol=1e-4)


def test_parameter_data_shares_storage_with_the_block():
    net = tnn.Dense(3, in_units=4, device="cpu")
    net.initialize()
    p = net.collect_params()[net.prefix + "weight"]
    w = p.data()
    assert isinstance(w, mt.nd.NDArray)
    assert w.tensor is net.weight is p.tensor
    assert p.data() is w
    w[:] = 2.0                       # an NDArray write reaches the block
    assert torch.equal(net.weight.detach(), torch.full((3, 4), 2.0))
    with torch.no_grad():            # and a block write reaches the NDArray
        net.weight.fill_(3.0)
    assert (w.asnumpy() == 3.0).all()
    p.set_data(np.ones((3, 4), np.float32))
    assert net.weight is p.tensor and (w.asnumpy() == 1.0).all()
    # the gradient lands in grad(), the tensor stays the block's
    x = mt.nd.array(np.ones((2, 4), np.float32), ctx=CPU)
    with mt.autograd.record():
        y = net(x)
    y.backward()
    assert net.weight.grad is None
    np.testing.assert_allclose(p.grad().asnumpy(), np.full((3, 4), 2.0))
    assert p.data().grad is p.grad()
    # attach_grad on the parameter's array keeps the block's tensor
    w.attach_grad()
    assert w.tensor is net.weight


def test_ndarray_in_gives_ndarray_out_and_tensor_in_tensor_out():
    net = tnn.HybridSequential(device="cpu")
    net.add(tnn.Dense(4, in_units=3, device="cpu"))
    net.add(tnn.Activation("relu", device="cpu"))
    net.initialize()
    x = np.random.RandomState(0).randn(2, 3).astype(np.float32)
    nd_out = net(mt.nd.array(x, ctx=CPU))
    t_out = net(torch.from_numpy(x))
    assert isinstance(nd_out, mt.nd.NDArray)
    assert isinstance(t_out, torch.Tensor)
    np.testing.assert_array_equal(nd_out.asnumpy(), t_out.detach().numpy())
    # outside record() no graph is built; the tensor path builds torch's
    assert not nd_out.tensor.requires_grad
    assert t_out.requires_grad
    with mt.autograd.record():
        assert net(mt.nd.array(x, ctx=CPU)).tensor.requires_grad
    # an identity block does not hand back its input's storage
    ident = tnn.HybridSequential(device="cpu")
    xin = mt.nd.array(x, ctx=CPU)
    out = ident(xin)
    out[:] = 0.0
    assert xin.asnumpy().any()
