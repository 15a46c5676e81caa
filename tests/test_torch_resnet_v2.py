"""ResNet v2 in the port against the JAX package, built with deferred
initialisation as the JAX package builds it.

For ``resnet18_v2`` and a thin ``BottleneckV2`` net, channel-last (every
pre-activation BN+ReLU a fused block) and channel-first: the JAX net is
resolved by a forward and its weights carried into a fresh port net with
``convert`` (which creates the deferred tensors); inference logits; then
one ``SPMDTrainer.run_steps`` call of K = 2 SGD-momentum steps in both
packages (the JAX trainer on the CPU, in this process, f32): losses,
every weight, momentum buffer and running statistic. Then
``resnet50_v2``'s parameter names and shapes, before and after the first
forward; the trainer's probe forward, which resolves the deferred
parameters in inference mode and moves no running statistic; ``convert``
of a trained net, running statistics included; and ``get_model``.

Tolerances: inference logits 1e-4 (relative and absolute), as
``test_torch_resnet.py`` holds the small v1's logits (a dozen layers
deep, where the JAX package's single-op 1e-5 would measure summation
order); losses 1e-4. Trained state: for the thin bottleneck net every
weight, momentum buffer and running statistic within 1e-3 of the
tensor's largest value (or of 1e-4, for the stem BatchNorm's gamma: only
BatchNorms read its output, so its exact gradient is 0 and both packages
return rounding noise of about 1e-6), as ``test_torch_spmd.py`` holds the
v1 trainer's f32 state. ``resnet18_v2`` is held to 5e-2 of each tensor's
L2 norm (of the change from the start, for weights and running
statistics): at these sizes, one ReLU whose input lies within 1e-5 of
its threshold, where the two packages' rounding picks opposite sides,
moves a stage's gradient by a few percent of its largest entry (a 1e-6
relative perturbation of the port's own weights does the same to the
port; measured here: 1.9 % and 2.0 % of the L2 norm, NHWC and NCHW).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, nd
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.parallel import SPMDTrainer as JTrainer

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, convert
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision
from mxnet_tpu_torch.ops import fused_bn_act as tk
from mxnet_tpu_torch.ops.registry import NotPortedError
from mxnet_tpu_torch.parallel import SPMDTrainer as TTrainer

OPT = {"learning_rate": 0.05, "momentum": 0.9}
THIN = ([1, 1, 1, 1], [8, 16, 32, 64, 128])
K, BATCH, SIZE = 2, 4, 64


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = prev


@pytest.fixture(autouse=True)
def _jax_name_scope():
    """The JAX blocks of these tests take their names in a scope of their
    own, so the JAX package's global block counters, which other test
    files' names depend on, do not move."""
    from mxnet_tpu.gluon.block import nn_block_scope
    with nn_block_scope("resnet_v2_"):
        yield


def _net(vision, model, layout, **device):
    if model == "resnet18_v2":
        return vision.resnet18_v2(classes=10, layout=layout, **device)
    return vision.ResNetV2(vision.BottleneckV2, *THIN, classes=10,
                           layout=layout, **device)


def _data(layout):
    rs = np.random.RandomState(5)
    x = rs.rand(K, BATCH, SIZE, SIZE, 3).astype(np.float32)
    if layout == "NCHW":
        x = np.ascontiguousarray(x.transpose(0, 1, 4, 2, 3))
    return x, rs.randint(0, 10, (K, BATCH)).astype(np.float32)


def _max_err(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-4)


def _l2_err(a, b):
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)),
                                              1e-12)


def _state(net, momenta):
    strip = len(net.prefix)
    out = {f"param/{k[strip:]}": p.data().asnumpy()
           for k, p in net.collect_params().items()}
    out.update({f"mom/{k[strip:]}": np.asarray(v) for k, v in momenta})
    return out


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
@pytest.mark.parametrize("model", ["resnet18_v2", "bottleneck_v2"])
def test_v2_logits_and_two_trainer_steps_match_jax(model, layout):
    data, label = _data(layout)
    mx.random.seed(0)
    jnet = _net(jvision, model, layout)
    jnet.initialize(mx.init.Xavier())
    with autograd.pause():
        jlogits = jnet(nd.array(data[0])).asnumpy()
    tnet = _net(tvision, model, layout, device="cpu")
    assert any(p.tensor is None for p in tnet.collect_params().values())
    init = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    convert.from_mxnet_tpu_params(tnet, init, prefix=jnet.prefix)
    start = _state(jnet, [])
    with mt.autograd.pause():
        tlogits = tnet(torch.from_numpy(data[0])).detach().numpy()
    np.testing.assert_allclose(tlogits, jlogits, rtol=1e-4, atol=1e-4)

    jtr = JTrainer(jnet, jloss.SoftmaxCrossEntropyLoss(),
                   optimizer_params=OPT)
    jlosses = np.asarray(jtr.run_steps(data, label))
    want = _state(jnet, [(p.name, m) for p, m in
                         zip(jtr._trainable, jtr._opt_state)])
    ttr = TTrainer(tnet, tloss.SoftmaxCrossEntropyLoss(),
                   optimizer_params=OPT)
    tk.reset_launches()
    tlosses = ttr.run_steps(torch.from_numpy(data),
                            torch.from_numpy(label)).numpy()
    assert not any(tk.launches.values())        # the host: plain versions
    got = _state(tnet, [(k, m.numpy()) for k, m in
                        ttr.optimizer_state.items()])
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert got.keys() == want.keys()
    assert sum(k.startswith("mom/") for k in want) > 0
    for k in want:
        if model != "resnet18_v2":
            assert _max_err(got[k], want[k]) <= 1e-3, k
        else:
            base = start.get(k, 0.0)
            assert _l2_err(got[k] - base, want[k] - base) <= 5e-2, k
    moved = [k for k in want if k.endswith("running_mean")]
    assert moved and all(np.abs(got[k]).max() > 0 for k in moved)


def _shapes(net):
    strip = len(net.prefix)
    return {k[strip:]: tuple(p.shape) for k, p in
            net.collect_params().items()}


def test_resnet50_v2_names_and_shapes_match_jax():
    mx.random.seed(0)
    jnet = jvision.get_model("resnet50_v2", layout="NHWC")
    tnet = tvision.get_model("resnet50_v2", layout="NHWC", device="cpu")
    declared = _shapes(jnet)
    assert _shapes(tnet) == declared              # deferred: 0 extents
    assert list(_shapes(tnet)) == list(declared)  # and the same order
    assert sum(0 in s for s in declared.values()) > 100
    jnet.initialize(mx.init.Xavier())
    tnet.initialize(mt.init.Xavier())
    x = np.zeros((1, 32, 32, 3), np.float32)
    with autograd.pause():
        jnet(nd.array(x))
    with mt.autograd.pause():
        tnet(torch.from_numpy(x))
    assert _shapes(tnet) == _shapes(jnet)
    assert not any(0 in s for s in _shapes(tnet).values())
    fused = [m for m in tnet.modules()
             if isinstance(m, mt.gluon.nn.FusedBatchNormReLU)]
    assert len(fused) == 48          # every pre-activation, channel-last
    grad_req = {k[len(jnet.prefix):]: p.grad_req
                for k, p in jnet.collect_params().items()}
    assert {k[len(tnet.prefix):]: p.grad_req
            for k, p in tnet.collect_params().items()} == grad_req


def test_the_trainers_probe_resolves_params_and_moves_no_statistic():
    """The first call resolves the deferred parameters with one inference
    forward on the first batch (the JAX package's ``_collect`` probe):
    the running statistics keep their initial values, the optimizer
    state is allocated for the resolved shapes, and the steps that follow
    train the net."""
    data, label = _data("NHWC")
    net = _net(tvision, "bottleneck_v2", "NHWC", device="cpu")
    net.initialize(mt.init.Xavier(), generator=torch.Generator()
                   .manual_seed(2))
    tr = TTrainer(net, tloss.SoftmaxCrossEntropyLoss(), optimizer_params=OPT)
    tr._inputs(torch.from_numpy(data), torch.from_numpy(label), steps=True)
    params = net.collect_params()
    assert all(p.initialized and p.tensor is not None
               for p in params.values())
    for k, p in params.items():
        if k.endswith("running_mean"):
            assert torch.equal(p.tensor, torch.zeros_like(p.tensor)), k
        if k.endswith("running_var"):
            assert torch.equal(p.tensor, torch.ones_like(p.tensor)), k
    for k, m in tr.optimizer_state.items():
        assert m.shape == params[k].tensor.shape
        assert not m.any()
    losses = tr.run_steps(torch.from_numpy(data), torch.from_numpy(label))
    assert torch.isfinite(losses).all()
    assert any(float(p.tensor.abs().max()) > 0 for k, p in params.items()
               if k.endswith("running_mean"))


def test_convert_carries_a_trained_v2_net_with_its_statistics():
    data, label = _data("NHWC")
    mx.random.seed(1)
    jnet = _net(jvision, "bottleneck_v2", "NHWC")
    jnet.initialize(mx.init.Xavier())
    jtr = JTrainer(jnet, jloss.SoftmaxCrossEntropyLoss(),
                   optimizer_params=OPT)
    jtr.step(data[0], label[0])                 # the probe, then a step
    params = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    assert any(np.abs(v).max() > 0 for k, v in params.items()
               if k.endswith("running_mean"))
    with autograd.pause():
        want = jnet(nd.array(data[1])).asnumpy()
    for resolved in (False, True):
        tnet = _net(tvision, "bottleneck_v2", "NHWC", device="cpu")
        if resolved:
            tnet.initialize()
            tnet(torch.from_numpy(data[1]))
        convert.from_mxnet_tpu_params(tnet, params, prefix=jnet.prefix)
        for k, p in tnet.collect_params().items():
            np.testing.assert_array_equal(
                p.data().asnumpy(), params[jnet.prefix + k[len(tnet.prefix):]])
        with mt.autograd.pause():
            got = tnet(torch.from_numpy(data[1])).detach().numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_get_model_builds_the_resnets_and_refuses_the_rest():
    net = tvision.get_model("ResNet50_v2", layout="NHWC", device="cpu")
    assert isinstance(net, tvision.ResNetV2)
    assert isinstance(tvision.get_model("resnet18_v1", device="cpu"),
                      tvision.ResNetV1)
    for name in ("vgg16", "mobilenet1.0", "densenet121", "inceptionv3",
                 "squeezenet1.1", "alexnet"):
        with pytest.raises(NotPortedError, match="A14"):
            tvision.get_model(name)
    with pytest.raises(MXNetError, match="not in zoo"):
        tvision.get_model("resnet51_v2")
