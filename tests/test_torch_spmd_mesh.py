"""The port's ``SPMDTrainer(mesh=, plan=)`` against the JAX package's on a
``{dp: 2}`` mesh: a thin channel-last ResNetV1 (the bench model's blocks,
fused epilogues included) trained by ``run_steps`` of K=1 then K=2 on a
global batch of 8, 64x64.

GSPMD computes the JAX trainer's BatchNorm statistics over the global
batch; the port's ranks each hold 4 images and all-reduce the fused
kernels' (plain versions', on the CPU) ``(2, C)`` sums over ``dp``
(``ops.fused_bn_act.sync_scope``), so the running statistics, the
weights and the momenta after each call match the JAX trainer's. With
``plan=`` the classifier's weight is split over ``dp`` (each rank holds 5
of its 10 rows and their momenta). A one-process port run on the whole
batch of 8 is held to the same trajectory. The JAX side runs here on the
8-device CPU mesh; the port's ranks over gloo through the launcher
(``tests/dist/torch_mesh_worker.py``). Tolerances, those of
``tests/test_torch_spmd.py``'s f32 trajectory: losses 1e-4 relative,
state 1e-3 of each tensor's largest value.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax

import mxnet_tpu as mx
from mxnet_tpu import autograd, nd
from mxnet_tpu import parallel as jpar
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo.vision.resnet import BottleneckV1, ResNetV1

from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
    BottleneckV1 as TBottleneck, ResNetV1 as TResNet)
from mxnet_tpu_torch.parallel import SPMDTrainer as TTrainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_common import launch, worker  # noqa: E402

SPEC = ([1, 1, 1, 1], [8, 16, 32, 64, 128])
OPT = {"learning_rate": 0.05, "momentum": 0.9}
SIZE, BATCH, K = 64, 8, 3


def _data():
    rs = np.random.RandomState(1)
    return (rs.rand(K, BATCH, SIZE, SIZE, 3).astype(np.float32),
            rs.randint(0, 10, (K, BATCH)).astype(np.float32))


def _jax_run(plan):
    data, label = _data()
    mx.random.seed(0)
    net = ResNetV1(BottleneckV1, *SPEC, classes=10, layout="NHWC",
                   stem_s2d=True, prefix="net_")
    net.initialize(mx.init.Xavier())
    with autograd.pause():
        net(nd.array(data[0, :1]))
    # by position: the JAX block names carry its process-wide counters
    items = list(net.collect_params().items())
    index = {k: i for i, (k, _) in enumerate(items)}
    init = {f"{i:03d}": p.data().asnumpy() for i, (_, p) in
            enumerate(items)}
    mesh = jpar.make_mesh({"dp": 2}, jax.devices()[:2])
    jplan = jpar.ShardingPlan([(r"dense\d+_weight", jpar.P("dp", None))]) \
        if plan else None
    tr = jpar.SPMDTrainer(net, jloss.SoftmaxCrossEntropyLoss(), mesh=mesh,
                          plan=jplan, optimizer="sgd",
                          optimizer_params=OPT)
    res = {"loss1": np.asarray(tr.run_steps(data[:1], label[:1])),
           "loss23": np.asarray(tr.run_steps(data[1:], label[1:]))}
    for k, p in items:
        res[f"param/{index[k]:03d}"] = np.asarray(p.data().asnumpy())
    for p, m in zip(tr._trainable, tr._opt_state):
        res[f"mom/{index[p.name]:03d}"] = np.asarray(m)
    return init, res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("spmd")
    want = {}
    inputs = None
    for plan in (False, True):
        init, want[plan] = _jax_run(plan)
        if inputs is not None:      # both JAX runs start from one init
            for k, v in init.items():
                np.testing.assert_array_equal(v, inputs[f"spmd/init/{k}"])
        else:
            data, label = _data()
            inputs = {f"spmd/init/{k}": v for k, v in init.items()}
            inputs.update({"spmd/data": data, "spmd/label": label})
    np.savez(out / "inputs.npz", **inputs)
    proc = launch(2, worker("torch_mesh_worker.py") +
                  [str(out), "spmd_dp", "spmd_plan"], timeout=400)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    got = {p: dict(np.load(out / f"spmd_{'plan' if p else 'dp'}.npz"))
           for p in (False, True)}
    return got, want, inputs


def _max_err(a, b):
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-6)


def _check(got, want):
    for k in ("loss1", "loss23"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    keys = [k for k in want if k.startswith(("param/", "mom/"))]
    assert set(keys) <= set(got)
    for k in keys:
        assert _max_err(got[k], want[k]) < 1e-3, (k, _max_err(got[k],
                                                               want[k]))


@pytest.mark.parametrize("plan", [False, True])
def test_dp_mesh_against_jax(plan, runs):
    got, want, _ = runs
    _check(got[plan], want[plan])
    # run_steps over a mesh of two ranks ran its three steps eagerly
    assert str(got[plan]["mode"]) == "eager"
    assert int(got[plan]["eager_steps"]) == 3


def test_dp_mesh_bn_is_global_batch(runs):
    """The two ranks' first step is the one-process step on the whole
    batch of 8: BatchNorm's statistics are the global batch's (running
    statistics 1e-4, weights 1e-3 of their largest value), and the three
    losses agree to 1e-4. (After three steps single weights move apart
    by summation order alone: the one-process BatchNorm subtracts a
    per-channel shift before it sums, the two ranks sum the raw values.)"""
    got, _, inputs = runs
    net = TResNet(TBottleneck, *SPEC, classes=10, layout="NHWC",
                  stem_s2d=True, device="cpu", prefix="net_")
    items = list(net.collect_params().items())
    for i, (_, p) in enumerate(items):
        p.set_data(inputs[f"spmd/init/{i:03d}"])
    tr = TTrainer(net, tloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
                  optimizer_params=OPT)
    data = torch.from_numpy(inputs["spmd/data"])
    label = torch.from_numpy(inputs["spmd/label"])
    loss1 = tr.run_steps(data[:1], label[:1]).numpy()
    stats = []
    for i, (k, p) in enumerate(items):
        g, w = got[False][f"step1/{i:03d}"], p.tensor.detach().numpy()
        tol = 1e-3
        if k.endswith(("running_mean", "running_var")):
            stats.append(k)
            tol = 1e-4
        assert _max_err(g, w) < tol, (k, _max_err(g, w))
    assert len(stats) > 10
    loss23 = tr.run_steps(data[1:], label[1:]).numpy()
    np.testing.assert_allclose(got[False]["loss1"], loss1, rtol=1e-4)
    np.testing.assert_allclose(got[False]["loss23"], loss23, rtol=1e-4)
