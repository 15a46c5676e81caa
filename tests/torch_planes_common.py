"""Shared by the telemetry-plane parity tests (``test_torch_numerics.py``,
``test_torch_efficiency.py``, ...): one small MLP and one two-block conv
net with the fused BatchNorm+ReLU epilogue, built in both packages with
explicit Gluon prefixes and the JAX net's weights, the same numpy data,
and a FitLoop over them. Not a test module."""
import contextlib
import os

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import fit as jfit  # noqa: E402
from mxnet_tpu import io as jio  # noqa: E402
from mxnet_tpu.contrib import chaos as jchaos  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import fit as tfit  # noqa: E402
from mxnet_tpu_torch import io as tio  # noqa: E402
from mxnet_tpu_torch.contrib import chaos as tchaos  # noqa: E402

PKGS = {"jax": (mx, jfit, jio, jchaos), "port": (mt, tfit, tio, tchaos)}
BATCH = 8


def data(kind, n=32, seed=3):
    rs = np.random.RandomState(seed)
    if kind == "mlp":
        x = rs.randn(n, 6).astype(np.float32)
    else:
        x = rs.rand(n, 8, 8, 3).astype(np.float32)
    y = rs.randint(0, 4, n).astype(np.float32)
    return x, y


def _build_net(m, kind):
    nn = m.gluon.nn
    if kind == "mlp":
        net = nn.HybridSequential(prefix="pmlp_")
        with net.name_scope():
            net.add(nn.Dense(16, activation="relu", prefix="d0_"),
                    nn.Dense(16, activation="relu", prefix="d1_"),
                    nn.Dense(4, prefix="d2_"))
        return net
    net = nn.HybridSequential(prefix="pcnn_")
    with net.name_scope():
        for i in range(2):
            net.add(nn.Conv2D(8, 3, padding=1, use_bias=False,
                              layout="NHWC", prefix=f"c{i}_"),
                    nn.FusedBatchNormReLU(axis=-1, prefix=f"bn{i}_"))
        net.add(nn.GlobalAvgPool2D(layout="NHWC", prefix="pool_"),
                nn.Dense(4, prefix="fc_"))
    return net


_WEIGHTS = {}


def _jax_weights(kind):
    if kind not in _WEIGHTS:
        mx.random.seed(0)
        net = _build_net(mx, kind)
        net.initialize(mx.init.Xavier())
        x, _ = data(kind)
        with mx.autograd.pause():
            net(mx.nd.array(x[:2]))
        _WEIGHTS[kind] = {k: p.data().asnumpy().copy()
                          for k, p in net.collect_params().items()}
    return _WEIGHTS[kind]


def net(pkg, kind, hybridize=False):
    """The net of ``kind`` in ``pkg``, with the JAX net's initial
    weights (the port's on the CPU)."""
    m = PKGS[pkg][0]
    ctx = mt.cpu() if pkg == "port" else contextlib.nullcontext()
    with ctx:
        n = _build_net(m, kind)
        n.initialize(m.init.Xavier())
        x, _ = data(kind)
        with m.autograd.pause():
            n(m.nd.array(x[:2]))
        w = _jax_weights(kind)
        for k, p in n.collect_params().items():
            p.set_data(m.nd.array(w[k]))
    if hybridize:
        n.hybridize()
    return n


def fit(pkg, kind, epochs=2, plan=None, loss_scale=1.0, opt="sgd",
        opt_kw=None, staging=False, hybridize=False, **loop_kw):
    """One FitLoop run; returns ``(net, trainer, FitResult)``."""
    m, fitm, io, chaos = PKGS[pkg]
    ctx = mt.cpu() if pkg == "port" else contextlib.nullcontext()
    with ctx:
        n = net(pkg, kind, hybridize)
        tr = m.gluon.Trainer(n.collect_params(), opt,
                             dict(opt_kw or {"learning_rate": 0.05,
                                             "momentum": 0.9}),
                             kvstore=None)
        x, y = data(kind)
        it = io.NDArrayIter(x, y, batch_size=BATCH, shuffle=True, seed=13)
        if staging:
            it = io.DeviceStagingIter(it)
        loop = fitm.FitLoop(n, tr, m.gluon.loss.SoftmaxCrossEntropyLoss(),
                            it, heartbeat=False, loss_scale=loss_scale,
                            **loop_kw)
        if plan:
            chaos.install(plan)
        try:
            res = loop.fit(epochs=epochs)
        finally:
            chaos.uninstall()
    return n, tr, res


def weights(n):
    return {k: p.data().asnumpy().copy()
            for k, p in n.collect_params().items()}


def state(tr):
    """Every optimizer state tensor of a port trainer, in index order."""
    out = []
    for i in sorted(tr._updaters[0].states):
        st = tr._updaters[0].states[i]
        for leaf in (st if isinstance(st, (tuple, list)) else (st,)):
            if leaf is not None:
                out.append(leaf.asnumpy().copy())
    return out
