"""The megastep on the card (marked ``cuda``; they skip on the CPU): the
FitLoop step as one CUDA graph replay per input signature. The file
imports no JAX, so it runs on the card with ``python3 -m pytest
--noconftest -p no:cacheprovider -m cuda tests/test_torch_megastep_cuda.py``.

- an MLP (Adam, whose lr moves every step) and a thin ResNet v1 NHWC
  through the four BN kernels (SGD momentum, deterministic cuDNN): the
  megastep equals the composed path bit for bit, the signature cache
  holds one entry, and no kernel wrapper runs after the first step (the
  warm steps are replays);
- a ``nan_grad`` step skipped inside the graph, bit for bit;
- optimizer state rebound by ``set_states_bytes`` is adopted, a
  parameter rebound after the capture raises;
- a Dropout net draws new masks on every replay.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import megastep
from mxnet_tpu_torch.contrib import chaos
from mxnet_tpu_torch.ops import fused_bn_act as tk

pytestmark = pytest.mark.cuda


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the megastep's CUDA graph runs only "
                    "there)")
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    chaos.uninstall()
    with mt.gpu(0):
        yield mt.gpu(0)
    chaos.uninstall()
    torch.backends.cudnn.deterministic = prev


def _mlp(dropout=None):
    rs = np.random.RandomState(0)
    net = mt.gluon.nn.Sequential()
    net.add(mt.gluon.nn.Dense(32, in_units=16, activation="relu"))
    if dropout is not None:
        net.add(mt.gluon.nn.Dropout(dropout))
    net.add(mt.gluon.nn.Dense(4, in_units=32))
    net.initialize()
    for _, p in sorted(net._collect_params_with_prefix().items()):
        p.set_data(0.3 * rs.randn(*p.shape).astype(np.float32))
    return net


def _thin_resnet():
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        BottleneckV1, ResNetV1)
    net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128],
                   classes=10, layout="NHWC", stem_s2d=True)
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
    return net


def _run(monkeypatch, mega, net, opt, X, Y, steps, plan=None,
         loss_fn=None, **kw):
    monkeypatch.setenv("MXTPU_MEGASTEP", "on" if mega else "off")
    name, okw = opt
    tr = mt.gluon.Trainer(net.collect_params(), name, dict(okw))
    counts = []
    loop = mt.fit.FitLoop(
        net, tr, loss_fn or mt.gluon.loss.L2Loss(),
        mt.io.DeviceStagingIter(mt.io.NDArrayIter(X, Y, batch_size=4)),
        heartbeat=False,
        on_step_end=lambda s, l: counts.append(sum(tk.launches.values())),
        **kw)
    if plan:
        chaos.install(plan)
    tk.reset_launches()
    try:
        res = loop.fit(epochs=1)
    finally:
        chaos.uninstall()
    assert res.step == steps
    state = [p.tensor.detach().clone() for p in tr._params]
    for _, st in sorted(tr._updaters[0].states.items()):
        for s in (st if isinstance(st, (tuple, list)) else [st]):
            if s is not None:
                state.append(s._data.clone())
    return res, state, counts, tr, loop


def _same(a, b):
    assert a[0].losses == b[0].losses
    assert a[0].skipped_steps == b[0].skipped_steps
    assert len(a[1]) == len(b[1])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)


def _data(n, d_in, d_out, seed=1):
    rs = np.random.RandomState(seed)
    return (rs.rand(n, d_in).astype(np.float32),
            rs.rand(n, d_out).astype(np.float32))


def test_mlp_graph_equals_composed(card, monkeypatch):
    X, Y = _data(24, 16, 4)
    opt = ("adam", {"learning_rate": 1e-2, "wd": 1e-3})
    comp = _run(monkeypatch, False, _mlp(), opt, X, Y, 6)
    net = _mlp()
    mega = _run(monkeypatch, True, net, opt, X, Y, 6)
    _same(comp, mega)
    info = megastep.cache_info(net)
    assert (info.misses, info.hits, info.currsize) == (1, 5, 1)
    entry = net._mxtpu_megastep_cache.snapshot_items()[0][1]
    assert entry.graph is not None and entry.capture_ms > 0


def test_thin_resnet_graph_equals_composed(card, monkeypatch):
    rs = np.random.RandomState(2)
    X = rs.rand(16, 32, 32, 3).astype(np.float32)
    Y = rs.randint(0, 10, 16).astype(np.float32)
    opt = ("sgd", {"learning_rate": 0.05, "momentum": 0.9})
    ce = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    comp = _run(monkeypatch, False, _thin_resnet(), opt, X, Y, 4,
                loss_fn=ce)
    mega = _run(monkeypatch, True, _thin_resnet(), opt, X, Y, 4,
                loss_fn=ce)
    _same(comp, mega)
    counts = mega[2]
    # only the eager first step counts: the capture records without
    # counting and the replays call no wrapper
    assert counts[0] > 0 and all(c == counts[0] for c in counts)
    assert comp[2][-1] == 4 * comp[2][0]


def test_nan_step_skipped_inside_the_graph(card, monkeypatch):
    X, Y = _data(24, 16, 4)
    opt = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    kw = dict(plan="nan_grad@3", loss_scale=128.0)
    comp = _run(monkeypatch, False, _mlp(), opt, X, Y, 6, **kw)
    mega = _run(monkeypatch, True, _mlp(), opt, X, Y, 6, **kw)
    assert mega[0].skipped_steps == [3] and mega[0].loss_scale == 64.0
    _same(comp, mega)


def test_rebound_state_adopted_and_rebound_parameter_raises(card,
                                                            monkeypatch):
    X, Y = _data(16, 16, 4)
    opt = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    out = {}
    for mega in (False, True):
        res, _, _, tr, loop = _run(monkeypatch, mega, _mlp(), opt, X, Y, 4)
        tr.set_states_bytes(tr.get_states_bytes())
        res2 = loop.fit(epochs=1, resume=False)
        out[mega] = (res.losses + res2.losses,
                     [p.tensor.detach().clone() for p in tr._params])
    assert out[False][0] == out[True][0]
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)
    p = tr._params[0]
    with torch.no_grad():
        p.tensor.data = p.tensor.data.clone()
    with pytest.raises(mt.MXNetError, match="rebound"):
        loop.fit(epochs=1, resume=False)


def test_dropout_draws_new_masks_on_every_replay(card, monkeypatch):
    """Same batch every step and lr 0: the losses differ only by the
    dropout mask, so equal losses on two replays would mean one mask."""
    x, y = _data(4, 16, 4)
    X, Y = np.tile(x, (5, 1)), np.tile(y, (5, 1))
    res = _run(monkeypatch, True, _mlp(dropout=0.5),
               ("sgd", {"learning_rate": 0.0}), X, Y, 5)[0]
    assert len(set(res.losses[1:])) == 4, res.losses
