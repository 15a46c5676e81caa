"""The FitLoop path's card-only parts (marked ``cuda``; they skip on the
CPU). The file imports no JAX, so it runs on the card with
``python3 -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_fit_cuda.py``.

- ``fault.CheckpointManager(async_write=True).save`` on the card: the
  snapshot goes through one flat device buffer and one copy into a pinned
  buffer, and is complete when ``save()`` returns: an in-place update
  right after it (the writer held back) never reaches the checkpoint,
  and the pinned buffer is reused by the next save.
- ``io.DeviceStagingIter`` on the card: pinned buffers, a side stream and
  an event the consumer's stream waits on; the staged batches equal the
  base iterator's, at depth 1 and 3, read without any host sync.
"""
import os
import threading

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import fault, io


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (pinned staging and the flat "
                    "snapshot run only there)")
    with mt.gpu(0):
        yield mt.gpu(0)


def _net_trainer():
    net = mt.gluon.nn.HybridSequential()
    net.add(mt.gluon.nn.Dense(64, in_units=32), mt.gluon.nn.Dense(8,
                                                                 in_units=64))
    net.initialize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9},
                               kvstore=None)
    return net, trainer


def _step(net, trainer):
    x = mt.nd.array(np.ones((4, 32), np.float32))
    with mt.autograd.record():
        loss = net(x).sum()
    loss.backward()
    trainer.step(4)


def _state(net, trainer):
    out = {k: p.tensor.detach().cpu().clone()
           for k, p in net._collect_params_with_prefix().items()}
    leaves = []
    fault._map_arrays(sorted(trainer._updaters[0].states.items()),
                      leaves.append)
    for j, a in enumerate(leaves):
        out[f"state{j}"] = a.tensor.detach().cpu().clone()
    return out


@pytest.mark.cuda
def test_async_snapshot_on_the_card(card, tmp_path):
    net, trainer = _net_trainer()
    _step(net, trainer)
    want = _state(net, trainer)
    cm = fault.CheckpointManager(str(tmp_path), async_write=True)
    gate = threading.Event()
    cm._submit(gate.wait)                      # hold the writer back
    cm.save(1, net=net, trainer=trainer)
    for _ in range(3):                         # in place, on the stream
        _step(net, trainer)
    gate.set()
    cm.wait()
    assert len(cm._pinned) == 1 and len(next(iter(cm._pinned.values()))) \
        == 1, "one flat pinned buffer for the f32 tensors, given back"
    net2, trainer2 = _net_trainer()
    _step(net2, trainer2)
    cm.restore(1, net=net2, trainer=trainer2)
    got = _state(net2, trainer2)
    for k, w in want.items():
        assert torch.equal(got[k], w), k
    cm.save(2, net=net, trainer=trainer)       # reuses the pinned buffer
    cm.wait()
    assert sorted(os.listdir(tmp_path)) == ["ckpt-1", "ckpt-2"]


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 3])
def test_staging_on_the_card(card, depth):
    rs = np.random.RandomState(0)
    X = rs.randn(40, 64, 64).astype(np.float32)
    Y = np.arange(40, dtype=np.float32)
    base = io.NDArrayIter(X, Y, batch_size=4, shuffle=True, seed=2)
    it = io.DeviceStagingIter(io.NDArrayIter(X, Y, batch_size=4,
                                             shuffle=True, seed=2),
                              depth=depth)
    assert it.device.type == "cuda"
    got = []
    for b in it:
        assert b.data[0]._data.is_cuda
        # consume on the current stream with no host sync first
        got.append((b.data[0]._data * 2).sum().item())
    want = [float((b.data[0]._data.cpu() * 2).sum()) for b in base]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert sum(len(v) for v in it._stager._pool.values()) >= 2, \
        "pinned buffers are pooled"
