"""The CachedOp's CUDA graphs on the card (marked ``cuda``; they skip on
the CPU), held against the same blocks un-hybridized with the same
weights. The file imports no JAX, so it runs on the card with
``python3 -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_cached_op_card.py``.

A thin ResNet v1 NHWC (the four BN kernels, deterministic cuDNN, TF32
off), each case run twice so that the second run replays what the first
captured:

- two forwards of one signature, then their two backwards (the second
  slot);
- a second backward through one forward (``retain_graph=True``, then
  ``backward`` or ``autograd.grad``);
- ``autograd.grad`` results held while later calls replay;
- a double backward raises, and so does a backward whose slot a later
  forward took;
- a rebound parameter is captured anew, and a cast drops the graphs of
  the old dtype with their memory;
- two threads replaying one inference entry.

Every comparison is bit for bit.
"""
import gc
import threading
import weakref

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError

pytestmark = pytest.mark.cuda

BATCH, IMG, CLASSES = 4, 32, 10


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CachedOp's CUDA graphs run only "
                    "there)")
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with mt.gpu(0):
        yield mt.gpu(0)
    (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


def _thin_resnet():
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        BottleneckV1, ResNetV1)
    net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [8, 16, 32, 64, 128],
                   classes=CLASSES, layout="NHWC", stem_s2d=True)
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
    return net


def _batches(n, seed=0):
    rs = np.random.RandomState(seed)
    return [(mt.nd.array(rs.rand(BATCH, IMG, IMG, 3).astype(np.float32)),
             mt.nd.array(rs.randint(0, CLASSES, BATCH).astype(np.float32)))
            for _ in range(n)]


def _pair():
    """The eager net and its hybridized twin, with equal weights."""
    eager, hyb = _thin_resnet(), _thin_resnet()
    x = _batches(1, seed=9)[0][0]
    with mt.autograd.pause():
        eager(x)
        hyb(x)
    with torch.no_grad():
        for a, b in zip(eager.collect_params().values(),
                        hyb.collect_params().values()):
            b.set_data(a.data())
    hyb.hybridize()
    return eager, hyb


def _trained(net):
    return [p for p in net.collect_params().values() if p.grad_req != "null"]


def _grads(net):
    return [p.grad().tensor.clone() for p in _trained(net)]


def _state(net):
    """Every parameter and buffer, the BN moving statistics among them."""
    return [p.tensor.detach().clone() for p in net.collect_params().values()]


def _same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), (i, float((g - w).abs().max()))


def _variants(hyb):
    return [v for _k, e in hyb._cached_op._cache.snapshot_items()
            for v in e.variants.values()]


_loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()


def test_two_forwards_then_two_backwards(card):
    eager, hyb = _pair()
    (x1, y1), (x2, y2) = _batches(2)
    runs = {}
    for name, net in (("eager", eager), ("hybrid", hyb)):
        rows = []
        for _ in range(2):
            with mt.autograd.record():
                l1 = _loss(net(x1), y1)
                l2 = _loss(net(x2), y2)
            l1.backward()
            g1 = _grads(net)
            l2.backward()
            rows += [l1.tensor.clone(), l2.tensor.clone(), *g1,
                     *_grads(net), *_state(net)]
        runs[name] = rows
    _same(runs["hybrid"], runs["eager"])
    (var,) = [v for v in _variants(hyb) if v.grad]
    assert len(var.slots) == 2


@pytest.mark.parametrize("second", ["backward", "grad"])
def test_second_backward_through_one_forward(card, second):
    eager, hyb = _pair()
    (x, y), = _batches(1)
    runs = {}
    for name, net in (("eager", eager), ("hybrid", hyb)):
        rows = []
        for _ in range(2):
            with mt.autograd.record():
                loss = _loss(net(x), y)
            loss.backward(retain_graph=True)
            rows += _grads(net)
            if second == "backward":
                loss.backward()
                rows += _grads(net)
            else:
                rows += [g.tensor.clone() for g in mt.autograd.grad(
                    loss, [p.data() for p in _trained(net)])]
        runs[name] = rows
    _same(runs["hybrid"], runs["eager"])
    half = len(runs["hybrid"]) // 4
    _same(runs["hybrid"][half:2 * half], runs["hybrid"][:half])


def test_grad_results_held_across_calls(card):
    eager, hyb = _pair()
    batches = _batches(3)
    runs = {}
    for name, net in (("eager", eager), ("hybrid", hyb)):
        held = []
        for x, y in batches:
            with mt.autograd.record():
                loss = _loss(net(x), y)
            held.append(mt.autograd.grad(
                loss, [p.data() for p in _trained(net)]))
        runs[name] = [g.tensor for gs in held for g in gs]
    _same(runs["hybrid"], runs["eager"])


def test_double_backward_raises(card):
    _eager, hyb = _pair()
    (x, y), = _batches(1)
    w = _trained(hyb)[-1].data()
    for _ in range(2):
        with mt.autograd.record():
            loss = _loss(hyb(x), y)
        (gw,) = mt.autograd.grad(loss, [w], create_graph=True)
        with mt.autograd.record():
            z = (gw * gw).sum()
        with pytest.raises(RuntimeError, match="differentiate twice"):
            z.backward()


def test_backward_after_its_slot_was_taken_raises(card):
    _eager, hyb = _pair()
    (x, y), = _batches(1)
    with mt.autograd.record():
        first = _loss(hyb(x), y)
    first.backward(retain_graph=True)
    with mt.autograd.record():
        later = _loss(hyb(x), y)
    with pytest.raises(MXNetError, match="overwritten"):
        first.backward()
    later.backward()


def test_rebound_parameter_is_captured_anew(card):
    eager, hyb = _pair()
    (x, _y), = _batches(1)
    stale = hyb(x).tensor.clone()
    hyb(x)
    (old,) = _variants(hyb)
    pe = next(iter(eager.collect_params().values()))
    ph = next(iter(hyb.collect_params().values()))
    new = (pe.tensor.detach() * 0.5).contiguous()
    pe.set_data(new)
    with torch.no_grad():
        ph.tensor.data = new.clone()
    got, want = hyb(x).tensor, eager(x).tensor
    _same([got], [want])
    assert not torch.equal(got, stale)
    (var,) = _variants(hyb)
    assert var is not old


def test_cast_drops_the_old_dtypes_graphs(card):
    eager, hyb = _pair()
    (x, _y), = _batches(1)
    hyb(x)
    (old,) = _variants(hyb)
    pool_out = weakref.ref(old.slots[0].outs[0])
    del old
    for net in (eager, hyb):
        net.cast("float64")
    x64 = x.astype("float64")
    _same([hyb(x64).tensor, hyb(x64).tensor], [eager(x64).tensor] * 2)
    gc.collect()
    (var,) = _variants(hyb)
    assert var.slots[0].outs[0].dtype == torch.float64
    assert pool_out() is None


def test_two_threads_replay_one_inference_entry(card):
    eager, hyb = _pair()
    xs = [x for x, _ in _batches(8)]
    want = [eager(x).tensor.clone() for x in xs]
    hyb(xs[0])
    got = {i: [] for i in range(len(xs))}
    errors = []

    def client(part):
        try:
            with mt.gpu(0):
                for _ in range(10):
                    for i in part:
                        got[i].append(hyb(xs[i]).tensor.clone())
        except Exception as err:   # reported by the main thread
            errors.append(repr(err))

    threads = [threading.Thread(target=client, args=(range(k, 8, 2),))
               for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(120)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    torch.cuda.synchronize()
    for i, outs in got.items():
        assert len(outs) == 10
        _same(outs, [want[i]] * 10)
    assert hyb._cached_op.cache_info().misses == 1
