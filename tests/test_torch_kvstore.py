"""The port's one-process KVStore against the JAX package's (the
one-process cases of ``tests/test_kvstore.py``), on the CPU: the same
numpy values through both stores, results compared exactly (a copy or a
sum of a few f32 values), or at 1e-6 after an optimizer update. The
distributed store on several ranks is ``tests/test_torch_dist_kvstore.py``."""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import kvstore as jkv
from mxnet_tpu import nd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch.ops.registry import NotPortedError

CPU = mt.cpu()


def _t(a):
    return mt.nd.array(np.asarray(a, np.float32), ctx=CPU)


def test_create_types():
    for name in ["local", "device", "nccl", "local_update_cpu",
                 "local_allreduce_device"]:
        kv = tkv.create(name)
        assert kv.type == jkv.create(name).type
        assert kv.num_workers == 1 and kv.rank == 0 and kv.num_devices == 1
    with pytest.raises(mt.MXNetError):
        tkv.create("bogus")
    for name in ["dist_sync", "dist_tpu_sync", "dist_async", "dist"]:
        kv = tkv.create(name)         # outside a group: one worker
        assert kv.type == jkv.create(name).type == "dist_tpu_sync"
        assert kv.num_workers == 1 and kv.rank == 0
    assert mt.kv is tkv


def test_init_push_pull_single():
    kv = tkv.create("local")
    kv.init(3, _t(np.ones((2, 3))))
    out = _t(np.zeros((2, 3)))
    ptr = out.tensor.data_ptr()
    kv.pull(3, out=out)
    assert (out.asnumpy() == 1).all()
    kv.push(3, _t(np.full((2, 3), 5.0)))
    kv.pull(3, out=out)
    assert (out.asnumpy() == 5).all() and out.tensor.data_ptr() == ptr


def test_push_aggregates_a_list_of_values_as_jax_does():
    vals = [np.random.RandomState(i).randn(4).astype(np.float32)
            for i in range(4)]
    jstore, tstore = jkv.create("device"), tkv.create("device")
    jstore.init("w", nd.zeros((4,)))
    tstore.init("w", _t(np.zeros(4)))
    jstore.push("w", [nd.array(v) for v in vals])
    tstore.push("w", [_t(v) for v in vals])
    jout, tout = nd.zeros((4,)), _t(np.zeros(4))
    jstore.pull("w", out=jout)
    tstore.pull("w", out=tout)
    np.testing.assert_array_equal(tout.asnumpy(), jout.asnumpy())
    tstore.pushpull("w", [_t(np.ones(4))] * 3, out=tout)
    assert (tout.asnumpy() == 3).all()


def test_list_keys():
    kv = tkv.create("local")
    kv.init([1, 2], [_t(np.ones(2)), _t(np.zeros(2))])
    outs = [_t(np.zeros(2)), _t(np.zeros(2))]
    kv.pull([1, 2], out=outs)
    assert outs[0].asnumpy().tolist() == [1, 1]
    assert outs[1].asnumpy().tolist() == [0, 0]
    with pytest.raises(mt.MXNetError, match="not initialized"):
        kv.push(9, _t(np.ones(2)))


def test_updater_on_kvstore():
    kv = tkv.create("local")
    kv.init(0, _t(np.full((2,), 10.0)))

    def sgd_like(key, grad, weight):
        weight._data.sub_(0.1 * grad._data)

    kv.set_updater(sgd_like)
    kv.push(0, _t(np.ones(2)))
    out = _t(np.zeros(2))
    kv.pull(0, out=out)
    np.testing.assert_allclose(out.asnumpy(), 9.9, rtol=1e-6)


@pytest.mark.parametrize("opt,kw", [
    ("sgd", {"learning_rate": 0.1}),
    ("adam", {"learning_rate": 0.01, "wd": 0.01}),
])
def test_set_optimizer_updates_the_store_as_jax_does(opt, kw, tmp_path):
    rs = np.random.RandomState(0)
    w0 = rs.randn(3, 4).astype(np.float32)
    grads = [rs.randn(3, 4).astype(np.float32) for _ in range(3)]
    jstore, tstore = jkv.create("local"), tkv.create("local")
    jstore.init(0, nd.array(w0))
    tstore.init(0, _t(w0))
    jstore.set_optimizer(mx.optimizer.create(opt, **kw))
    tstore.set_optimizer(mt.optimizer.create(opt, **kw))
    for g in grads:
        jstore.push(0, nd.array(g))
        tstore.push(0, _t(g))
    jout, tout = nd.zeros((3, 4)), _t(np.zeros((3, 4)))
    jstore.pull(0, out=jout)
    tstore.pull(0, out=tout)
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), rtol=1e-6,
                               atol=1e-6)
    # optimizer states round-trip through a file
    fname = str(tmp_path / "kv.states")
    tstore.save_optimizer_states(fname)
    again = tkv.create("local")
    again.init(0, _t(w0))
    again.set_optimizer(mt.optimizer.create(opt, **kw))
    with CPU:
        again.load_optimizer_states(fname)
    assert again._updater.optimizer.num_update == 3
    assert sorted(again._updater.states) == [0]


def test_trainer_with_kvstore():
    net = mt.gluon.nn.Dense(1, in_units=2, use_bias=False, device="cpu")
    net.initialize(mt.init.Constant(1.0))
    kv = tkv.create("device")
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore=kv)
    x = _t(np.ones((4, 2)))
    with mt.autograd.record():
        loss = net(x).sum()
    loss.backward()
    trainer.step(batch_size=4)
    np.testing.assert_allclose(net.weight.detach().numpy(), 0.9, rtol=1e-6)
    assert trainer.last_allreduce_collectives == 1


def test_trainer_drops_a_named_one_card_store():
    net = mt.gluon.nn.Dense(2, in_units=3, device="cpu")
    net.initialize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore="device")
    trainer.allreduce_grads()
    assert trainer._kvstore is None
    assert trainer.last_allreduce_collectives == 0


def test_flat_gradient_buckets_are_not_ported(monkeypatch):
    """Flat buckets are ported: the JAX Trainer's bucket count under each
    cap (weight and bias in one bucket, each alone, per key), and the
    same weights as the JAX Trainer after the step."""
    def run(pkg):
        if pkg == "port":
            net = mt.gluon.nn.Dense(2, in_units=3, device="cpu")
            net.initialize(mt.init.Constant(0.5))
            tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.1},
                                  kvstore=tkv.create("local"))
            x = _t(np.arange(12.0).reshape(4, 3))
            with mt.autograd.record():
                loss = net(x).sum()
        else:
            net = mx.gluon.nn.Dense(2, in_units=3)
            net.initialize(mx.init.Constant(0.5))
            tr = mx.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.1},
                                  kvstore=jkv.create("local"))
            x = nd.array(np.arange(12.0).reshape(4, 3).astype(np.float32))
            with mx.autograd.record():
                loss = net(x).sum()
        loss.backward()
        tr.step(4)
        return tr.last_allreduce_collectives, sorted(
            np.ravel(p.data().asnumpy()).tolist()
            for p in net.collect_params().values())

    for mb, n in (("25", 1), (str(31 / (1 << 20)), 2),
                  (str(32 / (1 << 20)), 1), ("0", 2)):
        monkeypatch.setenv("MXTPU_GRAD_BUCKET_MB", mb)
        got, want = run("port"), run("jax")
        assert got[0] == want[0] == n, mb
        for a, b in zip(got[1], want[1]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_not_ported_surfaces_raise():
    kv = tkv.create("local")
    kv.init("emb", _t(np.arange(12).reshape(4, 3)))
    # row_sparse_pull is ported (tests/test_torch_sparse_kvstore.py)
    rows = _t(np.zeros((2, 3)))
    kv.row_sparse_pull("emb", out=rows, row_ids=_t([1, 3]))
    np.testing.assert_array_equal(rows.asnumpy(),
                                  np.arange(12).reshape(4, 3)[[1, 3]])
    kv.set_gradient_compression({"type": "2bit"})    # ported
    assert kv._compressor.threshold == 0.5
    kv.barrier()
    with pytest.raises(mt.MXNetError, match="no optimizer"):
        kv.save_optimizer_states("unused")
    assert torch.equal(kv._store["emb"].tensor,
                       torch.arange(12.0).reshape(4, 3))
