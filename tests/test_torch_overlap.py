"""Gradient communication overlapped with backward
(``MXTPU_COMM_OVERLAP=on``, ``gluon.Trainer.overlap_scope`` over
``autograd.grad_ready_scope``) in the port:

- overlap on and off train bit for bit in the port (weights and
  optimizer state), for the six grouped optimizers, through the bucketed
  allreduce of a kept store and through a simulated ZeRO world of 2,
  with buckets launched from backward; the port against the JAX package
  at 1e-5 rtol / 1e-6 atol (``tests/test_torch_trainer.py``'s tolerance:
  the nets' matmuls differ in the last bits between the packages);
- a poisoned step under overlapped ZeRO through ``FitLoop`` (the scope
  goes inactive, the step is skipped, the scale backs off), bit for bit
  with the barrier run;
- the autotuner's communication knobs (``bucket_mb``, ``overlap``): the
  plan is the JAX package's, and under a simulated ZeRO world the
  overlap candidate is probed and the tuner locks (JAX
  ``tests/test_zero_overlap.py::test_zero_overlap_autotune_probes_knob``);
- ``grad_ready_scope``: once per gradient, later layers first, after
  the gradient's final value landed;
- a real 2-rank gloo group (``tests/dist/torch_train_worker.py``): a
  net's real backward under the bucketed allreduce and under ZeRO, each
  with and without overlap, all four bit for bit alike.
"""
import contextlib
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import kvstore as jkv
from mxnet_tpu import nd as jnd
from mxnet_tpu.telemetry import autotune as jat

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch.telemetry import autotune as tat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
from torch_dist_common import launch, worker  # noqa: E402

CPU = mt.cpu()
JTOL = dict(rtol=1e-5, atol=1e-6)
OPTS = [
    ("sgd", {"learning_rate": 0.1, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01, "wd": 0.001}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
]
WIDTHS = ((16, 16), (16, 16), (16, 4))


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("MXTPU_ZERO", "MXTPU_ZERO_WORLD", "MXTPU_COMM_OVERLAP",
              "MXTPU_GRAD_BUCKET_MB", "MXTPU_AUTOTUNE", "MXTPU_CHAOS",
              "MXTPU_MEGASTEP"):
        monkeypatch.delenv(k, raising=False)


def _overlap_env(monkeypatch, world, overlap, bucket_mb="0.001"):
    if world:
        monkeypatch.setenv("MXTPU_ZERO", "1")
        monkeypatch.setenv("MXTPU_ZERO_WORLD", str(world))
    else:
        monkeypatch.delenv("MXTPU_ZERO", raising=False)
        monkeypatch.delenv("MXTPU_ZERO_WORLD", raising=False)
    monkeypatch.setenv("MXTPU_COMM_OVERLAP", "on" if overlap else "off")
    monkeypatch.setenv("MXTPU_GRAD_BUCKET_MB", bucket_mb)
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "8")


def _weights():
    rs = np.random.RandomState(5)
    out = {}
    for k, (i, o) in enumerate(WIDTHS):
        out[f"{k}.weight"] = (0.3 * rs.randn(o, i)).astype(np.float32)
        out[f"{k}.bias"] = (0.1 * rs.randn(o)).astype(np.float32)
    return out


def _net(pkg, hybridize=False):
    """Three Dense layers, ReLU between, from one numpy draw."""
    g = mt.gluon if pkg == "port" else jgluon
    with (CPU if pkg == "port" else contextlib.nullcontext()):
        net = g.nn.HybridSequential()
        for k, (i, o) in enumerate(WIDTHS):
            net.add(g.nn.Dense(o, in_units=i,
                               activation="relu" if k < 2 else None))
        net.initialize()
    ws = _weights()
    for name, p in net._collect_params_with_prefix().items():
        p.set_data(ws[name] if pkg == "port" else jnd.array(ws[name]))
    if hybridize:
        net.hybridize()
    return net


def _store(pkg):
    return tkv.create("local") if pkg == "port" else jkv.create("local")


def _train(pkg, opt, kw, overlap, world, monkeypatch, steps=4,
           hybridize=False):
    _overlap_env(monkeypatch, world, overlap)
    net = _net(pkg, hybridize)
    g = mt if pkg == "port" else mx
    tr = g.gluon.Trainer(net.collect_params(), opt, dict(kw),
                         kvstore=_store(pkg))
    rs = np.random.RandomState(0)
    launched = []
    for _ in range(steps):
        x = rs.randn(8, 16).astype(np.float32)
        y = rs.randn(8, 4).astype(np.float32)
        if pkg == "port":
            with CPU, mt.autograd.record():
                loss = ((net(mt.nd.array(x)) - mt.nd.array(y)) ** 2).mean()
        else:
            with jautograd.record():
                loss = ((net(jnd.array(x)) - jnd.array(y)) ** 2).mean()
        with tr.overlap_scope() as scope:
            loss.backward()
        assert scope.active == overlap
        if pkg == "port":
            launched.append(scope.launched_in_backward)
        tr.step(8)
    named = sorted(net._collect_params_with_prefix().items())
    weights = [p.data().asnumpy().copy() for _, p in named]
    states = {i: [np.asarray(s.asnumpy() if hasattr(s, "asnumpy") else s)
                  for s in (st if isinstance(st, (tuple, list)) else [st])
                  if s is not None]
              for i, st in sorted(tr._updaters[0].states.items())}
    return weights, states, launched, tr


@pytest.mark.parametrize("opt,kw", OPTS,
                         ids=[f"{o}-{'-'.join(k)}" for o, k in OPTS])
@pytest.mark.parametrize("world", [0, 2])
def test_overlap_matches_barrier_and_jax(opt, kw, world, monkeypatch):
    bw, bs, bl, btr = _train("port", opt, kw, False, world, monkeypatch)
    ow, os_, ol, otr = _train("port", opt, kw, True, world, monkeypatch)
    jw, _, _, _ = _train("jax", opt, kw, True, world, monkeypatch)
    assert all(n > 1 for n in ol) and not any(bl)
    for a, b in zip(bw, ow):
        np.testing.assert_array_equal(a, b)
    assert sorted(bs) == sorted(os_)
    for i in bs:
        for a, b in zip(bs[i], os_[i]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(ow, jw):
        np.testing.assert_allclose(a, b, **JTOL)
    if world:
        assert otr.last_reduce_scatter_collectives == \
            btr.last_reduce_scatter_collectives > 1
        assert otr.last_allgather_collectives == \
            btr.last_allgather_collectives
    else:
        assert otr.last_allreduce_collectives == \
            btr.last_allreduce_collectives > 1


def test_overlap_hybridized_net(monkeypatch):
    """A hybridized net's training call is one autograd node: its
    gradients land together when its backward returns, and the scope
    launches every bucket then, with the same sums."""
    kw = {"learning_rate": 0.1, "momentum": 0.9}
    bw, _, _, _ = _train("port", "sgd", kw, False, 0, monkeypatch)
    hw, _, hl, _ = _train("port", "sgd", kw, True, 0, monkeypatch,
                          hybridize=True)
    assert all(n > 1 for n in hl)
    for a, b in zip(bw, hw):
        np.testing.assert_array_equal(a, b)


def _fit(pkg, monkeypatch, overlap, chaos_spec=None, steps=8,
         loss_scale=1.0, autotune=None):
    _overlap_env(monkeypatch, 2, overlap)
    if autotune is not None:
        monkeypatch.setenv("MXTPU_AUTOTUNE", autotune)
    net = _net(pkg)
    rs = np.random.RandomState(0)
    X = rs.rand(steps * 4, 16).astype(np.float32)
    Y = rs.rand(steps * 4, 4).astype(np.float32)
    if pkg == "port":
        from mxnet_tpu_torch.contrib import chaos
        with CPU:
            tr = mt.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": 1e-3},
                                  kvstore=tkv.create("local"))
            it = mt.io.NDArrayIter(X, Y, batch_size=4)
            loop = mt.fit.FitLoop(net, tr, lambda o, y: ((o - y) ** 2)
                                  .mean(), it, ckpt_dir=None,
                                  loss_scale=loss_scale, heartbeat=False)
    else:
        from mxnet_tpu.contrib import chaos
        tr = jgluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-3},
                            kvstore=jkv.create("local"))
        it = mx.io.NDArrayIter(X, Y, batch_size=4)
        loop = mx.fit.FitLoop(net, tr, lambda o, y: ((o - y) ** 2).mean(),
                              it, ckpt_dir=None, loss_scale=loss_scale)
    if chaos_spec:
        chaos.install(chaos_spec)
    try:
        with (CPU if pkg == "port" else contextlib.nullcontext()):
            res = loop.fit(epochs=1)
    finally:
        chaos.install("")
    res._weights = [p.data().asnumpy().copy() for _, p in
                    sorted(net._collect_params_with_prefix().items())]
    return res


def test_overlap_nonfinite_step_parity(monkeypatch):
    res_b = _fit("port", monkeypatch, False, "nan_grad@1", loss_scale=128.0)
    res_o = _fit("port", monkeypatch, True, "nan_grad@1", loss_scale=128.0)
    res_j = _fit("jax", monkeypatch, True, "nan_grad@1", loss_scale=128.0)
    for res in (res_b, res_o, res_j):
        assert res.skipped_steps == [1]
        assert res.loss_scale == 64.0
    assert res_b.losses == res_o.losses
    for a, b in zip(res_b._weights, res_o._weights):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(res_o.losses, res_j.losses, **JTOL)
    shares = res_o.step_breakdown["shares"]
    assert shares.get("comm_overlapped", 0.0) > 0.0


def test_zero_overlap_autotune_probes_knob(monkeypatch):
    """JAX tests/test_zero_overlap.py:222 in the port: under a simulated
    ZeRO world the overlap candidate is probed, its exposed-comm share
    recorded, the tuner locks and says the ZeRO round was steered."""
    res = _fit("port", monkeypatch, False, steps=10,
               autotune="on,probe=2,warmup=1,knobs=overlap")
    rep = res.tuning_report
    assert rep is not None and rep["status"] == "locked"
    assert rep["zero"] is True
    assert "overlap" in rep["baseline"]
    cands = {c["label"]: c for c in rep["candidates"]}
    assert "overlap=1" in cands
    assert cands["overlap=1"]["comm_exposed_share"] is not None
    assert rep["chosen"]["overlap"] in (0, 1)
    assert os.environ["MXTPU_COMM_OVERLAP"] == "off"


@pytest.mark.parametrize("spec", ["on", "on,knobs=bucket_mb",
                                  "on,knobs=agg|overlap",
                                  "on,bucket_mb=4|100", "on,overlap=1"])
@pytest.mark.parametrize("store", [True, False])
def test_comm_knob_plan_matches_jax(spec, store, monkeypatch):
    """The candidate plan of a trainer with a store object and without a
    store (the comm knobs need one) is the JAX package's; with the
    default "device" string (a store the Trainer drops on one card) the
    port leaves the comm knobs out, the JAX package probes them."""
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    plans = {}
    for pkg, mod in (("port", tat), ("jax", jat)):
        net = _net(pkg)
        g = mt if pkg == "port" else mx
        tr = g.gluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1},
                             kvstore=_store(pkg) if store else None)
        t = mod.AutoTuner(spec, trainer=tr, data_iter=None)
        plans[pkg] = [(c.label, c.knob, c.knobs) for c in t._build_plan()]
        t.restore_env()
    assert plans["port"] == plans["jax"]
    assert tat.parse_spec(spec) == jat.parse_spec(spec)
    net = _net("port")
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore="device")
    t = tat.AutoTuner(spec, trainer=tr, data_iter=None)
    plan = t._build_plan()
    t.restore_env()
    assert not {c.knob for c in plan} & {"bucket_mb", "overlap"}


def test_compressing_store_drops_bucket_knob(monkeypatch):
    net = _net("port")
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1},
                          kvstore=tkv.create("local"),
                          compression_params={"type": "2bit"})
    t = tat.AutoTuner("on", trainer=tr, data_iter=None)
    assert [c.knob for c in t._build_plan()] == [None, "agg", "overlap"]


def test_grad_ready_scope_order_and_values():
    """Once per gradient, later layers first, after the buffer holds its
    final value; nested scopes call the innermost."""
    net = _net("port")
    named = sorted(net._collect_params_with_prefix().items())
    who = {id(p.data()._grad): k for k, p in named}
    seen, outer = [], []
    x = mt.nd.array(np.ones((2, 16), np.float32), ctx=CPU)
    with mt.autograd.grad_ready_scope(lambda g: outer.append(g)):
        with mt.autograd.grad_ready_scope(
                lambda g: seen.append((who[id(g)], g.asnumpy().copy()))):
            with CPU, mt.autograd.record():
                loss = net(x).sum()
            loss.backward()
    assert not outer
    assert sorted(k for k, _ in seen) == sorted(who.values())
    order = [int(k.split(".")[0]) for k, _ in seen]
    assert order == sorted(order, reverse=True)
    for k, v in seen:
        np.testing.assert_array_equal(v, dict(named)[k].grad().asnumpy())
    seen.clear()
    with CPU, mt.autograd.record():
        loss = net(x).sum()
    loss.backward()
    assert not seen and not outer


NET_MODES = ["net:sgd", "net+overlap:sgd", "zero+net:sgd",
             "zero+net+overlap:sgd"]


def test_real_group_overlap_and_zero_bit_for_bit(tmp_path):
    proc = launch(2, worker("torch_train_worker.py") + [str(tmp_path)] +
                  NET_MODES)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    ref = np.load(tmp_path / f"{NET_MODES[0]}_r0.npz")
    ks = [f for f in ref.files if f.startswith("w")]
    for tag in NET_MODES:
        for r in range(2):
            z = np.load(tmp_path / f"{tag}_r{r}.npz")
            for k in ks:
                np.testing.assert_array_equal(z[k], ref[k])
            assert (int(z["launched"]) > 0) == ("overlap" in tag)
