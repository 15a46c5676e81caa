"""ZeRO-1 sharded optimizer state (``parallel/zero.py``) in the port
against the JAX package: the cases of ``tests/test_zero.py`` that need no
real group run in simulated worlds (``MXTPU_ZERO_WORLD`` 2 and 4) on the
same numpy weights and gradients in both packages, at 1e-6 rtol / 1e-7
atol, and the port's ZeRO run bit for bit against its own unsharded run;
then a real 2-rank gloo group (``tests/dist/torch_train_worker.py``)
against the JAX package's simulated world 2 on the summed gradients.
"""
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import kvstore as jkv
from mxnet_tpu import nd as jnd
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.parallel import zero as jzero

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch.parallel import zero as tzero

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))
sys.path.insert(0, os.path.join(ROOT, "tests", "dist"))
import torch_train_worker as W  # noqa: E402
from torch_dist_common import launch, worker  # noqa: E402

CPU = mt.cpu()
TOL = dict(rtol=1e-6, atol=1e-7)
OPTS = [
    ("sgd", {"learning_rate": 0.1, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01, "wd": 0.001}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k in ("MXTPU_ZERO", "MXTPU_ZERO_WORLD", "MXTPU_COMM_OVERLAP",
              "MXTPU_GRAD_BUCKET_MB", "MXTPU_CHAOS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")


def _zero_env(monkeypatch, world):
    if world:
        monkeypatch.setenv("MXTPU_ZERO", "1")
        monkeypatch.setenv("MXTPU_ZERO_WORLD", str(world))
    else:
        monkeypatch.delenv("MXTPU_ZERO", raising=False)
        monkeypatch.delenv("MXTPU_ZERO_WORLD", raising=False)


def _values(seed, n, shapes, steps, poison=None):
    rs = np.random.RandomState(seed)
    shapes = shapes or [(3, j + 2) for j in range(n)]
    ws = [rs.randn(*s).astype(np.float32) for s in shapes]
    gs = []
    for step in range(steps):
        g = [rs.randn(*s).astype(np.float32) for s in shapes]
        if poison is not None and poison[0] == step:
            g[poison[1]][0, 0] = np.nan
        gs.append(g)
    return ws, gs


class Port:
    pkg = "port"

    def __init__(self, ws, dtype="float32", prefix="p"):
        self.params = []
        for j, w in enumerate(ws):
            p = mt.gluon.Parameter(f"{prefix}{j}", shape=w.shape,
                                   dtype=dtype)
            p.initialize(mt.init.Constant(0.0), ctx=CPU)
            p.set_data(w)
            self.params.append(p)

    def trainer(self, opt, kw, store=True):
        return mt.gluon.Trainer(self.params, opt, dict(kw),
                                kvstore=tkv.create("local") if store
                                else None)

    def set_grads(self, gs):
        for p, g in zip(self.params, gs):
            p.grad()._data.copy_(torch.from_numpy(g))
            p._fresh_grad = True

    def weights(self):
        return [p.tensor.detach().float().numpy().copy()
                for p in self.params]

    @staticmethod
    def finite(flag):
        return bool(flag)


class Jax:
    pkg = "jax"

    def __init__(self, ws, dtype="float32", prefix="p"):
        self.params = []
        for j, w in enumerate(ws):
            p = jgluon.Parameter(f"{prefix}{j}", shape=w.shape, dtype=dtype)
            p.initialize(mx.init.Constant(0.0))
            p.set_data(jnd.array(w))
            self.params.append(p)

    def trainer(self, opt, kw, store=True):
        return jgluon.Trainer(self.params, opt, dict(kw),
                              kvstore=jkv.create("local") if store
                              else None)

    def set_grads(self, gs):
        for p, g in zip(self.params, gs):
            garr = jnd.array(g)
            if str(p.data().dtype) != "float32":
                garr = garr.astype(p.data().dtype)
            p._grad._rebind(garr._data)
            p._fresh_grad = True

    def weights(self):
        return [p.data().astype("float32").asnumpy() for p in self.params]

    @staticmethod
    def finite(flag):
        import jax
        return bool(jax.device_get(flag))


def _close(a, b, **tol):
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, **(tol or TOL))


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def _run(cls, opt, kw, world, monkeypatch, steps=3, dtype="float32", n=6,
         seed=0, shapes=None, prefix="p"):
    _zero_env(monkeypatch, world)
    ws, gs = _values(seed, n, shapes, steps)
    h = cls(ws, dtype, prefix)
    tr = h.trainer(opt, kw)
    for g in gs:
        h.set_grads(g)
        tr.step(4)
    return h, tr


@pytest.mark.parametrize("opt,kw", OPTS,
                         ids=[f"{o}-{'-'.join(k)}" for o, k in OPTS])
@pytest.mark.parametrize("world", [2, 4])
def test_zero_matches_unsharded_and_jax(opt, kw, world, monkeypatch):
    ref, tr_ref = _run(Port, opt, kw, 0, monkeypatch)
    assert tr_ref._zero in (None, False)
    got, tr = _run(Port, opt, kw, world, monkeypatch)
    want, jtr = _run(Jax, opt, kw, world, monkeypatch)
    assert tr._zero.world == jtr._zero.world == world
    assert tr._zero.owners == jtr._zero.owners
    for t in (tr, jtr):
        assert t.last_reduce_scatter_collectives >= 1
        assert t.last_allgather_collectives >= 1
        assert t.last_allreduce_collectives == 0
    assert tr.last_reduce_scatter_collectives == \
        jtr.last_reduce_scatter_collectives
    _equal(got.weights(), ref.weights())
    _close(got.weights(), want.weights())
    assert set(tr._updaters[0].states) == set(jtr._updaters[0].states)


def test_zero_multi_precision_parity(monkeypatch):
    kw = {"learning_rate": 0.05, "momentum": 0.9, "multi_precision": True}
    ref, _ = _run(Port, "sgd", kw, 0, monkeypatch, dtype="bfloat16")
    got, tr = _run(Port, "sgd", kw, 2, monkeypatch, dtype="bfloat16")
    want, jtr = _run(Jax, "sgd", kw, 2, monkeypatch, dtype="bfloat16")
    _equal(got.weights(), ref.weights())
    _equal(got.weights(), want.weights())
    for i in range(len(got.params)):
        np.testing.assert_allclose(
            tr._updaters[0].states[i][1].tensor.numpy(),
            jtr._updaters[0].states[i][1].asnumpy(), rtol=1e-6)
    from mxnet_tpu_torch.telemetry import memory as mem
    led = mem.ledger()
    assert all(led.live_bytes("masters", owner_prefix=f"master:zr{r}/2:p")
               > 0 for r in range(2))


def _sentinel_run(cls, world, monkeypatch, poison):
    _zero_env(monkeypatch, world)
    ws, gs = _values(3, 5, None, 3, poison=poison)
    h = cls(ws)
    tr = h.trainer("adam", {"learning_rate": 0.01})
    flags = []
    for g in gs:
        h.set_grads(g)
        tr.allreduce_grads()
        flag = tr.update_with_sentinel(4)
        assert flag is not None
        flags.append(h.finite(flag))
        if not flags[-1]:
            tr.rollback_step()
            for p in h.params:
                p.zero_grad()
    return h, tr, flags


def test_zero_nan_skip_sentinel_parity(monkeypatch):
    ref, tr_ref, f_ref = _sentinel_run(Port, 0, monkeypatch, (1, 2))
    got, tr, f = _sentinel_run(Port, 4, monkeypatch, (1, 2))
    want, jtr, f_j = _sentinel_run(Jax, 4, monkeypatch, (1, 2))
    assert f == f_ref == f_j == [True, False, True]
    assert tr._optimizer.num_update == jtr._optimizer.num_update == \
        tr_ref._optimizer.num_update == 2
    _equal(got.weights(), ref.weights())
    _close(got.weights(), want.weights())


def test_zero_skipped_first_step_creates_no_state(monkeypatch):
    from mxnet_tpu_torch.telemetry import memory as mem
    led = mem.ledger()
    for cls in (Port, Jax):
        _zero_env(monkeypatch, 2)
        ws, gs = _values(0, 3, None, 1, poison=(0, 0))
        h = cls(ws, prefix="zskip")
        tr = h.trainer("sgd", {"learning_rate": 0.1, "momentum": 0.9})
        h.set_grads(gs[0])
        tr.allreduce_grads()
        flag = tr.update_with_sentinel(2)
        assert flag is not None and not h.finite(flag)
        tr.rollback_step()
        assert not tr._updaters[0].states
        assert tr._optimizer.num_update == 0
    for r in range(2):
        assert led.live_bytes("optimizer",
                              owner_prefix=f"state:zr{r}/2:zskip") == 0


def _fit(pkg, world, monkeypatch):
    from mxnet_tpu_torch.contrib import chaos as tchaos
    from mxnet_tpu.contrib import chaos as jchaos
    _zero_env(monkeypatch, world)
    rs = np.random.RandomState(0)
    X = rs.rand(16, 3).astype(np.float32)
    Y = rs.rand(16, 2).astype(np.float32)
    if pkg == "port":
        with CPU:
            net = mt.gluon.nn.Dense(2, in_units=3)
            net.initialize(mt.init.Constant(0.5))
            tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.05},
                                  kvstore=tkv.create("local"))
            it = mt.io.NDArrayIter(X, Y, batch_size=4)
            loop = mt.fit.FitLoop(net, tr, lambda o, y: ((o - y) ** 2)
                                  .mean(), it, ckpt_dir=None,
                                  loss_scale=128.0, heartbeat=False)
            tchaos.install("nan_grad@1")
            try:
                res = loop.fit(epochs=1)
            finally:
                tchaos.install("")
        weight = [p for k, p in net.collect_params().items()
                  if k.endswith("weight")][0]
        return res, weight.data().asnumpy()
    mx.random.seed(0)
    net = jgluon.nn.Dense(2, in_units=3)
    net.initialize(mx.init.Constant(0.5))
    tr = jgluon.Trainer(net.collect_params(), "sgd",
                        {"learning_rate": 0.05}, kvstore=jkv.create("local"))
    it = mx.io.NDArrayIter(X, Y, batch_size=4)
    loop = mx.fit.FitLoop(net, tr, lambda o, y: ((o - y) ** 2).mean(), it,
                          ckpt_dir=None, loss_scale=128.0)
    jchaos.install("nan_grad@1")
    try:
        res = loop.fit(epochs=1)
    finally:
        jchaos.install("")
    return res, net.weight.data().asnumpy()


def test_zero_fitloop_loss_scale_parity(monkeypatch):
    res_p, w_p = _fit("port", 2, monkeypatch)
    res_u, w_u = _fit("port", 0, monkeypatch)
    res_j, w_j = _fit("jax", 2, monkeypatch)
    for res in (res_p, res_u, res_j):
        assert res.skipped_steps == [1]
        assert res.loss_scale == 64.0
    assert res_p.zero == res_j.zero
    assert res_p.zero["world"] == 2 and res_u.zero is None
    assert res_p.losses == res_u.losses
    np.testing.assert_array_equal(w_p, w_u)
    np.testing.assert_allclose(res_p.losses, res_j.losses, rtol=1e-6)
    np.testing.assert_allclose(w_p, w_j, **TOL)


def test_zero_ledger_one_over_n(monkeypatch):
    from mxnet_tpu_torch.telemetry import memory as mem
    led = mem.ledger()
    kw = {"learning_rate": 1e-3, "multi_precision": True}
    shapes = [(16, 16)] * 8
    keep = _run(Port, "adam", kw, 0, monkeypatch, steps=1,
                dtype="bfloat16", n=8, shapes=shapes, prefix="zubase")
    unsharded = led.live_bytes("optimizer", owner_prefix="state:zubase") + \
        led.live_bytes("masters", owner_prefix="master:zubase")
    assert unsharded > 0
    got = _run(Port, "adam", kw, 4, monkeypatch, steps=1,
               dtype="bfloat16", n=8, shapes=shapes, prefix="zshard")
    for r in range(4):
        per_rank = led.live_bytes(
            "optimizer", owner_prefix=f"state:zr{r}/4:zshard") + \
            led.live_bytes("masters", owner_prefix=f"master:zr{r}/4:zshard")
        assert per_rank == unsharded // 4, (r, per_rank, unsharded)
    _equal(got[0].weights(), keep[0].weights())


def test_zero_checkpoint_topology_portable(monkeypatch, tmp_path):
    """A world-4 ZeRO state file restores into an unsharded run and the
    other way round (one on-disk format), in both packages, and the
    continued trajectories agree across packages."""
    def build(cls, world):
        _zero_env(monkeypatch, world)
        ws, _ = _values(0, 6, None, 0)
        h = cls(ws)
        return h, h.trainer("adam", {"learning_rate": 0.01})

    _, gs = _values(1, 6, None, 2)
    files = {}
    for cls in (Port, Jax):
        for world in (4, 0):
            h, tr = build(cls, world)
            for g in gs:
                h.set_grads(g)
                tr.step(4)
            f = str(tmp_path / f"{cls.pkg}{world}")
            tr.save_states(f)
            files[(cls.pkg, world)] = (f, h.weights())
    with open(files[("port", 4)][0], "rb") as f, CPU:
        blob = pickle.loads(f.read())
    from mxnet_tpu_torch.optimizer.optimizer import Updater
    counts = blob.pop(Updater.COUNTS_KEY)
    blob.pop(Updater.NUM_UPDATE_KEY)
    assert set(blob) == set(range(6)) and set(counts) == set(range(6))
    assert all(c == 2 for c in counts.values())
    _, g_next = _values(99, 6, None, 1)
    finals = {}
    for cls, src, world in ((Port, ("port", 4), 0), (Port, ("port", 0), 4),
                            (Jax, ("jax", 4), 0), (Jax, ("jax", 0), 4)):
        h, tr = build(cls, world)
        for p, w in zip(h.params, files[src][1]):
            p.set_data(w if cls is Port else jnd.array(w))
        with CPU:
            tr.load_states(files[src][0])
        h.set_grads(g_next[0])
        tr.step(4)
        finals[(cls.pkg, src, world)] = h.weights()
    vals = list(finals.values())
    for v in vals[1:]:
        _close(v, vals[0])


def test_zero_flaky_reduce_scatter_retries_once_applied(monkeypatch):
    monkeypatch.setenv("MXNET_KV_RETRY_MAX", "30")
    monkeypatch.setenv("MXNET_KV_RETRY_BASE_MS", "0.1")
    from mxnet_tpu_torch.contrib import chaos

    def run(flake):
        if flake:
            chaos.install("kv_flake:0.4")
        try:
            h, _ = _run(Port, "adam", {"learning_rate": 0.01}, 2,
                        monkeypatch, n=5)
            plan = chaos.active()
        finally:
            chaos.install("")
        return h, plan

    clean, _ = run(False)
    flaky, plan = run(True)
    assert plan.injected["kv_flake"] > 0
    _equal(flaky.weights(), clean.weights())


def test_zero_counters_and_metrics(monkeypatch):
    from mxnet_tpu_torch.telemetry import default_registry
    monkeypatch.setenv("MXTPU_GRAD_BUCKET_MB", "0.0001")
    shapes = [(8, 4)] * 6
    _, tr = _run(Port, "sgd", {"learning_rate": 0.1}, 2, monkeypatch,
                 steps=1, shapes=shapes)
    _, jtr = _run(Jax, "sgd", {"learning_rate": 0.1}, 2, monkeypatch,
                  steps=1, shapes=shapes)
    assert tr.last_reduce_scatter_collectives > 1
    assert (tr.last_reduce_scatter_collectives,
            tr.last_allgather_collectives,
            tr.last_allreduce_collectives) == \
        (jtr.last_reduce_scatter_collectives,
         jtr.last_allgather_collectives, jtr.last_allreduce_collectives)
    text = default_registry().render_prometheus()
    assert "mxtpu_zero_reduce_scatter_collectives_total" in text
    assert "mxtpu_zero_allgather_collectives_total" in text
    assert "mxtpu_zero_world_size 2" in text


def test_zero_comm_spans_attributed(monkeypatch):
    """The sharded collectives are comm spans (``kv_reduce_scatter`` /
    ``kv_allgather`` on the bucket keys), as in the JAX package."""
    from mxnet_tpu_torch.telemetry.tracer import tracer
    tracer.configure("on")
    try:
        _run(Port, "sgd", {"learning_rate": 0.1}, 2, monkeypatch, steps=1,
             n=4)
        names = [e.get("name", "") for e in tracer.events()]
    finally:
        tracer.configure("off")
    assert any(n.startswith("kv_reduce_scatter:_gbkt") for n in names)
    assert any(n.startswith("kv_allgather:_gbkt") for n in names)


def test_zero_kill_resume_round_trip(monkeypatch, tmp_path):
    """Chaos kill@3 under ZeRO world 2 with gather-on-save checkpoints:
    the resumed run replays the fault-free trajectory bit for bit."""
    from mxnet_tpu_torch.contrib import chaos
    _zero_env(monkeypatch, 2)
    rs = np.random.RandomState(0)
    X = rs.rand(24, 3).astype(np.float32)
    Y = rs.rand(24, 2).astype(np.float32)

    def build(d):
        with CPU:
            net = mt.gluon.nn.Dense(2, in_units=3)
            net.initialize(mt.init.Constant(0.5))
            tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.05, "momentum": 0.9},
                                  kvstore=tkv.create("local"))
            it = mt.io.NDArrayIter(X, Y, batch_size=4, shuffle=True,
                                   seed=7)
            loop = mt.fit.FitLoop(net, tr, lambda o, y: ((o - y) ** 2)
                                  .mean(), it, ckpt_dir=d, ckpt_every=2,
                                  async_ckpt=False, seed=7,
                                  heartbeat=False)
        return net, loop

    def weights(net):
        return [p.data().asnumpy() for _, p in
                sorted(net.collect_params().items())]

    net_ref, loop_ref = build(str(tmp_path / "ref"))
    with CPU:
        res_ref = loop_ref.fit(epochs=2)
    chaos.install("kill@3")
    try:
        _, loop_a = build(str(tmp_path / "killed"))
        with pytest.raises(chaos.ChaosKilled), CPU:
            loop_a.fit(epochs=2)
    finally:
        chaos.install("")
    net_b, loop_b = build(str(tmp_path / "killed"))
    with CPU:
        res_b = loop_b.fit(epochs=2)
    assert res_b.resumed_from == 2 and res_b.zero["world"] == 2
    assert res_ref.losses[res_ref.step - len(res_b.losses):] == res_b.losses
    _equal(weights(net_b), weights(net_ref))


def test_zero_strict_parse_and_guards(monkeypatch):
    for mod, err in ((tzero, mt.MXNetError), (jzero, JMXNetError)):
        monkeypatch.setenv("MXTPU_ZERO", "bogus")
        with pytest.raises(err, match="MXTPU_ZERO"):
            mod.zero_requested()
        monkeypatch.setenv("MXTPU_ZERO_WORLD", "-2")
        with pytest.raises(err, match="MXTPU_ZERO_WORLD"):
            mod.simulated_world()
        monkeypatch.setenv("MXTPU_ZERO_WORLD", "four")
        with pytest.raises(err, match="integer"):
            mod.simulated_world()
    _zero_env(monkeypatch, 2)
    ws, gs = _values(0, 2, None, 2)
    for cls, err in ((Port, mt.MXNetError), (Jax, JMXNetError)):
        h = cls(ws)
        tr = h.trainer("sgd", {"learning_rate": 0.1}, store=False)
        h.set_grads(gs[0])
        with pytest.raises(err, match="requires a kvstore"):
            tr.step(2)
        tr2 = cls(ws).trainer("ftrl", {"learning_rate": 0.1})
        with pytest.raises(err, match="grouped"):
            tr2._init_kvstore() or tr2._zero_plane()
        monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "0")
        tr3 = cls(ws).trainer("sgd", {"learning_rate": 0.1})
        with pytest.raises(err, match="AGGREGATION"):
            tr3._init_kvstore() or tr3._zero_plane()
        monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
        h4 = cls(ws)
        tr4 = h4.trainer("sgd", {"learning_rate": 0.1})
        h4.set_grads(gs[0])
        tr4.step(2)
        tr4._kvstore.set_gradient_compression({"type": "2bit",
                                               "threshold": 0.5})
        h4.set_grads(gs[1])
        with pytest.raises(err, match="compression"):
            tr4.step(2)


def test_zero_bare_update_refused(monkeypatch):
    _zero_env(monkeypatch, 2)
    ws, gs = _values(0, 3, None, 1)
    for cls, err in ((Port, mt.MXNetError), (Jax, JMXNetError)):
        h = cls(ws)
        tr = h.trainer("sgd", {"learning_rate": 0.1})
        h.set_grads(gs[0])
        with pytest.raises(err, match="reduce-scatter"):
            tr.update(4)
        assert not tr._updaters[0].states
        tr.allreduce_grads()
        tr.update(4)
        assert tr.last_reduce_scatter_collectives >= 1


def test_zero_composes_with_overlap(monkeypatch):
    """The scope stays active under ZeRO; raw gradients never pass the
    hook, so every bucket rides finalize, on the barrier trajectory."""
    out = {}
    for overlap in (False, True):
        monkeypatch.setenv("MXTPU_COMM_OVERLAP", "on" if overlap else "off")
        _zero_env(monkeypatch, 2)
        ws, gs = _values(0, 4, None, 2)
        h = Port(ws)
        tr = h.trainer("sgd", {"learning_rate": 0.1})
        for g in gs:
            with tr.overlap_scope() as scope:
                assert scope.active == overlap
            h.set_grads(g)
            tr.step(4)
            assert tr.last_reduce_scatter_collectives >= 1
            assert tr._zero_step is None
        out[overlap] = h.weights()
    _equal(out[True], out[False])


def test_zero_stale_grad_declines_like_unsharded(monkeypatch):
    _zero_env(monkeypatch, 2)
    ws, gs = _values(0, 3, None, 1)
    for cls in (Port, Jax):
        h = cls(ws)
        tr = h.trainer("sgd", {"learning_rate": 0.1})
        h.set_grads(gs[0])
        tr.allreduce_grads()
        h.params[1]._fresh_grad = False
        before = h.weights()
        assert tr.update_with_sentinel(2) is None
        _equal(h.weights(), before)


@pytest.mark.parametrize("shapes,world", [
    ([(16, 16)] * 8, 4),
    ([(64, 64), (2, 2), (2, 2), (2, 2), (2, 2)], 2),
    ([(3, 5), (7,), (2, 9), (1,), (11, 2), (4, 4), (6,)], 3),
])
def test_zero_partition_matches_jax(shapes, world):
    ws = [np.zeros(s, np.float32) for s in shapes]
    tp, jp = Port(ws).params, Jax(ws).params
    assert tzero.partition(tp, world) == jzero.partition(jp, world)
    assert tzero.partition(tp, world) == tzero.partition(tp, world)


# ------------------------------------------------ a real group

ZMODES = ["zero:sgd", "zero:adam"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("zero_train")
    proc = launch(2, worker("torch_train_worker.py") + [str(out)] + ZMODES)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    return out


@pytest.mark.parametrize("tag", ZMODES)
def test_real_group_matches_jax_simulated_world2(trained, tag, monkeypatch):
    """Two gloo ranks under MXTPU_ZERO=1, each with its own gradients,
    against the JAX package's simulated world 2 on their sum; the
    gathered state file is the unsharded format, equal to the JAX one."""
    opt = tag.split(":")[1]
    zs = [np.load(trained / f"{tag}_r{r}.npz") for r in range(2)]
    got = [[z[f"w{j}"] for j in range(len(W.SHAPES))] for z in zs]
    _equal(got[0], got[1])
    _zero_env(monkeypatch, 2)
    h = Jax(W.init_weights())
    tr = h.trainer(opt, W.OPTS[opt])
    for step in range(W.STEPS):
        h.set_grads([a + b for a, b in zip(*(W.grads(step, r)
                                              for r in range(2)))])
        tr.step(4)
    _close(got[0], h.weights())
    with open(trained / f"{tag}.states", "rb") as f, CPU:
        blob = pickle.loads(f.read())
    want = pickle.loads(tr.get_states_bytes())
    from mxnet_tpu.optimizer.optimizer import Updater
    assert blob.pop(Updater.COUNTS_KEY) == want.pop(Updater.COUNTS_KEY)
    assert blob.pop(Updater.NUM_UPDATE_KEY) == want.pop(
        Updater.NUM_UPDATE_KEY)
    assert set(blob) == set(want) == set(range(len(W.SHAPES)))
    allgather, allreduce, reduce_scatter = zs[0]["counts"].tolist()
    assert (allgather, allreduce, reduce_scatter) == (1, 0, 1)
