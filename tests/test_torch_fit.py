"""``fit.FitLoop`` of the port against the JAX package's, on the CPU.

The scenarios of ``tests/test_chaos.py`` run in both packages from the
same numpy data and the same weights (the JAX net's Xavier draw from
``mx.random.seed(0)``, carried to the port by structural name): a tiny
MLP (Dense 8 ReLU, Dense 1), SGD momentum 0.9, batch 8 of 64 samples
shuffled with seed 13, f32. Each compares losses (1e-5 relative, the
JAX tests' ``rtol``), ``skipped_steps``, ``loss_scale``,
``resumed_from`` and the final weights (1e-5 relative), and the port
against itself where the JAX test does (a resumed tail equals the
fault-free tail):

- fault-free, with the keys of ``FitResult`` and of its
  ``step_breakdown`` / ``memory`` / ``numerics`` fields;
- ``kill@10`` and resume, the corrupt latest checkpoint's fallback,
  ``nan_grad`` skipped with the parameters and optimizer state untouched,
  ``preempt@5`` (exit code 75, final ckpt-5, resume), a no-op resume,
  ``ignore_stale_grad``, loss scaling with backoff and growth (the
  loss-scale timeline), and the same with asynchronous checkpoints;
- the flag and the loss reach the host in one transfer a step;
- what is not ported raises ``NotPortedError`` naming its ROADMAP item,
  before any step runs and before the signal handlers install.
"""
import dataclasses
import gc
import os
import signal

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import fault as jfault
from mxnet_tpu import fit as jfit
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import io as jio
from mxnet_tpu import nd as jnd
from mxnet_tpu.contrib import chaos as jchaos

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch import fit as tfit
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.contrib import chaos as tchaos
from mxnet_tpu_torch.ops.registry import NotPortedError

RTOL = 1e-5
PKGS = {"jax": (mx, jfit, jio, jnd, jchaos, jfault),
        "port": (mt, tfit, tio, tnd, tchaos, tfault)}


@pytest.fixture(autouse=True)
def _host_and_no_plan():
    jchaos.uninstall()
    tchaos.uninstall()
    with mt.cpu():
        yield
    jchaos.uninstall()
    tchaos.uninstall()


def _data(n=64, d=4, bs=8):
    rs = np.random.RandomState(42)
    X = rs.randn(n, d).astype(np.float32)
    w = rs.randn(d, 1).astype(np.float32)
    Y = X @ w + 0.01 * rs.randn(n, 1).astype(np.float32)
    return X, Y, bs


def _mse(p, y):
    return ((p - y) ** 2).mean()


def _weights(net):
    return {k: p.data().asnumpy().copy()
            for k, p in net._collect_params_with_prefix().items()}


_INIT = {}


def _init_weights():
    """The JAX net's initial weights by structural name (seed 0)."""
    if not _INIT:
        mx.random.seed(0)
        net = jgluon.nn.HybridSequential(prefix="mlp_")
        net.add(jgluon.nn.Dense(8, activation="relu", prefix="d0_"),
                jgluon.nn.Dense(1, prefix="d1_"))
        net.initialize(mx.init.Xavier())
        with mx.autograd.pause():
            net(jnd.ones((1, 4)))
        _INIT.update(_weights(net))
    return _INIT


def _net(pkg):
    m = PKGS[pkg][0]
    if pkg == "jax":
        mx.random.seed(0)
        np.random.seed(0)
    net = m.gluon.nn.HybridSequential(prefix="mlp_")
    net.add(m.gluon.nn.Dense(8, activation="relu", prefix="d0_"),
            m.gluon.nn.Dense(1, prefix="d1_"))
    net.initialize(m.init.Xavier())
    with m.autograd.pause():
        net(m.nd.ones((1, 4)))
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(m.nd.array(_init_weights()[k]))
    return net


def _build(pkg, ckpt_dir, ckpt_every=2, loss_scale=1.0, async_ckpt=False,
           **kw):
    """The deterministic net / trainer / iterator / loop of
    ``tests/test_chaos.py``, in either package."""
    m, fit, io = PKGS[pkg][:3]
    net = _net(pkg)
    trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9},
                              kvstore=None)
    X, Y, bs = _data()
    itr = io.NDArrayIter(X, Y, batch_size=bs, shuffle=True, seed=13)
    loop = fit.FitLoop(net, trainer, _mse, itr, ckpt_dir=ckpt_dir,
                       ckpt_every=ckpt_every, async_ckpt=async_ckpt,
                       heartbeat=False, loss_scale=loss_scale, **kw)
    return net, trainer, loop


def _run(pkg, ckpt_dir, epochs, plan=None, **kw):
    chaos = PKGS[pkg][4]
    net, trainer, loop = _build(pkg, ckpt_dir, **kw)
    if plan:
        chaos.install(plan)
    try:
        res = loop.fit(epochs=epochs)
    finally:
        chaos.uninstall()
    return net, trainer, res


def _same_result(port, jax_):
    """Port and JAX FitResults (and final weights) agree."""
    (tnet, tres), (jnet, jres) = port, jax_
    np.testing.assert_allclose(tres.losses, jres.losses, rtol=RTOL)
    assert tres.step == jres.step and tres.epoch == jres.epoch
    assert tres.skipped_steps == jres.skipped_steps
    assert tres.loss_scale == jres.loss_scale
    assert tres.resumed_from == jres.resumed_from
    tw, jw = _weights(tnet), _weights(jnet)
    assert sorted(tw) == sorted(jw)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=RTOL, atol=1e-6,
                                   err_msg=k)


def _both(fn, tmp_path=None):
    return {pkg: fn(pkg, None if tmp_path is None else str(tmp_path / pkg))
            for pkg in ("jax", "port")}


# ------------------------------------------------------------- fault-free

def _ledger_bytes():
    """Each package's process-wide memory ledger, bytes by category."""
    from mxnet_tpu.telemetry import memory as jmem
    from mxnet_tpu_torch.telemetry import memory as tmem
    return {"jax": jmem.ledger().summary()["by_category"],
            "port": tmem.ledger().summary()["by_category"]}


def _added(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def test_fault_free_run_matches_jax(tmp_path):
    gc.collect()      # the ledger is process-wide: free earlier tests' nets
    # what earlier tests keep alive (e.g. tests/test_fleet_router.py's
    # JAX parameters) stays in the ledgers: compare what this run adds
    before = _ledger_bytes()
    out = _both(lambda pkg, d: _run(pkg, d, 2), tmp_path)
    (tnet, _, tres), (jnet, _, jres) = out["port"], out["jax"]
    assert tres.step == 16 and not tres.skipped_steps
    _same_result((tnet, tres), (jnet, jres))
    assert [f.name for f in dataclasses.fields(tfit.FitResult)] == \
        [f.name for f in dataclasses.fields(jfit.FitResult)]
    assert sorted(tres.step_breakdown) == sorted(jres.step_breakdown)
    assert sorted(tres.memory) == sorted(jres.memory)
    assert tres.numerics is None and jres.numerics is None
    assert tres.efficiency is None and jres.efficiency is None
    assert tres.step_breakdown["steps"] == 16
    assert {"data_wait", "compute", "optimizer", "checkpoint"} <= \
        set(tres.step_breakdown["shares"])
    assert _added(tres.memory["by_category"], before["port"]) == \
        _added(jres.memory["by_category"], before["jax"]) != {}
    assert len(tres.memory["per_step"]) == 16


def test_one_transfer_a_step(tmp_path, monkeypatch):
    """The finiteness flag and the loss reach the host together: one
    fetch per trained step."""
    calls = []
    real = tfit.FitLoop._fetch

    def counting(flag, loss, nstats=None):
        calls.append(1)
        return real(flag, loss, nstats)

    monkeypatch.setattr(tfit.FitLoop, "_fetch", staticmethod(counting))
    _, _, res = _run("port", str(tmp_path), 1)
    assert res.step == 8 and len(calls) == 8


# ------------------------------------------------------------- kill chain

def _kill_resume(pkg, d, async_ckpt=False):
    chaos = PKGS[pkg][4]
    chaos.install("kill@10")
    _, _, loop = _build(pkg, d, async_ckpt=async_ckpt)
    with pytest.raises(chaos.ChaosKilled):
        loop.fit(epochs=2)
    chaos.uninstall()
    if async_ckpt:
        # the killed run's writer may still be finishing ckpt-10
        tfault.CheckpointManager(d).wait()
        _await_done(d, 10)
    net, _, res = _run(pkg, d, 2, async_ckpt=async_ckpt)
    return net, res


def _await_done(d, step, timeout=30.0):
    import time
    t = time.time()
    while not os.path.exists(os.path.join(d, f"ckpt-{step}", "DONE")):
        assert time.time() - t < timeout, f"ckpt-{step} never completed"
        time.sleep(0.01)


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_kill_resume_replays_fault_free_trajectory(tmp_path, async_ckpt):
    ff = {pkg: _run(pkg, str(tmp_path / f"ff_{pkg}"), 2)
          for pkg in ("jax", "port")}
    out = {"jax": _kill_resume("jax", str(tmp_path / "jax")),
           "port": _kill_resume("port", str(tmp_path / "port"),
                                async_ckpt)}
    for pkg in ("jax", "port"):
        net, res = out[pkg]
        assert res.resumed_from == 10 and res.step == 16
        np.testing.assert_allclose(res.losses, ff[pkg][2].losses[10:],
                                   rtol=RTOL)
    _same_result(out["port"], out["jax"])
    # the resumed run's final state equals the fault-free run's, bit for
    # bit, in the port
    tw, fw = _weights(out["port"][0]), _weights(ff["port"][0])
    for k in fw:
        np.testing.assert_array_equal(tw[k], fw[k], err_msg=k)


def test_staged_resume_inside_a_later_epoch(tmp_path):
    """DeviceStagingIter passes set_epoch / set_position through, so a
    staged run resumed from a checkpoint inside its second epoch (ckpt-10
    of 8-batch epochs) replays the fault-free run bit for bit, and the
    staged loop trains on the bare loop's batches. (The JAX package's
    wrapper lacks both: its relaunched run would reshuffle epoch 1.)"""
    def staged(d, plan=None):
        net, trainer, loop = _build("port", d)
        loop._iter = tio.DeviceStagingIter(loop._iter)
        if plan:
            tchaos.install(plan)
        try:
            res = loop.fit(epochs=2)
        except tchaos.ChaosKilled:
            res = None
        finally:
            tchaos.uninstall()
        return net, res
    bare_net, bare = _run("port", str(tmp_path / "bare"), 2)[0::2]
    ff_net, ff = staged(str(tmp_path / "ff"))
    assert ff.losses == bare.losses
    assert staged(str(tmp_path / "k"), "kill@10")[1] is None
    net, res = staged(str(tmp_path / "k"))
    assert res.resumed_from == 10 and res.losses == ff.losses[10:]
    for k, w in _weights(ff_net).items():
        np.testing.assert_array_equal(_weights(net)[k], w, err_msg=k)


def _corrupt_fallback(pkg, d):
    _run(pkg, d, 1, plan="ckpt_corrupt@8", ckpt_every=4)
    net, _, res = _run(pkg, d, 1, ckpt_every=4)
    assert os.path.isdir(os.path.join(d, "ckpt-8.bad"))
    return net, res


def test_corrupt_latest_falls_back_then_replays(tmp_path):
    ff = _run("port", str(tmp_path / "ff"), 1, ckpt_every=4)[2]
    out = _both(_corrupt_fallback, tmp_path)
    assert out["port"][1].resumed_from == 4
    np.testing.assert_allclose(out["port"][1].losses, ff.losses[4:],
                               rtol=RTOL)
    _same_result(out["port"], out["jax"])


# ------------------------------------------------------------ nan / scale

def test_nan_grad_step_skipped_params_untouched():
    out = _both(lambda pkg, d: _run(pkg, None, 1, plan="nan_grad@0",
                                    loss_scale=2.0))
    tres = out["port"][2]
    assert tres.skipped_steps == [0] and tres.loss_scale < 2.0
    _same_result(out["port"][::2], out["jax"][::2])

    # a run whose only step is poisoned leaves parameters at their
    # initial values, bit for bit, and creates no optimizer state
    net, trainer, loop = _build("port", None)
    before = _weights(net)
    tchaos.install("nan_grad@0,kill@1")
    with pytest.raises(tchaos.ChaosKilled):
        loop.fit(epochs=1)
    for k, w in _weights(net).items():
        np.testing.assert_array_equal(w, before[k], err_msg=k)
    assert not trainer._updaters[0].states


def test_nan_skip_recovers_with_accumulating_grads():
    def run(pkg, _):
        net, trainer, loop = _build(pkg, None)
        for p in trainer._params:
            p.grad_req = "add"
        PKGS[pkg][4].install("nan_grad@1")
        return net, trainer, loop.fit(epochs=1)
    out = _both(run)
    assert out["port"][2].skipped_steps == [1]
    _same_result(out["port"][::2], out["jax"][::2])


def test_loss_scaling_backoff_and_growth_match_jax():
    kw = dict(loss_scale=8.0, scale_growth_interval=3,
              max_loss_scale=16.0, plan="nan_grad@4,inf_grad@9")
    out = _both(lambda pkg, d: _run(pkg, None, 2, **kw))
    tres, jres = out["port"][2], out["jax"][2]
    assert tres.skipped_steps == [4, 9]
    _same_result(out["port"][::2], out["jax"][::2])
    assert tres.numerics["loss_scale_events"] == \
        jres.numerics["loss_scale_events"]
    triggers = [e["trigger"] for e in tres.numerics["loss_scale_events"]]
    assert "backoff" in triggers and "growth" in triggers
    assert sorted(tres.numerics) == sorted(jres.numerics)


# ------------------------------------------------------------- preemption

def _preempt(pkg, d):
    m, fit, _, _, chaos, fault = PKGS[pkg]
    chaos.install("preempt@5")
    _, _, loop = _build(pkg, d, ckpt_every=100)
    before = signal.getsignal(signal.SIGTERM)
    with pytest.raises(SystemExit) as ei:
        loop.fit(epochs=2)
    chaos.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before
    assert ei.value.code == fit.resumable_exit_code() == 75
    cm = fault.CheckpointManager(d)
    assert cm.latest() == 5
    cm.verify(5)
    net, _, res = _run(pkg, d, 2, ckpt_every=100)
    assert res.resumed_from == 5 and res.step == 16
    return net, res


def test_preempt_writes_final_checkpoint_and_exits_resumable(tmp_path):
    ff = _run("port", str(tmp_path / "ff"), 2, ckpt_every=100)[2]
    out = _both(_preempt, tmp_path)
    np.testing.assert_allclose(out["port"][1].losses, ff.losses[5:],
                               rtol=RTOL)
    _same_result(out["port"], out["jax"])


def _resize(pkg, d):
    fit, _, _, chaos, fault = PKGS[pkg][1:]
    chaos.install("resize@3:2")
    _, _, loop = _build(pkg, d, ckpt_every=100)
    with pytest.raises(SystemExit) as ei:
        loop.fit(epochs=1)
    chaos.uninstall()
    assert ei.value.code == 75
    return fault.latest_checkpoint_meta(d)


def test_resize_writes_the_target_world_and_exits_resumable(tmp_path):
    from mxnet_tpu_torch.parallel import elastic
    out = _both(_resize, tmp_path)
    (tstep, tmeta), (jstep, jmeta) = out["port"], out["jax"]
    assert tstep == jstep == 3
    assert elastic.resize_request(tmeta) == 2
    assert tmeta["topology"] == jmeta["topology"]
    assert tmeta["data_state"] == jmeta["data_state"]
    with pytest.raises(mt.MXNetError, match="checkpoint dir"):
        _run("port", None, 1, plan="resize@1")


def test_kv_chaos_and_mem_pressure_inside_the_loop(tmp_path, monkeypatch):
    """kv_flake / kv_slow fire on the trainer's store inside the loop
    (the retries change no result), and mem_pressure@2 writes one
    forensics dump at step 2."""
    monkeypatch.setenv("MXNET_KV_RETRY_BASE_MS", "0.01")
    monkeypatch.setenv("MXTPU_GRAD_BUCKET_MB", "0")
    monkeypatch.setenv("MXTPU_MEM_DUMP_DIR", str(tmp_path))

    def run(plan):
        net, trainer, loop = _build("port", None)
        trainer._kvstore_arg = mt.kv.create("local")
        p = tchaos.install(plan) if plan else None
        try:
            res = loop.fit(epochs=1)
        finally:
            tchaos.uninstall()
        return _weights(net), res, p

    want, ref, _ = run(None)
    got, res, plan = run("kv_flake:0.3,kv_slow@0.1,mem_pressure@2")
    assert plan.injected["kv_flake"] > 0 and plan.injected["kv_slow"] > 0
    assert res.losses == ref.losses
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w)
    dumps = list(tmp_path.glob("mem_forensics_*.json"))
    assert len(dumps) == 1 and plan.injected["mem_pressure"] == 1


def test_preempt_without_ckpt_dir_is_not_resumable():
    _, _, loop = _build("port", None)
    loop._preempted = signal.SIGINT
    res = tfit.FitResult(status="done", step=0, epoch=0)
    with pytest.raises(KeyboardInterrupt):
        loop._final_exit(None, res, 0, 0)


def test_noop_resume_preserves_position(tmp_path):
    def run(pkg, d):
        fault = PKGS[pkg][5]
        assert _run(pkg, d, 1, ckpt_every=3)[2].step == 8
        res2 = _run(pkg, d, 1, ckpt_every=3)[2]
        assert res2.resumed_from == 8 and res2.losses == []
        meta = fault.CheckpointManager(d).restore_latest()[2]
        assert meta["data_state"]["epoch"] == 1
        net, _, res3 = _run(pkg, d, 2, ckpt_every=3)
        return net, res3
    out = _both(run, tmp_path)
    ff = _run("port", str(tmp_path / "ff"), 2, ckpt_every=3)[2]
    np.testing.assert_allclose(out["port"][1].losses, ff.losses[8:],
                               rtol=RTOL)
    _same_result(out["port"], out["jax"])


# ------------------------------------------------------ ignore_stale_grad

def _two_head(pkg):
    m = PKGS[pkg][0]
    if pkg == "jax":
        mx.random.seed(0)

        class TwoHead(jgluon.nn.HybridBlock):
            def __init__(self):
                super().__init__(prefix="two_")
                self.used = jgluon.nn.Dense(1, in_units=4, use_bias=False,
                                            prefix="used_")
                self.unused = jgluon.nn.Dense(1, in_units=4, use_bias=False,
                                              prefix="unused_")
                self.register_child(self.used, "used")
                self.register_child(self.unused, "unused")

            def hybrid_forward(self, F, x):
                return self.used(x)
    else:
        class TwoHead(mt.gluon.HybridBlock):
            def __init__(self):
                super().__init__(prefix="two_")
                self.used = mt.gluon.nn.Dense(1, in_units=4, use_bias=False,
                                              prefix="used_")
                self.unused = mt.gluon.nn.Dense(1, in_units=4,
                                                use_bias=False,
                                                prefix="unused_")

            def forward(self, x):
                return self.used(x)
    net = TwoHead()
    net.initialize(m.init.Xavier())
    rs = np.random.RandomState(3)
    for k, p in sorted(net._collect_params_with_prefix().items()):
        p.set_data(m.nd.array(rs.randn(1, 4).astype(np.float32)))
    return net


def test_fitloop_ignore_stale_grad_passthrough():
    out = {}
    for pkg in ("jax", "port"):
        m, fit, io = PKGS[pkg][:3]
        net = _two_head(pkg)
        trainer = m.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.05}, kvstore=None)
        X, Y, bs = _data()
        itr = io.NDArrayIter(X, Y, batch_size=bs, shuffle=False)
        strict = fit.FitLoop(net, trainer, _mse, itr, heartbeat=False)
        with pytest.raises(m.base.MXNetError, match="stale"):
            strict.fit(epochs=1)
        lenient = fit.FitLoop(net, trainer, _mse, itr, heartbeat=False,
                              ignore_stale_grad=True)
        res = lenient.fit(epochs=1)
        assert res.step == 8 and np.isfinite(res.losses[-1])
        out[pkg] = (net, res)
    _same_result(out["port"], out["jax"])


# ---------------------------------------- the planes: ported and not

@pytest.mark.parametrize("flag,value,item", [
    ("MXTPU_AUTOTUNE", "on", "A9"),
    ("MXTPU_EFFICIENCY", "on", "A9"),
    ("MXTPU_NUMERICS", "on,every=2", "A9"),
    ("MXTPU_RUN_REPORT_DIR", "reports", "A9"),
    ("MXTPU_COLL_HEALTH", "4", "A10"),
    ("MXTPU_COLL_TIMEOUT_S", "30", "A10"),
    ("MXTPU_ZERO", "on", "A10"),
])
def test_unported_planes_raise_before_any_step(tmp_path, monkeypatch, flag,
                                               value, item):
    """A10's planes raise before any step runs (nothing written, no step,
    the handlers untouched). A9's are ported (the name and the cases are
    kept from when they raised): the same flag runs ``FitLoop.fit`` in
    both packages to the same trajectory and fills the same result
    field."""
    if item == "A9":
        monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
        monkeypatch.setenv(flag, value)
        out = {}
        for pkg in ("jax", "port"):
            cwd = tmp_path / pkg
            cwd.mkdir()
            monkeypatch.chdir(cwd)   # a relative report directory
            net, _, loop = _build(pkg, None)
            before = signal.getsignal(signal.SIGTERM)
            out[pkg] = (net, loop.fit(epochs=2))
            assert signal.getsignal(signal.SIGTERM) is before
        _same_result(out["port"], out["jax"])
        t, j = out["port"][1], out["jax"][1]
        if flag == "MXTPU_AUTOTUNE":
            assert [c["label"] for c in t.tuning_report["candidates"]] == \
                [c["label"] for c in j.tuning_report["candidates"]]
            assert sorted(t.tuning_report) == sorted(j.tuning_report)
        elif flag == "MXTPU_EFFICIENCY":
            assert sorted(t.efficiency) == sorted(j.efficiency)
            assert t.efficiency["steps"] == j.efficiency["steps"] == 16
        elif flag == "MXTPU_NUMERICS":
            assert [r["step"] for r in t.numerics["recent"]] == \
                [r["step"] for r in j.numerics["recent"]] == \
                list(range(0, 16, 2))
        else:
            for pkg in ("jax", "port"):
                rep = out[pkg][1].run_report
                assert os.path.dirname(rep) == value
                assert os.path.exists(tmp_path / pkg / rep)
        return
    _, trainer, loop = _build("port", str(tmp_path))
    before = signal.getsignal(signal.SIGTERM)
    monkeypatch.setenv(flag, value)
    with pytest.raises(NotPortedError, match=item):
        loop.fit(epochs=1)
    assert not os.listdir(tmp_path), "nothing may be written"
    assert not trainer._updaters[0].states, "no step may run"
    assert signal.getsignal(signal.SIGTERM) is before


@pytest.mark.parametrize("flag,value", [
    ("MXTPU_MEGASTEP", "onn"), ("MXTPU_EFFICIENCY", "bogus"),
    ("MXTPU_NUMERICS", "every=0"), ("MXTPU_COLL_HEALTH", "x")])
def test_malformed_plane_flags_raise_as_in_jax(tmp_path, monkeypatch, flag,
                                               value):
    _, _, loop = _build("port", None)
    monkeypatch.setenv(flag, value)
    with pytest.raises(mt.MXNetError):
        loop.fit(epochs=1)


def test_elastic_world_change_raises(tmp_path, monkeypatch):
    """A checkpoint recorded at another world: TopologyMismatchError with
    MXTPU_ELASTIC off, NotPortedError (A10) with it on — before any state
    loads."""
    from mxnet_tpu_torch.parallel import elastic
    import json
    d = str(tmp_path)
    _run("port", d, 1, ckpt_every=4)
    meta_path = os.path.join(d, "ckpt-8", "meta.json")
    meta = json.load(open(meta_path))
    meta["topology"]["world"] = 2
    json.dump(meta, open(meta_path, "w"))
    tfault.write_manifest(os.path.join(d, "ckpt-8"))
    with pytest.raises(elastic.TopologyMismatchError):
        _run("port", d, 2, ckpt_every=4)
    monkeypatch.setenv("MXTPU_ELASTIC", "on")
    net, trainer, loop = _build("port", d, ckpt_every=4)
    before = _weights(net)
    with pytest.raises(NotPortedError, match="A10"):
        loop.fit(epochs=2)
    for k, w in _weights(net).items():
        np.testing.assert_array_equal(w, before[k])
