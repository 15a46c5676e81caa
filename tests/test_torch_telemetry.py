"""The port's telemetry (``tracer``, ``chrome_trace``, ``step_breakdown``,
the memory ledger and the numerics / efficiency planes' off states)
against the JAX package's, on the CPU.

- The tracer: off records nothing, a bounded ring that counts drops,
  category filters and pause, and the ``MXTPU_PROFILE`` grammar
  accepting and rejecting what the JAX grammar does; the chrome export
  passes both packages' validators, which reject the same malformed
  traces.
- The step breakdown: exclusive-time charging of nested segments, the
  input-bound detector's one-line diagnosis through ``FitLoop``, the
  summary's keys as in the JAX package.
- The memory ledger, category by category, for the same small net and
  trainer in both packages (params, grads, optimizer state, f32 masters
  of a multi-precision optimizer; freed on ``grad_req='null'``, on a
  rolled-back step and on restore), the ``mem_pressure`` chaos dump, the
  ``MXTPU_MEM_BUDGET`` watermark (once), ``oom_guard`` on
  ``torch.cuda.OutOfMemoryError``, ``reconcile`` on the host; the
  compiled-program half raises ``NotPortedError`` (A9).
- The numerics and efficiency planes: off they return what the JAX
  package's return with the plane off; on they raise ``NotPortedError``
  (A9), and a malformed value raises as in the JAX package.
"""
import gc
import json
import logging
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu.telemetry import chrome_trace as jchrome
from mxnet_tpu.telemetry import efficiency as jeff
from mxnet_tpu.telemetry import memory as jmem
from mxnet_tpu.telemetry import numerics as jnum
from mxnet_tpu.telemetry.tracer import Tracer as JTracer

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.contrib import chaos as tchaos
from mxnet_tpu_torch.ops.registry import NotPortedError
from mxnet_tpu_torch.telemetry import chrome_trace as tchrome
from mxnet_tpu_torch.telemetry import efficiency as teff
from mxnet_tpu_torch.telemetry import memory as tmem
from mxnet_tpu_torch.telemetry import numerics as tnum
from mxnet_tpu_torch.telemetry.step_breakdown import StepBreakdown, segment
from mxnet_tpu_torch.telemetry.tracer import Tracer


@pytest.fixture(autouse=True)
def _clean():
    tr = telemetry.tracer
    tr.disable()
    tr.clear()
    tr.set_categories(None)
    tchaos.uninstall()
    with mt.cpu():
        yield
    tr.disable()
    tr.clear()
    tr.set_categories(None)
    tchaos.uninstall()


# ------------------------------------------------------------------ tracer

def test_tracer_off_ring_filter_pause():
    tr = Tracer()
    with tr.span("s", "compute"):
        pass
    tr.instant("i")
    tr.counter_event("c", 1.0)
    assert tr.events() == [] and not tr.enabled
    tr = Tracer(ring=8)
    tr.enable()
    t0 = time.perf_counter()
    for i in range(20):
        tr.record(f"s{i}", "compute", t0, t0 + 1e-6)
    assert len(tr.events()) == 8 and tr.events()[0]["name"] == "s12"
    assert tr.dropped == 12
    tr.clear()
    tr.set_categories({"comm"})
    tr.record("keep", "comm", t0, t0 + 1e-6)
    tr.record("drop", "compute", t0, t0 + 1e-6)
    tr.set_categories(None)
    tr.pause()
    tr.record("paused", "comm", t0, t0 + 1e-6)
    tr.resume()
    tr.record("resumed", "comm", t0, t0 + 1e-6)
    assert [e["name"] for e in tr.events()] == ["keep", "resumed"]
    tr.set_aggregate(True)
    tr.record("agg", "comm", t0, t0 + 2e-3)
    assert "comm::agg" in tr.aggregate_table()


@pytest.mark.parametrize("spec", [
    "on", "1", "all", "off", "0", "on,ring=128,cat=comm|data_wait",
    "cat=comm", "ring=16", "on,file={tmp}/trace.json", "",
    "bogus", "ring=x", "cat=", "file=", "wat=1", "ring=0"])
def test_profile_grammar_matches_jax(spec, tmp_path, monkeypatch):
    spec = spec.format(tmp=tmp_path)
    states = []
    for T in (JTracer, Tracer):
        tr = T()
        try:
            tr.configure(spec)
            states.append((tr.enabled, tr.ring_capacity, tr._categories,
                           tr._file))
        except Exception as e:
            states.append(("raises", type(e).__name__, str(e)))
    assert states[0] == states[1]


def test_chrome_export_passes_both_validators(tmp_path):
    telemetry.enable()
    with telemetry.span("outer", "compute"):
        with telemetry.span("inner", "comm"):
            time.sleep(0.001)
    telemetry.instant("mark")
    telemetry.counter_event("queue_depth", 3)
    telemetry.counter_event("memory", {"params": 10, "grads": 4})
    telemetry.disable()
    path = str(tmp_path / "trace.json")
    payload = tchrome.dump_chrome_trace(path)
    names = {e["name"] for e in tchrome.validate_chrome_trace(payload)}
    assert {"outer", "inner", "mark", "queue_depth", "process_name",
            "clock_sync"} <= names
    with open(path) as f:
        jchrome.validate_chrome_trace(f.read())


def test_profile_env_dumps_a_chrome_trace_at_exit(tmp_path):
    """MXTPU_PROFILE=on,file=PATH, read when the package is imported,
    writes a validator-clean chrome trace when the process exits."""
    import os
    import subprocess
    import sys
    path = tmp_path / "trace.json"
    code = ("import mxnet_tpu_torch as mx\n"
            "with mx.telemetry.span('work', 'compute'):\n"
            "    pass\n")
    env = dict(os.environ, MXTPU_PROFILE=f"on,file={path}")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                   check=True, timeout=120)
    events = tchrome.validate_chrome_trace(path.read_text())
    assert any(e["name"] == "work" for e in events)


def _span_ev(name, ts, dur, tid=0):
    return {"name": name, "cat": "t", "ph": "X", "ts": float(ts),
            "dur": float(dur), "pid": 0, "tid": tid}


@pytest.mark.parametrize("trace", [
    "{nope", {"events": []}, {"traceEvents": [{"name": "x", "ph": "X"}]},
    {"traceEvents": [dict(_span_ev("a", 0, 1), ph="Z")]},
    {"traceEvents": [dict(_span_ev("a", 0, 1), ts="soon")]},
    {"traceEvents": [_span_ev("a", 0, -1)]}, {"traceEvents": []},
    {"traceEvents": [_span_ev("a", 0, 100), _span_ev("b", 50, 100)]},
    {"traceEvents": [_span_ev("a", 0, 100, 1), _span_ev("b", 50, 100, 2)]},
    {"traceEvents": [_span_ev("p", 0, 100), _span_ev("c", 10, 20)]}])
def test_validator_matches_jax(trace):
    verdicts = []
    for v in (jchrome.validate_chrome_trace, tchrome.validate_chrome_trace):
        try:
            v(trace)
            verdicts.append("ok")
        except ValueError as e:
            verdicts.append(str(e))
    assert verdicts[0] == verdicts[1]


# -------------------------------------------------------- step breakdown

def test_breakdown_exclusive_time_accounting():
    bd = StepBreakdown(bound_frac=0).install()
    try:
        bd.begin_step(0)
        with segment("data_wait"):
            time.sleep(0.02)
            with segment("h2d"):
                time.sleep(0.01)
        rec = bd.end_step()
    finally:
        bd.uninstall()
    assert rec["h2d"] >= 0.009 and rec["data_wait"] >= 0.015
    assert rec["data_wait"] + rec["h2d"] <= rec["wall"] + 1e-3
    s = bd.summary()
    assert s["steps"] == 1 and s["memory"]["per_step"][0]["step"] == 0
    assert segment("x") is not None
    assert telemetry.current_breakdown() is None


def test_input_bound_detector_logs_one_line_diagnosis(caplog):
    class SlowIter(mt.io.NDArrayIter):
        def next(self):
            time.sleep(0.05)
            return super().next()

    rs = np.random.RandomState(0)
    net = mt.gluon.nn.Dense(2, in_units=4)
    net.initialize(mt.init.Xavier())
    it = SlowIter(rs.randn(8, 4).astype(np.float32),
                  rs.randint(0, 2, (8,)).astype(np.float32), batch_size=4)
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.01})
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    with caplog.at_level(logging.WARNING,
                         logger="mxnet_tpu_torch.telemetry"):
        res = mt.fit.FitLoop(net, trainer, loss_fn, it,
                             ckpt_dir=None).fit(epochs=1)
    assert res.step_breakdown["diagnoses"], "detector never fired"
    assert any("data_wait" in r.message and "input-bound" in r.message
               for r in caplog.records)
    # with the tracer off nothing lands in the ring
    assert telemetry.tracer.events() == []


def test_fit_trace_has_step_markers_and_memory_counters(tmp_path):
    telemetry.enable()
    rs = np.random.RandomState(0)
    net = mt.gluon.nn.Dense(1, in_units=4)
    net.initialize(mt.init.Xavier())
    it = mt.io.NDArrayIter(rs.randn(12, 4).astype(np.float32),
                           rs.randn(12, 1).astype(np.float32), batch_size=4)
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.01})
    res = mt.fit.FitLoop(net, trainer, lambda p, y: ((p - y) ** 2).mean(),
                         it, ckpt_dir=str(tmp_path)).fit(epochs=1)
    telemetry.disable()
    evs = telemetry.tracer.events()
    # as in the JAX package: a marker for each step opened, the last one
    # finding the epoch's end
    assert [e["name"] for e in evs if e.get("cat") == "step"] == \
        ["step:0", "step:1", "step:2", "step:3"]
    peaks = [e["args"]["value"] for e in evs
             if e["name"] == "device_memory_peak"]
    assert peaks == [r["peak_bytes"] for r in res.memory["per_step"]]
    tchrome.validate_chrome_trace(tchrome.dump_chrome_trace())


# ------------------------------------------------------------------ ledger

def _dense_net(m, dtype="float32"):
    net = m.gluon.nn.HybridSequential(prefix="mlp_")
    net.add(m.gluon.nn.Dense(16, in_units=8, prefix="d0_"),
            m.gluon.nn.Dense(4, in_units=16, prefix="d1_"))
    net.initialize()
    if dtype != "float32":
        net.cast(dtype)
    return net


def _step(m, net, trainer, dtype="float32"):
    x = m.nd.array(np.ones((2, 8), np.float32), dtype=dtype)
    with m.autograd.record():
        loss = net(x).sum()
    loss.backward()
    trainer.step(2)


def _ledger_delta(led, base):
    gc.collect()
    now = led.snapshot()
    return {c: now.get(c, 0) - base.get(c, 0)
            for c in set(now) | set(base) if now.get(c, 0) - base.get(c, 0)}


@pytest.mark.parametrize("opt,kw,dtype", [
    ("sgd", {"momentum": 0.9}, "float32"), ("adam", {}, "float32"),
    ("sgd", {"momentum": 0.9, "multi_precision": True}, "float16")])
def test_ledger_categories_match_jax(opt, kw, dtype):
    deltas = []
    for m, mem in ((mx, jmem), (mt, tmem)):
        gc.collect()
        led = mem.ledger()
        base = led.snapshot()
        net = _dense_net(m, dtype)
        trainer = m.gluon.Trainer(net.collect_params(), opt,
                                  dict(learning_rate=0.1, **kw),
                                  kvstore=None)
        _step(m, net, trainer, dtype)
        deltas.append(_ledger_delta(led, base))
        del net, trainer
    assert deltas[0] == deltas[1]
    n = 8 * 16 + 16 + 16 * 4 + 4
    item = 4 if dtype == "float32" else 2
    assert deltas[1]["params"] == deltas[1]["grads"] == n * item
    if dtype != "float32":
        assert deltas[1]["masters"] == n * 4


def test_ledger_frees_on_null_rollback_and_restore(tmp_path):
    gc.collect()
    led = tmem.ledger()
    base = led.snapshot()
    net = _dense_net(mt)
    n = (8 * 16 + 16 + 16 * 4 + 4) * 4
    assert _ledger_delta(led, base) == {"params": n, "grads": n}
    trainer = mt.gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": 0.01}, kvstore=None)
    for p in trainer._params:
        p.grad()._data.fill_(float("nan"))
        p._fresh_grad = True
    flag = trainer.update_with_sentinel(1)
    assert not bool(flag)
    trainer.rollback_step()
    assert _ledger_delta(led, base) == {"params": n, "grads": n}
    _step(mt, net, trainer)
    assert _ledger_delta(led, base)["optimizer"] == 2 * n
    cm = mt.fault.CheckpointManager(str(tmp_path))
    cm.save(1, net=net, trainer=trainer)
    cm.restore(1, net=net, trainer=trainer)
    assert _ledger_delta(led, base)["optimizer"] == 2 * n
    for p in net.collect_params().values():
        p.grad_req = "null"
    assert _ledger_delta(led, base) == {"params": n, "optimizer": 2 * n}
    del net, trainer, cm, p
    assert _ledger_delta(led, base) == {}


def test_ledger_windows_top_and_summary():
    led = tmem.MemoryLedger()
    led.set("params", "a", 100, owner="w")
    led.begin_window()
    led.set("staging", "b", 50, owner="s:1")
    led.drop("staging", "b")
    assert led.window_stats() == (150, 0) and led.peak_bytes == 150
    led.set("grads", "c", 70, owner="g")
    assert [e["owner"] for e in led.top(2)] == ["w", "g"]
    led.drop_owner("grads", "g")
    assert led.summary()["by_category"] == {"params": 100}
    assert tmem.nd_bytes(torch.zeros(3, 5)) == 60
    assert tmem.nd_bytes(mt.nd.zeros((2, 2), dtype="float16")) == 8
    assert tmem.nd_bytes(np.zeros(7, np.int64)) == 56


def test_mem_pressure_and_budget_dumps(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_MEM_DUMP_DIR", str(tmp_path))
    net = _dense_net(mt)
    plan = tchaos.ChaosPlan("mem_pressure@3")
    plan.begin_step(2)
    assert tmem.check_pressure(step=2, plan=plan) is None
    plan.begin_step(3)
    path = tmem.check_pressure(step=3, plan=plan)
    dump = json.load(open(path))
    assert dump["reason"] == "chaos_mem_pressure" and dump["step"] == 3
    jdump = json.load(open(jmem.dump_forensics(
        "x", path=str(tmp_path / "j.json"))))
    assert sorted(dump) == sorted(jdump)
    assert dump["categories"][0]["category"] in ("params", "grads")
    tmem.reset_pressure_state()
    monkeypatch.setenv("MXTPU_MEM_BUDGET", "1")
    assert tmem.check_pressure(step=4) is not None
    assert tmem.check_pressure(step=5) is None, "rising edge only"
    del net


def test_oom_guard_and_reconcile(tmp_path, monkeypatch):
    monkeypatch.setenv("MXTPU_MEM_DUMP_DIR", str(tmp_path))
    with pytest.raises(torch.cuda.OutOfMemoryError):
        with tmem.oom_guard(lambda: 7):
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
    dumps = list(tmp_path.glob("mem_forensics_*.json"))
    assert len(dumps) == 1
    assert json.load(open(dumps[0]))["reason"] == "resource_exhausted"
    assert tmem.is_oom(RuntimeError("RESOURCE_EXHAUSTED: x"))
    assert not tmem.maybe_dump_oom(ValueError("no"))
    rec = tmem.reconcile(mt.cpu())
    assert rec["backend_bytes_in_use"] is None and rec["consistent"] is None
    assert rec["ledger_bytes"] == tmem.ledger().live_bytes()
    # the per-program half, as the JAX package's on the same records
    for mem in (jmem, tmem):
        mem.record_program("spmd", "t:a", {"temp_bytes": 10,
                                           "argument_bytes": 3})
        mem.merge_program("spmd", "t:a", {"flops": 5.0})
        mem.record_program("spmd", "t:b", {"temp_bytes": 30,
                                           "argument_bytes": 4})
    for name in ("t:a", "t:b"):
        assert tmem.get_program("spmd", name) == \
            jmem.get_program("spmd", name)
    trows = [r for r in tmem.program_report() if r["label"] in ("t:a",
                                                                "t:b")]
    jrows = [r for r in jmem.program_report() if r["label"] in ("t:a",
                                                                "t:b")]
    assert trows == jrows and trows[0]["label"] == "t:b"
    assert tmem.program_total("temp_bytes") >= 40
    assert tmem.compiled_memory_stats(None) is None
    with teff.counting() as c:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert sorted(tmem.compiled_memory_stats(c)) == sorted(
        teff.MEMORY_FIELDS)
    owner_op = type("Op", (), {})()
    tmem.register_cache_programs("sigcache_t", owner_op,
                                 {"ab": {"temp_bytes": 7,
                                         "output_bytes": 1}})
    assert tmem.ledger().live_bytes("serving_cache") >= 8
    for name in ("t:a", "t:b"):
        tmem.drop_program("spmd", name)
        assert tmem.get_program("spmd", name) is None


# ---------------------------------------------------------- numerics, eff

def test_planes_off_match_jax(monkeypatch):
    for name in ("MXTPU_NUMERICS", "MXTPU_EFFICIENCY"):
        monkeypatch.delenv(name, raising=False)
    for num, eff in ((jnum, jeff), (tnum, teff)):
        num.reset_run()
        eff.reset_run()
        assert num.summary() is None and eff.summary() is None
        assert not num.enabled() and not eff.enabled()
        assert num.fallback_collect(None) is None
        num.note_loss_scale(3, 8.0, 4.0, "backoff")
    tsum, jsum = tnum.summary(), jnum.summary()
    assert tsum == jsum and tsum["loss_scale_events"] == [
        {"step": 3, "old": 8.0, "new": 4.0, "trigger": "backoff"}]
    tnum.reset_run()
    jnum.reset_run()
    assert tnum.summary() is None and teff.end_step(step=1) is None


@pytest.mark.parametrize("name,value", [
    ("MXTPU_NUMERICS", "on"), ("MXTPU_NUMERICS", "every=4"),
    ("MXTPU_NUMERICS", "on,stats=l2|absmax,pattern=dense.*"),
    ("MXTPU_EFFICIENCY", "on"), ("MXTPU_EFFICIENCY", "1,off,on")])
def test_planes_on_raise_not_ported(monkeypatch, name, value):
    """The planes are ported (the name is kept from when they raised):
    a value that turns one on arms it at ``reset_run`` as in the JAX
    package, with the same parsed spec, and its summary is the JAX
    package's with nothing recorded."""
    monkeypatch.setenv(name, value)
    jmod, tmod = (jnum, tnum) if name == "MXTPU_NUMERICS" else (jeff, teff)
    jmod.reset_run()
    tmod.reset_run()
    assert tmod.enabled() and jmod.enabled()
    if name == "MXTPU_NUMERICS":
        ts, js = tmod.spec(), jmod.spec()
        assert (ts.every, ts.stats, ts.raw) == (js.every, js.stats, js.raw)
        assert (ts.pattern and ts.pattern.pattern) == \
            (js.pattern and js.pattern.pattern)
        assert tmod.summary() == jmod.summary()
        assert tmod.summary()["enabled"] is True
    else:
        assert tmod.summary() is None and jmod.summary() is None
        assert tmod.device_peak()["estimate"] is True
    tmod.reset_run()


@pytest.mark.parametrize("name,value", [
    ("MXTPU_NUMERICS", "on,every=0"), ("MXTPU_NUMERICS", "stats=nope"),
    ("MXTPU_NUMERICS", "wat"), ("MXTPU_NUMERICS", "pattern=("),
    ("MXTPU_NUMERICS", "off,every=2"), ("MXTPU_NUMERICS", "off"),
    ("MXTPU_EFFICIENCY", "bogus"), ("MXTPU_EFFICIENCY", "off")])
def test_plane_parse_matches_jax(monkeypatch, name, value):
    monkeypatch.setenv(name, value)
    jmod, tmod = (jnum, tnum) if name == "MXTPU_NUMERICS" else (jeff, teff)
    try:
        jmod.reset_run()
        tmod.reset_run()                       # off in both
    except mx.base.MXNetError as e:
        with pytest.raises(mt.MXNetError) as ei:
            tmod.reset_run()
        assert str(ei.value) == str(e)
