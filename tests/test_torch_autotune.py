"""The port's knob autotuner (``MXTPU_AUTOTUNE``) against the JAX
package's: the same candidate plan for the same spec, the same lock
decision on the same injected step records, the operator's environment
and staging depth restored after ``fit()``, the trajectory unchanged
(the knobs are numerically neutral), and the communication knobs
(``bucket_mb``, ``overlap``) refused naming ROADMAP A10."""
import os

import numpy as np
import pytest

import torch_planes_common as C

import mxnet_tpu as mx
from mxnet_tpu.telemetry import autotune as jat

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.registry import NotPortedError
from mxnet_tpu_torch.telemetry import autotune as tat


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    for k in ("MXTPU_AUTOTUNE", "MXTPU_MEGASTEP", "MXTPU_NUMERICS",
              "MXTPU_EFFICIENCY"):
        monkeypatch.delenv(k, raising=False)


def _tuner(pkg, spec):
    m, _, io, _ = C.PKGS[pkg]
    ctx = mt.cpu() if pkg == "port" else C.contextlib.nullcontext()
    with ctx:
        n = C.net(pkg, "mlp")
        tr = m.gluon.Trainer(n.collect_params(), "sgd",
                             {"learning_rate": 0.1}, kvstore=None)
        x, y = C.data("mlp")
        it = io.DeviceStagingIter(io.NDArrayIter(x, y, batch_size=8))
    mod = tat if pkg == "port" else jat
    return mod.AutoTuner(spec, trainer=tr, data_iter=it)


@pytest.mark.parametrize("spec", [
    "on", "on,probe=3,warmup=0", "on,agg=2|8|4", "on,knobs=prefetch",
    "on,prefetch=1|2,agg=16"])
def test_same_plan_as_jax(spec):
    plans = {}
    for pkg in ("jax", "port"):
        t = _tuner(pkg, spec)
        plans[pkg] = [(c.label, c.knob, c.knobs) for c in t._build_plan()]
        t.restore_env()
    assert plans["port"] == plans["jax"]
    assert tat.parse_spec(spec) == jat.parse_spec(spec)


@pytest.mark.parametrize("walls,winner", [
    ({"baseline": 0.10, "agg=16": 0.08, "prefetch=3": 0.099}, "agg"),
    ({"baseline": 0.10, "agg=16": 0.099, "prefetch=3": 0.09}, "prefetch"),
    ({"baseline": 0.10, "agg=16": 0.11, "prefetch=3": 0.12}, None)])
def test_same_lock_decision_on_injected_records(walls, winner):
    reports = {}
    for pkg in ("jax", "port"):
        t = _tuner(pkg, "on,probe=2,warmup=1")
        step = 0
        while not t.locked:
            t.on_step_begin(step)
            label = t._cands[t._idx].label
            t.on_step_end(step, {"wall": walls[label], "optimizer": 0.01})
            step += 1
        reports[pkg] = (t.report(), t.locked_at_step, dict(t.chosen))
        t.restore_env()
    assert reports["port"] == reports["jax"]
    rep, _, chosen = reports["port"]
    assert rep["status"] == "locked" and rep["zero"] is False
    base = rep["baseline"]
    changed = {k for k in chosen if chosen[k] != base[k]}
    assert changed == ({winner} if winner else set())


@pytest.mark.parametrize("mega", ["off", "on"])
def test_fit_restores_env_and_keeps_the_trajectory(monkeypatch, mega):
    """Composed and under the megastep (where each aggregation size is a
    signature of its own)."""
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    monkeypatch.setenv("MXTPU_MEGASTEP", mega)
    base = C.fit("port", "mlp", epochs=3, staging=True)
    monkeypatch.setenv("MXTPU_AUTOTUNE", "on,probe=2,warmup=1,agg=1")
    net, tr, res = C.fit("port", "mlp", epochs=3, staging=True)
    assert os.environ["MXTPU_OPTIMIZER_AGGREGATION"] == "4"
    rep = res.tuning_report
    assert rep["status"] == "locked"
    assert [c["label"] for c in rep["candidates"]] == [
        "baseline", "agg=1", "prefetch=3"]
    assert all(c["measured_steps"] == 2 for c in rep["candidates"])
    assert res.losses == base[2].losses
    for k, w in C.weights(base[0]).items():
        assert np.array_equal(C.weights(net)[k], w), k
    text = mt.telemetry.default_registry().render_prometheus()
    assert "mxtpu_autotune_probe_steps_total" in text
    assert "mxtpu_autotune_chosen_agg" in text
    assert "mxtpu_autotune_score_ms_baseline" in text


@pytest.mark.parametrize("spec", [
    "on,knobs=bucket_mb", "on,knobs=agg|overlap", "on,bucket_mb=4|100",
    "on,overlap=1"])
def test_comm_knobs_raise_a10(spec, monkeypatch):
    """The comm knobs are ported (A10's first half; the name and cases
    are kept from when they raised): the spec parses as in the JAX
    package, and a fit without a kvstore drops them from the plan in
    both packages, with the same report."""
    assert tat.parse_spec(spec) == jat.parse_spec(spec)
    monkeypatch.setenv("MXTPU_AUTOTUNE", spec)
    reps = {pkg: C.fit(pkg, "mlp", epochs=1)[2].tuning_report
            for pkg in ("port", "jax")}
    assert [c["label"] for c in reps["port"]["candidates"]] == \
        [c["label"] for c in reps["jax"]["candidates"]]
    assert reps["port"]["baseline"] == reps["jax"]["baseline"]
    assert "bucket_mb" not in reps["port"]["baseline"]
    assert "overlap" not in reps["port"]["baseline"]


@pytest.mark.parametrize("spec", ["wat", "on,probe=0", "probe=4",
                                  "on,knobs=nope", "on,agg=x"])
def test_typos_raise_like_jax(spec, monkeypatch):
    monkeypatch.setenv("MXTPU_AUTOTUNE", spec)
    with pytest.raises(mx.base.MXNetError) as je:
        jat.requested()
    with pytest.raises(MXNetError) as te:
        tat.requested()
    assert str(te.value) == str(je.value)
