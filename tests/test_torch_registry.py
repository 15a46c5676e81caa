"""The port's metrics registry (``mxnet_tpu_torch/telemetry/registry.py``)
against the JAX package's: the same sequence of observations renders the
same Prometheus and JSON text; the default registry holds the port's
counters (signature caches, kvstore retries, chaos injections, update
dispatches, compiles, device memory)."""
import json
import os

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")

from mxnet_tpu.telemetry import registry as jreg  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.telemetry import registry as treg  # noqa: E402


def _observe(mod):
    """One scripted sequence of observations on a fresh registry."""
    reg = mod.MetricsRegistry()
    c = reg.counter("mxtpu_x_total", "x things")
    c.inc()
    c.inc(4)
    lab = reg.counter("mxtpu_kind_total", "by kind", label="kind")
    for k in ("nan_grad", "kill", "nan_grad"):
        lab.inc(label_value=k)
    g = reg.gauge("mxtpu_level", "a level")
    for v in (3.0, 7.5, 2.0):
        g.set(v)
    g.inc(0.25)
    g.dec(1)
    h = reg.histogram("mxtpu_lat_ms", "latency")
    for v in (0.1, 0.7, 3.0, 12.0, 99.0, 1e5, 2.5, 2.5):
        h.observe(v)
    h2 = reg.histogram("mxtpu_small", "", buckets=(1, 2, 4))
    for v in range(6):
        h2.observe(float(v))
    reg.callback_gauge("mxtpu_polled", lambda: 42, "polled")
    reg.callback_gauge("mxtpu_broken", lambda: 1 / 0, "raises")
    return reg


def test_renderings_identical_to_jax():
    t, j = _observe(treg), _observe(jreg)
    assert t.render_prometheus() == j.render_prometheus()
    assert t.render_json() == j.render_json()
    assert t.render_json_text() == j.render_json_text()
    assert t.names() == j.names()
    text = t.render_prometheus()
    assert 'mxtpu_kind_total{kind="nan_grad"} 2' in text
    assert 'mxtpu_lat_ms_bucket{le="+Inf"} 8' in text
    assert "mxtpu_broken 0" in text


@pytest.mark.parametrize("mod", [treg, jreg], ids=["port", "jax"])
def test_kind_clash_and_percentiles(mod):
    reg = mod.MetricsRegistry()
    reg.counter("a")
    with pytest.raises(ValueError, match="already registered as counter"):
        reg.gauge("a")
    h = reg.histogram("h")
    for v in range(1, 101):
        h.observe(float(v))
    assert h.percentile(50) == 51.0 and h.count == 100
    snap = h.snapshot()
    assert snap["p95"] == 95.0 and snap["mean"] == 50.5
    reg.unregister("a")
    assert reg.get("a") is None
    reg.clear()
    assert reg.render_prometheus() == ""


def test_default_registry_holds_the_ports_counters(monkeypatch):
    reg = mt.telemetry.default_registry()
    assert reg is treg.default_registry()
    # signature caches: polled, monotone over a cache that dies
    from mxnet_tpu_torch.cached_op import SignatureLRU
    c = SignatureLRU()
    before = reg.get("mxtpu_cachedop_cache_hits").value
    c.get_or_insert("k", dict)
    c.get_or_insert("k", dict)
    assert reg.get("mxtpu_cachedop_cache_hits").value == before + 1
    del c
    import gc
    gc.collect()
    assert reg.get("mxtpu_cachedop_cache_hits").value == before + 1
    # chaos injections by kind
    from mxnet_tpu_torch.contrib import chaos
    inj = reg.counter("mxtpu_chaos_injections_total", label="kind")
    n0 = inj.by_label().get("nan_grad", 0)
    plan = chaos.ChaosPlan("nan_grad@2")
    plan.begin_step(2)
    assert plan.should("nan_grad")
    assert inj.by_label()["nan_grad"] == n0 + 1
    # kvstore retries after a transient failure
    from mxnet_tpu_torch import kvstore
    retries = reg.counter("mxtpu_kv_retries_total", label="op")
    r0 = retries.value
    monkeypatch.setenv("MXNET_KV_RETRY_BASE_MS", "0")
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise kvstore.TransientKVError("flake")
        return "ok"
    assert kvstore._retry_op("push", flaky) == "ok"
    assert retries.value == r0 + 2
    # compiles, with their seconds, by kind
    treg.note_compile("graph_capture", 0.25, "g")
    treg.note_compile("nvcc", 1.5, "fused_bn_act.cu")
    total = reg.get("mxtpu_compile_total").by_label()
    secs = reg.get("mxtpu_compile_seconds_total").by_label()
    assert total["graph_capture"] >= 1 and secs["nvcc"] >= 1.5
    # device memory: the ledger on the CPU (no card here)
    assert reg.get("mxtpu_device_bytes_in_use").value >= 0
    assert treg.device_memory_watermark() >= \
        reg.get("mxtpu_device_bytes_in_use").value
    text = reg.render_prometheus()
    for name in ("mxtpu_compile_total", "mxtpu_compile_seconds_total",
                 "mxtpu_device_peak_bytes", "mxtpu_chaos_injections_total",
                 "mxtpu_kv_retries_total", "mxtpu_cachedop_cache_misses"):
        assert f"# TYPE {name} " in text, name
    json.dumps(reg.render_json())


def test_update_dispatches_counted():
    reg = mt.telemetry.default_registry()
    with mt.cpu():
        net = mt.gluon.nn.Dense(3, in_units=4)
        net.initialize()
        tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1})
        before = reg.counter("mxtpu_update_dispatches_total").value
        x = mt.nd.array(np.ones((2, 4), np.float32))
        with mt.autograd.record():
            loss = net(x).sum()
        loss.backward()
        tr.step(2)
    assert tr.last_update_dispatches >= 1
    assert reg.counter("mxtpu_update_dispatches_total").value == \
        before + tr.last_update_dispatches
