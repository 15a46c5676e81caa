"""The port's in-process serving core (``mxnet_tpu_torch.serving``) against
the JAX package's on the CPU, after tests/test_serving.py.

The batcher's policy, the typed rejections, deadlines, drain, the SIGTERM
exit code, the metrics plane (its Prometheus and JSON text byte for byte
against the JAX ``ServerMetrics`` on the same counts), the profiler span,
the serving run report, signature replay, and rows served from a padded
batch against the JAX ``ModelServer`` on the same weights (f32 2e-5).
``examples/serving/resnet_server.py`` runs under the port's names, its
``--smoke`` path and its zoo path (to the SIGTERM drain), in a child
process. Every wait is bounded.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.serving import ModelServer as JModelServer
from mxnet_tpu.serving import batcher as jbatcher
from mxnet_tpu.serving import metrics as jmetrics

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert, serving
from mxnet_tpu_torch.contrib import chaos
from mxnet_tpu_torch.serving import (BucketTable, DeadlineExceeded,
                                     ModelServer, NoBucket, QueueFull,
                                     ServerClosed, batch_buckets, pad_rows)
from mxnet_tpu_torch.serving import metrics as tmetrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()


class _CountingModel:
    """Plain-callable model that records every dispatched batch size."""

    def __init__(self, delay_s=0.0):
        self.batches = []
        self.delay_s = delay_s
        self.lock = threading.Lock()

    def __call__(self, x):
        with self.lock:
            self.batches.append(int(x.shape[0]))
        if self.delay_s:
            time.sleep(self.delay_s)
        return x * 2


def _server(model, **kw):
    with CPU:
        return ModelServer(model, **kw)


def _await_dispatch(srv, timeout=5.0):
    """Until a batch is executing (the worker pinned by serve_slow)."""
    t = time.perf_counter()
    while srv.metrics.inflight_batches.value < 1:
        assert time.perf_counter() - t < timeout, "no batch dispatched"
        time.sleep(0.002)


@pytest.fixture(autouse=True)
def _no_leftover_chaos():
    yield
    chaos.uninstall()


def _pool_net(mx, seed=0):
    """tests/test_serving.py's shape-polymorphic net: conv, global average
    pool, dense."""
    mx.random.seed(seed)
    net = mx.gluon.nn.HybridSequential(prefix="srv_pool_")
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(4, kernel_size=3, padding=1,
                                   in_channels=3))
        net.add(mx.gluon.nn.GlobalAvgPool2D())
        net.add(mx.gluon.nn.Flatten())
        net.add(mx.gluon.nn.Dense(3, in_units=4))
    return net


def _pool_pair(seed=0):
    jnet = _pool_net(jmx, seed)
    jnet.initialize(jmx.init.Xavier())
    with CPU:
        tnet = _pool_net(tmx, seed)
        tnet.initialize(tmx.init.Xavier())
    convert.from_mxnet_tpu_params(
        tnet, {k: p.data().asnumpy() for k, p in
               jnet.collect_params().items()}, prefix=jnet.prefix)
    return jnet, tnet


# ---------------------------------------------------------------------------
# policy layer (pure), against the JAX module
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_batch", [1, 3, 8, 32, 33])
def test_batch_buckets_and_padding_follow_jax(max_batch):
    assert batch_buckets(max_batch) == jbatcher.batch_buckets(max_batch)
    rows = [np.full((2, 3), i, np.float32) for i in range(3)]
    for bucket in (3, 4, 8):
        got = pad_rows(rows, bucket)
        np.testing.assert_array_equal(got, jbatcher.pad_rows(rows, bucket))
        assert got.shape == (bucket, 2, 3) and not got[3:].any()
    table = BucketTable(max_batch, 5.0)
    jtable = jbatcher.BucketTable(max_batch, 5.0)
    assert [table.pad_to(n) for n in range(1, 40)] == \
        [jtable.pad_to(n) for n in range(1, 40)]


def test_bucket_table_flush_policy():
    t = BucketTable(max_batch_size=3, max_queue_latency_ms=50,
                    bucket_shapes=[(2,)])
    key = t.key_for((2,), "float32")
    with pytest.raises(NoBucket):
        t.key_for((5,), "float32")
    mk = (lambda: jbatcher.Request(np.zeros(2, np.float32), key, None))
    assert t.add(mk()) is None and t.add(mk()) is None
    full = t.add(mk())
    assert full is not None and len(full.requests) == 3
    t.add(mk())
    assert t.due(time.perf_counter()) == []
    late = t.due(time.perf_counter() + 0.06)
    assert len(late) == 1 and len(late[0].requests) == 1
    t.add(mk())
    assert len(t.flush_all()) == 1 and t.pending_count == 0


def test_chaos_serve_slow_grammar():
    plan = chaos.ChaosPlan("serve_slow@7")
    assert plan.serve_delay_s() == 0.007
    assert plan.injected["serve_slow"] == 1
    with pytest.raises(tmx.MXNetError, match="delay target"):
        chaos.ChaosPlan("serve_slow:0.5")
    with pytest.raises(tmx.MXNetError, match="probability"):
        chaos.ChaosPlan("serve_slow:1.5@20")


# ---------------------------------------------------------------------------
# server behaviours
# ---------------------------------------------------------------------------

def test_mixed_shape_clients_land_in_correct_buckets():
    model = _CountingModel()
    srv = _server(model, bucket_shapes=[(3,), (6,)], max_batch_size=8,
                  max_queue_latency_ms=5, queue_depth=64)
    try:
        futs3 = [srv.submit(np.full((3,), i, np.float32)) for i in range(5)]
        futs6 = [srv.submit(np.full((6,), i, np.float32)) for i in range(3)]
        out3 = [f.result(timeout=5) for f in futs3]
        out6 = [f.result(timeout=5) for f in futs6]
    finally:
        srv.stop()
    for i, o in enumerate(out3):
        np.testing.assert_array_equal(o, np.full((3,), 2.0 * i, np.float32))
    for i, o in enumerate(out6):
        np.testing.assert_array_equal(o, np.full((6,), 2.0 * i, np.float32))
    assert set(model.batches) <= set(batch_buckets(8))


def test_no_bucket_and_closed_rejections():
    srv = _server(_CountingModel(), bucket_shapes=[(3,)], max_batch_size=2,
                  max_queue_latency_ms=1)
    srv.start()
    with pytest.raises(NoBucket):
        srv.submit(np.zeros((4,), np.float32))
    srv.stop()
    with pytest.raises(ServerClosed):
        srv.submit(np.zeros((3,), np.float32))
    rejected = srv.metrics.rejected_total.by_label()
    assert rejected.get("no_bucket") == 1 and rejected.get("closed") == 1


def test_queue_full_is_raised_not_deadlocked():
    model = _CountingModel(delay_s=0.05)
    srv = _server(model, bucket_shapes=[(2,)], max_batch_size=4,
                  max_queue_latency_ms=1, queue_depth=8, workers=1)
    try:
        futs, nfull = [], 0
        t0 = time.perf_counter()
        for _ in range(64):
            try:
                futs.append(srv.submit(np.zeros((2,), np.float32)))
            except QueueFull:
                nfull += 1
        assert time.perf_counter() - t0 < 2.0
        assert nfull > 0
        for f in futs:
            f.result(timeout=10)
    finally:
        srv.stop()
    m = srv.metrics.render_json()
    assert m["rejected"].get("queue_full") == nfull
    assert m["responses_total"] == len(futs)
    assert m["requests_total"] == 64


def test_saturation_queue_depth_metric_is_monotone():
    chaos.install("serve_slow@200")   # the first batch pins the worker
    depth = 6
    srv = _server(_CountingModel(), bucket_shapes=[(2,)], max_batch_size=2,
                  max_queue_latency_ms=1, queue_depth=depth, workers=1)
    try:
        srv.submit(np.zeros((2,), np.float32))
        _await_dispatch(srv)
        samples, nfull = [], 0
        for _ in range(2 * depth):
            try:
                srv.submit(np.zeros((2,), np.float32))
            except QueueFull:
                nfull += 1
            samples.append(srv.metrics.queue_depth.value)
        assert nfull > 0
        assert samples == sorted(samples)
        assert srv.metrics.queue_depth.peak == depth
    finally:
        srv.stop()


def test_deadline_expired_requests_never_dispatched():
    """serve_slow pins the worker; requests whose deadline expires while
    queued are rejected BEFORE dispatch: the model never sees them."""
    chaos.install("serve_slow@80")
    model = _CountingModel()
    srv = _server(model, bucket_shapes=[(2,)], max_batch_size=4,
                  max_queue_latency_ms=1, queue_depth=64, workers=1)
    try:
        t0 = time.perf_counter()
        first = srv.submit(np.zeros((2,), np.float32))
        _await_dispatch(srv)
        doomed = [srv.submit(np.zeros((2,), np.float32), deadline_ms=10)
                  for _ in range(5)]
        first.result(timeout=5)
        assert time.perf_counter() - t0 >= 0.08     # the delay happened
        for f in doomed:
            with pytest.raises(DeadlineExceeded, match="never dispatched"):
                f.result(timeout=5)
    finally:
        srv.stop()
        plan = chaos.active()
        assert plan is not None and plan.injected["serve_slow"] >= 1
    assert sum(model.batches) == 1, model.batches
    m = srv.metrics.render_json()
    assert m["rejected"].get("deadline") == 5
    assert m["responses_total"] == 1


def test_stop_drain_completes_pending_work():
    srv = _server(_CountingModel(delay_s=0.01), bucket_shapes=[(2,)],
                  max_batch_size=8, max_queue_latency_ms=500, queue_depth=64)
    futs = [srv.submit(np.full((2,), i, np.float32)) for i in range(6)]
    srv.stop(drain=True)
    for i, f in enumerate(futs):
        np.testing.assert_array_equal(f.result(timeout=1),
                                      np.full((2,), 2.0 * i, np.float32))


def test_stop_without_drain_rejects_queued_work():
    srv = _server(_CountingModel(), bucket_shapes=[(2,)], max_batch_size=8,
                  max_queue_latency_ms=500, queue_depth=64)
    futs = [srv.submit(np.zeros((2,), np.float32)) for _ in range(3)]
    srv.stop(drain=False)
    for f in futs:
        with pytest.raises(ServerClosed):
            f.result(timeout=5)


_SIGTERM_CHILD = r"""
import atexit, signal, sys, threading, time
import numpy as np
sys.path.insert(0, sys.argv[1])
import mxnet_tpu_torch as mx
from mxnet_tpu_torch.serving import ModelServer

class Slow:
    def __call__(self, x):
        time.sleep(0.01)
        return x * 2

with mx.cpu():
    srv = ModelServer(Slow(), bucket_shapes=[(2,)], max_batch_size=4,
                      max_queue_latency_ms=1, queue_depth=64)
futs = [srv.submit(np.full((2,), i, np.float32)) for i in range(12)]

@atexit.register
def report():
    ok = 0
    for i, f in enumerate(futs):
        if f.done():
            try:
                ok += int(f.result(0)[0] == 2.0 * i)
            except Exception:
                pass
    print(f"COMPLETED {ok}/{len(futs)}", flush=True)

threading.Timer(0.05, signal.raise_signal, (signal.SIGTERM,)).start()
srv.serve_forever()
"""


def test_sigterm_drain_exits_resumable():
    res = subprocess.run([sys.executable, "-c", _SIGTERM_CHILD, ROOT],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 75, (res.returncode, res.stderr[-500:])
    assert "COMPLETED 12/12" in res.stdout, (res.stdout, res.stderr[-500:])


# ---------------------------------------------------------------------------
# metrics plane
# ---------------------------------------------------------------------------

def _drive_metrics(mod):
    """The same counts through either package's ServerMetrics."""
    m = mod.ServerMetrics("m")
    info = jmx.cached_op.CacheInfo(5, 3, 1, 2, 4)
    m.cache_info_fn = lambda: info
    m.memory_fn = lambda: 4096
    for i in range(9):
        m.record_request()
    m.record_rejection("no_bucket")
    m.record_rejection("queue_full")
    m.queue_depth.set(3)
    m.queue_depth.set(1)
    m.inflight_batches.inc()
    m.inflight_batches.dec()
    for b, rows in enumerate((4, 3, 1)):
        t = 10.0 + b
        m.record_batch(rows, 4, t, t + 0.0125 * (b + 1))
        for r in range(rows):
            m.record_response(t - 0.003 * (r + 1), t - 0.001, t,
                              t + 0.0125 * (b + 1))
    return m


def test_metrics_text_is_the_jax_modules_byte_for_byte(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1000.0)
    t, j = _drive_metrics(tmetrics), _drive_metrics(jmetrics)
    monkeypatch.setattr(time, "time", lambda: 1012.5)
    assert t.render_prometheus() == j.render_prometheus()
    assert t.render_json_text() == j.render_json_text()
    assert t.render_prometheus("x") == j.render_prometheus("x")


def test_metrics_of_a_served_run():
    srv = _server(_CountingModel(), bucket_shapes=[(4,)], max_batch_size=4,
                  max_queue_latency_ms=2, queue_depth=32)
    try:
        futs = [srv.submit(np.zeros((4,), np.float32)) for _ in range(9)]
        for f in futs:
            f.result(timeout=5)
        with pytest.raises(NoBucket):
            srv.submit(np.zeros((9,), np.float32))
    finally:
        srv.stop()
    text = srv.metrics_text()
    for fam in ("mxtpu_serve_requests_total", "mxtpu_serve_batch_size",
                "mxtpu_serve_cache_misses_total",
                "mxtpu_serve_total_latency_ms", "mxtpu_serve_uptime_seconds"):
        assert f"# TYPE {fam} " in text, fam
    j = json.loads(srv.metrics.render_json_text())
    assert j["responses_total"] == 9 and j["requests_total"] == 10
    assert j["latency_ms"]["total"]["count"] == 9
    assert j["latency_ms"]["total"]["p99"] >= j["latency_ms"]["total"]["p50"]
    assert j["rejected"] == {"no_bucket": 1}
    assert j["cache"]["misses"] >= 1 and j["throughput_rps"] > 0


def test_batch_dispatch_emits_profiler_span():
    from mxnet_tpu_torch import profiler
    srv = _server(_CountingModel(), bucket_shapes=[(2,)], max_batch_size=2,
                  max_queue_latency_ms=1)
    profiler.set_state("run")
    try:
        futs = [srv.submit(np.zeros((2,), np.float32)) for _ in range(4)]
        for f in futs:
            f.result(timeout=5)
    finally:
        srv.stop()
        profiler.set_state("stop")
    spans = [e for e in profiler.events("serving")
             if e["name"].startswith("serve_batch")]
    assert spans and spans[0]["args"]["rows"] >= 1
    assert spans[0]["args"]["padded_to"] in batch_buckets(2)


def test_serving_run_report_on_drain(monkeypatch, tmp_path):
    from mxnet_tpu.telemetry import run_report as jrr
    from mxnet_tpu_torch.telemetry import run_report as trr
    monkeypatch.setenv("MXTPU_RUN_REPORT_DIR", str(tmp_path))
    srv = _server(_CountingModel(), bucket_shapes=[(2,)], max_batch_size=4,
                  max_queue_latency_ms=1, name="counting")
    futs = [srv.submit(np.zeros((2,), np.float32)) for _ in range(5)]
    for f in futs:
        f.result(timeout=5)
    srv.stop(drain=True)
    paths = [p for p in os.listdir(tmp_path) if p.startswith("serve_")]
    assert len(paths) == 1
    got = trr.load_run_report(os.path.join(tmp_path, paths[0]))
    want = jrr.build_serving_payload(srv.metrics_json())
    assert sorted(got) == sorted(want)
    assert sorted(got["serving"]) == sorted(want["serving"])
    assert got["serving"]["responses_total"] == 5
    assert got["serving"]["model"] == "counting"


# ---------------------------------------------------------------------------
# blocks through the CachedOp, against the JAX ModelServer
# ---------------------------------------------------------------------------

def test_padded_batch_rows_match_the_jax_server():
    """ONE batch of 7 requests padded to bucket 8 (flush window >> submit
    time): the port's rows equal its hybridized net on the same zero-padded
    batch, bit for bit, and the JAX ModelServer's rows at 2e-5."""
    jnet, tnet = _pool_pair(seed=7)
    rs = np.random.RandomState(2)
    items = [rs.rand(3, 8, 8).astype(np.float32) for _ in range(7)]
    served = {}
    for name, cls, net in (("jax", JModelServer, jnet),
                           ("port", ModelServer, tnet)):
        with CPU:
            srv = cls(net, bucket_shapes=[(3, 8, 8)], max_batch_size=8,
                      max_queue_latency_ms=300, queue_depth=32)
        try:
            futs = [srv.submit(x) for x in items]
            served[name] = np.stack([f.result(timeout=60) for f in futs])
            assert srv.metrics.batches_total.value == 1
            assert srv.metrics.padded_rows_total.value == 1
        finally:
            srv.stop()
    padded = np.concatenate([np.stack(items),
                             np.zeros((1, 3, 8, 8), np.float32)])
    tnet.hybridize()
    ref = tnet(tmx.nd.array(padded, ctx=CPU)).asnumpy()[:7]
    np.testing.assert_array_equal(served["port"], ref)
    np.testing.assert_allclose(served["port"], served["jax"], rtol=2e-5,
                               atol=2e-5)


def test_concurrent_clients_closed_signature_set():
    shapes = [(3, 8, 8), (3, 12, 12)]
    _, net = _pool_pair()
    srv = _server(net, bucket_shapes=shapes, max_batch_size=4,
                  max_queue_latency_ms=5, queue_depth=256, workers=2)
    srv.start()
    built = srv.warmup()
    assert built == len(shapes) * len(batch_buckets(4))
    rs = np.random.RandomState(0)
    inputs = {s: [rs.rand(*s).astype(np.float32) for _ in range(10)]
              for s in shapes}
    results = {s: [None] * 10 for s in shapes}
    errors = []

    def client(shape, i):
        try:
            results[shape][i] = srv.submit(inputs[shape][i]).result(
                timeout=30)
        except Exception as e:  # pragma: no cover - failure reporting
            errors.append((shape, i, e))

    threads = [threading.Thread(target=client, args=(s, i))
               for s in shapes for i in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    try:
        assert not errors, errors
        assert srv.cache.cache_info().misses == built
        net.hybridize()
        for s in shapes:
            direct = net(tmx.nd.array(np.stack(inputs[s]), ctx=CPU))
            np.testing.assert_allclose(np.stack(results[s]),
                                       direct.asnumpy(), rtol=1e-6,
                                       atol=1e-6)
    finally:
        srv.stop()


def test_saturation_sheds_load_through_a_block():
    chaos.install("serve_slow@100")
    _, net = _pool_pair()
    srv = _server(net, bucket_shapes=[(3, 8, 8)], max_batch_size=4,
                  max_queue_latency_ms=1, queue_depth=8, workers=1)
    try:
        srv.warmup()
        futs, full = [], 0
        for _ in range(48):
            try:
                futs.append(srv.submit(np.zeros((3, 8, 8), np.float32)))
            except QueueFull:
                full += 1
        for f in futs:
            f.result(timeout=30)
        assert full > 0 and srv.metrics.queue_depth.peak == 8
    finally:
        srv.stop()


def test_replay_log_prewarms_a_new_cache(monkeypatch, tmp_path):
    path = str(tmp_path / "replay.jsonl")
    monkeypatch.setenv("MXTPU_SERVE_REPLAY", path)
    _, net = _pool_pair()
    srv = _server(net, bucket_shapes=[(3, 8, 8)], max_batch_size=4,
                  max_queue_latency_ms=1)
    try:
        for n in (1, 3):
            futs = [srv.submit(np.zeros((3, 8, 8), np.float32))
                    for _ in range(n)]
            for f in futs:
                f.result(timeout=10)
            time.sleep(0.02)
    finally:
        srv.stop()
    sigs = serving.ReplayLog.signatures(path)
    assert {s[2] for s in sigs} <= {1, 2, 4} and sigs
    with CPU:
        fresh = serving.SignatureCache(net)
    assert serving.warm_from_replay(fresh, path) == len(sigs)
    assert serving.warm_from_replay(fresh, path) == 0


def test_memory_bytes_follow_the_cache():
    _, net = _pool_pair()
    srv = _server(net, bucket_shapes=[(3, 8, 8)], max_batch_size=2)
    try:
        srv.warmup()
        stats = srv.cache.program_memory()
        assert len(stats) == 2
        assert srv.cache.memory_bytes() == sum(
            s["temp_bytes"] + s["output_bytes"] for s in stats.values())
    finally:
        srv.stop()


def test_not_ported_parts_name_their_queue_item(tmp_path):
    # ModelServer.load came with symbol/ (A13's slice): a missing
    # checkpoint is a missing file
    with pytest.raises(OSError):
        ModelServer.load(str(tmp_path / "missing"))
    # the serving fleet (A23) is ported: every name is the real one, from
    # its module (tests/test_torch_serving_fleet.py and
    # tests/test_torch_fleet_router.py hold them to the JAX package)
    for name in jmx.serving.__all__:
        obj = getattr(serving, name)
        assert obj.__module__.startswith("mxnet_tpu_torch.serving."), name
    reg = serving.ModelRegistry(str(tmp_path / "registry"))
    assert reg.models() == [] and reg.current("m") is None
    assert serving.decide([], min_replicas=1, max_replicas=1,
                          target_queue=1)["op"] == "none"
    assert serving.enable_compile_cache("off") is None
    with pytest.raises(tmx.MXNetError, match="no verified version"):
        serving.LookupReplica(reg, "m")
    fp = serving.runtime_fingerprint()
    assert sorted(fp) == ["cuda", "device", "torch"]
    assert sorted(serving.__all__) == sorted(jmx.serving.__all__)


# ---------------------------------------------------------------------------
# examples/serving/resnet_server.py under the port's names
# ---------------------------------------------------------------------------

#: runs the example with ``mxnet_tpu`` resolved to the port, on the CPU;
#: the zoo path's ``serve_forever`` gets a SIGTERM once its handlers are
#: in place
EXAMPLE_RUNNER = r"""
import runpy, signal, sys, threading
root, argv = sys.argv[1], sys.argv[2:]
sys.path.insert(0, root)
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.context import Context
from mxnet_tpu_torch.gluon.model_zoo import vision
Context._default_ctx.value = mt.cpu()
sys.modules.update({"mxnet_tpu": mt, "mxnet_tpu.gluon": mt.gluon,
                    "mxnet_tpu.serving": mt.serving,
                    "mxnet_tpu.gluon.model_zoo": mt.gluon.model_zoo,
                    "mxnet_tpu.gluon.model_zoo.vision": vision})
install = mt.serving.ModelServer.install_signal_handlers

def install_then_term(self):
    install(self)
    threading.Timer(0.2, signal.raise_signal, (signal.SIGTERM,)).start()

mt.serving.ModelServer.install_signal_handlers = install_then_term
sys.argv = ["resnet_server.py"] + argv
runpy.run_path(root + "/examples/serving/resnet_server.py",
               run_name="__main__")
"""


@pytest.mark.parametrize("argv,code", [
    (["--smoke", "--requests", "48"], 0),
    (["--model", "resnet18_v1", "--size", "32", "--requests", "24",
      "--max-batch", "8"], 75)])
def test_resnet_server_example_runs_on_the_port(argv, code):
    res = subprocess.run([sys.executable, "-c", EXAMPLE_RUNNER, ROOT,
                          *argv], capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == code, (res.returncode, res.stdout[-800:],
                                    res.stderr[-1500:])
    n = int(argv[argv.index("--requests") + 1])
    assert f"served {n}/{n} requests" in res.stdout, res.stdout[-800:]
    assert "mxtpu_serve_responses_total" in res.stdout
    if code == 0:
        assert "SMOKE OK" in res.stdout
    else:
        assert "serving until SIGTERM" in res.stdout
