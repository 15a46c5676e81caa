"""The port's serving fleet (``mxnet_tpu_torch.serving``: registry,
FleetServer hot-swap, AOT signature bundles, replay, the in-process
Fleet, the lookup tier, ``make_scan_forward``) against the JAX package on
the CPU, after tests/test_serving_fleet.py.

Every model served here carries the weights of a JAX-package net built
from a seed (copied with ``convert.from_mxnet_tpu_params``), and every
served output is held to that net's forward at f32 1e-5. The registry's
layout is held file for file against the JAX package's, and versions
cross in both directions: one published by either package resolves and
serves in the other (outputs within 1e-5). The AOT contract is the
port's restatement (a CUDA graph cannot be saved): after ``aot_load``
the warm-up makes zero signature-cache misses; a fresh process with the
compile cache enabled makes zero nvcc / NVRTC builds. Every wait is
bounded.
"""
import json
import os
import pickle
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import serving as jserving

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import chaos
from mxnet_tpu_torch.serving import (Fleet, FleetServer, ModelRegistry,
                                     QueueFull, RegistryCorruptError,
                                     ReplayLog, warm_from_replay)
from mxnet_tpu_torch.serving.registry import ARTIFACT_PREFIX

pytestmark = pytest.mark.serving

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)   # f32, one Dense / MLP


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _jax_dense(seed, out=4, in_units=8):
    jmx.random.seed(seed)
    net = jmx.gluon.nn.Dense(out, in_units=in_units, prefix="fl_")
    net.initialize(jmx.init.Xavier())
    with jmx.autograd.pause():
        net(jmx.nd.ones((1, in_units)))
    return net


def _dense_net(seed=0, out=4, in_units=8):
    """The port's Dense on the CPU with the seeded JAX Dense's weights."""
    jnet = _jax_dense(seed, out, in_units)
    with CPU:
        net = tmx.gluon.nn.Dense(out, in_units=in_units, prefix="fl_")
        net.initialize()
    convert.from_mxnet_tpu_params(
        net, {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}, prefix=jnet.prefix)
    return net


def _jax_out(seed, x):
    """The seeded JAX Dense on rows ``x`` (numpy)."""
    return _jax_dense(seed)(jmx.nd.array(np.atleast_2d(x))).asnumpy()


SIG = {"bucket_shapes": [[8]], "dtype": "float32", "batch_sizes": [1, 2]}


def _registry(tmp_path, versions=1):
    reg = ModelRegistry(str(tmp_path / "registry"))
    for i in range(versions):
        reg.publish("m", net=_dense_net(seed=i + 1), signature=SIG)
    return reg


def _server(reg, model="m", **kw):
    with CPU:
        return FleetServer(reg, model, **kw)


ONES = np.ones((8,), np.float32)


@pytest.fixture(autouse=True)
def _no_leftover_chaos():
    yield
    chaos.uninstall()


# ---------------------------------------------------------------------------
# registry: publish / resolve / CURRENT / gc / rollback
# ---------------------------------------------------------------------------

def test_publish_layout_and_resolve(tmp_path):
    reg = _registry(tmp_path)
    assert reg.versions("m") == ["v1"] and reg.current("m") == "v1"
    vdir = tmp_path / "registry" / "m" / "v1"
    for name in (f"{ARTIFACT_PREFIX}-symbol.json",
                 f"{ARTIFACT_PREFIX}-0000.params", "MANIFEST.json",
                 "manifest.json", "DONE"):
        assert (vdir / name).exists(), name
    # the JAX registry's publish of the same net writes the same files
    jreg = jserving.ModelRegistry(str(tmp_path / "jregistry"))
    jreg.publish("m", net=_jax_dense(1), signature=SIG)
    assert sorted(os.listdir(vdir)) == sorted(
        os.listdir(tmp_path / "jregistry" / "m" / "v1"))
    assert (tmp_path / "registry" / "m" / "CURRENT").read_text() == \
        (tmp_path / "jregistry" / "m" / "CURRENT").read_text()
    res = reg.resolve("m")
    assert res.version == "v1" and res.signature == SIG
    assert res.manifest["input_names"] == ["data"]
    assert sorted(res.manifest) == sorted(jreg.resolve("m").manifest)
    # the resolved prefix loads through the standard import path
    from mxnet_tpu_torch.gluon.block import SymbolBlock
    net = SymbolBlock.imports(f"{res.prefix}-symbol.json", ["data"],
                              f"{res.prefix}-0000.params", ctx=CPU)
    x = np.ones((2, 8), np.float32)
    np.testing.assert_allclose(net(tmx.nd.array(x, ctx=CPU)).asnumpy(),
                               _jax_out(1, x), **TOL)


def test_publish_versions_are_monotone_and_immutable(tmp_path):
    reg = _registry(tmp_path, versions=2)
    assert reg.versions("m") == ["v1", "v2"]
    assert reg.current("m") == "v2"  # publish flips CURRENT by default
    with pytest.raises(MXNetError, match="immutable"):
        reg.publish("m", net=_dense_net(), version="v2")
    for bad in ("CURRENT", "v1.bad", "prod"):
        with pytest.raises(MXNetError, match="must match v<N>"):
            reg.publish("m", net=_dense_net(), version=bad)
    v3 = reg.publish("m", net=_dense_net(), set_current=False)
    assert v3 == "v3" and reg.current("m") == "v2"  # no flip on request


def test_publish_from_prefix_artifacts(tmp_path):
    net = _dense_net(seed=7)
    prefix = str(tmp_path / "export" / "mynet")
    os.makedirs(os.path.dirname(prefix))
    net.export(prefix)
    reg = ModelRegistry(str(tmp_path / "registry"))
    v = reg.publish("m", prefix=prefix, signature=SIG)
    res = reg.resolve("m", v)
    from mxnet_tpu_torch.gluon.block import SymbolBlock
    loaded = SymbolBlock.imports(f"{res.prefix}-symbol.json", ["data"],
                                 f"{res.prefix}-0000.params", ctx=CPU)
    x = np.ones((2, 8), np.float32)
    np.testing.assert_allclose(loaded(tmx.nd.array(x, ctx=CPU)).asnumpy(),
                               _jax_out(7, x), **TOL)


def test_gc_keeps_current_and_newest(tmp_path):
    reg = _registry(tmp_path, versions=4)
    reg.set_current("m", "v2")  # current is OLD
    deleted = reg.gc("m", keep=2)
    assert deleted == ["v1"]  # v2 is old but CURRENT -> kept
    assert reg.versions("m") == ["v2", "v3", "v4"]


def test_rollback_default_and_pinned(tmp_path):
    reg = _registry(tmp_path, versions=3)
    assert reg.rollback("m") == "v2" and reg.current("m") == "v2"
    assert reg.rollback("m", "v1") == "v1"
    with pytest.raises(MXNetError, match="roll back"):
        reg.rollback("m")  # nothing older than v1


# ---------------------------------------------------------------------------
# corruption: truncated artifact / forged hash / missing CURRENT
# ---------------------------------------------------------------------------

def test_truncated_artifact_quarantines_and_falls_back(tmp_path):
    reg = _registry(tmp_path, versions=2)
    params = tmp_path / "registry" / "m" / "v2" / \
        f"{ARTIFACT_PREFIX}-0000.params"
    data = params.read_bytes()
    params.write_bytes(data[:len(data) // 2])  # truncate
    res = reg.resolve("m")  # CURRENT=v2 is corrupt
    assert res.version == "v1"
    assert reg.current("m") == "v1"  # pointer healed
    assert (tmp_path / "registry" / "m" / "v2.bad").exists()
    assert reg.versions("m") == ["v1"]


def test_forged_manifest_hash_quarantines(tmp_path):
    reg = _registry(tmp_path, versions=2)
    man = tmp_path / "registry" / "m" / "v2" / "MANIFEST.json"
    body = man.read_bytes()
    man.write_bytes(body.replace(b'"m"', b'"x"', 1))
    assert len(man.read_bytes()) == len(body)  # only content verify sees it
    res = reg.resolve("m")
    assert res.version == "v1"
    assert (tmp_path / "registry" / "m" / "v2.bad").exists()


def test_missing_current_pointer_falls_back_to_newest_verified(tmp_path):
    reg = _registry(tmp_path, versions=3)
    os.remove(tmp_path / "registry" / "m" / "CURRENT")
    chaos.corrupt_file(str(tmp_path / "registry" / "m" / "v3" /
                           f"{ARTIFACT_PREFIX}-0000.params"))
    res = reg.resolve("m")
    assert res.version == "v2"
    assert reg.current("m") == "v2"  # pointer restored
    assert (tmp_path / "registry" / "m" / "v3.bad").exists()


def test_pinned_resolve_of_corrupt_version_raises(tmp_path):
    reg = _registry(tmp_path, versions=2)
    chaos.corrupt_file(str(tmp_path / "registry" / "m" / "v1" /
                           f"{ARTIFACT_PREFIX}-0000.params"))
    with pytest.raises(RegistryCorruptError):
        reg.resolve("m", "v1")
    assert (tmp_path / "registry" / "m" / "v1.bad").exists()
    assert reg.resolve("m").version == "v2"


def test_all_versions_corrupt_raises_with_context(tmp_path):
    reg = _registry(tmp_path, versions=1)
    chaos.corrupt_file(str(tmp_path / "registry" / "m" / "v1" /
                           f"{ARTIFACT_PREFIX}-0000.params"))
    with pytest.raises(MXNetError, match="no verified version"):
        reg.resolve("m")


def test_chaos_registry_corrupt_grammar(tmp_path):
    with pytest.raises(MXNetError, match="version target"):
        chaos.ChaosPlan("registry_corrupt")
    with pytest.raises(MXNetError, match="unknown event kind"):
        chaos.ChaosPlan("registry_corupt@v1")
    plan = chaos.install("registry_corrupt@v2")
    reg = _registry(tmp_path, versions=2)  # v2 publish fires the hook
    assert plan.injected["registry_corrupt"] == 1
    assert (tmp_path / "registry" / "m" / "v2" / "DONE").exists()
    assert reg.resolve("m").version == "v1"
    assert (tmp_path / "registry" / "m" / "v2.bad").exists()


def test_chaos_registry_corrupt_latest(tmp_path):
    plan = chaos.install("registry_corrupt@latest")
    reg = _registry(tmp_path, versions=1)  # the NEXT publish is hit
    assert plan.injected["registry_corrupt"] == 1
    reg.publish("m", net=_dense_net(seed=9), signature=SIG)  # untouched
    assert plan.injected["registry_corrupt"] == 1
    assert reg.resolve("m").version == "v2"
    with pytest.raises(RegistryCorruptError):
        reg.resolve("m", "v1")
    assert reg.versions("m") == ["v2"]


# ---------------------------------------------------------------------------
# across the packages: a version published by either serves in the other
# ---------------------------------------------------------------------------

def test_jax_published_version_serves_in_port(tmp_path):
    jreg = jserving.ModelRegistry(str(tmp_path / "registry"))
    jreg.publish("m", net=_jax_dense(4), signature=SIG)
    srv = _server(ModelRegistry(str(tmp_path / "registry")), "m",
                  max_batch_size=2).start()
    try:
        assert srv.active_version == "v1"
        out = srv.predict(ONES, timeout=10)
    finally:
        srv.stop()
    jsrv = jserving.FleetServer(jreg, "m", max_batch_size=2).start()
    try:
        want = jsrv.predict(ONES, timeout=10)
    finally:
        jsrv.stop()
    np.testing.assert_allclose(out, want, **TOL)
    np.testing.assert_allclose(out, _jax_out(4, ONES)[0], **TOL)


def test_port_published_version_serves_in_jax(tmp_path):
    reg = ModelRegistry(str(tmp_path / "registry"))
    reg.publish("m", net=_dense_net(6), signature=SIG)
    jsrv = jserving.FleetServer(
        jserving.ModelRegistry(str(tmp_path / "registry")), "m",
        max_batch_size=2).start()
    try:
        assert jsrv.active_version == "v1"
        want = jsrv.predict(ONES, timeout=10)
    finally:
        jsrv.stop()
    srv = _server(reg, "m", max_batch_size=2).start()
    try:
        out = srv.predict(ONES, timeout=10)
    finally:
        srv.stop()
    np.testing.assert_allclose(out, want, **TOL)


# ---------------------------------------------------------------------------
# FleetServer: deploy / hot-swap / rollback
# ---------------------------------------------------------------------------

def test_fleet_server_serves_current_and_tags_responses(tmp_path):
    reg = _registry(tmp_path)
    srv = _server(reg, max_batch_size=2, max_queue_latency_ms=2.0).start()
    try:
        assert srv.active_version == "v1"
        assert srv._table.bucket_shapes == {(8,)}
        fut = srv.submit(ONES)
        row = fut.result(timeout=10)
        assert row.shape == (4,)
        assert fut.version == "v1" and fut.dispatch_seq is not None
        np.testing.assert_allclose(row, _jax_out(1, ONES)[0], **TOL)
    finally:
        srv.stop()


def test_fleet_server_without_a_card_raises(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this case needs a host without a CUDA card")
    reg = _registry(tmp_path)
    with pytest.raises(MXNetError, match="no CUDA card"):
        FleetServer(reg, "m")  # the default context is the card


def test_deploy_hot_swap_under_load_is_atomic(tmp_path):
    reg = _registry(tmp_path, versions=2)
    reg.set_current("m", "v1")
    srv = _server(reg, version="v1", max_batch_size=4,
                  max_queue_latency_ms=1.0, workers=2,
                  queue_depth=512).start()
    item = np.random.RandomState(0).rand(8).astype(np.float32)
    tags, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()

    def client():
        while not stop.is_set():
            try:
                fut = srv.submit(item)
                out = fut.result(timeout=30)
                with lock:
                    tags.append((fut.dispatch_seq, fut.version, out))
            except Exception as e:
                with lock:
                    errors.append(repr(e))

    threads = [threading.Thread(target=client) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        time.sleep(0.15)
        report = srv.deploy("v2")
        time.sleep(0.15)
    finally:
        stop.set()
        for t in threads:
            t.join(30)
        srv.stop()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert report["previous"] == "v1" and report["version"] == "v2"
    assert report["captures"] == 0 and report["capture_ms"] == 0.0  # CPU
    tags.sort(key=lambda r: r[0])
    versions = [v for _, v, _ in tags]
    assert "v1" in versions and "v2" in versions  # load spanned the swap
    flip = versions.index("v2")
    assert all(v == "v1" for v in versions[:flip])
    assert all(v == "v2" for v in versions[flip:])  # monotone: no mixing
    # every response is its version's model: the JAX nets of seeds 1, 2
    want = {"v1": _jax_out(1, item)[0], "v2": _jax_out(2, item)[0]}
    for _, v, out in tags:
        np.testing.assert_allclose(out, want[v], **TOL)
    assert not np.allclose(want["v1"], want["v2"])


def test_deploy_same_version_is_noop_and_rollback_flips_back(tmp_path):
    reg = _registry(tmp_path, versions=2)
    srv = _server(reg, max_batch_size=2).start()
    try:
        assert srv.active_version == "v2"
        rep = srv.deploy("v2")
        assert rep["previous"] == "v2" and rep["warm_s"] == 0.0
        back = srv.rollback()
        assert back["version"] == "v1" and srv.active_version == "v1"
        assert reg.current("m") == "v1"
        np.testing.assert_allclose(srv.predict(ONES, timeout=10),
                                   _jax_out(1, ONES)[0], **TOL)
    finally:
        srv.stop()


def test_deploy_metrics_and_spans_recorded(tmp_path):
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.telemetry import default_registry
    reg_t = default_registry()
    before = reg_t.render_json().get("mxtpu_serve_deploys_total", {})
    before_n = before.get("total", 0) if isinstance(before, dict) else before
    reg = _registry(tmp_path, versions=2)
    reg.set_current("m", "v1")
    srv = _server(reg, max_batch_size=2).start()
    spans = []
    record = profiler.record_span

    def spy(name, *a, **k):
        spans.append(name)
        return record(name, *a, **k)

    profiler.record_span = spy
    try:
        srv.deploy("v2")
    finally:
        profiler.record_span = record
        srv.stop()
    after = reg_t.render_json()
    total = after["mxtpu_serve_deploys_total"]
    total_n = total.get("total", total) if isinstance(total, dict) else total
    assert total_n >= (before_n or 0) + 1
    assert after["mxtpu_serve_warm_seconds"] > 0
    assert "deploy_warm[m]" in spans and "deploy_swap[m]" in spans


# ---------------------------------------------------------------------------
# AOT bundles + replay warmers
# ---------------------------------------------------------------------------

def test_publish_aot_makes_deploy_zero_compile(tmp_path):
    """The warm replica exports its signatures for the NEXT version (same
    architecture -> same keys); the deploy installs them and its warm-up
    makes ZERO signature-cache misses (the port's restated contract:
    on the card the graphs are captured at load, 0 on the CPU)."""
    reg = _registry(tmp_path, versions=1)
    srv = _server(reg, max_batch_size=2).start()
    try:
        v2 = reg.publish("m", net=_dense_net(seed=5), signature=SIG)
        n = srv.publish_aot(version=v2)
        assert n == 2  # buckets 1 and 2 of the one item shape
        assert reg.resolve("m", v2).aot_path is not None
        report = srv.deploy(v2)
        assert report["aot_loaded"] == n
        assert report["compiles"] == 0  # the whole point
        misses = srv.cache.cache_info().misses
        out = srv.predict(ONES, timeout=10)
        assert srv.cache.cache_info().misses == misses
        np.testing.assert_allclose(out, _jax_out(5, ONES)[0], **TOL)
    finally:
        srv.stop()


def test_aot_bundle_fingerprint_mismatch_falls_back(tmp_path):
    reg = _registry(tmp_path, versions=1)
    srv = _server(reg, max_batch_size=2).start()
    try:
        v2 = reg.publish("m", net=_dense_net(seed=5), signature=SIG)
        srv.publish_aot(version=v2)
        aot = reg.resolve("m", v2).aot_path
        with open(aot, "rb") as f:
            bundle = pickle.load(f)
        bundle["fingerprint"] = {"torch": "9.9", "cuda": "9.9",
                                 "device": "mars"}
        with open(aot, "wb") as f:
            pickle.dump(bundle, f)
        reg.attach("m", v2, "aot.bin", aot)  # re-manifest the edit
        report = srv.deploy(v2)
        assert report["aot_loaded"] == 0     # rejected, not crashed
        assert report["compiles"] > 0        # warmed as misses instead
        np.testing.assert_allclose(srv.predict(ONES, timeout=10),
                                   _jax_out(5, ONES)[0], **TOL)
    finally:
        srv.stop()


def test_aot_bundle_entries_are_checked(tmp_path):
    """A bundle of another format loads nothing; an entry whose
    parameters differ from the block's is skipped, the rest installed;
    an unreadable file loads nothing."""
    from mxnet_tpu_torch.cached_op import CachedOp
    net = _dense_net(seed=1)
    op = CachedOp(net)
    for b in (1, 2):
        op(tmx.nd.array(np.zeros((b, 8), np.float32), ctx=CPU))
    path = str(tmp_path / "aot.bin")
    assert op.aot_export(path) == 2
    with open(path, "rb") as f:
        bundle = pickle.load(f)
    fresh = CachedOp(_dense_net(seed=2))
    assert fresh.aot_load(path) == 2
    assert fresh.cache_info().misses == 0
    wide = CachedOp(_dense_net(seed=2, in_units=6))
    assert wide.aot_load(path) == 0      # every key's parameters differ
    bad = dict(bundle, format=99)
    with open(path, "wb") as f:
        pickle.dump(bad, f)
    assert CachedOp(_dense_net(seed=2)).aot_load(path) == 0
    with open(path, "wb") as f:
        f.write(b"not a bundle")
    assert CachedOp(_dense_net(seed=2)).aot_load(path) == 0


def test_replay_log_roundtrip_and_dedup(tmp_path):
    path = str(tmp_path / "replay.jsonl")
    log = ReplayLog(path)
    assert log.record((8,), "float32", 2) is True
    assert log.record((8,), "float32", 2) is False  # dedup
    assert log.record((8,), "float32", 4) is True
    with open(path, "a") as f:
        f.write('{"shape": [8], "dt')
    assert ReplayLog.signatures(path) == [((8,), "float32", 2),
                                          ((8,), "float32", 4)]
    # the JAX package reads the same file the same way
    assert jserving.ReplayLog.signatures(path) == ReplayLog.signatures(path)
    log2 = ReplayLog(path)
    assert log2.record((8,), "float32", 4) is False


def test_server_records_replay_and_warmer_prewarms(tmp_path, monkeypatch):
    replay = str(tmp_path / "replay.jsonl")
    monkeypatch.setenv("MXTPU_SERVE_REPLAY", replay)
    from mxnet_tpu_torch.serving import ModelServer, SignatureCache
    with CPU:
        srv = ModelServer(_dense_net(), bucket_shapes=[(8,)],
                          max_batch_size=2, max_queue_latency_ms=1.0).start()
    try:
        for _ in range(3):
            srv.predict(ONES, timeout=10)
    finally:
        srv.stop()
    sigs = ReplayLog.signatures(replay)
    assert ((8,), "float32", 1) in sigs
    assert len(sigs) == len(set(sigs))
    monkeypatch.delenv("MXTPU_SERVE_REPLAY")
    with CPU:
        cache = SignatureCache(_dense_net(seed=2))
    assert warm_from_replay(cache, replay) == len(sigs)
    assert warm_from_replay(cache, replay) == 0  # second pass all hits


def test_deploy_warms_from_published_replay(tmp_path):
    reg = _registry(tmp_path, versions=1)
    replay = tmp_path / "replay.jsonl"
    log = ReplayLog(str(replay))
    log.record((8,), "float32", 1)
    log.record((8,), "float32", 2)
    reg.attach("m", "v1", "replay.jsonl", str(replay))
    assert reg.resolve("m").replay_path is not None
    srv = _server(reg, max_batch_size=2).start()
    try:
        info = srv.cache.cache_info()
        assert info.misses >= 2
        srv.predict(ONES, timeout=10)
        assert srv.cache.cache_info().misses == info.misses
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# Fleet: routing + rolling deploy
# ---------------------------------------------------------------------------

def test_fleet_round_robin_and_rolling_deploy(tmp_path):
    reg = _registry(tmp_path, versions=2)
    reg.set_current("m", "v1")
    with CPU:
        fleet = Fleet(reg, "m", replicas=2, version="v1", max_batch_size=2,
                      max_queue_latency_ms=1.0).start()
    try:
        assert fleet.versions() == ["v1", "v1"]
        futs = [fleet.submit(ONES) for _ in range(8)]
        for f in futs:
            np.testing.assert_allclose(f.result(timeout=10),
                                       _jax_out(1, ONES)[0], **TOL)
        for r in fleet.replicas:
            assert r.metrics_json()["responses_total"] > 0
        reports = fleet.deploy("v2")
        assert [r["version"] for r in reports] == ["v2", "v2"]
        assert fleet.versions() == ["v2", "v2"]
        np.testing.assert_allclose(fleet.predict(ONES, timeout=10),
                                   _jax_out(2, ONES)[0], **TOL)
    finally:
        fleet.stop()


def test_fleet_failover_on_saturated_replica(tmp_path):
    reg = _registry(tmp_path, versions=1)
    with CPU:
        fleet = Fleet(reg, "m", replicas=2, max_batch_size=2,
                      max_queue_latency_ms=50.0, queue_depth=1,
                      workers=1).start()
    try:
        chaos.install("serve_slow@200")
        futs = []
        for _ in range(4):
            try:
                futs.append(fleet.submit(ONES))
            except QueueFull:
                pass  # both saturated: the client-visible contract
        got = sum(1 for f in futs if f.result(timeout=30) is not None)
        assert got == len(futs) and got >= 2
    finally:
        chaos.uninstall()
        fleet.stop()


# ---------------------------------------------------------------------------
# cold start in fresh processes: zero misses, zero kernel builds
# ---------------------------------------------------------------------------

_COLD_CHILD = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, sys.argv[3])
import torch
torch.set_num_threads(1)
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.serving import (ModelRegistry, FleetServer,
                                     enable_compile_cache)
from mxnet_tpu_torch.telemetry import default_registry

cache = enable_compile_cache()  # the builds read the cache from here on
root, mode = sys.argv[1], sys.argv[2]
reg = ModelRegistry(root)
with mx.cpu():
    if mode == "publish":
        mx.random.seed(0)
        net = gluon.nn.Dense(4, in_units=8)
        net.initialize(mx.init.Xavier())
        net(nd.ones((1, 8)))
        reg.publish("m", net=net, signature={"bucket_shapes": [[8]],
                                             "dtype": "float32"})
    srv = FleetServer(reg, "m", max_batch_size=2).start()
if mode == "publish":
    srv.publish_aot()
out = srv.predict(np.ones((8,), np.float32), timeout=60)
assert out.shape == (4,)
srv.stop()
by = default_registry().render_json().get(
    "mxtpu_compile_total", {}).get("by_label", {})
print("STATS " + json.dumps({
    "warm": srv.cold_start_stats, "cache": cache,
    "build_dir": _build.BUILD_DIR,
    "nvcc": by.get("nvcc", 0), "nvrtc": by.get("nvrtc", 0)}))
"""


def _run_cold_child(tmp_path, mode):
    env = dict(os.environ, MXTPU_COMPILE_CACHE=str(tmp_path / "cache"))
    res = subprocess.run(
        [sys.executable, "-c", _COLD_CHILD, str(tmp_path / "registry"),
         mode, ROOT], capture_output=True, text=True, timeout=120, env=env,
        cwd=ROOT)
    assert res.returncode == 0, res.stderr[-1500:]
    stats = [ln for ln in res.stdout.splitlines() if ln.startswith("STATS ")]
    assert stats, res.stdout
    return json.loads(stats[-1][len("STATS "):])


def test_second_cold_start_records_zero_compile_seconds(tmp_path):
    """The port's cold-start acceptance: the first process publishes,
    warms (misses) and publishes the AOT bundle; a FRESH PROCESS serving
    the same version with the compile cache enabled warms with zero
    signature misses from the bundle and builds no kernel (its build
    directory is the fingerprinted cache)."""
    from mxnet_tpu_torch.serving import fingerprint_token
    first = _run_cold_child(tmp_path, "publish")
    assert first["warm"]["compiles"] > 0, first
    second = _run_cold_child(tmp_path, "serve")
    assert second["warm"]["aot_loaded"] == first["warm"]["compiles"], second
    assert second["warm"]["compiles"] == 0, second   # zero misses
    assert second["nvcc"] == 0 and second["nvrtc"] == 0, second
    want = os.path.join(str(tmp_path / "cache"), fingerprint_token())
    assert second["cache"] == want and second["build_dir"] == want


def test_enable_compile_cache_resolution(tmp_path, monkeypatch):
    """The JAX resolution rule: explicit dir > MXTPU_COMPILE_CACHE; None
    when unset or off; the effective dir namespaced by the fingerprint;
    a library already in the cache is loaded, not built."""
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.serving import (enable_compile_cache,
                                         fingerprint_token)
    saved = _build.BUILD_DIR
    try:
        monkeypatch.delenv("MXTPU_COMPILE_CACHE", raising=False)
        assert enable_compile_cache() is None
        for off in ("0", "off", "OFF", "none"):
            assert enable_compile_cache(off) is None
        monkeypatch.setenv("MXTPU_COMPILE_CACHE", str(tmp_path / "env"))
        got = enable_compile_cache()
        assert got == os.path.join(str(tmp_path / "env"),
                                   fingerprint_token())
        got = enable_compile_cache(str(tmp_path / "explicit"))
        assert got == os.path.join(str(tmp_path / "explicit"),
                                   fingerprint_token())
        assert _build.BUILD_DIR == got and os.path.isdir(got)
        # a finished build in the cache: build() runs no nvcc (none here)
        lib = _build._lib_path("rtc")
        assert os.path.dirname(lib) == got
        open(lib, "wb").close()
        assert _build.build(("rtc",)) == {"rtc": lib}
        tok = fingerprint_token({"torch": "2.1/x", "cuda": "12.4",
                                 "device": "NVIDIA H100 80GB HBM3"})
        assert tok == "2.1_x-12.4-NVIDIA_H100_80GB_HBM3"
    finally:
        _build.set_build_dir(saved)


def test_kernel_builds_start_in_the_background(tmp_path, monkeypatch):
    """``_build.start`` launches the nvcc runs and returns; ``build`` (and
    so ``load``) collects a run that is under way instead of starting a
    second one. A stand-in ``nvcc`` on PATH writes its ``-o`` file (there
    is no CUDA toolkit here)."""
    from mxnet_tpu_torch.ops import _build
    fake = tmp_path / "bin" / "nvcc"
    fake.parent.mkdir()
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'sleep 0.2; echo built > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{fake.parent}{os.pathsep}"
                               f"{os.environ['PATH']}")
    saved = _build.BUILD_DIR
    try:
        _build.set_build_dir(str(tmp_path / "build"))
        _build.start(("rtc", "flash_attention"))
        assert sorted(_build._running) == ["flash_attention", "rtc"]
        _build.start(("rtc",))                  # already under way
        assert len(_build._running) == 2
        lib = _build._lib_path("rtc")
        assert _build.build(("rtc",)) == {"rtc": lib}
        assert os.path.exists(lib) and "rtc" in _build.build_seconds
        assert list(_build._running) == ["flash_attention"]
        paths = _build.build(("flash_attention", "rtc"))
        assert not _build._running and all(
            os.path.exists(p) for p in paths.values())
    finally:
        for _, _, _, proc in _build._running.values():
            proc.wait(30)
        _build._running.clear()
        for n in ("rtc", "flash_attention"):
            _build.build_seconds.pop(n, None)
        _build.set_build_dir(saved)


def test_registry_ctl_smoke_and_layout_compat(tmp_path):
    """tools/registry_ctl.py (stdlib only) --smoke passes, and a version
    it publishes from the port's export resolves + serves in the port."""
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "registry_ctl.py"),
         "--smoke"], capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr[-800:]
    assert "SMOKE OK" in res.stdout
    net = _dense_net(seed=3)
    prefix = str(tmp_path / "art")
    net.export(prefix)
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "registry_ctl.py"),
         "publish", str(tmp_path / "registry"), "m", prefix,
         "--signature", json.dumps(SIG)],
        capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr[-800:]
    reg = ModelRegistry(str(tmp_path / "registry"))
    assert reg.resolve("m").version == "v1"
    srv = _server(reg, max_batch_size=2).start()
    try:
        np.testing.assert_allclose(srv.predict(ONES, timeout=10),
                                   _jax_out(3, ONES)[0], **TOL)
    finally:
        srv.stop()


def test_model_server_load_still_serves_unregistered_prefixes(tmp_path):
    from mxnet_tpu_torch.serving import ModelServer
    net = _dense_net(seed=11)
    prefix = str(tmp_path / "bare")
    net.export(prefix)
    with CPU:
        srv = ModelServer.load(prefix, bucket_shapes=[(8,)],
                               max_batch_size=2, max_queue_latency_ms=1.0)
    try:
        srv.start()
        fut = srv.submit(ONES)
        out = fut.result(timeout=10)
        np.testing.assert_allclose(out, _jax_out(11, ONES)[0], **TOL)
        assert fut.version is None  # registry-less servers are untagged
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# make_scan_forward (tests/test_model_zoo.py's case)
# ---------------------------------------------------------------------------

def _scan_net(mx):
    net = mx.gluon.nn.HybridSequential(prefix="scan_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(8, activation="relu"),
                mx.gluon.nn.Dense(3))
    return net


@pytest.mark.parametrize("training", [False, True])
def test_make_scan_forward_matches_eager(training):
    """K-batch scanned inference equals per-batch eager forwards and the
    JAX ``make_scan_forward`` on the same weights (f32 1e-5); training
    mode leaves the block's buffers alone, as the JAX scan drops the
    forward's state."""
    import jax.numpy as jnp
    from mxnet_tpu.cached_op import make_scan_forward as jscan
    from mxnet_tpu_torch.cached_op import make_scan_forward, scan_forward
    xs = np.random.RandomState(0).rand(4, 5, 6).astype(np.float32)
    jmx.random.seed(3)
    jnet = _scan_net(jmx)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(xs[0]))
    with CPU:
        net = _scan_net(tmx)
        net.initialize()
        net(tmx.nd.array(xs[0], ctx=CPU))
    convert.from_mxnet_tpu_params(
        net, {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}, prefix=jnet.prefix)
    fwd_k = make_scan_forward(net, training=training)
    out = fwd_k(tmx.nd.array(xs, ctx=CPU))
    assert out.shape == (4, 5, 3)
    want = jscan(jnet, training=training)(jnp.asarray(xs)).asnumpy()
    np.testing.assert_allclose(out.asnumpy(), want, **TOL)
    for k in range(4):
        ref = net(tmx.nd.array(xs[k], ctx=CPU)).asnumpy()
        np.testing.assert_allclose(out.asnumpy()[k], ref, **TOL)
    np.testing.assert_allclose(
        scan_forward(net, tmx.nd.array(xs, ctx=CPU)).asnumpy(), want, **TOL)


# ---------------------------------------------------------------------------
# the embedding lookup tier (tests/test_embedding_plane.py's cases)
# ---------------------------------------------------------------------------

@pytest.fixture
def plane_on(monkeypatch):
    monkeypatch.setenv("MXTPU_SPARSE_PLANE", "on")
    with CPU:
        yield


def _trained_plane(mod, name, rows=64, dim=8, world=4):
    """A plane of either package stepped twice on seeded numpy batches."""
    from importlib import import_module
    ep = import_module(mod.__name__ + ".parallel.embedding_plane")
    plane = ep.EmbeddingPlane(name, rows=rows, dim=dim, world=world,
                              optimizer=mod.optimizer.Adam(
                                  learning_rate=0.05), seed=0)
    rs = np.random.RandomState(1)
    for _ in range(2):
        ids = rs.randint(0, rows, size=6)
        g = rs.randn(6, dim).astype(np.float32)
        plane.step(ids, mod.nd.array(g))
    return plane


def test_lookup_serving_roundtrip(plane_on, tmp_path):
    from mxnet_tpu_torch.serving import (LookupFleet, LookupReplica,
                                         publish_embedding)
    plane = _trained_plane(tmx, "t_serve")
    try:
        reg = ModelRegistry(str(tmp_path / "registry"))
        sig = {"bucket_shapes": [[8]], "dtype": "float32"}
        version = publish_embedding(reg, "two_tower", plane,
                                    _dense_net(seed=2, out=2), signature=sig)
        table = plane.todense()
        replica = LookupReplica(reg, "two_tower", version=version)
        assert (replica.rows, replica.dim, replica.world) == (64, 8, 4)
        ids = np.array([0, 17, 63, 17])
        np.testing.assert_array_equal(replica.lookup(ids), table[ids])
        out = replica.recommend(ids)
        assert out.shape == (4, 2)
        np.testing.assert_array_equal(out, replica.dense_tower(table[ids]))
        jtower = _jax_dense(2, out=2)
        np.testing.assert_allclose(
            out, jtower(jmx.nd.array(table[ids])).asnumpy(), **TOL)
        fleet = LookupFleet(reg, "two_tower", replicas=2, version=version)
        for _ in range(6):
            fleet.lookup(ids)
        m = fleet.metrics_json()
        assert m["replicas"] == 2 and m["requests"] == 6
        assert m["lookup_qps"] > 0
        assert sorted(m["per_replica"].values()) == [3, 3]
        emb_meta = replica.resolved.manifest["metadata"]["embedding"]
        assert emb_meta["rows"] == 64 and emb_meta["world"] == 4
        # the JAX lookup tier serves the port's published sidecar, and
        # the port's serves a JAX-published one, row for row
        jrep = jserving.LookupReplica(
            jserving.ModelRegistry(str(tmp_path / "registry")),
            "two_tower", version=version)
        np.testing.assert_array_equal(jrep.lookup(ids), table[ids])
        jplane = _trained_plane(jmx, "t_serve_jax")
        try:
            jver = jserving.publish_embedding(
                jserving.ModelRegistry(str(tmp_path / "registry")),
                "jax_tower", jplane, _jax_dense(2, out=2), signature=sig)
            got = LookupReplica(reg, "jax_tower", version=jver).lookup(ids)
            np.testing.assert_array_equal(got, jplane.todense()[ids])
        finally:
            jplane.close()
    finally:
        plane.close()


def test_lookup_replica_requires_sidecar(plane_on, tmp_path):
    from mxnet_tpu_torch.serving import LookupReplica
    reg = ModelRegistry(str(tmp_path / "registry"))
    reg.publish("plain", net=_dense_net(seed=2, out=2),
                signature={"bucket_shapes": [[8]], "dtype": "float32"})
    with pytest.raises(MXNetError, match="sidecar"):
        LookupReplica(reg, "plain")


def test_corrupt_sidecar_quarantines_the_version(plane_on, tmp_path):
    """The sidecar is in the version's manifest: a corrupt one fails
    resolve, which quarantines the version before a replica serves it."""
    from mxnet_tpu_torch.serving import LookupReplica, publish_embedding
    from mxnet_tpu_torch.serving.lookup import EMBEDDING_SIDECAR
    plane = _trained_plane(tmx, "t_corrupt")
    try:
        reg = ModelRegistry(str(tmp_path / "registry"))
        v = publish_embedding(reg, "tt", plane, _dense_net(seed=2, out=2),
                              signature={"bucket_shapes": [[8]],
                                         "dtype": "float32"})
        chaos.corrupt_file(str(tmp_path / "registry" / "tt" / v /
                               EMBEDDING_SIDECAR))
        with pytest.raises(RegistryCorruptError):
            LookupReplica(reg, "tt", version=v)
        assert (tmp_path / "registry" / "tt" / f"{v}.bad").exists()
    finally:
        plane.close()


# ---------------------------------------------------------------------------
# the examples that use the fleet, under the port's names
# ---------------------------------------------------------------------------

#: runs an example with ``mxnet_tpu`` resolved to the port, on the CPU
RECIPE_RUNNER = r"""
import runpy, sys
from importlib import import_module
root, script, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
sys.path.insert(0, root)
import torch
torch.set_num_threads(2)
import mxnet_tpu_torch as mt
from mxnet_tpu_torch.context import Context
Context._default_ctx.value = mt.cpu()
names = ("gluon", "gluon.nn", "optimizer", "parallel.embedding_plane",
         "serving", "serving.lookup")
sys.modules.update({"mxnet_tpu": mt, **{
    f"mxnet_tpu.{n}": import_module(f"mxnet_tpu_torch.{n}") for n in names}})
sys.argv = [script] + argv
runpy.run_path(root + "/" + script, run_name="__main__")
"""


@pytest.mark.parametrize("script,marker", [
    ("examples/serving/fleet_demo.py", "SMOKE OK"),
    ("examples/recsys/two_tower.py", "TWO_TOWER OK")])
def test_fleet_examples_run_under_the_port(script, marker, tmp_path):
    """fleet_demo.py (publish, hot-swap under load from the AOT bundle
    with zero misses, rollback) and two_tower.py (its training half, then
    the lookup tier's publish_embedding / LookupFleet with the served
    table bitwise the trained one) pass their own --smoke asserts."""
    env = dict(os.environ, MXTPU_SPARSE_PLANE="on")
    res = subprocess.run(
        [sys.executable, "-c", RECIPE_RUNNER, ROOT, script, "--smoke",
         "--registry", str(tmp_path / "registry")],
        capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-1500:]
    assert marker in res.stdout, res.stdout[-1500:]
