"""The port's ``mx.profiler`` facade and ``mx.monitor.Monitor`` against
the JAX package's: the same script of scopes, markers and counters gives
the same events, the facade's Chrome export passes
``validate_chrome_trace``, the device trace (``torch.profiler``) lands in
its log directory, the server routing and the executor refuse naming
their ROADMAP items, and the Monitor's ``toc`` entries fed by the
numerics plane match the JAX Monitor's."""
import json
import os
import time

import numpy as np
import pytest

import torch_planes_common as C

import mxnet_tpu as mx
from mxnet_tpu import profiler as jprof

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import profiler as tprof
from mxnet_tpu_torch.telemetry import chrome_trace as tct


def _script(prof, path):
    prof.set_config(filename=str(path), aggregate_stats=True)
    prof.set_state("run")
    dom = prof.Domain("io")
    with prof.Task("load", dom):
        pass
    with prof.Event("decode"):
        pass
    fr = prof.Frame("frame", dom)
    fr.start()
    fr.stop()
    c = prof.Counter("queue", dom, 3)
    c += 2
    c -= 1
    prof.Marker("epoch_end").mark()
    prof.pause()
    with prof.Task("hidden"):
        pass
    prof.resume()
    t = time.perf_counter()
    prof.record_span("manual", "custom", t, t + 1e-3, {"k": 1})
    prof.set_state("stop")
    prof.dump()
    return [(e["name"], e["cat"], e["ph"]) for e in prof.events()
            if e["cat"] in ("task", "event", "frame", "counter", "marker",
                            "custom")]


def test_facade_matches_jax_and_exports_a_valid_trace(tmp_path):
    from mxnet_tpu.telemetry.tracer import tracer as jtr
    from mxnet_tpu_torch.telemetry.tracer import tracer as ttr
    jtr.clear()
    ttr.clear()
    got = {"jax": _script(jprof, tmp_path / "j.json"),
           "port": _script(tprof, tmp_path / "t.json")}
    assert got["port"] == got["jax"]
    assert ("hidden", "task", "X") not in got["port"]
    assert ("queue", "counter", "C") in got["port"]
    evs = tct.validate_chrome_trace(json.load(open(tmp_path / "t.json")))
    assert {"io:load", "decode", "manual"} <= {e["name"] for e in evs}
    assert tprof.state() == "stop"
    table = tprof.dumps(reset=True)
    assert "io:load" in table and "decode" in table


def test_device_trace_and_refusals(tmp_path):
    import torch
    tprof.start_xla_trace(str(tmp_path / "dev"))
    with pytest.raises(mt.MXNetError, match="a trace is running"):
        tprof.start_xla_trace(str(tmp_path / "dev"))
    (torch.ones(64, 64) @ torch.ones(64, 64)).sum()
    path = tprof.stop_xla_trace()
    assert tprof.stop_xla_trace() is None
    assert os.path.dirname(path) == str(tmp_path / "dev")
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "aten::mm" in names
    # profile_process='server' is ported (A10's first half): without a
    # dist kvstore both packages refuse with the same words; with a
    # one-worker dist store the command reaches this process
    for prof, err in ((tprof, mt.MXNetError), (jprof, mx.base.MXNetError)):
        prof.set_kvstore_handle(None)
        for call in (lambda: prof.set_state("run", profile_process="server"),
                     lambda: prof.set_config(profile_process="server"),
                     lambda: prof.dump(profile_process="server"),
                     lambda: prof.pause(profile_process="server")):
            with pytest.raises(err, match="needs a dist kvstore"):
                call()
    mt.kv.create("dist_sync")            # registers itself
    tprof.set_state("run", profile_process="server")
    assert tprof.state() == "run"
    tprof.pause(profile_process="server")
    tprof.resume(profile_process="server")
    tprof.set_state("stop", profile_process="server")
    assert tprof.state() == "stop"
    tprof.set_kvstore_handle(None)
    # Monitor.install came with the executor (A13's slice): it takes an
    # executor, whose monitor callback it sets
    with pytest.raises(AttributeError, match="set_monitor_callback"):
        mt.monitor.Monitor(1).install(object())


def test_monitor_eager_wrap():
    mon = mt.monitor.Monitor(2, pattern="relu.*")
    relu = mon.wrap(lambda x: mt.nd.relu(x), "relu0")
    with mt.cpu():
        x = mt.nd.array(np.array([-1.0, 2.0, 3.0], np.float32))
        outs = []
        for _ in range(3):
            mon.tic()
            relu(x)
            outs.append(mon.toc())
    # steps 0 and 2 are sampled (interval 2); the default stat is the
    # mean absolute value
    want = str(np.array([5 / 3], np.float32))
    assert outs == [[(0, "relu0", want)], [], [(2, "relu0", want)]]
    assert mon.step == 3


def test_monitor_toc_entries_match_jax(monkeypatch):
    """The Monitor fed by the numerics plane: the same (step, name:stat)
    entries as the JAX Monitor, values within the plane's tolerance."""
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    monkeypatch.setenv("MXTPU_NUMERICS", "on,every=1")
    got = {}
    for pkg in ("jax", "port"):
        m = C.PKGS[pkg][0]
        mon = m.monitor.Monitor(1, pattern=r"d2_.*").install_numerics()
        entries = []
        mon.tic()
        C.fit(pkg, "mlp", epochs=1, on_step_end=lambda s, l, mon=mon,
              entries=entries: (entries.extend(mon.toc()), mon.tic()))
        got[pkg] = entries
    assert [(s, k) for s, k, _ in got["port"]] == \
        [(s, k) for s, k, _ in got["jax"]]
    # 4 steps x 2 params x 5 stats, less the zero-initialised bias's
    # update ratio at step 0 (no ratio against a zero weight)
    assert len(got["port"]) == 4 * 2 * 5 - 1
    for (_, k, tv), (_, _, jv) in zip(got["port"], got["jax"]):
        np.testing.assert_allclose(float(tv), float(jv), rtol=2e-5,
                                   atol=1e-6 if not k.endswith(":mean")
                                   else 1e-4, err_msg=k)
