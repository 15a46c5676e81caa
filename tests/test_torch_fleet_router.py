"""The port's cross-process serving fleet (``mxnet_tpu_torch.serving``:
router, autoscaler, chaos drill) against the JAX package on the CPU,
after tests/test_fleet_router.py.

The policy (``autoscale.decide``) is a table held action for action
against the JAX ``decide``; the pick is held against the JAX router's on
the same synthetic heartbeats; the frames are byte for byte the JAX
package's. The transport (``ReplicaEndpoint`` / ``FleetRouter``) runs
against in-process ``ModelServer`` replicas over loopback sockets, and
the acceptance drill spawns REAL replica processes
(tests/dist/torch_fleet_replica_worker.py, on the CPU):

- a SIGKILL'd replica drops ZERO of 24 in-flight requests (the router
  retries its un-acked ids on survivors; replicas are idempotent by
  request id), every answer the JAX net's forward at f32 1e-5,
- a scale-up replica cold-starts from the published AOT bundle with ZERO
  signature misses and ZERO nvcc / NVRTC builds, and both survivors
  exit 75 after ``stop_fleet``.

Every wait is bounded.
"""
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.serving import autoscale as jautoscale
from mxnet_tpu.serving import router as jrouter

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import chaos
from mxnet_tpu_torch.contrib.chaos import ChaosPlan
from mxnet_tpu_torch.serving import (Autoscaler, FleetRouter, FleetServer,
                                     ModelRegistry, ModelServer, QueueFull,
                                     ReplicaEndpoint, decide)
from mxnet_tpu_torch.serving.autoscale import (fleet_max, fleet_min,
                                               fleet_target_queue)
from mxnet_tpu_torch.serving.router import (_array_header,
                                            fleet_heartbeat_ms, recv_frame,
                                            send_frame)

pytestmark = pytest.mark.serving

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)   # f32, one Dense


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _endpoint(fn=None, name="rep", **kwargs):
    """An in-process replica: ModelServer over a callable, behind a
    loopback ReplicaEndpoint."""
    with CPU:
        srv = ModelServer(fn or (lambda x: x * 2), bucket_shapes=[(8,)],
                          max_batch_size=kwargs.pop("max_batch_size", 4),
                          name=name, **kwargs)
    return ReplicaEndpoint(srv).start()


def _obs(**replicas):
    """One decide() observation from keyword replica states."""
    return {"replicas": {
        n: {"queue_depth": s[0], "inflight": s[1], "healthy": s[2]}
        for n, s in replicas.items()}}


def _jax_dense(seed):
    jmx.random.seed(seed)
    net = jmx.gluon.nn.Dense(4, in_units=8, prefix="fr_")
    net.initialize(jmx.init.Xavier())
    with jmx.autograd.pause():
        net(jmx.nd.ones((1, 8)))
    return net


def _dense_net(seed=0):
    """The port's Dense on the CPU with the seeded JAX Dense's weights."""
    jnet = _jax_dense(seed)
    with CPU:
        net = tmx.gluon.nn.Dense(4, in_units=8, prefix="fr_")
        net.initialize()
    convert.from_mxnet_tpu_params(
        net, {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}, prefix=jnet.prefix)
    return net


def _jax_out(seed, x):
    return _jax_dense(seed)(jmx.nd.array(np.atleast_2d(x))).asnumpy()[0]


SIG = {"bucket_shapes": [[8]], "dtype": "float32"}


@pytest.fixture(autouse=True)
def _no_leftover_chaos():
    yield
    chaos.uninstall()


# ---------------------------------------------------------------------------
# the pure policy: decide() is a table, the JAX package's
# ---------------------------------------------------------------------------

KNOBS = dict(min_replicas=2, max_replicas=4, target_queue=8,
             pressure_ticks=2, idle_ticks=3)

IDLE = (0, 0, True)
BUSY = (20, 3, True)
DEAD = (0, 0, False)


@pytest.mark.parametrize("history,op,extra", [
    ([], "none", {}),
    ([_obs(a=IDLE, b=DEAD)], "respawn", {"replicas": ["b"]}),
    ([_obs(a=DEAD, b=DEAD)], "respawn", {"replicas": ["a", "b"]}),
    ([_obs(a=BUSY, b=DEAD)] * 3, "respawn", {"replicas": ["b"]}),
    ([_obs(a=IDLE)], "scale_up", {"add": 1}),
    ([_obs(a=BUSY, b=BUSY)] * 2, "scale_up", {"add": 1}),
    ([_obs(a=IDLE, b=IDLE), _obs(a=BUSY, b=BUSY)], "none", {}),
    ([_obs(a=BUSY, b=BUSY, c=BUSY, d=BUSY)] * 2, "none", {}),
    ([_obs(a=IDLE, b=IDLE, c=IDLE)] * 3, "scale_down", {"drain": "a"}),
    ([_obs(a=(0, 1, True), b=IDLE, c=IDLE)] * 3, "none", {}),
    ([_obs(a=IDLE, b=IDLE)] * 3, "none", {}),
    ([_obs(a=IDLE, b=IDLE, c=IDLE)] * 2, "none", {}),
    ([_obs(a=(3, 1, True), b=(2, 0, True))], "none", {}),
])
def test_decide_table(history, op, extra):
    action = decide(history, **KNOBS)
    assert action["op"] == op, action
    for k, v in extra.items():
        assert action[k] == v, action
    assert action["reason"]
    assert action == jautoscale.decide(history, **KNOBS)


def test_decide_pressure_is_mean_depth_not_max():
    hot, idle = (20, 0, True), (0, 0, True)
    fires = [_obs(a=hot, b=idle)] * 2
    assert decide(fires, **KNOBS)["op"] == "scale_up"
    spread = [_obs(a=hot, b=idle, c=idle, d=idle)] * 2
    assert decide(spread, **KNOBS)["op"] == "none"
    for h in (fires, spread):
        assert decide(h, **KNOBS) == jautoscale.decide(h, **KNOBS)


def test_decide_validates_knobs():
    with pytest.raises(MXNetError, match="max_replicas"):
        decide([_obs(a=IDLE)], min_replicas=4, max_replicas=2,
               target_queue=8)
    with pytest.raises(MXNetError, match="min_replicas"):
        decide([], min_replicas=0, max_replicas=2, target_queue=8)


def test_fleet_env_knobs_are_strict(monkeypatch):
    for var, fn, jfn in [
            ("MXTPU_FLEET_MIN", fleet_min, jautoscale.fleet_min),
            ("MXTPU_FLEET_MAX", fleet_max, jautoscale.fleet_max),
            ("MXTPU_FLEET_TARGET_QUEUE", fleet_target_queue,
             jautoscale.fleet_target_queue)]:
        monkeypatch.delenv(var, raising=False)
        assert fn() == jfn()  # the same default
        monkeypatch.setenv(var, "many")
        with pytest.raises(MXNetError, match=var):
            fn()
        monkeypatch.setenv(var, "0")
        with pytest.raises(MXNetError, match="must be >= 1"):
            fn()
        monkeypatch.setenv(var, "3")
        assert fn() == 3
    monkeypatch.delenv("MXTPU_FLEET_HEARTBEAT_MS", raising=False)
    assert fleet_heartbeat_ms() == jrouter.fleet_heartbeat_ms()
    monkeypatch.setenv("MXTPU_FLEET_HEARTBEAT_MS", "fast")
    with pytest.raises(MXNetError, match="MXTPU_FLEET_HEARTBEAT_MS"):
        fleet_heartbeat_ms()
    monkeypatch.setenv("MXTPU_FLEET_HEARTBEAT_MS", "-5")
    with pytest.raises(MXNetError, match="must be > 0"):
        fleet_heartbeat_ms()


# ---------------------------------------------------------------------------
# routing: least-loaded pick against synthetic heartbeats
# ---------------------------------------------------------------------------

class _FakeClient:
    def __init__(self, name):
        self.name = name
        self.dead = threading.Event()
        self.pid = None

    def close(self):
        pass


def _synthetic_router(cls, load):
    """A router of ``cls`` with fake clients and hand-written heartbeat
    state: ``load`` maps name -> (inflight, queue_depth, version)."""
    router = cls(heartbeat_ms=60000)
    for name, (inflight, depth, version) in load.items():
        router._replicas[name] = _FakeClient(name)
        router._inflight[name] = inflight
        router._state[name] = {"queue_depth": depth, "version": version}
    return router


def _picks(cls, load, floor, excludes):
    router = _synthetic_router(cls, load)
    router._version_floor = floor
    try:
        return [getattr(router._pick(ex), "name", None) for ex in excludes]
    finally:
        router.close()


def test_pick_prefers_least_loaded():
    load = {"a": (5, 0, None), "b": (0, 1, None), "c": (2, 2, None)}
    ex = [set()] * 4 + [{"b"}, {"b", "c"}, {"a", "b", "c"}]
    got = _picks(FleetRouter, load, (-1, None), ex)
    assert got == ["b"] * 4 + ["c", "a", None]
    assert got == _picks(jrouter.FleetRouter, load, (-1, None), ex)


def test_pick_respects_version_floor():
    load = {"old": (0, 0, "v1"), "new": (9, 9, "v2"), "fresh": (0, 0, None)}
    ex = [set(), {"fresh"}, {"fresh", "new"}]
    got = _picks(FleetRouter, load, (2, "v2"), ex)
    assert got == ["fresh", "new", "old"]
    assert got == _picks(jrouter.FleetRouter, load, (2, "v2"), ex)


def test_states_snapshot_shapes_the_autoscaler_observation():
    router = _synthetic_router(FleetRouter, {"a": (2, 7, "v3")})
    router._replicas["a"].dead.set()
    try:
        s = router.states()["a"]
        assert s == {"queue_depth": 7, "p95_ms": 0.0, "version": "v3",
                     "inflight": 2, "healthy": False}
    finally:
        router.close()


# ---------------------------------------------------------------------------
# transport: frames, endpoint idempotence, death retry, shed failover
# ---------------------------------------------------------------------------

def test_frames_are_the_jax_packages():
    """The wire format byte for byte: a frame either package writes is
    the other's."""
    a, b = socket.socketpair()
    try:
        arr = np.arange(8, dtype=np.float32)
        for send in (send_frame, jrouter.send_frame):
            send(a, _array_header("predict", "rid", arr, deadline_ms=5.0),
                 arr.tobytes())
            h, p = jrouter.recv_frame(b)
            assert h == jrouter._array_header("predict", "rid", arr,
                                              deadline_ms=5.0)
            assert p == arr.tobytes()
        jrouter.send_frame(a, {"op": "ping", "id": "x"})
        assert recv_frame(b) == ({"op": "ping", "id": "x"}, b"")
    finally:
        a.close()
        b.close()


def test_endpoint_is_idempotent_by_request_id():
    calls = []

    def fn(x):
        calls.append(int(x.shape[0]))
        return x * 2

    ep = _endpoint(fn, name="idem")
    try:
        conn = socket.create_connection(ep.addr, timeout=10)
        arr = np.ones(8, dtype=np.float32)
        header = _array_header("predict", "rid-1", arr)
        send_frame(conn, header, arr.tobytes())
        h1, p1 = recv_frame(conn)
        assert h1["op"] == "result" and h1["id"] == "rid-1"
        computed = sum(calls)
        send_frame(conn, header, arr.tobytes())
        h2, p2 = recv_frame(conn)
        assert h2["op"] == "result" and h2["id"] == "rid-1"
        assert p2 == p1
        assert sum(calls) == computed
        conn.close()
    finally:
        ep.close()


def test_replica_death_retries_in_flight_with_zero_drops():
    def slow(x):
        time.sleep(0.02)
        return x * 2

    ep1 = _endpoint(slow, name="r1")
    ep2 = _endpoint(slow, name="r2")
    router = FleetRouter(heartbeat_ms=50)
    try:
        router.add_replica("r1", ep1.addr)
        router.add_replica("r2", ep2.addr)
        x = np.ones(8, dtype=np.float32)
        futs = [router.submit(x) for _ in range(16)]
        ep1.close(abort=True)  # the replica process "dies" mid-flight
        outs = [f.result(timeout=30) for f in futs]  # ZERO dropped
        assert len(outs) == 16
        for out in outs:
            np.testing.assert_allclose(out, 2 * x, rtol=1e-6)
        states = router.states()
        assert states["r2"]["healthy"]
        assert not states["r1"]["healthy"]
        assert router.live_count() == 1
        assert any(f.retries > 0 for f in futs)
        assert all(f.replica == "r2" for f in futs if f.retries)
    finally:
        router.close()
        ep1.close(abort=True)
        ep2.close(abort=True)


def test_saturated_fleet_sheds_with_typed_queuefull():
    def slow(x):
        time.sleep(0.05)
        return x

    ep = _endpoint(slow, name="tiny", max_batch_size=1, queue_depth=1)
    router = FleetRouter(heartbeat_ms=60000)
    try:
        router.add_replica("tiny", ep.addr)
        x = np.ones(8, dtype=np.float32)
        futs = [router.submit(x) for _ in range(10)]
        results, shed = 0, 0
        for f in futs:
            try:
                f.result(timeout=30)
                results += 1
            except QueueFull:
                shed += 1
        assert results >= 1 and shed >= 1
        assert results + shed == 10
    finally:
        router.close()
        ep.close(abort=True)


# ---------------------------------------------------------------------------
# rolling deploy: version tags stay monotone under concurrent load
# ---------------------------------------------------------------------------

def test_rolling_deploy_is_monotone_under_load(tmp_path):
    reg = ModelRegistry(str(tmp_path / "registry"))
    reg.publish("m", net=_dense_net(seed=1), signature=SIG)
    reg.publish("m", net=_dense_net(seed=2), signature=SIG)
    with CPU:
        eps = [ReplicaEndpoint(FleetServer(reg, "m", version="v1",
                                           max_batch_size=4,
                                           name=f"m-{i}")).start()
               for i in range(2)]
    router = FleetRouter(heartbeat_ms=50)
    tags, errs = [], []
    stop = threading.Event()
    x = np.ones(8, dtype=np.float32)

    def client():
        while not stop.is_set():
            fut = router.submit(x)
            try:
                out = fut.result(timeout=30)
                tags.append((fut.version, out))
            except Exception as e:  # pragma: no cover - the assertion
                errs.append(e)
    try:
        router.add_replica("m0", eps[0].addr)
        router.add_replica("m1", eps[1].addr)
        t = threading.Thread(target=client)
        t.start()
        time.sleep(0.15)
        reports = router.rolling_deploy("v2")
        time.sleep(0.15)
        stop.set()
        t.join(30)
        assert not t.is_alive()
        assert len(reports) == 2
        assert all(r["version"] == "v2" for r in reports)
        assert not errs
        nums = [int(v[1:]) for v, _ in tags if v]
        assert nums and nums == sorted(nums)
        assert nums[0] == 1 and nums[-1] == 2
        assert router._version_floor[0] == 2
        want = {"v1": _jax_out(1, x), "v2": _jax_out(2, x)}
        for v, out in tags:
            np.testing.assert_allclose(out, want[v], **TOL)
    finally:
        stop.set()
        router.close()
        for ep in eps:
            ep.close(abort=True)


# ---------------------------------------------------------------------------
# autoscaler executor: respawn / drain against live endpoints
# ---------------------------------------------------------------------------

def test_autoscaler_respawns_dead_and_drains_idle():
    spawned, retired = [], []
    endpoints = {}

    def spawn(name):
        ep = _endpoint(name=name)
        endpoints[name] = ep
        spawned.append(name)
        return ep.addr, None

    def retire(name, pid):
        retired.append(name)

    router = FleetRouter(heartbeat_ms=50)
    scaler = Autoscaler(router, spawn, retire, min_replicas=1,
                        max_replicas=3, target_queue=4,
                        pressure_ticks=2, idle_ticks=2)
    try:
        for _ in range(2):
            scaler._spawn_one()
        scaler.seed_seq(2)
        assert router.live_count() == 2
        assert scaler.step()["op"] == "none"

        endpoints["r1"].close(abort=True)  # kill one replica
        deadline = time.monotonic() + 10
        while router.live_count() == 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        action = scaler.step()
        assert action["op"] == "respawn" and action["replicas"] == ["r1"]
        assert router.live_count() == 2  # capacity restored
        assert spawned == ["r1", "r2", "r3"] and retired == ["r1"]

        ops = [scaler.step()["op"] for _ in range(2)]
        assert ops == ["none", "scale_down"]
        assert router.live_count() == 1
        assert len(retired) == 2
    finally:
        router.close()
        for ep in endpoints.values():
            ep.close(abort=True)


# ---------------------------------------------------------------------------
# chaos: replica_kill grammar + the router integration
# ---------------------------------------------------------------------------

def test_replica_kill_grammar():
    plan = ChaosPlan("replica_kill@5")
    assert plan.replica_kill_due(4) is None
    assert plan.replica_kill_due(5) == -1  # default victim: busiest
    assert plan.replica_kill_due(50) is None  # consume-once
    assert plan.injected["replica_kill"] == 1
    assert ChaosPlan("replica_kill@3:1").replica_kill_due(3) == 1
    for bad in ("replica_kill@0", "replica_kill@-2", "replica_kill@x",
                "replica_kill@3:z", "replica_kill@3:-7", "replica_kill"):
        with pytest.raises(MXNetError):
            ChaosPlan(bad)


def test_router_chaos_kill_fires_once_and_drops_nothing():
    killed = []
    eps = {"a": _endpoint(name="a"), "b": _endpoint(name="b")}
    router = FleetRouter(heartbeat_ms=50)
    try:
        router.add_replica("a", eps["a"].addr)
        router.add_replica("b", eps["b"].addr)
        chaos.install("replica_kill@3:0")
        router.set_kill_hook(
            lambda name: (killed.append(name),
                          eps[name].close(abort=True)))
        x = np.ones(8, dtype=np.float32)
        outs = [router.predict(x, timeout=30) for _ in range(8)]
        assert len(outs) == 8
        assert killed == ["a"]
        assert chaos.active().injected["replica_kill"] == 1
        assert router.live_count() == 1
        assert router.states()["b"]["healthy"]
    finally:
        chaos.uninstall()
        router.close()
        for ep in eps.values():
            ep.close(abort=True)


# ---------------------------------------------------------------------------
# the acceptance drill: REAL replica processes
# ---------------------------------------------------------------------------

def _spawn_worker(tmp_path, publish_aot=False, timeout=90):
    env = dict(os.environ)
    env.pop("MXTPU_CHAOS", None)
    env.update({"FLEET_REGISTRY": str(tmp_path / "registry"),
                "FLEET_MODEL": "drill", "FLEET_DEVICE": "cpu",
                "FLEET_PUBLISH_AOT": "1" if publish_aot else "0",
                "MXTPU_COMPILE_CACHE": str(tmp_path / "cache")})
    proc = subprocess.Popen(
        [sys.executable,
         os.path.join(ROOT, "tests", "dist", "torch_fleet_replica_worker.py")],
        stdout=subprocess.PIPE, text=True, bufsize=1, env=env)
    info = {}
    done = threading.Event()

    def _read():
        for line in proc.stdout:
            if line.startswith("FLEET_REPLICA_READY "):
                info.update(json.loads(line.split(" ", 1)[1]))
                done.set()
                return
        done.set()

    threading.Thread(target=_read, daemon=True).start()
    if not done.wait(timeout) or "port" not in info:
        proc.kill()
        raise RuntimeError(f"worker not ready (rc={proc.poll()})")
    return proc, info


def test_two_process_drill_kill_zero_drop_then_zero_compile_scaleup(
        tmp_path):
    reg = ModelRegistry(str(tmp_path / "registry"))
    reg.publish("drill", net=_dense_net(seed=3), signature=SIG)
    procs = []
    router = FleetRouter(heartbeat_ms=100)
    x = np.ones(8, dtype=np.float32)
    want = _jax_out(3, x)
    try:
        p1, i1 = _spawn_worker(tmp_path, publish_aot=True)
        procs.append(p1)
        p2, i2 = _spawn_worker(tmp_path)
        procs.append(p2)
        assert i1["aot_published"] > 0  # replica 1 seeded the bundle
        assert i1["device"] == "cpu(0)"
        router.add_replica("r1", ("127.0.0.1", i1["port"]),
                           pid=i1["pid"])
        router.add_replica("r2", ("127.0.0.1", i2["port"]),
                           pid=i2["pid"])
        np.testing.assert_allclose(router.predict(x, timeout=60), want,
                                   **TOL)

        # SIGKILL one replica with a burst in flight: zero drops
        futs = [router.submit(x) for _ in range(24)]
        os.kill(i1["pid"], signal.SIGKILL)
        outs = [f.result(timeout=60) for f in futs]
        assert len(outs) == 24
        for out in outs:
            np.testing.assert_allclose(out, want, **TOL)
        deadline = time.monotonic() + 10
        while router.live_count() == 2 and time.monotonic() < deadline:
            time.sleep(0.02)
        assert router.live_count() == 1

        # scale up: the fresh process installs the bundle (zero misses)
        # and builds no kernel (the fingerprinted compile cache)
        p3, i3 = _spawn_worker(tmp_path)
        procs.append(p3)
        assert i3["warm"]["aot_loaded"] > 0, i3
        assert i3["warm"]["compiles"] == 0, i3
        assert i3["nvcc_builds"] == 0 and i3["nvrtc_builds"] == 0, i3
        assert i3["compile_cache"].startswith(str(tmp_path / "cache"))
        router.add_replica("r3", ("127.0.0.1", i3["port"]),
                           pid=i3["pid"])
        np.testing.assert_allclose(router.predict(x, timeout=60), want,
                                   **TOL)

        # drain-stop the fleet: survivors exit RESUMABLE
        router.stop_fleet(drain=True)
        assert p2.wait(timeout=30) == 75
        assert p3.wait(timeout=30) == 75
    finally:
        router.close()
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
