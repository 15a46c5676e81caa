"""``fault``, ``contrib.chaos``, the kvstore's retry and the one-process
half of ``parallel.elastic`` in the port, against the JAX package's, on
the CPU.

- Checkpoints: the same files, ``meta.json`` keys and manifest in both
  packages, each package's ``params`` file loadable by the other; SHA-256
  manifests identical; verify, quarantine and fallback, an unfinished
  write never restored, the strict restore in both directions, pruning.
- The asynchronous save: ``save()`` has its host snapshot before it
  returns — an in-place update right after it never reaches the
  checkpoint, even with the writer held back — and a failed write raises
  at ``wait()``.
- Heartbeats, ``dead_nodes``, ``latest_checkpoint_meta``, ``is_recovery``.
- The chaos grammar accepts and rejects exactly what the JAX grammar does,
  with the same plan state; the seeded ``kv_flake`` firing sequence, the
  kvstore's bounded retry and its exhaustion match the JAX package's.
- The topology record, the data re-split and the restore gate match the
  JAX package's, the elastic resize of a simulated world too.
"""
import json
import os
import threading

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import fault as jfault
from mxnet_tpu import io as jio
from mxnet_tpu import nd as jnd
from mxnet_tpu.contrib import chaos as jchaos
from mxnet_tpu.parallel import elastic as jelastic

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.contrib import chaos as tchaos
from mxnet_tpu_torch.parallel import elastic as telastic


@pytest.fixture(autouse=True)
def _host_and_no_plan():
    jchaos.uninstall()
    tchaos.uninstall()
    with mt.cpu():
        yield
    jchaos.uninstall()
    tchaos.uninstall()


def _values():
    rs = np.random.RandomState(5)
    return {"0.weight": rs.randn(8, 4).astype(np.float32),
            "0.bias": rs.randn(8).astype(np.float32),
            "1.weight": rs.randn(1, 8).astype(np.float32),
            "1.bias": rs.randn(1).astype(np.float32)}


def _net_trainer(m):
    """A two-layer net with known weights and a momentum SGD trainer that
    took one step (so the optimizer has state)."""
    net = m.gluon.nn.HybridSequential(prefix="mlp_")
    net.add(m.gluon.nn.Dense(8, in_units=4, prefix="d0_"),
            m.gluon.nn.Dense(1, in_units=8, prefix="d1_"))
    net.initialize()
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(m.nd.array(_values()[k]))
    tr = m.gluon.Trainer(net.collect_params(), "sgd",
                         {"learning_rate": 0.1, "momentum": 0.9},
                         kvstore=None)
    x = m.nd.array(np.ones((2, 4), np.float32))
    with m.autograd.record():
        loss = net(x).sum()
    loss.backward()
    tr.step(2)
    return net, tr


def _weights(net):
    return {k: p.data().asnumpy().copy()
            for k, p in net._collect_params_with_prefix().items()}


# ------------------------------------------------------------ checkpoints

def test_checkpoint_layout_matches_jax(tmp_path):
    out = {}
    for name, m, fault in (("jax", mx, jfault), ("port", mt, tfault)):
        net, tr = _net_trainer(m)
        cm = fault.CheckpointManager(str(tmp_path / name))
        path = cm.save(3, net=net, trainer=tr,
                       extra={"data_state": {"epoch": 0, "batch": 3}})
        out[name] = (path, net)
    (tpath, tnet), (jpath, jnet) = out["port"], out["jax"]
    assert sorted(os.listdir(tpath)) == sorted(os.listdir(jpath)) == \
        ["DONE", "manifest.json", "meta.json", "params", "trainer"]
    tmeta = json.load(open(os.path.join(tpath, "meta.json")))
    jmeta = json.load(open(os.path.join(jpath, "meta.json")))
    assert sorted(tmeta) == sorted(jmeta) and tmeta["step"] == 3
    tman = json.load(open(os.path.join(tpath, "manifest.json")))
    jman = json.load(open(os.path.join(jpath, "manifest.json")))
    assert sorted(tman) == sorted(jman)
    assert sorted(tman["params"]) == ["bytes", "sha256"]
    # each package reads the other's params file
    from_port = jnd.load(os.path.join(tpath, "params"))
    from_jax = tnd.load(os.path.join(jpath, "params"))
    tw, jw = _weights(tnet), _weights(jnet)
    assert sorted(from_port) == sorted(from_jax) == sorted(jw)
    for k in jw:
        np.testing.assert_allclose(tw[k], jw[k], rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(from_port[k].asnumpy(), tw[k])
        np.testing.assert_array_equal(from_jax[k].asnumpy(), jw[k])


def test_manifest_sha256_matches_jax(tmp_path):
    d = tmp_path / "art"
    d.mkdir()
    (d / "a.bin").write_bytes(os.urandom(3000))
    (d / "b.json").write_text('{"x": 1}')
    (d / "c.tmp.99").write_text("in flight")
    tman = tfault.write_manifest(str(d))
    jman = jfault.write_manifest(str(d), name="j.json")
    assert tman == {k: v for k, v in jman.items()
                    if k != "manifest.json"}
    assert tfault.verify_manifest(str(d)) == tman
    tchaos.corrupt_file(str(d / "a.bin"))
    for fault in (tfault, jfault):
        with pytest.raises(fault.ManifestError, match="a.bin"):
            fault.verify_manifest(str(d))
    os.remove(d / "a.bin")
    with pytest.raises(tfault.ManifestError, match="missing"):
        tfault.verify_manifest(str(d))
    assert tfault.verify_manifest(str(tmp_path)) is None
    with pytest.raises(tfault.ManifestError):
        tfault.verify_manifest(str(tmp_path), required=True)


def test_resume_exact_and_prune(tmp_path):
    net, tr = _net_trainer(mt)
    cm = tfault.CheckpointManager(str(tmp_path), max_keep=2)
    for step in (1, 2, 3):
        cm.save(step, net=net, trainer=tr)
    assert cm.steps() == [2, 3] and cm.latest() == 3
    want = _weights(net)
    states = tr.get_states_bytes()
    net2, tr2 = _net_trainer(mt)
    net2._collect_params_with_prefix()["0.weight"].set_data(
        np.zeros((8, 4), np.float32))
    step, params, meta = cm.restore_latest(net=net2, trainer=tr2)
    assert step == 3 and meta["step"] == 3
    for k, w in _weights(net2).items():
        np.testing.assert_array_equal(w, want[k])
    assert tr2.get_states_bytes() == states


def test_unfinished_write_is_never_restored(tmp_path):
    net, tr = _net_trainer(mt)
    cm = tfault.CheckpointManager(str(tmp_path))
    cm.save(1, net=net)
    os.makedirs(tmp_path / "ckpt-2")          # no DONE: a crash mid-write
    os.makedirs(tmp_path / "ckpt-3.tmp")
    assert cm.steps() == [1]
    assert cm.restore_latest(net=net)[0] == 1
    with pytest.raises(tfault.CheckpointCorruptError, match="DONE"):
        cm.verify(2)
    assert tfault.CheckpointManager(str(tmp_path / "fresh")) \
        .restore_latest() is None


def test_corrupt_latest_quarantined_and_falls_back(tmp_path):
    net, tr = _net_trainer(mt)
    cm = tfault.CheckpointManager(str(tmp_path))
    cm.save(1, net=net, trainer=tr)
    cm.save(2, net=net, trainer=tr)
    tchaos.corrupt_file(str(tmp_path / "ckpt-2" / "params"))
    with pytest.raises(tfault.CheckpointCorruptError):
        cm.restore(2, net=net)
    assert cm.restore_latest(net=net, trainer=tr)[0] == 1
    assert os.path.isdir(tmp_path / "ckpt-2.bad")
    tchaos.corrupt_file(str(tmp_path / "ckpt-1" / "trainer"))
    assert cm.restore_latest(net=net) is None
    assert os.path.isdir(tmp_path / "ckpt-1.bad")


def test_restore_strict_both_directions(tmp_path):
    net, tr = _net_trainer(mt)
    cm = tfault.CheckpointManager(str(tmp_path))
    ps = net._collect_params_with_prefix()
    cm.save(1, params={"0.weight": ps["0.weight"].data(),
                       "bogus": ps["0.bias"].data()})
    with pytest.raises(mt.MXNetError, match="not found in net"):
        cm.restore(1, net=net)
    cm.save(2, params={"0.weight": ps["0.weight"].data()})
    before = _weights(net)
    with pytest.raises(mt.MXNetError, match="absent from checkpoint"):
        cm.restore(2, net=net)
    for k, w in _weights(net).items():
        np.testing.assert_array_equal(w, before[k])
    cm.restore(2, net=net, allow_missing=True)


def test_async_save_snapshot_taken_before_return(tmp_path):
    """The port updates weights in place: an update right after save()
    must not reach the checkpoint. The writer is held back until after
    the update, so a snapshot taken later than save()'s return would
    write the updated weights under step 5's name."""
    net, tr = _net_trainer(mt)
    want = _weights(net)
    states = tr.get_states_bytes()
    cm = tfault.CheckpointManager(str(tmp_path), async_write=True)
    gate = threading.Event()
    cm._submit(gate.wait)                      # hold the writer back
    cm.save(5, net=net, trainer=tr)
    assert not os.path.exists(tmp_path / "ckpt-5")
    x = mt.nd.array(np.ones((2, 4), np.float32))
    with mt.autograd.record():
        loss = net(x).sum()
    loss.backward()
    tr.step(2)                                 # in place: weights, momenta
    for p in net.collect_params().values():
        p.tensor.data.add_(1.0)
    gate.set()
    cm.wait()
    assert cm.steps() == [5] and len(cm.write_seconds) == 1
    net2, tr2 = _net_trainer(mt)
    cm.restore(5, net=net2, trainer=tr2)
    for k, w in _weights(net2).items():
        np.testing.assert_array_equal(w, want[k], err_msg=k)
    assert tr2.get_states_bytes() == states


def test_async_saves_under_thread_stress(tmp_path):
    """Saves queued faster than the writer drains them, with a tiny switch
    interval: every checkpoint lands, in submission order, and the
    writer thread is gone once drained."""
    import sys
    net, tr = _net_trainer(mt)
    cm = tfault.CheckpointManager(str(tmp_path), max_keep=100,
                                  async_write=True)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for step in range(1, 21):
            cm.save(step, net=net, trainer=tr)
        waiter = threading.Thread(target=cm.wait)
        waiter.start()
        waiter.join(timeout=120)
        assert not waiter.is_alive(), "the writes never finished"
    finally:
        sys.setswitchinterval(old)
    assert cm.steps() == list(range(1, 21))
    assert len(cm.write_seconds) == 20 and cm._thread is None
    order = [json.load(open(tmp_path / f"ckpt-{s}" / "meta.json"))["time"]
             for s in range(1, 21)]
    assert order == sorted(order)


def test_async_write_failure_raises_at_wait(tmp_path, monkeypatch):
    net, _ = _net_trainer(mt)
    cm = tfault.CheckpointManager(str(tmp_path), async_write=True)

    def broken(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(tfault.nd, "save", broken)
    cm.save(1, net=net)
    with pytest.raises(mt.MXNetError, match="disk full"):
        cm.wait()
    cm.wait()                                  # reported once


def test_heartbeat_dead_nodes_and_meta(tmp_path, monkeypatch):
    d = str(tmp_path)
    hb = tfault.Heartbeat(d, rank=3, interval=0.05).start()
    hb.stop()
    assert tfault.dead_nodes(d, timeout=60) == jfault.dead_nodes(
        d, timeout=60) == []
    with open(os.path.join(d, "heartbeat-3"), "w") as f:
        f.write("0")
    assert tfault.dead_nodes(d, timeout=1) == jfault.dead_nodes(
        d, timeout=1) == [3]
    monkeypatch.setenv("DMLC_RANK", "7")
    assert tfault.Heartbeat(d).rank == 7
    net, tr = _net_trainer(mt)
    cm = tfault.CheckpointManager(d)
    cm.save(4, net=net, extra={"topology": {"world": 1, "resize_to": 2}})
    step, meta = tfault.latest_checkpoint_meta(d)
    assert (step, meta) == jfault.latest_checkpoint_meta(d)
    assert telastic.resize_request(meta) == jelastic.resize_request(meta) == 2
    assert tfault.latest_checkpoint_meta(str(tmp_path / "none")) is None


@pytest.mark.parametrize("raw", [None, "0", "", "false", "False", "1",
                                 "true", "yes"])
def test_is_recovery_matches_jax(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv("MXNET_IS_RECOVERY", raising=False)
    else:
        monkeypatch.setenv("MXNET_IS_RECOVERY", raw)
    assert tfault.is_recovery() == jfault.is_recovery()


# ------------------------------------------------------------------ chaos

SPECS = [
    "nan_grad@3,kill@10,ckpt_corrupt@latest,kv_flake:0.25",
    "inf_grad@0", "preempt@5", "resize@5", "resize@5:3", "ckpt_corrupt@8",
    "kv_slow@20", "kv_slow:0.5@2.5", "serve_slow:0.1@7",
    "kv_hang:1@3", "kv_hang:0@4:250", "mem_pressure@2",
    "mem_pressure@2:1048576", "registry_corrupt@v2",
    "registry_corrupt@latest", "replica_kill@40", "replica_kill@40:1",
    " nan_grad@1 , ,kill@2 ", "",
    # rejected
    "bogus@3", "kv_flake", "kv_flake:1.5", "kv_flake:0.5@3", "nan_grad",
    "nan_grad@latest", "kill:0.5@3", "kv_slow", "kv_slow:2@5",
    "kv_slow@-1", "kv_hang@3", "kv_hang:x@3", "kv_hang:-1@3", "kv_hang:1",
    "kv_hang:1@3:z", "resize:0.5@3", "resize", "resize@x", "resize@3:0",
    "replica_kill:0.5@3", "replica_kill", "replica_kill@0",
    "replica_kill@3:-2", "mem_pressure:0.5@3", "mem_pressure",
    "mem_pressure@3:-1", "mem_pressure@x", "registry_corrupt", "preempt@",
    "ckpt_corrupt@x",
]


def _plan_state(p):
    return (p.kv_flake_p, p.kv_slow_p, p.kv_slow_ms, p.serve_slow_p,
            p.serve_slow_ms, {k: sorted(v) for k, v in p._at.items()},
            p._ckpt_latest, sorted(p._registry_targets), p._registry_latest,
            dict(p._kv_hang), dict(p._mem_pressure), dict(p._replica_kill),
            dict(p._resize))


@pytest.mark.parametrize("spec", SPECS)
def test_chaos_grammar_matches_jax(spec):
    try:
        jplan = jchaos.ChaosPlan(spec)
    except mx.base.MXNetError as e:
        with pytest.raises(mt.MXNetError) as ei:
            tchaos.ChaosPlan(spec)
        assert str(ei.value) == str(e)
        return
    assert _plan_state(tchaos.ChaosPlan(spec)) == _plan_state(jplan)


def test_chaos_step_events_fire_once_as_in_jax():
    plans = [c.ChaosPlan("nan_grad@3,kill@10,preempt@11,resize@12:2,"
                         "mem_pressure@4:100") for c in (jchaos, tchaos)]
    for step in range(14):
        seen = []
        for p in plans:
            p.begin_step(step)
            row = [p.should("nan_grad"), p.should("nan_grad"),
                   p.resize_target(), p.mem_pressure_bytes(),
                   p.poisons_step(step + 1)]
            seen.append(row)
        assert seen[0] == seen[1], step
    tp = tchaos.ChaosPlan("kill@2")
    tp.begin_step(2)
    with pytest.raises(tchaos.ChaosKilled):
        tp.maybe_kill()
    assert tp.injected["kill"] == 1


@pytest.mark.parametrize("seed", [0, 7])
def test_kv_flake_sequence_matches_jax(monkeypatch, seed):
    monkeypatch.setenv("MXTPU_CHAOS_SEED", str(seed))
    seqs = []
    for chaos, err in ((jchaos, mx.kvstore.TransientKVError),
                       (tchaos, mt.kvstore.TransientKVError)):
        plan = chaos.ChaosPlan("kv_flake:0.3,kv_slow:0.5@0")
        seq = []
        for i in range(200):
            try:
                plan.kv_maybe_fail("push", i)
                seq.append(plan.kv_delay_s() >= 0.0)
            except err:
                seq.append(None)
        seqs.append((seq, dict(plan.injected)))
    assert seqs[0] == seqs[1]


def test_kv_flake_retry_recovers_and_exhausts(monkeypatch):
    monkeypatch.setenv("MXNET_KV_RETRY_BASE_MS", "0.01")
    got = []
    for m, chaos in ((mx, jchaos), (mt, tchaos)):
        plan = chaos.install("kv_flake:0.4")
        kv = m.kv.create("local")
        kv.init(0, m.nd.ones((4,)))
        out = m.nd.zeros((4,))
        for i in range(40):
            kv.push(0, m.nd.ones((4,)) * i)
            kv.pull(0, out=out)
        got.append((plan.injected["kv_flake"], out.asnumpy()))
        chaos.uninstall()
    assert got[0][0] == got[1][0] > 0
    np.testing.assert_array_equal(got[0][1], got[1][1])
    monkeypatch.setenv("MXNET_KV_RETRY_MAX", "2")
    kv = mt.kv.create("local")
    kv.init(0, mt.nd.ones((4,)))
    tchaos.install("kv_flake:1.0")
    with pytest.raises(mt.MXNetError, match="after 2 retries"):
        kv.push(0, mt.nd.ones((4,)))


def test_trainer_step_drives_the_chaos_clock():
    net = mt.gluon.nn.Dense(1, in_units=3, use_bias=False)
    net.initialize(mt.init.Constant(1.0))
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1}, kvstore=None)
    plan = tchaos.install("nan_grad@1")
    x, y = mt.nd.ones((4, 3)), mt.nd.ones((4, 1))
    for _ in range(2):
        with mt.autograd.record():
            loss = ((net(x) - y) ** 2).mean()
        loss.backward()
        trainer.step(4)
    assert plan.injected["nan_grad"] == 1 and trainer._chaos_step == 2
    w = net.collect_params()[net.prefix + "weight"].data().asnumpy()
    assert not np.all(np.isfinite(w))


def test_env_plan_tracks_env(monkeypatch):
    monkeypatch.delenv("MXTPU_CHAOS", raising=False)
    assert tchaos.active() is None
    monkeypatch.setenv("MXTPU_CHAOS", "kv_flake:0.1")
    assert tchaos.active().kv_flake_p == 0.1
    monkeypatch.delenv("MXTPU_CHAOS")
    assert tchaos.active() is None
    with pytest.raises(mt.MXNetError):
        tchaos.install(3)


# ---------------------------------------------------------------- elastic

@pytest.mark.parametrize("parts,index,batches", [(1, 0, 3), (2, 1, 2),
                                                 (4, 3, 1)])
def test_topology_record_matches_jax(parts, index, batches):
    X = np.arange(64 * 2, dtype=np.float32).reshape(64, 2)
    recs = []
    for m, io, el in ((mx, jio, jelastic), (mt, tio, telastic)):
        it = io.NDArrayIter(X, X[:, 0], batch_size=4, num_parts=parts,
                            part_index=index, seed=1, shuffle=True)
        recs.append(el.topology_record(None, it, batches=batches))
    assert recs[0] == recs[1]
    staged = tio.DeviceStagingIter(tio.NDArrayIter(
        X, X[:, 0], batch_size=4, num_parts=parts, part_index=index))
    assert telastic.current_topology(None, staged)["num_parts"] == parts


def test_resplit_and_restore_gate_match_jax(monkeypatch):
    cur = {"world": 1, "rank": 0, "distributed": False, "num_parts": 2,
           "part_index": 0, "batch_size": 4}
    for topo in ({"num_parts": 2, "batch_size": 4, "global_samples": 24},
                 {"num_parts": 1, "batch_size": 8, "global_samples": 24},
                 {"num_parts": 4, "batch_size": 2, "global_samples": 16}):
        assert telastic.resplit_batches(topo, cur, 3) == \
            jelastic.resplit_batches(topo, cur, 3)
    bad = {"num_parts": 3, "batch_size": 4, "global_samples": 36}
    for el in (jelastic, telastic):
        with pytest.raises(el.TopologyMismatchError):
            el.resplit_batches(bad, cur, 3)
    assert telastic.check_restore(None, cur) is False
    assert telastic.check_restore({"world": 1}, cur) is False
    for el in (jelastic, telastic):
        with pytest.raises(el.TopologyMismatchError, match="MXTPU_ELASTIC"):
            el.check_restore({"world": 2}, cur)
        with pytest.raises(el.TopologyMismatchError, match="NON-portable"):
            el.check_restore({"world": 2, "portable_states": False}, cur)
    monkeypatch.setenv("MXTPU_ELASTIC", "on")
    # the group half is ported: the gate lets the change through and the
    # resize re-forms a (simulated) group, as in the JAX package
    for el in (jelastic, telastic):
        assert el.check_restore({"world": 2}, cur) is True
        el.reset_comm_state()
    assert telastic.reform_group(cur) == jelastic.reform_group(cur)
    assert telastic.begin_resize({"world": 2}, cur) == \
        jelastic.begin_resize({"world": 2}, cur)
    monkeypatch.setenv("MXTPU_ELASTIC", "maybe")
    for el in (jelastic, telastic):
        with pytest.raises(mt.MXNetError if el is telastic
                           else mx.base.MXNetError):
            el.elastic_enabled()
    # a simulated ZeRO world is ported (A10's first half): the topology
    # reads it as the JAX package does
    monkeypatch.setenv("MXTPU_ZERO_WORLD", "2")
    assert telastic.current_topology(None, None) == \
        jelastic.current_topology(None, None)
    assert telastic.current_topology(None, None)["world"] == 2
    monkeypatch.setenv("MXTPU_ZERO_WORLD", "two")
    for el in (jelastic, telastic):
        with pytest.raises(mt.MXNetError if el is telastic
                           else mx.base.MXNetError, match="integer"):
            el.current_topology(None, None)
