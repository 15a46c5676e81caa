"""The port's comm-health plane (``telemetry/collective.py``: the
collective ledger, the cross-rank digest comparison, the hung-collective
watchdog and its flight records) against the JAX package's.

- The pure parts against the JAX functions on the same inputs: the env
  grammar and its messages, ``compare_digests`` (clean, desynced order,
  a straggler, a longer tail), the ``kv_hang`` grammar and its
  consume-once, rank-gated firing.
- ``FitLoop`` in one process: ``FitResult.comm_health`` has the JAX
  package's keys, and the plane on changes no bit of the trajectory.
- Two gloo ranks (``tests/dist/torch_health_worker.py``): the same ledger
  order on both ranks (no desync), a rank delayed by ``kv_slow`` named the
  straggler, and chaos ``kv_hang:1@2:3000`` with
  ``MXTPU_COLL_TIMEOUT_S=1``: rank 0's watchdog writes a flight record
  whose absent rank is 1, the exchange then completes and both ranks end
  with the same weights as a run without the hang.
"""
import json
import os
import sys

import numpy as np
import pytest

from mxnet_tpu.contrib import chaos as jchaos
from mxnet_tpu.telemetry import collective as jcoll

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.contrib import chaos as tchaos
from mxnet_tpu_torch.telemetry import collective as tcoll

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_common import launch, worker  # noqa: E402
import torch_planes_common as C  # noqa: E402


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("MXTPU_COLL_HEALTH", "MXTPU_COLL_TIMEOUT_S", "MXTPU_COLL_RING",
              "MXTPU_CHAOS"):
        monkeypatch.delenv(k, raising=False)
    for c in (tcoll, jcoll):
        c.ledger.clear()
        c.reset_health()
    tchaos.uninstall()
    yield
    tchaos.uninstall()
    tcoll.ledger.force(None)


@pytest.mark.parametrize("var,value", [
    ("MXTPU_COLL_TIMEOUT_S", "wat"), ("MXTPU_COLL_TIMEOUT_S", "-1"),
    ("MXTPU_COLL_RING", "wat"), ("MXTPU_COLL_RING", "0"),
    ("MXTPU_COLL_HEALTH", "wat"), ("MXTPU_COLL_HEALTH", "-2"),
    ("MXTPU_COLL_HEALTH", "3")])
def test_env_grammar_matches_jax(var, value, monkeypatch):
    monkeypatch.setenv(var, value)
    for fn in ("timeout_s", "ring_capacity", "health_interval"):
        try:
            want = getattr(jcoll, fn)()
        except Exception as e:
            with pytest.raises(mt.MXNetError) as te:
                getattr(tcoll, fn)()
            assert str(te.value) == str(e)
        else:
            assert getattr(tcoll, fn)() == want


def _digest(entries, t0=1000.0):
    return [{"kind": k, "key": key, "seq": s, "bytes": 0,
             "t_enter_epoch": t0 + dt} for (k, key, s, dt) in entries]


def _lag(lag):
    return _digest([("push", "a", 0, lag), ("pull", "a", 0, 0.01 + lag),
                    ("push", "a", 1, 0.02 + lag)])


DIGESTS = {
    "clean": {0: _lag(0.0), 1: _lag(0.0)},
    "desync": {0: _digest([("push", "a", 0, 0.0), ("push", "b", 0, 0.01)]),
               1: _digest([("push", "b", 0, 0.0), ("push", "a", 0, 0.01)])},
    "straggler": {0: _lag(0.0), 1: _lag(0.05), 2: _lag(0.002)},
    "tail": {0: _digest([("push", "a", 0, 0.0), ("push", "a", 1, 0.01),
                         ("push", "a", 2, 0.02)]),
             1: _digest([("push", "a", 0, 0.0), ("push", "a", 1, 0.01)])},
}


@pytest.mark.parametrize("case", sorted(DIGESTS))
def test_compare_digests_matches_jax(case):
    got = tcoll.compare_digests(DIGESTS[case])
    assert got == jcoll.compare_digests(DIGESTS[case])
    if case == "straggler":
        assert got["straggler_rank"] == 1


@pytest.mark.parametrize("spec", ["kv_hang:1@3:500", "kv_hang:0@7",
                                  "kv_hang@3", "kv_hang:x@3", "kv_hang:1",
                                  "kv_hang:-1@3", "kv_hang:1@3:-5"])
def test_kv_hang_grammar_and_firing_match_jax(spec):
    try:
        jp = jchaos.ChaosPlan(spec)
    except Exception as e:
        with pytest.raises(mt.MXNetError) as te:
            tchaos.ChaosPlan(spec)
        assert str(te.value) == str(e)
        return
    tp = tchaos.ChaosPlan(spec)
    assert tp._kv_hang == jp._kv_hang
    step = next(iter(jp._kv_hang))
    for p in (tp, jp):
        p.begin_step(step)
    for rank in (0, 1, 1):
        assert tp.kv_hang_delay_s(rank) == jp.kv_hang_delay_s(rank)
    assert tp.injected["kv_hang"] == jp.injected["kv_hang"] == 1


def _fit(pkg):
    """The planes' MLP through ``FitLoop`` with a ``local`` kvstore object
    (its push / pull are ledgered): ``(net, trainer, FitResult)``."""
    import contextlib
    m, fitm, io, _ = C.PKGS[pkg]
    with (mt.cpu() if pkg == "port" else contextlib.nullcontext()):
        n = C.net(pkg, "mlp", False)
        tr = m.gluon.Trainer(n.collect_params(), "sgd",
                             {"learning_rate": 0.05, "momentum": 0.9},
                             kvstore=m.kv.create("local"))
        x, y = C.data("mlp")
        it = io.NDArrayIter(x, y, batch_size=C.BATCH, shuffle=True, seed=13)
        loop = fitm.FitLoop(n, tr, m.gluon.loss.SoftmaxCrossEntropyLoss(),
                            it, heartbeat=False)
        return n, tr, loop.fit(epochs=1)


def test_fitloop_comm_health_keys_match_jax(monkeypatch):
    """One process, ``MXTPU_COLL_HEALTH=2``: both packages fill
    ``comm_health`` with the same keys and the same self view, and the
    port's ledger recorded the step's kvstore exchanges."""
    monkeypatch.setenv("MXTPU_COLL_HEALTH", "2")
    got = {}
    for pkg in ("port", "jax"):
        got[pkg] = _fit(pkg)[2].comm_health
    assert set(got["port"]) == set(got["jax"])
    for k in ("desync", "max_skew_ms", "straggler_rank", "watchdog_fired",
              "flight_records", "world"):
        assert got["port"][k] == got["jax"][k], k
    assert got["port"]["checks"] >= 1 and got["port"]["ledger_depth"] > 0


def test_plane_on_changes_no_bit(monkeypatch):
    off = _fit("port")
    monkeypatch.setenv("MXTPU_COLL_HEALTH", "1")
    monkeypatch.setenv("MXTPU_COLL_TIMEOUT_S", "30")
    on = _fit("port")
    assert tcoll.ledger.depth() > 0
    assert on[2].losses == off[2].losses
    won, woff = C.weights(on[0]), C.weights(off[0])
    for k in woff:
        np.testing.assert_array_equal(won[k], woff[k])


def _health(tmp_path, name, env):
    out = tmp_path / name
    out.mkdir()
    proc = launch(2, worker("torch_health_worker.py") + [str(out)],
                  extra_env=env, timeout=180)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return [json.load(open(out / f"health_r{r}.json")) for r in range(2)]


def test_two_ranks_same_order_and_straggler(tmp_path):
    base = _health(tmp_path, "base", {"MXTPU_COLL_HEALTH": "1"})
    assert base[0]["records"] == base[1]["records"]
    assert {r[0] for r in base[0]["records"]} >= {"push", "pull",
                                                  "allreduce"}
    for r in base:
        assert r["summary"]["desync"] is None
        assert r["summary"]["checks"] == 6 and r["summary"]["world"] == 2
    assert base[0]["clock_offset_ms"] == 0.0
    slow = _health(tmp_path, "slow", {"MXTPU_COLL_HEALTH": "1",
                                      "HEALTH_SLOW_RANK": "1"})
    # rank 1 sleeps 150 ms before each exchange: both ranks name it
    for r in slow:
        assert r["summary"]["straggler_rank"] == 1
        assert r["summary"]["skew_ms_by_rank"]["1"]["mean_ms"] > 50
    assert slow[0]["weight"] == base[0]["weight"]


def test_two_ranks_kv_hang_flight_record_names_rank_one(tmp_path):
    env = {"MXTPU_COLL_HEALTH": "1", "MXTPU_COLL_TIMEOUT_S": "1",
           "MXTPU_CHAOS": "kv_hang:1@2:3000",
           "MXTPU_MEM_DUMP_DIR": str(tmp_path / "dumps")}
    hung = _health(tmp_path, "hung", env)
    base = _health(tmp_path, "base", {"MXTPU_COLL_HEALTH": "1"})
    assert hung[1]["injected"]["kv_hang"] == 1
    assert hung[0]["injected"]["kv_hang"] == 0
    assert hung[0]["summary"]["watchdog_fired"] >= 1
    recs = tcoll.scan_flight_records(str(tmp_path / "dumps"))
    named = {r["rank"] for r in recs if r["absent_rank"] == 1}
    assert 0 in named
    # the JAX parser reads the port's record the same way
    for r in recs:
        assert jcoll.parse_flight_record(r["path"]) == r
    for r in range(2):
        assert hung[r]["weight"] == base[r]["weight"]
