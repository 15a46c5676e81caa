"""The port's self-healing fleet (``parallel/supervisor.py``, ``launch
--supervise``, ``parallel/fleet_trace.py``) against the JAX package's.

- The pure parts against the JAX functions on the same inputs: the knob
  parse, the exit-code taxonomy, the escalation ladder ``decide`` (the
  table of ``tests/test_supervisor.py``), the capacity models, the
  forensic bundle's files, the flight-record schema both ways, the fleet
  trace merge.
- The ladder on stub workers: a fleet that always crashes ends by the
  budget with a forensic bundle, never an endless relaunch.
- Live fleets on gloo ranks (``tests/dist/torch_fleet_worker.py``, a
  two-layer net through ``FitLoop`` over ``dist_sync``): a kill of rank 1
  shrinks the fleet to 1 and the capacity model grows it back to 2; a
  hung exchange of rank 1 (chaos ``kv_hang``) makes rank 0's watchdog
  write a flight record naming rank 1, and the supervisor shrinks on it.
  Each run's final weights are held bit for bit to an unsupervised
  reference: plain ``launch`` runs that take the same world schedule
  from the same checkpoint steps (``resize@STEP:WORLD`` ends a segment
  with a checkpoint at STEP). A zero restart budget fails loudly with
  the bundle.
"""
import json
import os
import subprocess
import sys
import time

import pytest

from mxnet_tpu.parallel import supervisor as jsv
from mxnet_tpu.telemetry import collective as jcoll

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.parallel import fleet_trace as tft
from mxnet_tpu_torch.parallel import supervisor as tsv
from mxnet_tpu_torch.telemetry import collective as tcoll

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_common import ROOT, free_ports, worker  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "data",
                       "coll_flight_pr12_fixture.json")
KNOBS = dict(max_restarts=8, crash_window_s=300.0, crash_limit=3)


def _ev(kind, rank=None, t=0.0, ranks=None):
    e = {"kind": kind, "rank": rank, "time": t}
    if ranks is not None:
        e["ranks"] = ranks
    return e


LADDER = [
    ("flake_retries", [_ev("flake", 0)], 2, {}),
    ("flake_even_after_incidents",
     [_ev("crash", 1, 0.0), _ev("flake", 0, 1.0)], 2, {}),
    ("single_crash_shrinks", [_ev("crash", 1, 0.0)], 2, {}),
    ("hang_shrinks_absent_rank", [_ev("hang", 0, 0.0, ranks=[0])], 3, {}),
    ("multi_rank_death", [_ev("crash", 0, 0.0, ranks=[0, 2])], 4, {}),
    ("whole_group_death", [_ev("crash", 0, 0.0, ranks=[0, 1])], 2, {}),
    ("resumable_resumes", [_ev("resumable")], 2, {}),
    ("crash_loop_excludes",
     [_ev("crash", 1, t) for t in (0.0, 10.0, 20.0)], 2,
     {"crash_limit": 3}),
    ("crash_loop_window_expired",
     [_ev("crash", 1, t) for t in (0.0, 10.0, 1000.0)], 2,
     {"crash_limit": 3, "crash_window_s": 300.0}),
    ("different_ranks_shrink",
     [_ev("crash", 0, 0.0), _ev("crash", 1, 10.0)], 2, {"crash_limit": 2}),
    ("budget_exhausted",
     [_ev("crash", 1, float(t)) for t in range(4)], 2,
     {"max_restarts": 3, "crash_limit": 99}),
    ("budget_counts_resumables", [_ev("resumable")] * 3, 2,
     {"max_restarts": 2}),
    ("budget_ignores_flakes",
     [_ev("flake", 0, float(t)) for t in range(10)] +
     [_ev("crash", 1, 11.0)], 2, {"max_restarts": 1}),
    ("budget_outranks_crash_loop",
     [_ev("crash", 1, float(t)) for t in range(5)], 3,
     {"max_restarts": 2, "crash_limit": 3}),
    ("exclude_below_floor_fails",
     [_ev("crash", 0, t) for t in (0.0, 1.0, 2.0)], 1, {"crash_limit": 3}),
]


@pytest.mark.parametrize("events,world,over", [c[1:] for c in LADDER],
                         ids=[c[0] for c in LADDER])
def test_decide_ladder_matches_jax(events, world, over):
    kw = {**KNOBS, **over}
    assert tsv.decide(events, world=world, floor=1, **kw) == \
        jsv.decide(events, world=world, floor=1, **kw)


@pytest.mark.parametrize("name,value", [
    ("MXTPU_SUPERVISE_MAX_RESTARTS", "x"),
    ("MXTPU_SUPERVISE_MAX_RESTARTS", "-1"),
    ("MXTPU_SUPERVISE_CRASH_WINDOW_S", "0"),
    ("MXTPU_SUPERVISE_CRASH_LIMIT", "0"),
    ("MXTPU_SUPERVISE_MAX_RESTARTS", "5")])
def test_knobs_and_taxonomy_match_jax(name, value, monkeypatch):
    monkeypatch.setenv(name, value)
    for fn in ("supervise_max_restarts", "supervise_crash_window_s",
               "supervise_crash_limit"):
        try:
            want = getattr(jsv, fn)()
        except Exception as e:
            with pytest.raises(mt.MXNetError) as te:
                getattr(tsv, fn)()
            assert str(te.value) == str(e)
        else:
            assert getattr(tsv, fn)() == want
    for rc in (0, 75, -9, -15, 1, 137):
        assert tsv.classify_exit(rc) == jsv.classify_exit(rc)
    with pytest.raises(mt.MXNetError):
        tsv.classify_exit(None)


def test_capacity_models_match_jax():
    for sv in (tsv, jsv):
        m = sv.SpotCapacityModel(3, recovery_s=10.0)
        m.note_lost(2, 100.0)
        got = [m.available(t) for t in (0.0, 105.0, 110.0)]
        m.note_lost(1, 200.0)
        got.append(m.available(205.0))
        assert got == [1, 1, 3, 2]
        assert sv.StaticCapacity(4).available(1e9) == 4
    with pytest.raises(mt.MXNetError):
        tsv.SpotCapacityModel(0)


def test_flight_records_cross_packages(monkeypatch, tmp_path):
    """The port parses the JAX package's records (the PR 12 fixture and a
    live dump) and the JAX package parses the port's: one schema."""
    assert tcoll.parse_flight_record(FIXTURE) == \
        jcoll.parse_flight_record(FIXTURE)
    t = time.perf_counter() - 7.0
    rec = [{"kind": "push", "key": "_gbkt_0", "seq": 3, "bytes": 64,
            "rank": 1, "waiting_for": 0, "t_enter": t}]
    for src, dst in ((tcoll, jcoll), (jcoll, tcoll)):
        d = tmp_path / src.__name__.split(".")[0]
        monkeypatch.setenv("MXTPU_MEM_DUMP_DIR", str(d))
        path = src.ledger._dump_flight([dict(r) for r in rec], 5.0)
        assert dst.parse_flight_record(path)["absent_rank"] == 0
        assert src.parse_flight_record(path) == dst.parse_flight_record(path)
        seen = set()
        assert [r["path"] for r in tcoll.scan_flight_records(str(d), seen)] \
            == [path]
        assert tcoll.scan_flight_records(str(d), seen) == []
    bad = tmp_path / "coll_flight_bogus.json"
    bad.write_text(json.dumps({"reason": "oom"}))
    with pytest.raises(mt.MXNetError, match="not 'hung_collective'"):
        tcoll.parse_flight_record(str(bad))


def _trace(rank, offset_ms, names):
    evs = [{"ph": "M", "name": "clock_sync", "pid": 0, "tid": 0,
            "args": {"epoch_t0_s": 1000.0, "clock_offset_ms": offset_ms,
                     "rank": rank}}]
    for i, n in enumerate(names):
        evs.append({"ph": "X", "name": n, "cat": "comm", "pid": 0,
                    "tid": 1, "ts": 1000.0 * i + 100 * rank, "dur": 50.0})
    return {"traceEvents": evs}


def test_forensic_bundle_and_fleet_trace_match_jax(tmp_path):
    """The bundle holds the same files in both packages, and the port's
    copy of the fleet-trace merge gives the JAX tool's events."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import fleet_trace as jft
    traces = []
    for r in range(2):
        p = tmp_path / f"rank{r}.json"
        p.write_text(json.dumps(_trace(r, 3.0 * r,
                                       ["kv_push:0", "kv_pull:0"])))
        traces.append(str(p))
    assert tft.merge([tft.load_trace(p) for p in traces]) == \
        jft.merge([jft.load_trace(p) for p in traces])
    dumps = tmp_path / "dumps"
    dumps.mkdir()
    (dumps / "coll_flight_1_1.json").write_text(open(FIXTURE).read())
    files = {}
    for name, sv in (("port", tsv), ("jax", jsv)):
        b = sv.write_forensic_bundle(
            str(tmp_path / name), events=[_ev("crash", 1)],
            summary={"ok": False}, dump_dir=str(dumps),
            run_report_dir=str(tmp_path / "none"), trace_paths=traces)
        files[name] = sorted(os.listdir(b))
    assert files["port"] == files["jax"]
    assert "fleet_trace.json" in files["port"]


def test_stub_fleet_ends_by_the_budget_with_a_bundle(tmp_path, capsys):
    """Workers that always crash: shrink, exclude, then the budget fails
    the job (rc 1) with the forensic bundle, in bounded generations."""
    spawned = []

    def spawn(world, gen, extra):
        spawned.append((gen, world, extra.get("MXTPU_ELASTIC")))
        return {r: subprocess.Popen([sys.executable, "-c",
                                     "import sys; sys.exit(3)"])
                for r in range(world)}

    sup = tsv.Supervisor(spawn, 2, state_dir=str(tmp_path),
                         dump_dir=str(tmp_path / "dumps"), max_restarts=3,
                         crash_window_s=300.0, crash_limit=3,
                         term_grace_s=0.5, floor=1)
    assert sup.run() == 1
    assert len(spawned) <= 2 * 3 + 2 and sup.restarts <= 3
    assert spawned[0][2] is None and all(s[2] == "on" for s in spawned[1:])
    summary = json.loads(capsys.readouterr().out.split(
        "SUPERVISOR_SUMMARY ", 1)[1])
    assert summary["ok"] is False
    assert os.path.exists(os.path.join(summary["forensics"], "events.json"))


# ---------------------------------------------------------------------
# live fleets
# ---------------------------------------------------------------------

def _launch(args, env, timeout=240):
    full = dict(os.environ, OMP_NUM_THREADS="1",
                MXTPU_CMD_PORT_BASE=str(free_ports(8)), **env)
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.launch"] + args
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, env=full, cwd=ROOT)


def _gens(out):
    """``[(gen, world, start)]`` of the generations that started, from
    rank 0's records, and the final record."""
    gens, last = [], None
    for name in sorted(os.listdir(out)):
        if name.startswith("gen") and name.endswith("_r0.json"):
            rec = json.load(open(os.path.join(out, name)))
            gens.append((rec["gen"], rec["world"], rec["start"]))
            if "end" in rec:
                last = rec
    return sorted(gens), last


def _reference(tmp, gens):
    """Plain launches over the supervised run's world schedule."""
    out = tmp / "ref"
    out.mkdir()
    segs = [(w, s) for _, w, s in gens]
    # a generation that trained nothing leaves the schedule as it was
    segs = [seg for i, seg in enumerate(segs)
            if i + 1 == len(segs) or segs[i + 1][1] > seg[1]]
    for i, (w, start) in enumerate(segs):
        env = {"FLEET_OUT_DIR": str(out), "FLEET_TARGET": str(w)}
        if i:
            env["MXTPU_ELASTIC"] = "on"
        if i + 1 < len(segs):
            env["FLEET_STOP"] = f"{segs[i + 1][1]}:{segs[i + 1][0]}"
        proc = _launch(["-n", str(w), "--coordinator",
                        f"127.0.0.1:{free_ports()}"] +
                       worker("torch_fleet_worker.py"), env)
        want_rc = 75 if i + 1 < len(segs) else 0
        assert proc.returncode == want_rc, proc.stderr[-4000:]
    return _gens(out)[1], segs


def _supervised(tmp, events, recovery, extra=None):
    out = tmp / "fleet"
    (out / "dumps").mkdir(parents=True)
    env = {"FLEET_OUT_DIR": str(out), "FLEET_TARGET": "2",
           "FLEET_EVENTS": json.dumps(events), "FLEET_STEP_SLEEP_MS": "300",
           "MXTPU_MEM_DUMP_DIR": str(out / "dumps")}
    env.update(extra or {})
    proc = _launch(["-n", "2", "--coordinator",
                    f"127.0.0.1:{free_ports(8)}", "--supervise",
                    "--supervise-ckpt", str(out / "ckpt_r0"),
                    "--supervise-dir", str(out / "state"),
                    "--supervise-grace", "2",
                    "--supervise-recovery", str(recovery)] +
                   worker("torch_fleet_worker.py"), env, timeout=300)
    summary = json.loads(proc.stdout.split("SUPERVISOR_SUMMARY ", 1)[1]
                         .splitlines()[0]) \
        if "SUPERVISOR_SUMMARY " in proc.stdout else None
    return proc, summary, out


def test_kill_shrinks_grows_back_bit_for_bit(tmp_path):
    proc, summary, out = _supervised(
        tmp_path, {"0": {"kind": "kill", "rank": 1, "offset": 3}},
        recovery=6)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert summary["ok"] and summary["final_world"] == 2
    assert [e["kind"] for e in summary["events"]] == ["crash"]
    assert summary["grows"] == 1 and summary["restarts"] == 1
    gens, last = _gens(str(out))
    assert [w for _, w, _ in gens] == [2, 1, 2]
    assert last["end"] == 24 and last["world"] == 2
    assert last["elastic"]["from_world"] == 1
    ref, segs = _reference(tmp_path, gens)
    assert ref["end"] == 24
    assert last["weights"] == ref["weights"]


def test_hang_flight_record_names_rank_one_bit_for_bit(tmp_path):
    proc, summary, out = _supervised(
        tmp_path, {"0": {"kind": "kv_hang", "rank": 1, "offset": 3}},
        recovery=3600,
        extra={"MXTPU_COLL_TIMEOUT_S": "2", "MXTPU_COLL_HEALTH": "1"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert [e["kind"] for e in summary["events"]] == ["hang"]
    assert summary["events"][0]["ranks"] == [1]
    recs = tcoll.scan_flight_records(str(out / "dumps"))
    assert 0 in {r["rank"] for r in recs if r["absent_rank"] == 1}
    gens, last = _gens(str(out))
    assert [w for _, w, _ in gens] == [2, 1]
    assert last["end"] == 24 and last["comm_health"]
    ref, _ = _reference(tmp_path, gens)
    assert last["weights"] == ref["weights"]


def test_zero_budget_fails_loudly_with_the_bundle(tmp_path):
    proc, summary, out = _supervised(
        tmp_path, {"0": {"kind": "kill", "rank": 1, "offset": 2}},
        recovery=3600, extra={"MXTPU_SUPERVISE_MAX_RESTARTS": "0"})
    assert proc.returncode == 1
    assert summary["ok"] is False and summary["restarts"] == 0
    files = os.listdir(summary["forensics"])
    assert {"events.json", "MANIFEST.txt"} <= set(files)
