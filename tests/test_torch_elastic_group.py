"""The group half of the port's elastic training and the cross-rank
planes, against the JAX package's.

- ``parallel/elastic.py``: ``check_restore`` under ``MXTPU_ELASTIC=on``,
  ``reform_group`` / ``begin_resize`` of a simulated world and
  ``reset_comm_state`` give the JAX functions' results and effects;
  ``world_for_fingerprint`` reads the same world.
- A real world change on gloo ranks (``tests/dist/torch_fleet_worker.py``
  through plain launches): 2 ranks to step 4 (``resize@4:1``), 1 rank to
  step 12 (``resize@12:2``), 2 ranks to the end. Each resumed generation
  re-forms its group (``FitResult.elastic``: the worlds and the roster),
  its data position re-splits exactly (the global batch is 8 at every
  world), and without ``MXTPU_ELASTIC=on`` the world change is refused
  before any state loads. The final weights equal a run that never
  resized at world 2 within 1e-6 (f32: the two worlds' gradients sum in
  different orders; the world-1 segment's learning rate normalisation is
  the global batch's, so the trajectories are the same function).
- The numerics plane under a distributed ZeRO plane
  (``tests/dist/torch_planes_worker.py``): the shards' stats merge over
  the group, so both ranks publish the same records and name the same
  culprit of a ``nan_grad`` step, and the records equal a one-process
  run's on the same global batch (non-finite counts exactly, the sums and
  maxima within 1e-6 relative); every rank's run report carries
  ``world_size`` 2 and the JAX package's report keys.
"""
import json
import os
import sys

import numpy as np
import pytest

from mxnet_tpu.parallel import elastic as jel
from mxnet_tpu.telemetry import collective as jcoll

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.parallel import elastic as tel
from mxnet_tpu_torch.telemetry import collective as tcoll

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_common import launch, worker  # noqa: E402


def _cur(world, distributed=False):
    return {"world": world, "rank": 0, "distributed": distributed,
            "num_parts": world, "part_index": 0, "batch_size": 4}


def test_check_restore_elastic_on_matches_jax(monkeypatch):
    monkeypatch.setenv("MXTPU_ELASTIC", "on")
    for topo in ({"world": 2}, {"world": 1}, None):
        assert tel.check_restore(topo, _cur(1)) == \
            jel.check_restore(topo, _cur(1))
    assert tel.check_restore({"world": 2}, _cur(1)) is True
    with pytest.raises(tel.TopologyMismatchError, match="NON-portable"):
        tel.check_restore({"world": 2, "portable_states": False}, _cur(1))


def test_reform_and_begin_resize_simulated_match_jax():
    topo = {"world": 4, "resize_to": 2}
    for el in (tel, jel):
        assert el.reform_group(_cur(2)) == {"reformed": True,
                                            "members": [0, 1]}
    from mxnet_tpu_torch.telemetry import default_registry
    c = default_registry().counter("mxtpu_elastic_resizes_total", "")
    before = c.value
    got = tel.begin_resize(topo, _cur(2))
    assert got == jel.begin_resize(topo, _cur(2))
    assert got["from_world"] == 4 and got["resize_to"] == 2
    assert c.value == before + 1


def test_reset_comm_state_matches_jax():
    from mxnet_tpu.telemetry.tracer import tracer as jtr
    from mxnet_tpu_torch.telemetry.tracer import tracer as ttr
    for coll, tr, el in ((tcoll, ttr, tel), (jcoll, jtr, jel)):
        coll.ledger.clock_offset_ms = 12.5
        tr.clock_offset_ms = 12.5
        coll.health_check(None)
        assert coll.health_summary()["checks"] == 1
        el.reset_comm_state()
        assert coll.ledger.clock_offset_ms == 0.0
        assert tr.clock_offset_ms == 0.0
        assert coll.health_summary()["checks"] == 0


@pytest.mark.parametrize("zero_world", [None, "3"])
def test_world_for_fingerprint_matches_jax(zero_world, monkeypatch):
    if zero_world:
        monkeypatch.setenv("MXTPU_ZERO_WORLD", zero_world)
    else:
        monkeypatch.delenv("MXTPU_ZERO_WORLD", raising=False)
    assert tel.world_for_fingerprint() == jel.world_for_fingerprint()


# ---------------------------------------------------------------------
# a real world change
# ---------------------------------------------------------------------

def _segment(out, n, stop=None, elastic=True, extra=None):
    env = {"FLEET_OUT_DIR": str(out), "FLEET_TARGET": str(n),
           "MXTPU_MEM_DUMP_DIR": str(out / "dumps")}
    if elastic:
        env["MXTPU_ELASTIC"] = "on"
    if stop:
        env["FLEET_STOP"] = stop
    env.update(extra or {})
    return launch(n, worker("torch_fleet_worker.py"), extra_env=env,
                  timeout=240)


def _rec(out, gen=0):
    return json.load(open(out / f"gen{gen}_r0.json"))


def test_two_one_two_resize_reforms_and_resplits(tmp_path):
    out = tmp_path / "rz"
    out.mkdir()
    assert _segment(out, 2, stop="4:1", elastic=False).returncode == 75
    # the world change is refused without MXTPU_ELASTIC=on
    bad = _segment(out, 1, stop="12:2", elastic=False)
    assert bad.returncode != 0 and "MXTPU_ELASTIC=on" in bad.stderr
    assert _segment(out, 1, stop="12:2").returncode == 75
    mid = _rec(out)
    assert mid["world"] == 1 and mid["start"] == 4
    last = _segment(out, 2)
    assert last.returncode == 0, last.stderr[-3000:]
    end = _rec(out)
    assert end["end"] == 24 and end["start"] == 12
    assert end["elastic"] == {"from_world": 1, "world": 2, "rank": 0,
                              "members": [0, 1], "resize_to": 2}
    # never resized, at world 2
    ref = tmp_path / "ref"
    ref.mkdir()
    assert _segment(ref, 2, elastic=False).returncode == 0
    want = _rec(ref)["weights"]
    for k, w in want.items():
        np.testing.assert_allclose(end["weights"][k], w, rtol=1e-6,
                                   atol=1e-7)


def _planes(tmp_path, name, n, env):
    out = tmp_path / name
    out.mkdir()
    env = dict(env, MXTPU_MEM_DUMP_DIR=str(out / "dumps"))
    proc = launch(n, worker("torch_planes_worker.py") + [str(out)],
                  extra_env=env, timeout=180)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return [json.load(open(out / f"planes_r{r}.json")) for r in range(n)]


def test_numerics_merge_under_distributed_zero_and_run_report(tmp_path):
    flags = {"MXTPU_NUMERICS": "on,every=1", "MXTPU_CHAOS": "nan_grad@2"}
    two = _planes(tmp_path, "two", 2,
                  dict(flags, MXTPU_ZERO="1",
                       MXTPU_RUN_REPORT_DIR=str(tmp_path / "reports")))
    one = _planes(tmp_path, "one", 1, flags)[0]
    assert two[0]["zero"]["world"] == 2
    # one merged view on both ranks
    assert two[0]["numerics"]["recent"] == two[1]["numerics"]["recent"]
    assert two[0]["numerics"]["culprits"] == two[1]["numerics"]["culprits"]
    assert two[0]["numerics"]["culprits"] == one["numerics"]["culprits"]
    assert two[0]["skipped"] == one["skipped"] == [2]
    got, want = two[0]["numerics"]["recent"], one["numerics"]["recent"]
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, w in zip(got, want):
        assert g["nonfinite_params"] == w["nonfinite_params"]
        assert set(g["per_param"]) == set(w["per_param"])
        if not w["finite"]:
            continue
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"],
                                   rtol=1e-6)
        for name, st in w["per_param"].items():
            for k, v in st.items():
                np.testing.assert_allclose(g["per_param"][name][k], v,
                                           rtol=1e-6, atol=1e-9)
    # every rank's report, stamped with the group's world
    from mxnet_tpu.telemetry import run_report as jrr
    for r in two:
        rep = json.load(open(r["run_report"]))
        assert rep["fingerprint"]["world_size"] == 2
    jkeys = set(jrr.build_payload(type("R", (), {"step": 0})()))
    assert jkeys <= set(rep)
