"""The port's numerics plane (``MXTPU_NUMERICS``) against the JAX
package's, through ``FitLoop`` on the same nets, data and weights
(``torch_planes_common``): per-parameter statistics within rtol 2e-5 /
atol 1e-6 (f32; a gradient mean within 2e-5 of the gradient's abs-max
plus 1e-6, since its summands may cancel), non-finite counts exact, the
same culprit for ``nan_grad@3``, the same loss-scale timeline; with the
plane on the trajectory is bit for bit the plane-off one, composed and
under the megastep (eager on the CPU)."""
import json

import numpy as np
import pytest

import torch_planes_common as C

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.telemetry import numerics as tnum


@pytest.fixture(autouse=True)
def _agg(monkeypatch):
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    monkeypatch.delenv("MXTPU_MEGASTEP", raising=False)
    monkeypatch.delenv("MXTPU_EFFICIENCY", raising=False)


def _close(a, b, what):
    np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-6, err_msg=what)


def _compare_records(trec, jrec):
    assert [r["step"] for r in trec] == [r["step"] for r in jrec]
    for t, j in zip(trec, jrec):
        assert t["finite"] == j["finite"]
        assert t["nonfinite_params"] == j["nonfinite_params"]
        assert sorted(t["per_param"]) == sorted(j["per_param"])
        _close(t["grad_norm"], j["grad_norm"], "grad_norm")
        if j["update_ratio"] is None:
            assert t["update_ratio"] is None
        else:
            _close(t["update_ratio"], j["update_ratio"], "update_ratio")
        for name, js in j["per_param"].items():
            ts = t["per_param"][name]
            assert sorted(ts) == sorted(js), name
            for stat, v in js.items():
                what = f"step {t['step']} {name}:{stat}"
                if stat == "nonfinite":
                    assert ts[stat] == v, what
                elif stat == "mean" and "absmax" in js:
                    # a mean of summands that cancel (the last layer's
                    # bias under softmax cross-entropy sums to 0) is held
                    # relative to the summands' scale, its abs-max
                    np.testing.assert_allclose(
                        ts[stat], v, rtol=0,
                        atol=1e-6 + 2e-5 * abs(js["absmax"]), err_msg=what)
                else:
                    _close(ts[stat], v, what)


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_stats_culprit_and_timeline_match_jax(kind, monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_NUMERICS", "on,every=1")
    monkeypatch.setenv("MXTPU_MEM_DUMP_DIR", str(tmp_path))
    out = {pkg: C.fit(pkg, kind, epochs=1, plan="nan_grad@3",
                      loss_scale=128.0) for pkg in ("jax", "port")}
    tres, jres = out["port"][2], out["jax"][2]
    assert tres.skipped_steps == jres.skipped_steps == [3]
    tn, jn = tres.numerics, jres.numerics
    assert tn["enabled"] and tn["samples"] == jn["samples"] == 4
    _compare_records(tn["recent"], jn["recent"])
    assert tn["nonfinite_steps"] == jn["nonfinite_steps"] == [3]
    assert tn["culprits"] == jn["culprits"]
    assert tn["loss_scale_events"] == jn["loss_scale_events"] == [
        {"step": 3, "old": 128.0, "new": 64.0, "trigger": "backoff"}]
    dump = json.load(open(tn["dumps"][0]))
    assert dump["culprit"]["name"] == tn["culprits"][0]
    assert dump["culprit"]["nonfinite"] == dump["culprit"]["size"]
    jd = json.load(open(jn["dumps"][0]))
    assert dump["culprit"] == jd["culprit"]
    assert dump["bucket_nonfinite_counts"] == jd["bucket_nonfinite_counts"]


@pytest.mark.parametrize("mega", ["off", "on"])
@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_plane_on_is_bit_for_bit_plane_off(kind, mega, monkeypatch,
                                            tmp_path):
    monkeypatch.setenv("MXTPU_MEGASTEP", mega)
    monkeypatch.setenv("MXTPU_MEM_DUMP_DIR", str(tmp_path))
    off = C.fit("port", kind, plan="nan_grad@5", loss_scale=128.0)
    monkeypatch.setenv("MXTPU_NUMERICS", "on,every=2")
    on = C.fit("port", kind, plan="nan_grad@5", loss_scale=128.0)
    assert on[2].losses == off[2].losses
    assert on[2].skipped_steps == off[2].skipped_steps == [5]
    for k, w in C.weights(off[0]).items():
        assert np.array_equal(C.weights(on[0])[k], w), k
    for a, b in zip(C.state(on[1]), C.state(off[1])):
        assert np.array_equal(a, b)
    num = on[2].numerics
    assert [r["step"] for r in num["recent"]] == list(range(0, 8, 2))
    assert num["culprits"] and num["nonfinite_steps"] == [5]
    assert off[2].numerics["enabled"] is False


def test_megastep_stats_equal_composed(monkeypatch):
    monkeypatch.setenv("MXTPU_NUMERICS", "on,every=2")
    comp = C.fit("port", "conv")[2].numerics["recent"]
    monkeypatch.setenv("MXTPU_MEGASTEP", "on")
    mega = C.fit("port", "conv")[2].numerics["recent"]
    assert comp == mega


def test_per_parameter_fallback_matches_jax(monkeypatch):
    """Aggregation 0: the classic update path's stats (no update ratio)."""
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "0")
    monkeypatch.setenv("MXTPU_NUMERICS", "on,every=2,stats=l2|nonfinite")
    out = {pkg: C.fit(pkg, "mlp", epochs=1) for pkg in ("jax", "port")}
    trec = out["port"][2].numerics["recent"]
    _compare_records(trec, out["jax"][2].numerics["recent"])
    assert trec and all(r["update_ratio"] is None for r in trec)
    assert sorted(next(iter(trec[0]["per_param"].values()))) == [
        "l2", "nonfinite"]


def test_pattern_and_cadence_and_trainer(monkeypatch):
    monkeypatch.setenv("MXTPU_NUMERICS", "every=3,pattern=d1_.*")
    res = C.fit("port", "mlp", epochs=1)[2]
    recs = res.numerics["recent"]
    assert [r["step"] for r in recs] == [0, 3]
    assert [sorted(r["per_param"]) for r in recs] == \
        [["d1_bias", "d1_weight"]] * 2
    # gluon.Trainer accepts the flag; a bare loop samples on its own
    # clock and parks the matrices on the trainer
    tnum.reset_run()
    with mt.cpu():
        net = C.net("port", "mlp")
        tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1})
        x, y = C.data("mlp")
        with mt.autograd.record():
            loss = mt.gluon.loss.SoftmaxCrossEntropyLoss()(
                net(mt.nd.array(x[:8])), mt.nd.array(y[:8]))
        loss.backward()
        tr.step(8)
    names, mat = tr.last_numerics_stats[0]
    assert mat.shape == (len(names), 6) and mat.dtype.is_floating_point
    monkeypatch.setenv("MXTPU_NUMERICS", "on,every=0")
    with pytest.raises(MXNetError, match="every must be >= 1"):
        mt.gluon.Trainer(net.collect_params(), "sgd")
