"""The port's run report (``MXTPU_RUN_REPORT_DIR``) against the JAX
package's: the payload's keys are the JAX package's apart from the
identity block, the directory's manifest verifies, and
``tools/run_compare.py`` (unchanged) diffs two port reports and a JAX
report beside a port report."""
import json
import os
import subprocess
import sys

import pytest

import torch_planes_common as C

from mxnet_tpu.telemetry import run_report as jrr

from mxnet_tpu_torch import fault as tfault
from mxnet_tpu_torch.ops.registry import NotPortedError
from mxnet_tpu_torch.telemetry import run_report as trr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# wall time on a shared host is noise: the diffs below are held to the
# trajectory, the counts and the file format, not to timings
FENCE = "1000"


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    monkeypatch.setenv("MXTPU_NUMERICS", "on,every=2")
    monkeypatch.setenv("MXTPU_EFFICIENCY", "on")
    monkeypatch.setenv("MXTPU_MEM_DUMP_DIR", str(tmp_path / "dumps"))
    monkeypatch.delenv("MXTPU_MEGASTEP", raising=False)


def _keys(d, depth=2):
    if not isinstance(d, dict) or depth == 0:
        return None
    return {k: _keys(v, depth - 1) for k, v in d.items()}


def _compare(a, b, *extra):
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "run_compare.py"),
         a, b, "--fence", FENCE, *extra], capture_output=True, text=True)


def _report(pkg, rdir, monkeypatch, **kw):
    monkeypatch.setenv("MXTPU_RUN_REPORT_DIR", str(rdir))
    return C.fit(pkg, "mlp", hybridize=True, plan="nan_grad@3",
                 loss_scale=128.0, **kw)[2].run_report


def test_payload_keys_are_jaxs_and_the_manifest_verifies(tmp_path,
                                                         monkeypatch):
    paths = {pkg: _report(pkg, tmp_path / pkg, monkeypatch)
             for pkg in ("jax", "port")}
    t = trr.load_run_report(paths["port"])
    j = jrr.load_run_report(paths["jax"])
    tk, jk = _keys(t), _keys(j)
    tfp, jfp = tk.pop("fingerprint"), jk.pop("fingerprint")
    assert tk == jk
    assert tfp.keys() - {"torch"} == jfp.keys() - {"jax"}
    assert t["fingerprint"]["torch"] and "jax" not in t["fingerprint"]
    assert t["fingerprint"]["backend"] == "cpu"
    assert t["fingerprint"]["world_size"] == 1
    assert t["fingerprint"]["env_overrides"]["MXTPU_NUMERICS"] == \
        "on,every=2"
    assert "MXTPU_RUN_REPORT_DIR" not in t["fingerprint"]["env_overrides"]
    assert t["format"] == trr.REPORT_FORMAT == jrr.REPORT_FORMAT
    assert t["run"] == dict(j["run"])
    assert t["loss"]["n"] == 8 and t["numerics"]["nonfinite_steps"] == 1
    assert "recent" not in t["efficiency"]
    tfault.verify_manifest(str(tmp_path / "port"), required=True)
    # the JAX package's verifier reads the port's manifest too
    from mxnet_tpu import fault as jfault
    jfault.verify_manifest(str(tmp_path / "port"), required=True)


def test_run_compare_on_port_reports_and_beside_a_jax_report(
        tmp_path, monkeypatch):
    a = _report("port", tmp_path / "r", monkeypatch)
    b = _report("port", tmp_path / "r", monkeypatch)
    assert a != b
    ra, rb = trr.load_run_report(a), trr.load_run_report(b)
    assert ra["loss"]["sha256_16"] == rb["loss"]["sha256_16"]
    out = _compare(a, b)
    assert out.returncode == 0, out.stdout + out.stderr
    res = json.loads(_compare(a, b, "--json").stdout)
    assert res["verdict"] == "ok" and res["fingerprint_diff"] == []
    assert res["topology_diff"] is None
    j = _report("jax", tmp_path / "j", monkeypatch)
    out = _compare(j, a, "--json")
    assert out.returncode in (0, 1), out.stderr
    res = json.loads(out.stdout)
    got = {r["metric"]: r for r in res["metrics"]}
    assert got["skipped_steps"]["verdict"] == "ok"
    assert got["nonfinite_steps"]["verdict"] == "ok"
    assert got["loss_last"]["baseline"] == pytest.approx(
        got["loss_last"]["candidate"], rel=1e-4)


def test_serving_report_is_a12(tmp_path):
    with pytest.raises(NotPortedError, match="A12"):
        trr.write_serving_report({}, directory=str(tmp_path))
    with pytest.raises(NotPortedError, match="A12"):
        trr.build_serving_payload({})
    with pytest.raises(ValueError, match="no directory"):
        trr.write_run_report(object())
