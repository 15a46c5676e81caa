"""The port's environment-variable registry against the JAX package's.

``mxnet_tpu_torch.base.env`` copies ``mxnet_tpu.base.env``: the same
declarations (type, default) for the flags the port reads, and the same
``get`` semantics, where a bool is false only for "0", "false", "False"
and "". Both packages' ``_safe_acc`` then make the same upcast decision
for every spelling of ``MXNET_SAFE_ACCUMULATION``.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu import base as jbase
from mxnet_tpu.ops import reduce as jreduce

from mxnet_tpu_torch import base as tbase
from mxnet_tpu_torch.ops import reduce as treduce

PORTED = ("MXNET_SAFE_ACCUMULATION", "MXNET_RESID_DTYPE",
          "MXTPU_FUSED_EPILOGUE")
VALUES = ["on", "yes", "2", "1", "true", "0", "false", "False", "", None]


def _set(monkeypatch, name, value):
    if value is None:
        monkeypatch.delenv(name, raising=False)
    else:
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("value", VALUES)
@pytest.mark.parametrize("name", PORTED)
def test_get_matches_jax(monkeypatch, name, value):
    _set(monkeypatch, name, value)
    assert tbase.env.get(name) == jbase.env.get(name)
    assert tbase.env.raw(name) == jbase.env.raw(name) == value


@pytest.mark.parametrize("value", VALUES)
def test_safe_acc_upcast_decision_matches_jax(monkeypatch, value):
    """C3: "on", "yes" and "2" upcast in both packages."""
    import jax.numpy as jnp
    _set(monkeypatch, "MXNET_SAFE_ACCUMULATION", value)
    x = np.arange(6, dtype=np.float32)
    jx, back_j = jreduce._safe_acc(jnp.asarray(x).astype(jnp.bfloat16))
    tx, back_t = treduce._safe_acc(torch.from_numpy(x).to(torch.bfloat16))
    assert (back_j is None) == (back_t is None)
    assert (str(jx.dtype) == "float32") == (tx.dtype == torch.float32)
    assert (tx.dtype == torch.float32) == bool(
        tbase.env.get("MXNET_SAFE_ACCUMULATION"))


def test_declarations_match_jax():
    for name in PORTED:
        assert tbase.env.default_for(name) == jbase.env.default_for(name)
        assert tbase.env._defaults[name][0] is jbase.env._defaults[name][0]
    assert {n for n, *_ in tbase.env.items()} == set(PORTED)


def test_undeclared_names_read_raw(monkeypatch):
    monkeypatch.setenv("MXT_TEST_UNDECLARED", "abc")
    monkeypatch.delenv("MXT_TEST_UNSET", raising=False)
    assert tbase.env.get("MXT_TEST_UNDECLARED") == "abc"
    assert tbase.env.get("MXT_TEST_UNSET", 7) == 7
    assert tbase.env.default_for("MXT_TEST_UNSET") is None


def test_no_module_of_the_port_reads_os_environ():
    import pathlib
    pkg = pathlib.Path(tbase.__file__).parent
    readers = sorted(str(f.relative_to(pkg)) for f in pkg.rglob("*.py")
                     if f != pkg / "base.py"
                     and "os.environ" in f.read_text())
    assert readers == []
