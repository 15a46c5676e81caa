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
          "MXTPU_FUSED_EPILOGUE", "MXNET_CONV_COMPUTE")
# gluon.Trainer's flags, with values of their types
TRAINER_FLAGS = {"MXTPU_OPTIMIZER_AGGREGATION": ["0", "1", "4", "64", None],
                 "MXTPU_GRAD_BUCKET_MB": ["0", "0.0001", "25", None],
                 "MXTPU_COMM_OVERLAP": ["on", "off", "", None],
                 "MXTPU_MEGASTEP": ["on", "off", "", None],
                 "MXTPU_ZERO": ["on", "off", "1", None],
                 "MXTPU_NUMERICS": ["on,every=2", "off", "", None]}
# the FitLoop path's flags (fit, fault, chaos, kvstore retry, telemetry,
# elastic, the comm planes, the supervisor), with values of their types
FIT_FLAGS = {"MXNET_IS_RECOVERY": ["1", "0", "False", "", None],
             "DMLC_RANK": ["0", "3", None],
             "MXTPU_WORKER_ID": ["0", "2", None],
             "MXTPU_CHAOS": ["kill@3", "", None],
             "MXTPU_CHAOS_SEED": ["0", "11", None],
             "MXNET_KV_RETRY_MAX": ["0", "5", None],
             "MXNET_KV_RETRY_BASE_MS": ["0.5", "50", None],
             "MXTPU_RESUMABLE_EXIT_CODE": ["75", "3", None],
             "MXTPU_PROFILE": ["on,ring=8", "off", None],
             "MXTPU_PROFILE_BOUND_FRAC": ["0", "0.4", None],
             "MXTPU_MEM_BUDGET": ["0", "1048576", None],
             "MXTPU_MEM_DUMP_DIR": ["dumps", "", None],
             "MXTPU_EFFICIENCY": ["on", "off", "", None],
             "MXTPU_AUTOTUNE": ["on", "off", None],
             "MXTPU_RUN_REPORT_DIR": ["reports", "", None],
             "MXTPU_COLL_HEALTH": ["0", "4", None],
             "MXTPU_COLL_TIMEOUT_S": ["0", "2.5", None],
             "MXTPU_COLL_RING": ["4096", "8", None],
             "MXTPU_SUPERVISE_MAX_RESTARTS": ["8", "0", None],
             "MXTPU_SUPERVISE_CRASH_WINDOW_S": ["300", "2.5", None],
             "MXTPU_SUPERVISE_CRASH_LIMIT": ["3", "1", None],
             "MXTPU_ZERO_WORLD": ["0", "2", None],
             "MXTPU_ELASTIC": ["on", "off", None]}
# the distributed group, the launcher and the command channel
# (kvstore_server, launch, parallel/collectives)
DIST_FLAGS = {"MXTPU_COORDINATOR": ["127.0.0.1:29500", "", None],
              "MXTPU_NUM_WORKERS": ["1", "4", None],
              "MXTPU_WORKER_HOSTS": ["h0,h1", "", None],
              "MXTPU_CMD_PORT_BASE": ["0", "23000", None],
              "MXTPU_CMD_TOKEN": ["abc", "", None],
              "MXTPU_COORD_TIMEOUT_MS": ["120000", "5", None],
              "DMLC_ROLE": ["worker", "server", None]}
# the megastep's signature cache (cached_op.SignatureLRU)
MEGASTEP_FLAGS = {"MXTPU_CACHEDOP_CACHE_SIZE": ["0", "8", "256", None]}
# CachedOp's bulk-exec bypass and the serving core
SERVING_FLAGS = {"MXNET_EXEC_BULK_EXEC_INFERENCE": ["0", "1", "", None],
                 "MXNET_EXEC_BULK_EXEC_TRAIN": ["0", "false", "1", None],
                 "MXTPU_SERVE_MAX_BATCH": ["1", "32", None],
                 "MXTPU_SERVE_MAX_LATENCY_MS": ["0.5", "5", None],
                 "MXTPU_SERVE_QUEUE_DEPTH": ["1", "256", None],
                 "MXTPU_SERVE_REPLAY": ["replay.jsonl", "", None],
                 "MXTPU_SERVE_REGISTRY": ["registry", "", None],
                 "MXTPU_COMPILE_CACHE": ["cache", "off", "", None],
                 "MXTPU_FLEET_MIN": ["1", "3", None],
                 "MXTPU_FLEET_MAX": ["4", "8", None],
                 "MXTPU_FLEET_TARGET_QUEUE": ["16", "2", None],
                 "MXTPU_FLEET_HEARTBEAT_MS": ["200", "50.5", None]}
# backward rematerialisation (util.mirror_wrapper)
MIRROR_FLAGS = {"MXNET_BACKWARD_DO_MIRROR": ["1", "0", "true", "", None],
                "MXNET_BACKWARD_MIRROR_POLICY": ["full", "dots", "convs",
                                                 "", None]}
# mx.random.np_rng's reproducibility guard
RANDOM_FLAGS = {"MXNET_ENFORCE_DETERMINISM": ["1", "0", "true", "", None]}
# base.data_dir, the vision datasets' default root
DATA_FLAGS = {"MXNET_HOME": ["/data/mxnet", "", None]}
# sparse storage and the embedding plane (read strictly where they are
# used: parallel/embedding_plane.py)
SPARSE_FLAGS = {"MXNET_STORAGE_FALLBACK_LOG_VERBOSE": ["0", "1", "", None],
                "MXTPU_SPARSE_PLANE": ["on", "off", "", None],
                "MXTPU_SPARSE_MAX_ROWS": ["1", "16384", None]}
# int8 training convolutions (ops/resid8.py conv_int8_train)
QUANT_FLAGS = {"MXNET_CONV_INT8_RANGE": ["8", "2.5", "16.0", None]}
# Module.update through a kvstore (module/module.py)
MODULE_FLAGS = {"MXNET_UPDATE_ON_KVSTORE": ["1", "0", "false", "", None]}
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
    for name in PORTED + tuple(TRAINER_FLAGS) + tuple(FIT_FLAGS) + \
            tuple(MEGASTEP_FLAGS) + tuple(MIRROR_FLAGS) + \
            tuple(RANDOM_FLAGS) + tuple(DATA_FLAGS) + tuple(SERVING_FLAGS) + \
            tuple(DIST_FLAGS) + tuple(SPARSE_FLAGS) + tuple(QUANT_FLAGS) + \
            tuple(MODULE_FLAGS):
        assert tbase.env.default_for(name) == jbase.env.default_for(name)
        assert tbase.env._defaults[name][0] is jbase.env._defaults[name][0]
    assert {n for n, *_ in tbase.env.items()} == \
        set(PORTED) | set(TRAINER_FLAGS) | set(FIT_FLAGS) | \
        set(MEGASTEP_FLAGS) | set(MIRROR_FLAGS) | set(RANDOM_FLAGS) | \
        set(DATA_FLAGS) | set(SERVING_FLAGS) | set(DIST_FLAGS) | \
        set(SPARSE_FLAGS) | set(QUANT_FLAGS) | set(MODULE_FLAGS)


@pytest.mark.parametrize("name,value", [
    (n, v) for n, vs in SPARSE_FLAGS.items() for v in vs])
def test_sparse_flag_get_matches_jax(monkeypatch, name, value):
    _set(monkeypatch, name, value)
    assert tbase.env.get(name) == jbase.env.get(name)


@pytest.mark.parametrize("name,value", [
    (n, v) for n, vs in {**QUANT_FLAGS, **MODULE_FLAGS}.items()
    for v in vs])
def test_quant_flag_get_matches_jax(monkeypatch, name, value):
    _set(monkeypatch, name, value)
    assert tbase.env.get(name) == jbase.env.get(name)


@pytest.mark.parametrize("name,value", [
    (n, v) for n, vs in RANDOM_FLAGS.items() for v in vs])
def test_random_flag_get_matches_jax(monkeypatch, name, value):
    _set(monkeypatch, name, value)
    assert tbase.env.get(name) == jbase.env.get(name)


@pytest.mark.parametrize("name,value", [
    (n, v) for n, vs in DATA_FLAGS.items() for v in vs])
def test_data_flag_get_and_data_dir_match_jax(monkeypatch, name, value):
    _set(monkeypatch, name, value)
    assert tbase.env.get(name) == jbase.env.get(name)
    assert tbase.data_dir() == jbase.data_dir()


@pytest.mark.parametrize("name,value", [
    (n, v) for n, vs in MIRROR_FLAGS.items() for v in vs])
def test_mirror_flag_get_matches_jax(monkeypatch, name, value):
    _set(monkeypatch, name, value)
    assert tbase.env.get(name) == jbase.env.get(name)


@pytest.mark.parametrize("name,value", [
    (n, v) for n, vs in MEGASTEP_FLAGS.items() for v in vs])
def test_megastep_flag_get_matches_jax(monkeypatch, name, value):
    _set(monkeypatch, name, value)
    assert tbase.env.get(name) == jbase.env.get(name)


@pytest.mark.parametrize("name,value", [
    (n, v) for n, vs in SERVING_FLAGS.items() for v in vs])
def test_serving_flag_get_matches_jax(monkeypatch, name, value):
    _set(monkeypatch, name, value)
    assert tbase.env.get(name) == jbase.env.get(name)


@pytest.mark.parametrize("name,value", [
    (n, v) for n, vs in TRAINER_FLAGS.items() for v in vs])
def test_trainer_flag_get_matches_jax(monkeypatch, name, value):
    _set(monkeypatch, name, value)
    assert tbase.env.get(name) == jbase.env.get(name)


@pytest.mark.parametrize("name,value", [
    (n, v) for n, vs in FIT_FLAGS.items() for v in vs])
def test_fit_flag_get_matches_jax(monkeypatch, name, value):
    _set(monkeypatch, name, value)
    assert tbase.env.get(name) == jbase.env.get(name)


@pytest.mark.parametrize("name,value", [
    (n, v) for n, vs in DIST_FLAGS.items() for v in vs])
def test_dist_flag_get_matches_jax(monkeypatch, name, value):
    _set(monkeypatch, name, value)
    assert tbase.env.get(name) == jbase.env.get(name)


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
