"""The port's distributed kvstore (``mx.kv.create("dist_sync")``) against
the JAX package, on gloo ranks on the host started by the port's launcher
(``python -m mxnet_tpu_torch.launch``), every port taken free.

- ``tests/dist/torch_kvstore_worker.py`` at 2 and 3 ranks: push / pull
  sums, rank 0's init, 2-bit wire compression, the ZeRO plane's
  collectives; and the remote profiler commands over the command channel.
- ``tests/dist/torch_train_worker.py`` at 2 ranks: ``gluon.Trainer`` over
  the dist store with one flat bucket and with one key a gradient (SGD
  momentum, Adam) and with 2-bit compression, held to the JAX Trainer on
  the summed gradients (the compressed run through the JAX compressor)
  at 1e-6 rtol / 1e-7 atol, and both ranks' weights bit for bit alike.
- The flat-bucket layout and keys against the JAX Trainer's, and 2-bit
  compression on a one-worker store against the JAX store's.
- The launcher: fail fast, the drain code passed through, the modes that
  are not ported.
"""
import os
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import kvstore as jkv

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import kvstore as tkv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests", "dist"))
sys.path.insert(0, os.path.join(ROOT, "tests"))
import torch_train_worker as W  # noqa: E402
from torch_dist_common import launch, worker as _worker  # noqa: E402

CPU = mt.cpu()
TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n", [2, 3])
def test_dist_sync_kvstore_multiprocess(n):
    proc = launch(n, _worker("torch_kvstore_worker.py") + ["kvstore"])
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    for r in range(n):
        assert f"worker {r}/{n}: kvstore checks passed" in out, out[-3000:]


def test_remote_profiler_commands(tmp_path):
    proc = launch(2, _worker("torch_kvstore_worker.py") +
                  ["profiler", str(tmp_path)])
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    for r in range(2):
        assert f"worker {r}/2: profiler checks passed" in out, out[-3000:]
    assert (tmp_path / "remote_prof.json").exists()


# ------------------------------------------------ training on a real group

MODES = ["buckets:sgd", "buckets:adam", "perkey:sgd", "perkey:adam",
         "compress:sgd"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist_train")
    proc = launch(2, _worker("torch_train_worker.py") + [str(out)] + MODES)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    return out


def _jax_params(np_weights):
    ps = []
    for j, w in enumerate(np_weights):
        p = jgluon.Parameter(f"p{j}", shape=w.shape)
        p.initialize(mx.init.Constant(0.0))
        p.set_data(mx.nd.array(w))
        ps.append(p)
    return ps


def _jax_set_grads(ps, gs):
    for p, g in zip(ps, gs):
        p._grad._rebind(mx.nd.array(g)._data)
        p._fresh_grad = True


def jax_reference(opt, compress=False, world=0, monkeypatch=None):
    """The JAX Trainer on the two ranks' gradients summed g0 + g1 (each
    rank's 2-bit round trip first when ``compress``); ``world`` > 0: a
    simulated ZeRO world."""
    if monkeypatch is not None:
        if world:
            monkeypatch.setenv("MXTPU_ZERO", "1")
            monkeypatch.setenv("MXTPU_ZERO_WORLD", str(world))
        else:
            monkeypatch.delenv("MXTPU_ZERO", raising=False)
            monkeypatch.delenv("MXTPU_ZERO_WORLD", raising=False)
    from mxnet_tpu.gradient_compression import GradientCompression
    ps = _jax_params(W.init_weights())
    tr = jgluon.Trainer(ps, opt, dict(W.OPTS[opt]),
                        kvstore=jkv.create("local"))
    comps = [GradientCompression("2bit", 0.5) for _ in range(2)]
    for step in range(W.STEPS):
        per = [W.grads(step, r) for r in range(2)]
        if compress:
            per = [[np.asarray(comps[r].roundtrip(i, mx.nd.array(g)._data))
                    for i, g in enumerate(per[r])] for r in range(2)]
        _jax_set_grads(ps, [a + b for a, b in zip(*per)])
        tr.step(4)
    return [p.data().asnumpy() for p in ps], tr


def load(out, tag):
    zs = [np.load(out / f"{tag}_r{r}.npz") for r in range(2)]
    k = len([f for f in zs[0].files if f.startswith("w")])
    ws = [[z[f"w{j}"] for j in range(k)] for z in zs]
    for a, b in zip(*ws):
        np.testing.assert_array_equal(a, b)    # both ranks alike
    return ws[0], zs[0]


@pytest.mark.parametrize("tag", MODES)
def test_dist_trainer_matches_jax_on_summed_grads(trained, tag, monkeypatch):
    mode, opt = tag.split(":")
    got, z = load(trained, tag)
    want, _ = jax_reference(opt, compress=(mode == "compress"),
                            monkeypatch=monkeypatch)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    allgather, allreduce, reduce_scatter = z["counts"].tolist()
    assert allreduce == (6 if mode == "perkey" else 1)
    assert reduce_scatter == allgather == 0


# ------------------------------------------------ one process

def test_create_types_and_profiler_handle():
    from mxnet_tpu_torch import profiler
    for name in ["dist_sync", "dist_tpu_sync", "dist_async", "dist",
                 "dist_device_sync", "dist_sync_device"]:
        kv = tkv.create(name)
        assert isinstance(kv, tkv.KVStoreDistTPU)
        assert kv.type == "dist_tpu_sync" == jkv.create(name).type
        assert (kv.rank, kv.num_workers) == (0, 1)
        assert profiler._kvstore is kv
    # one worker: push / pull are the local store's
    kv = tkv.create("dist_sync")
    kv.init("k", mt.nd.array(np.ones((2, 2), np.float32), ctx=CPU))
    kv.push("k", [mt.nd.array(np.full((2, 2), v, np.float32), ctx=CPU)
                  for v in (1.0, 2.0)])
    o = mt.nd.zeros((2, 2), ctx=CPU)
    kv.pull("k", out=o)
    np.testing.assert_array_equal(o.asnumpy(), np.full((2, 2), 3.0))
    # profile_process='server' over a one-worker store runs here
    kv.send_profiler_command("state", "stop")


def test_one_worker_compression_matches_jax():
    """A one-worker store quantizes in place of the wire, with the
    residual carried to the next push, as the JAX store does."""
    rs = np.random.RandomState(0)
    t = tkv.create("local")
    j = jkv.create("local")
    for kv in (t, j):
        kv.set_gradient_compression({"type": "2bit", "threshold": 0.3})
    shape = (4, 9)
    t.init(0, mt.nd.array(np.zeros(shape, np.float32), ctx=CPU))
    j.init(0, mx.nd.zeros(shape))
    for _ in range(4):
        g = (0.4 * rs.randn(*shape)).astype(np.float32)
        t.push(0, mt.nd.array(g, ctx=CPU))
        j.push(0, mx.nd.array(g))
        ot, oj = mt.nd.zeros(shape, ctx=CPU), mx.nd.zeros(shape)
        t.pull(0, out=ot)
        j.pull(0, out=oj)
        np.testing.assert_array_equal(ot.asnumpy(), oj.asnumpy())
    np.testing.assert_array_equal(t._compressor._residuals[0].numpy(),
                                  np.asarray(j._compressor._residuals[0]))


@pytest.mark.parametrize("bucket_mb,dtypes", [
    (25.0, ["float32"] * 7),
    (0.0001, ["float32"] * 7),
    (0.00005, ["float32", "float32", "float16", "float16", "float32",
               "float32", "float32"]),
])
def test_bucket_layout_matches_jax(bucket_mb, dtypes):
    """The flat buckets and their ``_gbkt*`` keys are the JAX Trainer's:
    the same runs of one dtype in parameter order under the cap."""
    shapes = [(3, 4), (5,), (2, 2, 3), (7, 1), (8, 8), (1,), (4, 6)]
    tp, jp = [], []
    for j, (s, dt) in enumerate(zip(shapes, dtypes)):
        a = mt.gluon.Parameter(f"q{j}", shape=s, dtype=dt)
        a.initialize(mt.init.Constant(0.0), ctx=CPU)
        b = jgluon.Parameter(f"q{j}", shape=s, dtype=dt)
        b.initialize(mx.init.Constant(0.0))
        tp.append(a)
        jp.append(b)
    ttr = mt.gluon.Trainer(tp, "sgd", {"learning_rate": 0.1}, kvstore=None)
    jtr = jgluon.Trainer(jp, "sgd", {"learning_rate": 0.1}, kvstore=None)
    tb = ttr._grad_buckets([(i, p.grad()) for i, p in enumerate(tp)],
                           bucket_mb)
    jb = jtr._grad_buckets([(i, p.grad()) for i, p in enumerate(jp)],
                           bucket_mb)
    assert [[i for i, _ in b] for b in tb] == [[i for i, _ in b]
                                               for b in jb]
    assert [ttr._bucket_sig_key(k, b)[1] for k, b in enumerate(tb)] == \
        [jtr._bucket_sig_key(k, b)[1] for k, b in enumerate(jb)]


def test_bucketed_local_store_matches_jax(monkeypatch):
    """A store object (kept on one worker) under several bucket caps:
    one push / pull a bucket, the gradients back in place, the trajectory
    the JAX Trainer's."""
    for mb in ("25", "0.00002", "0"):
        monkeypatch.setenv("MXTPU_GRAD_BUCKET_MB", mb)
        ws = W.init_weights()
        tp = []
        for j, w in enumerate(ws):
            p = mt.gluon.Parameter(f"p{j}", shape=w.shape)
            p.initialize(mt.init.Constant(0.0), ctx=CPU)
            p.set_data(w)
            tp.append(p)
        ttr = mt.gluon.Trainer(tp, "sgd", dict(W.OPTS["sgd"]),
                               kvstore=tkv.create("local"))
        jp = _jax_params(ws)
        jtr = jgluon.Trainer(jp, "sgd", dict(W.OPTS["sgd"]),
                             kvstore=jkv.create("local"))
        for step in range(W.STEPS):
            gs = W.grads(step, 0)
            for p, g in zip(tp, gs):
                p.grad()._data.copy_(torch.from_numpy(g))
                p._fresh_grad = True
            ptrs = [p.grad()._data.data_ptr() for p in tp]
            _jax_set_grads(jp, gs)
            ttr.step(4)
            jtr.step(4)
            assert ttr.last_allreduce_collectives == \
                jtr.last_allreduce_collectives
            assert [p.grad()._data.data_ptr() for p in tp] == ptrs
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.data().asnumpy(),
                                       b.data().asnumpy(), **TOL)


# ------------------------------------------------ the launcher

def _py(code):
    return [sys.executable, "-c", code]


def test_launcher_fails_fast():
    """A worker that dies fatally terminates the others at once; the
    group exits with its code."""
    code = ("import os, sys, time\n"
            "r = int(os.environ['MXTPU_WORKER_ID'])\n"
            "assert os.environ['DMLC_RANK'] == str(r)\n"
            "assert os.environ['MXTPU_NUM_WORKERS'] == "
            "os.environ['DMLC_NUM_WORKER'] == '3'\n"
            "assert os.environ['MXTPU_CMD_TOKEN']\n"
            "sys.exit(3) if r == 1 else time.sleep(60)\n")
    import time
    t = time.monotonic()
    proc = launch(3, _py(code), timeout=120)
    assert proc.returncode == 3, proc.stderr[-2000:]
    assert time.monotonic() - t < 40
    assert "worker 1 exited with 3 (fatal): group terminated" in proc.stderr


def test_launcher_passes_the_drain_code_through(tmp_path):
    """A worker that exits with the drain code (75) leaves its peers to
    finish; the group's exit code reports the drain."""
    code = ("import os, sys, time\n"
            "r = int(os.environ['MXTPU_WORKER_ID'])\n"
            "if r == 0:\n"
            "    sys.exit(75)\n"
            "time.sleep(1.0)\n"
            f"open(os.path.join({str(tmp_path)!r}, 'peer%d' % r), 'w')"
            ".write('finished')\n")
    proc = launch(3, _py(code), timeout=120)
    assert proc.returncode == 75, proc.stderr[-2000:]
    assert sorted(os.listdir(tmp_path)) == ["peer1", "peer2"]
    assert "graceful drain" in proc.stderr
    proc = launch(2, _py("import sys; sys.exit(0)"), timeout=120)
    assert proc.returncode == 0


@pytest.mark.parametrize("flags", [["--launcher", "ssh"],
                                   ["--launcher", "mpi"], ["--supervise"]])
def test_launcher_modes_not_ported(flags, tmp_path, monkeypatch):
    """The remote and supervised modes are ported (the name and the cases
    are kept from when they raised naming A10): ``ssh`` through a stub
    that runs the remote command locally, ``supervise`` a fleet whose
    workers exit 0 at once, both return 0; ``mpi`` without an MPI
    runtime returns 127 (a stub ``mpirun`` is tested in
    ``test_torch_launch_remote.py``)."""
    import shutil
    from mxnet_tpu_torch import launch as tlaunch
    if flags[-1] == "ssh":
        stub = tmp_path / "fake_ssh"
        stub.write_text("#!/bin/sh\nshift\nexec sh -c \"$@\"\n")
        stub.chmod(0o755)
        flags = flags + ["--ssh-cmd", str(stub)]
    if flags[-1] == "mpi" and (shutil.which("mpirun") or
                               shutil.which("mpiexec")):
        pytest.skip("an MPI runtime is installed here")
    monkeypatch.setenv("MXTPU_MEM_DUMP_DIR", str(tmp_path))
    rc = tlaunch.main(["-n", "2"] + flags + ["true"])
    assert rc == (127 if flags[-1] == "mpi" else 0)


def test_launcher_manual_prints_the_jax_launchers_environment(
        capsys, monkeypatch):
    """``--launcher manual`` prints each rank's variables: the JAX
    launcher's names and values (and the reference's DMLC_PS_ROOT_PORT
    beside them)."""
    import argparse
    import importlib.util
    from mxnet_tpu_torch import launch as tlaunch
    spec = importlib.util.spec_from_file_location(
        "jax_launch", os.path.join(ROOT, "tools", "launch.py"))
    jl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jl)
    monkeypatch.setenv("MXTPU_CMD_TOKEN", "job")   # main() keeps it
    assert tlaunch.main(["-n", "3", "--launcher", "manual",
                         "--coordinator", "10.0.0.1:1234", "run"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 3
    for r, line in enumerate(lines):
        got = dict(kv.split("=", 1) for kv in line.split()[2:-1])
        want = jl._worker_env(argparse.Namespace(
            coordinator="10.0.0.1:1234", num_workers=3), r)
        assert got.pop("DMLC_PS_ROOT_PORT") == "1234"
        assert got == want
        assert line.startswith(f"[host {r}] ") and line.endswith(" run")
