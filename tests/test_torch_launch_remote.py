"""The port's launcher's remote modes (``python -m mxnet_tpu_torch.launch
--launcher ssh | mpi``) against the JAX package's ``tools/launch.py``.

The card's machine has neither ssh nor MPI, so, as the JAX tests do, a
stub stands in: a ``--ssh-cmd`` script that drops the host argument and
runs the remote command locally, and an ``mpirun`` on ``PATH`` that
starts ``-n`` copies of its command with ``OMPI_COMM_WORLD_RANK`` set.
Through them two gloo ranks join one group and all-reduce; the
hostfile's slots place the ranks as the JAX launcher places them, the
worker environment is the JAX launcher's, the forwarded variables
arrive, and a failed rank fails the group fast.
"""
import importlib.util
import os
import subprocess
import sys

import pytest

from mxnet_tpu_torch import launch as tlaunch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_common import ROOT, free_ports  # noqa: E402

WORKER = r"""
import os, sys
sys.path.insert(0, {root!r})
import torch
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import kvstore_server
from mxnet_tpu_torch.parallel import collectives as C
with mt.cpu():
    assert kvstore_server.init_distributed()
    t = torch.tensor([float(C.rank() + 1)])
    C.cross_process_allreduce(t)
    print(f"rank {{C.rank()}}/{{C.world()}} sum {{t.item()}} "
          f"role {{os.environ['DMLC_ROLE']}} fwd "
          f"{{os.environ.get('MXTPU_REMOTE_PROBE')}} "
          f"hosts {{os.environ['MXTPU_WORKER_HOSTS']}}", flush=True)
"""


def _jlaunch():
    spec = importlib.util.spec_from_file_location(
        "jax_launch", os.path.join(ROOT, "tools", "launch.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args, env=None, timeout=120):
    full = dict(os.environ, OMP_NUM_THREADS="1",
                MXTPU_CMD_PORT_BASE=str(free_ports(4)), **(env or {}))
    return subprocess.run([sys.executable, "-m", "mxnet_tpu_torch.launch"]
                          + args, capture_output=True, text=True,
                          timeout=timeout, env=full, cwd=ROOT)


def _stub_ssh(tmp_path):
    stub = tmp_path / "fake_ssh"
    stub.write_text("#!/bin/sh\n# args: <host> <remote command>\n"
                    "shift\nexec sh -c \"$@\"\n")
    stub.chmod(0o755)
    return stub


def _worker(tmp_path):
    w = tmp_path / "worker.py"
    w.write_text(WORKER.format(root=ROOT))
    return w


@pytest.mark.parametrize("text,n", [
    ("# two pseudo-hosts\nhostA slots=1\nhostB slots=1\n", 2),
    ("hostA slots=2\nhostB\n", 3),
    ("hostA\n\nhostB slots=3  # comment\n", 5)])
def test_hostfile_and_placement_match_jax(text, n, tmp_path):
    jl = _jlaunch()
    hf = tmp_path / "hosts"
    hf.write_text(text)
    assert tlaunch.parse_hostfile(str(hf)) == jl._parse_hostfile(str(hf))
    hosts = tlaunch.parse_hostfile(str(hf))
    assert tlaunch.assign_ranks(hosts, n) == jl._assign_ranks(hosts, n)


def test_ssh_launcher_runs_a_group(tmp_path):
    hf = tmp_path / "hosts"
    hf.write_text("hostA slots=1\nhostB slots=1\n")
    proc = _run(["-n", "2", "--launcher", "ssh", "-H", str(hf),
                 "--ssh-cmd", str(_stub_ssh(tmp_path)),
                 "--env", "MXTPU_REMOTE_PROBE",
                 "--coordinator", f"127.0.0.1:{free_ports()}",
                 sys.executable, str(_worker(tmp_path))],
                env={"MXTPU_REMOTE_PROBE": "yes"})
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    assert "launched rank 0 on hostA" in out
    assert "launched rank 1 on hostB" in out
    for r in range(2):
        assert f"rank {r}/2 sum 3.0 role worker fwd yes hosts hostA,hostB" \
            in proc.stdout


def test_ssh_launcher_fails_fast(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os, sys, time\n"
                   "rank = int(os.environ['MXTPU_WORKER_ID'])\n"
                   "assert os.environ['DMLC_RANK'] == str(rank)\n"
                   "sys.exit(3) if rank == 1 else time.sleep(60)\n")
    proc = _run(["-n", "2", "--launcher", "ssh",
                 "--ssh-cmd", str(_stub_ssh(tmp_path)),
                 sys.executable, str(bad)], timeout=60)
    assert proc.returncode == 3, proc.stdout + proc.stderr
    assert "worker 1 exited with 3" in proc.stderr


def _stub_mpirun(tmp_path):
    d = tmp_path / "bin"
    d.mkdir()
    stub = d / "mpirun"
    stub.write_text(
        "#!/bin/sh\n# mpirun -n N cmd ...\n"
        "n=$2; shift 2\ni=0; pids=''\n"
        "while [ $i -lt $n ]; do\n"
        "  OMPI_COMM_WORLD_RANK=$i \"$@\" & pids=\"$pids $!\"\n"
        "  i=$((i+1))\ndone\n"
        "rc=0; for p in $pids; do wait $p || rc=$?; done; exit $rc\n")
    stub.chmod(0o755)
    return d


def test_mpi_launcher_runs_a_group_through_the_shim(tmp_path):
    path = f"{_stub_mpirun(tmp_path)}{os.pathsep}{os.environ['PATH']}"
    proc = _run(["-n", "2", "--launcher", "mpi",
                 "--coordinator", f"127.0.0.1:{free_ports()}",
                 sys.executable, str(_worker(tmp_path))],
                env={"PATH": path, "MXTPU_REMOTE_PROBE": "mpi"})
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    for r in range(2):
        assert f"rank {r}/2 sum 3.0 role worker fwd mpi" in proc.stdout


def test_mpi_launcher_without_mpirun(tmp_path):
    import shutil
    if shutil.which("mpirun") or shutil.which("mpiexec"):
        pytest.skip("an MPI runtime is installed here")
    proc = _run(["-n", "2", "--launcher", "mpi",
                 sys.executable, "-c", "print('hi')"], timeout=60)
    assert proc.returncode == 127
    assert "not found" in proc.stderr


def test_worker_env_matches_jax():
    import argparse
    jl = _jlaunch()
    for r in range(3):
        want = jl._worker_env(argparse.Namespace(
            coordinator="10.0.0.1:1234", num_workers=3), r,
            ["h0", "h1", "h1"])
        got = tlaunch.worker_env("10.0.0.1:1234", 3, r, ["h0", "h1", "h1"])
        assert got.pop("DMLC_PS_ROOT_PORT") == "1234"
        assert got == want


def test_supervise_needs_the_local_launcher(capsys):
    with pytest.raises(SystemExit):
        tlaunch.main(["-n", "2", "--launcher", "ssh", "--supervise", "true"])
    assert "--supervise requires --launcher local" in capsys.readouterr().err
