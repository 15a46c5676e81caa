"""Start the N workers of one job (ref: the JAX package's
``tools/launch.py``; the reference's tools/launch.py and dmlc_tracker).

    python -m mxnet_tpu_torch.launch -n 2 [--coordinator HOST:PORT] \\
        python train.py ...
    python -m mxnet_tpu_torch.launch -n 4 --launcher ssh -H hostfile \\
        --coordinator host0:29500 python train.py ...
    python -m mxnet_tpu_torch.launch -n 4 --launcher mpi \\
        --coordinator host0:29500 python train.py ...
    python -m mxnet_tpu_torch.launch -n 2 --supervise \\
        --supervise-ckpt DIR [--supervise-dir D] python train.py ...

Each worker gets the environment ``kvstore_server.init_distributed``
reads: ``MXTPU_COORDINATOR`` (rank 0's ``TCPStore``; default
``127.0.0.1`` on a free port), ``MXTPU_NUM_WORKERS``, ``MXTPU_WORKER_ID``,
``MXTPU_WORKER_HOSTS`` and the job's command token ``MXTPU_CMD_TOKEN``,
with the reference's ``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT`` /
``DMLC_NUM_WORKER`` / ``DMLC_RANK`` / ``DMLC_ROLE`` beside them.

It fails fast: a worker that dies fatally (any code but 0 and the drain
code, or a signal) terminates the others, and the group exits with its
code. A worker that exits with the drain code
(``MXTPU_RESUMABLE_EXIT_CODE``, default 75) is a graceful preemption:
its peers are left to finish their own final checkpoint, and the group
exits with the drain code.

``--launcher manual`` prints each rank's environment and command for
starting them by hand. ``--launcher ssh`` starts rank r on the r-th slot
of the hostfile (``-H``: one ``host [slots=K]`` a line, ranks placed
block-wise) through ``--ssh-cmd`` (``--ssh-port``), with the forwarded
environment (``MXNET_*``, ``MXTPU_*``, ``PYTHONPATH``, ``--env`` names)
exported in the remote shell. ``--launcher mpi`` runs ``mpirun -n N``
over a Python shim that reads the MPI runtime's rank variable and sets
the worker environment before it runs the command. Both need a
coordinator address every host reaches.

``--supervise`` (local launcher) runs the self-healing fleet of
``parallel/supervisor.py``: each generation is a fresh group on the
coordinator port + generation; a death or a hung collective (a watchdog
flight record under ``MXTPU_MEM_DUMP_DIR``) shrinks the fleet to the
survivors, the spot capacity model (``--supervise-recovery`` seconds)
grows it back, ``--supervise-ckpt`` is where the workers' checkpoints
(and any ``resize_to`` request) are read, ``--supervise-grace`` the
seconds between SIGTERM and SIGKILL, and ``--supervise-dir`` where the
forensic bundle lands when the restart budget runs out.
"""
from __future__ import annotations

import argparse
import os
import shlex
import shutil
import signal
import socket
import subprocess
import sys
import time
import uuid

from .base import env

__all__ = ["main", "worker_env", "wait_group"]


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker_env(coordinator: str, num_workers: int, rank: int,
               placement=None) -> dict:
    """The variables worker ``rank`` of the job reads."""
    host, port = coordinator.rsplit(":", 1)
    return {
        "MXTPU_COORDINATOR": coordinator,
        "MXTPU_NUM_WORKERS": str(num_workers),
        "MXTPU_WORKER_ID": str(rank),
        # rank -> host placement: any worker reaches any other's command
        # endpoint; an operator's own value wins
        "MXTPU_WORKER_HOSTS": env.raw("MXTPU_WORKER_HOSTS") or ",".join(
            placement or ["127.0.0.1"] * num_workers),
        "DMLC_PS_ROOT_URI": host,
        "DMLC_PS_ROOT_PORT": port,
        "DMLC_NUM_WORKER": str(num_workers),
        "DMLC_RANK": str(rank),
        "DMLC_ROLE": "worker",
    }


def _resumable_code() -> int:
    try:
        return int(env.get("MXTPU_RESUMABLE_EXIT_CODE"))
    except (TypeError, ValueError):
        return 75


def _classify_exit(rc: int) -> str:
    """``ok`` (0), ``resumable`` (the drain code), ``signal`` (negative:
    killed by a signal) or ``fatal``."""
    if rc == 0:
        return "ok"
    if rc == _resumable_code():
        return "resumable"
    if rc < 0:
        return "signal"
    return "fatal"


def wait_group(procs) -> int:
    """Wait for every ``(rank, Popen)``. A fatal or signal death
    terminates the rest at once (a crashed rank would leave them waiting
    in a collective); a resumable exit does not. Returns the first fatal
    code, else the drain code if any rank drained, else 0."""
    failed = None
    drained = False
    alive = dict(procs)
    try:
        while alive:
            for r in list(alive):
                rc = alive[r].poll()
                if rc is None:
                    continue
                del alive[r]
                cls = _classify_exit(rc)
                if cls == "resumable":
                    drained = True
                    print(f"worker {r} exited resumable ({rc}): graceful "
                          "drain, waiting for peers", file=sys.stderr,
                          flush=True)
                elif cls in ("fatal", "signal") and failed is None:
                    failed = (r, rc)
                    for other in alive.values():
                        try:
                            other.terminate()
                        except OSError:
                            pass
            if alive:
                time.sleep(0.05)
    except KeyboardInterrupt:
        for p in alive.values():
            p.send_signal(signal.SIGINT)
        raise
    if failed:
        r, rc = failed
        what = f"killed by signal {-rc}" if rc < 0 else f"exited with {rc}"
        print(f"worker {r} {what} (fatal): group terminated",
              file=sys.stderr, flush=True)
        return rc
    if drained:
        print(f"group drained: resumable exit ({_resumable_code()}), "
              "relaunch to resume", file=sys.stderr, flush=True)
        return _resumable_code()
    return 0


def _forward_env(names=()) -> dict:
    """The variables a remote worker inherits: ``MXNET_*``, ``MXTPU_*``,
    ``PYTHONPATH`` and the extra ``names``."""
    base = env.snapshot()
    out = {k: v for k, v in base.items()
           if k.startswith(("MXNET_", "MXTPU_")) or k == "PYTHONPATH"}
    for k in names or ():
        if k in base:
            out[k] = base[k]
    return out


def parse_hostfile(path: str):
    """``[(host, slots)]`` of a hostfile: ``host`` or ``host slots=K`` a
    line, ``#`` comments."""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            slots = 1
            for p in parts[1:]:
                if p.startswith("slots="):
                    slots = int(p.split("=", 1)[1])
            hosts.append((parts[0], slots))
    return hosts


def assign_ranks(hosts, n: int):
    """Rank -> host, block-wise over the slots (dmlc_tracker/ssh.py)."""
    if sum(s for _, s in hosts) <= 0:
        raise SystemExit("hostfile has no usable slots")
    placement, i = [], 0
    while len(placement) < n:
        host, slots = hosts[i % len(hosts)]
        for _ in range(slots):
            if len(placement) >= n:
                break
            placement.append(host)
        i += 1
    return placement


def launch_ssh(args, coordinator: str, cmd) -> int:
    hosts = parse_hostfile(args.hostfile) if args.hostfile \
        else [("localhost", args.num_workers)]
    placement = assign_ranks(hosts, args.num_workers)
    fwd = _forward_env(args.env)
    procs = []
    for r in range(args.num_workers):
        wenv = dict(fwd)
        wenv.update(worker_env(coordinator, args.num_workers, r, placement))
        exports = " ".join(f"export {k}={shlex.quote(v)};"
                           for k, v in sorted(wenv.items()))
        quoted = " ".join(shlex.quote(c) for c in cmd)
        remote = (f"cd {shlex.quote(args.remote_workdir or os.getcwd())} "
                  f"&& {exports} exec {quoted}")
        ssh_base = shlex.split(args.ssh_cmd)
        if args.ssh_port and args.ssh_cmd == "ssh":
            ssh_base += ["-p", str(args.ssh_port)]
        procs.append((r, subprocess.Popen(ssh_base + [placement[r],
                                                      remote])))
        print(f"launched rank {r} on {placement[r]}", file=sys.stderr,
              flush=True)
    return wait_group(procs)


def launch_mpi(args, coordinator: str, cmd) -> int:
    """``mpirun -n N`` over a Python shim that reads the runtime's rank
    variable (OpenMPI, PMI, PMIx or Slurm), overlays the same worker
    environment the local and ssh launchers set, and runs the command."""
    mpirun = shutil.which("mpirun") or shutil.which("mpiexec")
    if mpirun is None:
        print("mpirun/mpiexec not found on PATH", file=sys.stderr)
        return 127
    wenv = _forward_env(args.env)
    wenv.update(worker_env(coordinator, args.num_workers, 0))
    # the shim runs in each MPI process, before the worker: it reads the
    # runtime's variables there
    shim = (
        "import sys,subprocess;from os import environ as E;"
        f"env={wenv!r};"
        "r=E.get('OMPI_COMM_WORLD_RANK') or E.get('PMI_RANK') or "
        "E.get('PMIX_RANK') or E.get('SLURM_PROCID');"
        "assert r is not None, "
        "'cannot determine MPI rank (no OMPI/PMI/PMIX/SLURM rank var)';"
        "env['MXTPU_WORKER_ID']=r; env['DMLC_RANK']=r;"
        "E.update(env);"
        "sys.exit(subprocess.call(sys.argv[1:]))")
    return subprocess.call([mpirun, "-n", str(args.num_workers),
                            sys.executable, "-c", shim] + list(cmd))


def launch_supervised(args, coordinator: str, cmd) -> int:
    """The self-healing local fleet (``parallel/supervisor.py``): each
    generation gets a fresh coordinator port (base + generation; a dead
    group's store cannot be rejoined) and generations after the first
    run under ``MXTPU_ELASTIC=on`` and ``MXNET_IS_RECOVERY=1``."""
    from .parallel.supervisor import SpotCapacityModel, Supervisor
    host, base_port = coordinator.rsplit(":", 1)
    base_port = int(base_port)
    base = env.snapshot()

    def spawn(world, gen, extra):
        procs = {}
        for r in range(world):
            wenv = dict(base)
            wenv.update(worker_env(f"{host}:{base_port + gen}", world, r))
            wenv.update(extra)
            procs[r] = subprocess.Popen(cmd, env=wenv)
        return procs

    sup = Supervisor(
        spawn, args.num_workers, ckpt_dir=args.supervise_ckpt,
        state_dir=args.supervise_dir,
        capacity=SpotCapacityModel(args.num_workers,
                                   recovery_s=args.supervise_recovery),
        term_grace_s=args.supervise_grace)
    return sup.run()


def launch_local(coordinator: str, num_workers: int, cmd) -> int:
    base = env.snapshot()
    procs = []
    for r in range(num_workers):
        wenv = dict(base)
        wenv.update(worker_env(coordinator, num_workers, r))
        procs.append((r, subprocess.Popen(cmd, env=wenv)))
    return wait_group(procs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mxnet_tpu_torch.launch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("--launcher", default="local",
                    choices=["local", "manual", "ssh", "mpi"],
                    help="manual: print each rank's environment and "
                         "command instead of starting it")
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0's TCPStore (default "
                         "127.0.0.1 on a free port)")
    ap.add_argument("-H", "--hostfile", default=None,
                    help="one host a line, optional 'slots=K' (ssh)")
    ap.add_argument("--env", action="append", default=[],
                    help="extra variable names forwarded to remote workers")
    ap.add_argument("--remote-workdir", default=None,
                    help="working directory on remote hosts (default: "
                         "the current one)")
    ap.add_argument("--ssh-port", type=int, default=None)
    ap.add_argument("--ssh-cmd", default="ssh", help="the ssh executable")
    ap.add_argument("--supervise", action="store_true",
                    help="self-healing fleet: shrink and resume on a "
                         "failure, grow back when capacity returns "
                         "(local launcher only)")
    ap.add_argument("--supervise-ckpt", default=None,
                    help="checkpoint dir the supervisor reads resize "
                         "requests from")
    ap.add_argument("--supervise-dir", default=None,
                    help="where the forensic bundle lands when the "
                         "restart budget runs out")
    ap.add_argument("--supervise-grace", type=float, default=5.0,
                    help="seconds between SIGTERM and SIGKILL when a "
                         "generation is retired")
    ap.add_argument("--supervise-recovery", type=float, default=30.0,
                    help="spot capacity model: seconds until a lost slot "
                         "is offered again")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")
    if args.num_workers < 1:
        ap.error("-n must be at least 1")
    if args.supervise and args.launcher != "local":
        ap.error("--supervise requires --launcher local")
    coordinator = args.coordinator or f"127.0.0.1:{_free_port()}"
    # one command-channel token a job: workers authenticate the command
    # endpoint with it (kvstore_server)
    if not env.get("MXTPU_CMD_TOKEN"):
        env.set("MXTPU_CMD_TOKEN", uuid.uuid4().hex)
    if args.launcher == "manual":
        for r in range(args.num_workers):
            wenv = " ".join(f"{k}={v}" for k, v in sorted(
                worker_env(coordinator, args.num_workers, r).items()))
            print(f"[host {r}] {wenv} {' '.join(args.command)}")
        return 0
    if args.supervise:
        return launch_supervised(args, coordinator, args.command)
    if args.launcher == "ssh":
        return launch_ssh(args, coordinator, args.command)
    if args.launcher == "mpi":
        return launch_mpi(args, coordinator, args.command)
    return launch_local(coordinator, args.num_workers, args.command)


if __name__ == "__main__":
    sys.exit(main())
