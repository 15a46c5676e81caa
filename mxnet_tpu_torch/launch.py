"""Start N local workers of one job (ref: the JAX package's
``tools/launch.py``, its local mode; the reference's tools/launch.py and
dmlc_tracker).

    python -m mxnet_tpu_torch.launch -n 2 [--coordinator HOST:PORT] \\
        python train.py ...

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
starting them by hand. Not ported: ``--launcher ssh`` / ``mpi`` and
``--supervise`` (the self-healing fleet) raise ``NotPortedError``
(ROADMAP A10).
"""
from __future__ import annotations

import argparse
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
    ap.add_argument("--supervise", action="store_true")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if not args.command:
        ap.error("no command given")
    if args.num_workers < 1:
        ap.error("-n must be at least 1")
    if args.launcher in ("ssh", "mpi") or args.supervise:
        from .ops.registry import NotPortedError
        what = "--supervise" if args.supervise else \
            f"--launcher {args.launcher}"
        raise NotPortedError(f"launch {what} is not ported yet "
                             "(ROADMAP.md, queue A10)")
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
    return launch_local(coordinator, args.num_workers, args.command)


if __name__ == "__main__":
    sys.exit(main())
