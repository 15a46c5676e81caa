"""Launch a cross-process serving fleet behind the least-loaded router
(ref: the JAX package's ``tools/serve_fleet.py``, with the same flags and
``--device``).

Parent mode spawns N replica processes (each a registry-loaded
``FleetServer`` behind a ``ReplicaEndpoint`` socket), wires them into a
``FleetRouter``, and runs the autoscaler tick loop (``serving.autoscale``:
sustained queue pressure scales up, sustained idle drains down, replica
death respawns from CURRENT — bounded by ``MXTPU_FLEET_MIN/MAX``).

    python -m mxnet_tpu_torch.serving.serve_fleet \
        --registry /srv/registry --model resnet --replicas 2

    # rolling deploy the fleet onto a new version (from another shell,
    # after `registry.publish(...)`):
    python -m mxnet_tpu_torch.serving.serve_fleet \
        --registry /srv/registry --model resnet \
        --deploy v3 --connect 127.0.0.1:9400,127.0.0.1:9401

Replica mode (spawned by the parent; also usable standalone to put one
replica on a known port behind an external router)::

    python -m mxnet_tpu_torch.serving.serve_fleet --replica \
        --registry /srv/registry --model resnet --port 9400

Each replica serves on ``--device`` (``gpu``, the default, or ``cpu``)
and prints one ``FLEET_REPLICA_READY {json}`` line (bound port, pid,
active version, cold-start counts — 0 signature misses when the
published AOT bundle covers the signature set, 0 nvcc / NVRTC builds
with a warm ``MXTPU_COMPILE_CACHE``, and the graph captures) and exits
with the resumable code (75) on SIGTERM after draining.
"""
import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

READY_PREFIX = "FLEET_REPLICA_READY"


def _parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--registry", required=True,
                   help="shared ModelRegistry root")
    p.add_argument("--model", required=True, help="registry model name")
    p.add_argument("--version", default="current",
                   help="version to serve (default CURRENT)")
    p.add_argument("--replicas", type=int, default=None,
                   help="initial replica count (default MXTPU_FLEET_MIN)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0,
                   help="replica mode: port to bind (0 = ephemeral)")
    p.add_argument("--replica", action="store_true",
                   help="run ONE replica process (internal/advanced)")
    p.add_argument("--device", default="gpu", choices=("gpu", "cpu"),
                   help="replica mode: where the replica serves (a "
                        "replica on gpu with no card raises)")
    p.add_argument("--publish-aot", action="store_true",
                   help="replica mode: publish the warm AOT bundle back "
                        "to the registry after cold start")
    p.add_argument("--tick-s", type=float, default=1.0,
                   help="autoscaler tick interval")
    p.add_argument("--deploy", default=None, metavar="VERSION",
                   help="rolling-deploy VERSION onto a running fleet "
                        "(requires --connect), then exit")
    p.add_argument("--connect", default=None,
                   help="comma-separated host:port replica endpoints to "
                        "attach to instead of spawning")
    return p.parse_args(argv)


def _run_replica(args):
    from .router import replica_main
    replica_main(args.registry, args.model, host=args.host, port=args.port,
                 version=args.version, publish_aot=args.publish_aot,
                 ready_prefix=READY_PREFIX, device=args.device)


class _ReplicaProc:
    """One spawned replica process + its READY info."""

    def __init__(self, proc, info):
        self.proc = proc
        self.info = info

    @property
    def addr(self):
        return ("127.0.0.1", self.info["port"])


def spawn_replica(registry, model, version="current", publish_aot=False,
                  timeout=180.0, env_extra=None, port=0, device="gpu"):
    """Spawn one replica process; block until its READY line (or death).
    Returns a :class:`_ReplicaProc`."""
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.serving.serve_fleet",
           "--replica", "--registry", registry, "--model", model,
           "--version", version, "--port", str(port), "--device", device]
    if publish_aot:
        cmd.append("--publish-aot")
    from ..base import env as _env
    env = dict(_env.snapshot(), **(env_extra or {}))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_REPO, env.get("PYTHONPATH")) if p)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            bufsize=1, env=env)
    info = wait_ready(proc, timeout=timeout)
    return _ReplicaProc(proc, info)


def wait_ready(proc, timeout=180.0, prefix=READY_PREFIX):
    """Read the replica's stdout until its READY json (raises on death
    or timeout; the caller owns cleanup)."""
    result = {}
    done = threading.Event()

    def _read():
        for line in proc.stdout:
            if line.startswith(prefix + " "):
                try:
                    result.update(json.loads(line[len(prefix) + 1:]))
                except ValueError:
                    pass
                done.set()
                return
        done.set()  # EOF: replica died before READY

    t = threading.Thread(target=_read, daemon=True)
    t.start()
    if not done.wait(timeout) or "port" not in result:
        raise RuntimeError(
            f"replica not ready after {timeout}s (rc={proc.poll()})")
    return result


def _run_fleet(args):
    from .autoscale import Autoscaler, fleet_min
    from .router import FleetRouter

    router = FleetRouter()
    procs = {}

    def spawn(name):
        # the FIRST replica publishes the warm AOT bundle so every later
        # scale-up cold-starts with 0 signature misses
        rp = spawn_replica(args.registry, args.model, version=args.version,
                           publish_aot=not procs, device=args.device)
        procs[name] = rp
        warm = rp.info.get("warm", {})
        print(f"fleet: replica {name} up on :{rp.info['port']} "
              f"(pid {rp.info['pid']}, {rp.info['version']}, "
              f"{warm.get('compiles', '?')} misses, "
              f"{rp.info.get('nvcc_builds', '?')} nvcc builds, "
              f"{rp.info.get('captures', '?')} captures)", flush=True)
        return rp.addr, rp.info["pid"]

    def retire(name, pid):
        rp = procs.pop(name, None)
        if rp is None:
            return
        if rp.proc.poll() is None:
            rp.proc.terminate()  # SIGTERM -> drain -> exit 75
        try:
            rp.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            rp.proc.kill()

    scaler = Autoscaler(router, spawn, retire)
    n0 = args.replicas if args.replicas is not None else fleet_min()
    for _ in range(max(1, n0)):
        scaler._spawn_one()

    # chaos replica_kill integration: the hook kills the PROCESS (the
    # real fault), the router's retry path proves zero dropped requests
    def _kill(name):
        rp = procs.get(name)
        if rp is not None and rp.proc.poll() is None:
            rp.proc.kill()
    router.set_kill_hook(_kill)

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    print(f"fleet: routing {router.live_count()} replica(s) of "
          f"{args.model} (min={scaler._min} max={scaler._max} "
          f"target_queue={scaler._tq}); MXTPU_FLEET_* env tunes bounds",
          flush=True)
    while not stop.wait(args.tick_s):
        action = scaler.step()
        if action["op"] != "none":
            print(f"fleet: {action['op']}: {action['reason']}", flush=True)
    print("fleet: draining", flush=True)
    router.stop_fleet(drain=True)
    for name in list(procs):
        retire(name, None)


def _run_deploy(args):
    from .router import FleetRouter
    router = FleetRouter()
    for i, hp in enumerate(args.connect.split(",")):
        host, _, port = hp.strip().rpartition(":")
        router.add_replica(f"r{i}", (host or "127.0.0.1", int(port)))
    reports = router.rolling_deploy(args.deploy)
    for rep in reports:
        print(json.dumps(rep), flush=True)
    router.close()


def main(argv=None):
    args = _parse_args(argv)
    if args.replica:
        _run_replica(args)
    elif args.deploy:
        if not args.connect:
            print("--deploy requires --connect host:port[,host:port...]",
                  file=sys.stderr)
            sys.exit(2)
        _run_deploy(args)
    else:
        _run_fleet(args)


if __name__ == "__main__":
    main()
