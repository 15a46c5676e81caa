"""The distributed group and the worker command channel (ref: the JAX
package's ``kvstore_server.py``; python/mxnet/kvstore_server.py and the
profiler commands of src/kvstore/kvstore_dist_server.h:276-287).

:func:`init_distributed` joins this process to a ``torch.distributed``
group from the launcher's environment (``MXTPU_COORDINATOR``,
``MXTPU_NUM_WORKERS``, ``MXTPU_WORKER_ID``; the reference's
``DMLC_PS_ROOT_URI`` / ``DMLC_PS_ROOT_PORT``, ``DMLC_NUM_WORKER`` and
``DMLC_RANK`` are read when those are unset). Rank 0 hosts the
``TCPStore`` at the coordinator address and every rank rendezvouses
through it; at world 1 there is nothing to join and it returns False, as
the JAX package does. :func:`join_group` is the same join for an explicit
address, world and rank (a world of 1 included).

The backend follows a rule, not a knob: NCCL when this process runs on
the card and every rank on its host has a card of its own, gloo
otherwise (on the host, or ranks sharing a card; gloo moves CUDA tensors
itself where it can and ``parallel/collectives.py`` stages the rest
through host tensors). A rank's card is ``local_rank % device_count``,
where the local rank is its index among the ranks placed on its host
(``MXTPU_WORKER_HOSTS``). ``MXTPU_COORD_TIMEOUT_MS`` is the group's
timeout. Nothing falls back quietly: a rank asked to run on the card
(the default context) that finds none raises, and so does a failed
rendezvous.

There is no server role: reduction is collective, so a process started
as a server is a worker. What survives of the server design is the
**command channel**: every worker serves a small TCP endpoint
(:func:`start_command_server`, port ``MXTPU_CMD_PORT_BASE`` + rank,
default the coordinator's port + 100) and :func:`send_command` is its
client, used by ``KVStoreDistTPU.send_profiler_command`` for
``profile_process='server'``. Every command carries the job's token
(``MXTPU_CMD_TOKEN``); without one the endpoint binds loopback only.
"""
from __future__ import annotations

import atexit
import datetime
import json
import socket
import struct
import threading
import time

from .base import MXNetError, check, env

__all__ = ["init_distributed", "join_group", "group_info", "KVStoreServer",
           "_init_kvstore_server_module", "start_command_server",
           "send_command", "worker_command_address"]

_group = {}
_group_lock = threading.Lock()


def _coordinator() -> str:
    coord = env.get("MXTPU_COORDINATOR")
    if not coord and env.raw("DMLC_PS_ROOT_URI"):
        port = env.raw("DMLC_PS_ROOT_PORT") or ""
        coord = f"{env.raw('DMLC_PS_ROOT_URI')}:{port}" if port else ""
    return coord


def _int_env(name: str, alias: str, default: int) -> int:
    raw = env.raw(name)
    if raw is None:
        raw = env.raw(alias)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError as e:
        raise MXNetError(f"{name}: not an integer: {raw!r}") from e


def coord_timeout_ms() -> int:
    """``MXTPU_COORD_TIMEOUT_MS``, strictly parsed: an unparseable bound
    must not become an unbounded wait."""
    try:
        t = int(env.get("MXTPU_COORD_TIMEOUT_MS"))
    except (TypeError, ValueError) as e:
        raise MXNetError(
            f"MXTPU_COORD_TIMEOUT_MS: not an integer: "
            f"{env.raw('MXTPU_COORD_TIMEOUT_MS')!r}") from e
    check(t > 0, f"MXTPU_COORD_TIMEOUT_MS must be > 0, got {t}")
    return t


def _placement(nproc: int):
    hosts = [h for h in env.get("MXTPU_WORKER_HOSTS").split(",") if h]
    return [hosts[r] if r < len(hosts) else "127.0.0.1"
            for r in range(nproc)]


def init_distributed() -> bool:
    """Join the group the launcher's environment describes. Returns True
    when a group of more than one process was joined (False at world 1
    or without a coordinator)."""
    coord = _coordinator()
    nproc = _int_env("MXTPU_NUM_WORKERS", "DMLC_NUM_WORKER", 1)
    rank = _int_env("MXTPU_WORKER_ID", "DMLC_RANK", 0)
    if not coord or nproc <= 1:
        return False
    join_group(coord, nproc, rank)
    start_command_server()
    return True


def join_group(coordinator: str, num_workers: int, rank: int,
               device=None) -> dict:
    """Join (once) the ``torch.distributed`` group of ``num_workers``
    ranks whose ``TCPStore`` rank 0 hosts at ``coordinator``
    (``host:port``). ``device``: where this rank computes (default the
    current context). Returns :func:`group_info`."""
    import torch
    import torch.distributed as dist
    from .context import resolve_device, set_process_device
    with _group_lock:
        if _group:
            check(_group["world"] == num_workers and _group["rank"] == rank,
                  f"already in a group of {_group['world']} as rank "
                  f"{_group['rank']}")
            return group_info()
        check(0 <= rank < num_workers,
              f"rank {rank} outside a world of {num_workers}")
        check(":" in coordinator,
              f"coordinator {coordinator!r} is not host:port")
        host, port = coordinator.rsplit(":", 1)
        dev = resolve_device(device)        # the card, or raise
        placement = _placement(num_workers)
        local = [r for r in range(num_workers)
                 if placement[r] == placement[rank]]
        local_rank = local.index(rank)
        if dev.type == "cuda":
            ncards = torch.cuda.device_count()
            dev = torch.device("cuda", local_rank % ncards)
            torch.cuda.set_device(dev)
            set_process_device(dev)
            backend = "nccl" if len(local) <= ncards and \
                dist.is_nccl_available() else "gloo"
        else:
            backend = "gloo"
        timeout = datetime.timedelta(milliseconds=coord_timeout_ms())
        try:
            store = dist.TCPStore(host, int(port), num_workers,
                                  is_master=(rank == 0), timeout=timeout)
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=num_workers,
                                    timeout=timeout)
        except Exception as e:
            raise MXNetError(
                f"rank {rank}/{num_workers}: joining the group at "
                f"{coordinator} ({backend}) failed: {e}") from e
        _group.update(world=num_workers, rank=rank, local_rank=local_rank,
                      local_world=len(local), backend=backend,
                      device=str(dev), store=store)
        atexit.register(_leave_group)
    return group_info()


def _leave_group() -> None:
    """At exit: every rank meets, leaves the group, and rank 0 (whose
    process hosts the TCPStore) waits until the others have left, so no
    rank's teardown finds the store or a peer gone (a gloo rank that
    exits while its peers still talk aborts)."""
    import torch.distributed as dist
    if not _group or not dist.is_initialized():
        return
    try:
        from .parallel.collectives import barrier
        barrier()
        dist.destroy_process_group()
        store = _group["store"]
        store.add("mxt_left", 1)
        if _group["rank"] == 0:
            deadline = time.monotonic() + 30.0
            while store.add("mxt_left", 0) < _group["world"] and \
                    time.monotonic() < deadline:
                time.sleep(0.01)
    except Exception:  # at exit: report, never raise
        from .log import get_logger
        get_logger("mxnet_tpu_torch.kvstore_server").warning(
            "leaving the group at exit failed", exc_info=True)


def group_info() -> dict:
    """``{world, rank, local_rank, local_world, backend, device}`` of the
    joined group, or ``{}`` when this process joined none."""
    return {k: v for k, v in _group.items() if k != "store"}


# ---------------------------------------------------------------------------
# Worker command channel (profiler remote control)
# ---------------------------------------------------------------------------

_cmd_server = None
_cmd_lock = threading.Lock()


def _cmd_port(rank: int) -> int:
    base = int(env.get("MXTPU_CMD_PORT_BASE"))
    if base <= 0:
        coord = _coordinator()
        if ":" not in coord:
            return 0
        base = int(coord.rsplit(":", 1)[1]) + 100
    return base + rank


def worker_command_address(rank: int):
    """(host, port) of worker ``rank``'s command endpoint, from the
    launcher's ``MXTPU_WORKER_HOSTS`` placement (loopback by default)."""
    hosts = [h for h in env.get("MXTPU_WORKER_HOSTS").split(",") if h]
    host = hosts[rank] if rank < len(hosts) else "127.0.0.1"
    if host == "localhost":
        host = "127.0.0.1"
    return host, _cmd_port(rank)


def _recv_exact(conn, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("command peer closed mid-message")
        buf += chunk
    return buf


def _send_msg(conn, obj) -> None:
    payload = json.dumps(obj).encode()
    conn.sendall(struct.pack(">I", len(payload)) + payload)


def _recv_msg(conn):
    (n,) = struct.unpack(">I", _recv_exact(conn, 4))
    return json.loads(_recv_exact(conn, n).decode())


def _handle_command(head: str, body: str) -> str:
    """Run one remote command; returns the reply payload. The heads are
    the reference's KVStoreServerProfilerCommand (kvstore.h:49):
    ``profiler.set_config`` (kSetConfig), ``profiler.state`` (kState),
    ``profiler.pause`` / ``resume`` (kPause), ``profiler.dump`` /
    ``dumps`` (kDump)."""
    from . import profiler
    if head == "profiler.set_config":
        profiler.set_config(**json.loads(body or "{}"))
        return ""
    if head == "profiler.state":
        profiler.set_state(body or "stop")
        return ""
    if head == "profiler.pause":
        profiler.pause()
        return ""
    if head == "profiler.resume":
        profiler.resume()
        return ""
    if head == "profiler.dump":
        # written on the remote side AND returned, so the controller
        # collects the trace without a shared file system
        profiler.dump()
        with open(profiler._config["filename"]) as f:
            return f.read()
    if head == "profiler.dumps":
        return profiler.dumps()
    raise ValueError(f"unknown worker command {head!r}")


def _cmd_token() -> str:
    return env.get("MXTPU_CMD_TOKEN")


def _serve(sock) -> None:
    while True:
        try:
            conn, _ = sock.accept()
        except OSError:
            return
        with conn:
            try:
                req = _recv_msg(conn)
                if req.get("token", "") != _cmd_token():
                    raise PermissionError("bad or missing command token")
                payload = _handle_command(req.get("head", ""),
                                          req.get("body", ""))
                _send_msg(conn, {"ok": True, "payload": payload})
            except Exception as e:  # reply; the server thread lives on
                try:
                    _send_msg(conn, {"ok": False, "error": str(e)})
                except Exception:
                    pass


def start_command_server():
    """Bind this worker's command endpoint (once). Returns the bound
    port, or None when no port is configured."""
    global _cmd_server
    with _cmd_lock:
        if _cmd_server is not None:
            return _cmd_server[1]
        rank = _int_env("MXTPU_WORKER_ID", "DMLC_RANK", 0)
        port = _cmd_port(rank)
        if port <= 0:
            return None
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        sock.bind(("" if _cmd_token() else "127.0.0.1", port))
        sock.listen(8)
        t = threading.Thread(target=_serve, args=(sock,), daemon=True,
                             name="mxtpu-cmd-server")
        t.start()
        _cmd_server = (sock, port, t)
        return port


def send_command(rank: int, head: str, body: str = "",
                 timeout: float = 30.0) -> str:
    """Send one command to worker ``rank``; returns its reply payload
    (a remote error raises :class:`MXNetError`). A refused connection is
    retried until ``timeout``: a peer just out of the rendezvous may not
    have bound its endpoint yet."""
    host, port = worker_command_address(rank)
    deadline = time.monotonic() + timeout
    while True:
        try:
            conn = socket.create_connection((host, port), timeout=timeout)
            break
        except (ConnectionRefusedError, socket.timeout):
            if time.monotonic() >= deadline:
                raise
            time.sleep(0.1)
    with conn:
        _send_msg(conn, {"head": head, "body": body,
                         "token": _cmd_token()})
        rep = _recv_msg(conn)
    if not rep.get("ok"):
        raise MXNetError(f"worker {rank} command {head!r} failed: "
                         f"{rep.get('error')}")
    return rep.get("payload", "")


class KVStoreServer:
    """(ref: kvstore_server.py KVStoreServer) No serving loop: collectives
    have no server side."""

    def __init__(self, kvstore):
        self.kvstore = kvstore

    def run(self) -> None:
        pass


def _init_kvstore_server_module() -> None:
    init_distributed()
