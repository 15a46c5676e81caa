"""Process-level serving fleet: socket endpoint + least-loaded router (ref:
the JAX package's ``serving/router.py``).

:class:`~mxnet_tpu_torch.serving.fleet.Fleet` is N in-process replicas
behind one ``submit()`` — one Python process, one GIL, one failure
domain. This module is the cross-process half: replica workers are
separate processes each running a :class:`FleetServer` loaded from the
shared :class:`ModelRegistry` (cold start with zero signature misses via
the published AOT bundle and zero kernel builds via the compile cache),
and a :class:`FleetRouter` dispatches over them. On one card each replica
is a process with its own CUDA context, weights and graph pools; a
replica killed with SIGKILL takes only its own context with it.

Wire protocol (length-prefixed frames over TCP loopback)::

    frame   := header_len:u32be payload_len:u32be header payload
    header  := JSON object, always carrying {"op": ..., "id": ...}
    payload := raw little-endian ndarray bytes (shape/dtype in header)

Ops (client -> replica): ``predict`` (ndarray payload), ``metrics``,
``deploy`` (version), ``stop`` (drain), ``ping``. Replies
(replica -> client): ``result`` (ndarray payload, tagged with the
serving model ``version``), ``error`` (typed: etype + message),
``metrics`` / ``deployed`` / ``stopping`` / ``pong``.

Router contracts:

- **Least-loaded dispatch**: each pick minimizes router-side in-flight
  plus the replica's last-heartbeat queue depth (the serving metrics
  plane exported over the ``metrics`` op), round-robin tie-break.
- **Typed shed**: when every live replica rejects with ``QueueFull``
  (or none is live), the router raises ``QueueFull`` to the client —
  never silent drops.
- **Zero dropped in-flight on replica death**: every un-acked request
  id of a dead replica is retried on a survivor. Replicas keep a
  bounded response cache by request id, so a retry that raced a
  delivered response is answered idempotently, not recomputed.
- **Version monotonicity**: response version tags are parsed and the
  router maintains a high-water *version floor*; picks prefer replicas
  whose heartbeat version has reached the floor, so a client that saw
  vN+1 during a rolling deploy is not routed back to a vN replica.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
import uuid
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from ..base import MXNetError, check, env
from ..log import get_logger
from .batcher import (DeadlineExceeded, NoBucket, QueueFull, ServerClosed,
                      ServingError)

__all__ = ["FleetRouter", "ReplicaEndpoint", "ReplicaClient", "RouterFuture",
           "ReplicaDead", "send_frame", "recv_frame", "fleet_heartbeat_ms",
           "replica_main"]

# the parent logger: server.py owns "mxnet_tpu_torch.serving" with a
# handler, and a handler-bearing child would double-emit through
# propagation
_LOG = get_logger("mxnet_tpu_torch.serving")

# a frame larger than this is a protocol error, not a big request
_MAX_FRAME = 256 << 20


class ReplicaDead(ServingError):
    """The replica's socket is gone (process death or close)."""


def fleet_heartbeat_ms() -> float:
    """Router heartbeat poll interval (``MXTPU_FLEET_HEARTBEAT_MS``)."""
    try:
        v = float(env.get("MXTPU_FLEET_HEARTBEAT_MS"))
    except (TypeError, ValueError):
        raise MXNetError("MXTPU_FLEET_HEARTBEAT_MS: expected a number, got "
                         f"{env.raw('MXTPU_FLEET_HEARTBEAT_MS')!r}")
    check(v > 0, f"MXTPU_FLEET_HEARTBEAT_MS must be > 0, got {v}")
    return v


# -- wire protocol ----------------------------------------------------------

def send_frame(sock: socket.socket, header: dict, payload: bytes = b""
               ) -> None:
    hb = json.dumps(header, separators=(",", ":")).encode("utf-8")
    sock.sendall(struct.pack(">II", len(hb), len(payload)) + hb + payload)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed"
                                  + (" mid-frame" if buf else ""))
        buf += chunk
    return bytes(buf)


def recv_frame(sock: socket.socket) -> Tuple[dict, bytes]:
    hlen, plen = struct.unpack(">II", _recv_exact(sock, 8))
    if hlen > _MAX_FRAME or plen > _MAX_FRAME:
        raise MXNetError(f"router frame too large ({hlen}+{plen} bytes): "
                         "corrupt stream or protocol mismatch")
    header = json.loads(_recv_exact(sock, hlen).decode("utf-8"))
    payload = _recv_exact(sock, plen) if plen else b""
    return header, payload


def _array_header(op: str, rid: str, arr: np.ndarray, **extra) -> dict:
    h = {"op": op, "id": rid, "shape": list(arr.shape),
         "dtype": str(arr.dtype)}
    h.update(extra)
    return h


def _array_of(header: dict, payload: bytes) -> np.ndarray:
    return np.frombuffer(payload, dtype=header["dtype"]).reshape(
        header["shape"])


_TYPED_ERRORS = {"QueueFull": QueueFull, "DeadlineExceeded": DeadlineExceeded,
                 "NoBucket": NoBucket, "ServerClosed": ServerClosed,
                 "ReplicaDead": ReplicaDead, "ServingError": ServingError}


def _typed_error(etype: str, message: str) -> Exception:
    return _TYPED_ERRORS.get(etype, MXNetError)(message)


def _version_num(tag) -> Optional[int]:
    """'v12' -> 12; None/unparsable -> None (excluded from floor logic)."""
    if not isinstance(tag, str):
        return None
    digits = "".join(c for c in tag if c.isdigit())
    return int(digits) if digits else None


# -- replica side -----------------------------------------------------------

class ReplicaEndpoint:
    """Socket front-end of one replica's :class:`ModelServer`.

    Accepts router connections, decodes ``predict`` frames into
    ``server.submit()`` calls, and streams results back as they resolve.
    Keeps a bounded response cache by request id so retried requests
    (the router re-sends a dead replica's un-acked ids to survivors, and
    a survivor may legitimately see a duplicate after reconnect) are
    answered from cache — **idempotent by request id**.
    """

    def __init__(self, server, host: str = "127.0.0.1", port: int = 0,
                 done_cache: int = 1024):
        self.server = server
        self._done_cache = int(done_cache)
        self._done: "OrderedDict[str, Tuple[dict, bytes]]" = OrderedDict()
        self._done_lock = threading.Lock()
        self._lock = threading.Lock()
        self._conns: List[socket.socket] = []
        self._threads: List[threading.Thread] = []
        self._closed = False
        self._stop_requested = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.addr: Tuple[str, int] = self._sock.getsockname()

    def start(self) -> "ReplicaEndpoint":
        self.server.start()
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name=f"mxtpu-endpoint[{self.server.name}]")
        t.start()
        self._threads.append(t)
        return self

    # -- accept / per-connection loops ---------------------------------
    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # listener closed
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                if self._closed:
                    conn.close()
                    return
                self._conns.append(conn)
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def _conn_loop(self, conn: socket.socket) -> None:
        # one writer lock per connection: worker threads resolving
        # futures and the reader answering metrics share the socket
        wlock = threading.Lock()
        try:
            while not self._closed:
                header, payload = recv_frame(conn)
                self._handle(conn, wlock, header, payload)
        except (ConnectionError, OSError, ValueError):
            pass  # router went away (or we are closing); server state is
        #         untouched — in-flight work still resolves and is cached
        finally:
            with self._lock:
                if conn in self._conns:
                    self._conns.remove(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _reply(self, conn, wlock, header: dict, payload: bytes = b""
               ) -> None:
        try:
            with wlock:
                send_frame(conn, header, payload)
        except (ConnectionError, OSError):
            pass  # reply undeliverable; response cache still answers a retry

    def _handle(self, conn, wlock, header: dict, payload: bytes) -> None:
        op = header.get("op")
        rid = header.get("id") or uuid.uuid4().hex
        if op == "predict":
            self._handle_predict(conn, wlock, rid, header, payload)
        elif op == "metrics":
            m = self.server.metrics_json()
            self._reply(conn, wlock, {
                "op": "metrics", "id": rid,
                "version": self.server.active_version,
                "queue_depth": m.get("queue_depth", 0),
                "p95_ms": m.get("latency_ms", {}).get("total", {}).get(
                    "p95", 0.0),
                "metrics": m})
        elif op == "deploy":
            threading.Thread(
                target=self._handle_deploy,
                args=(conn, wlock, rid, header.get("version")),
                daemon=True).start()
        elif op == "stop":
            self._reply(conn, wlock, {"op": "stopping", "id": rid})
            self._stop_requested.set()
        elif op == "ping":
            self._reply(conn, wlock, {"op": "pong", "id": rid})
        else:
            self._reply(conn, wlock, {"op": "error", "id": rid,
                                      "etype": "MXNetError",
                                      "message": f"unknown op {op!r}"})

    def _handle_predict(self, conn, wlock, rid, header, payload) -> None:
        with self._done_lock:
            cached = self._done.get(rid)
        if cached is not None:  # duplicate id: answer, don't recompute
            self._reply(conn, wlock, cached[0], cached[1])
            return
        try:
            x = _array_of(header, payload)
            fut = self.server.submit(x, deadline_ms=header.get("deadline_ms"))
        except Exception as e:
            self._reply(conn, wlock, {"op": "error", "id": rid,
                                      "etype": type(e).__name__,
                                      "message": str(e)})
            return
        # resolve off-thread: the reader must keep draining frames (a
        # metrics heartbeat racing a slow batch must not block on it)
        threading.Thread(target=self._resolve, daemon=True,
                         args=(conn, wlock, rid, fut)).start()

    def _resolve(self, conn, wlock, rid, fut) -> None:
        try:
            out = fut.result(timeout=300)
        except Exception as e:
            self._reply(conn, wlock, {"op": "error", "id": rid,
                                      "etype": type(e).__name__,
                                      "message": str(e)})
            return
        arr = np.ascontiguousarray(
            out[0] if isinstance(out, (tuple, list)) else out)
        h = _array_header("result", rid, arr,
                          version=getattr(fut, "version", None))
        p = arr.tobytes()
        with self._done_lock:
            self._done[rid] = (h, p)
            while len(self._done) > self._done_cache:
                self._done.popitem(last=False)
        self._reply(conn, wlock, h, p)

    def _handle_deploy(self, conn, wlock, rid, version) -> None:
        try:
            if not hasattr(self.server, "deploy"):
                raise MXNetError("replica server is not registry-attached "
                                 "(no deploy); serve a FleetServer")
            report = self.server.deploy(version)
            self._reply(conn, wlock, {"op": "deployed", "id": rid,
                                      "report": dict(report)})
        except Exception as e:
            self._reply(conn, wlock, {"op": "error", "id": rid,
                                      "etype": type(e).__name__,
                                      "message": str(e)})

    # -- lifecycle -----------------------------------------------------
    def close(self, abort: bool = False) -> None:
        """Shut the endpoint down. ``abort=True`` slams every socket shut
        with no drain — the test double for a replica process dying."""
        self._closed = True
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = list(self._conns), []
        if abort:
            for c in conns:
                try:
                    c.close()
                except OSError:
                    pass
            self.server.stop(drain=False)
            return
        # graceful: drain the server first so every accepted request's
        # future resolves (and flushes through _resolve) before sockets go
        self.server.stop(drain=True)
        time.sleep(0.05)  # let resolver threads flush their last frames
        for c in conns:
            try:
                c.close()
            except OSError:
                pass

    def serve_forever(self) -> None:
        """Run until SIGTERM/SIGINT or a ``stop`` op, drain, and exit
        with the resumable exit code (the supervisor's contract)."""
        import signal
        import sys
        from ..fit import resumable_exit_code
        signal.signal(signal.SIGTERM,
                      lambda *_: self._stop_requested.set())
        signal.signal(signal.SIGINT,
                      lambda *_: self._stop_requested.set())
        while not self._stop_requested.wait(0.2):
            pass
        self.close(abort=False)
        sys.exit(resumable_exit_code())


# -- router side ------------------------------------------------------------

class RouterFuture:
    """Client-side handle for one routed request. Carries everything the
    router needs to re-send it (header + payload + tried-replica set)."""

    def __init__(self, rid: str, header: dict, payload: bytes):
        self.id = rid
        self.version: Optional[str] = None
        self.replica: Optional[str] = None
        self.retries = 0
        self._header = header
        self._payload = payload
        self._tried: set = set()
        self._ev = threading.Event()
        self._result = None
        self._exc: Optional[Exception] = None

    def done(self) -> bool:
        return self._ev.is_set()

    def set_result(self, value) -> None:
        self._result = value
        self._ev.set()

    def set_exception(self, exc: Exception) -> None:
        self._exc = exc
        self._ev.set()

    def result(self, timeout: Optional[float] = None):
        if not self._ev.wait(timeout):
            raise TimeoutError(f"request {self.id} pending after "
                               f"{timeout}s")
        if self._exc is not None:
            raise self._exc
        return self._result


class _SyncCall:
    """Pending synchronous request (metrics/deploy/stop/ping)."""

    def __init__(self):
        self._ev = threading.Event()
        self.header: Optional[dict] = None
        self.payload: bytes = b""
        self.exc: Optional[Exception] = None

    def resolve(self, header, payload) -> None:
        self.header, self.payload = header, payload
        self._ev.set()

    def fail(self, exc) -> None:
        self.exc = exc
        self._ev.set()

    def wait(self, timeout):
        if not self._ev.wait(timeout):
            raise TimeoutError("replica call timed out")
        if self.exc is not None:
            raise self.exc
        return self.header, self.payload


class ReplicaClient:
    """Router-side handle: one multiplexed connection to one replica."""

    def __init__(self, name: str, addr: Tuple[str, int],
                 on_frame: Callable, on_death: Callable,
                 connect_timeout: float = 10.0, pid: Optional[int] = None):
        self.name = name
        self.addr = tuple(addr)
        self.pid = pid
        self.dead = threading.Event()
        self._on_frame = on_frame
        self._on_death = on_death
        self._wlock = threading.Lock()
        self._plock = threading.Lock()
        self._death_lock = threading.Lock()
        self._pending: Dict[str, object] = {}
        deadline = time.monotonic() + connect_timeout
        while True:  # the replica process may still be binding its port
            try:
                self._sock = socket.create_connection(self.addr, timeout=2.0)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True,
            name=f"mxtpu-router-reader[{name}]")
        self._reader.start()

    # -- pending registry ----------------------------------------------
    def register(self, rid: str, entry) -> None:
        with self._plock:
            self._pending[rid] = entry

    def pop_pending(self, rid: str):
        with self._plock:
            return self._pending.pop(rid, None)

    def pending_count(self) -> int:
        with self._plock:
            return len(self._pending)

    def send(self, header: dict, payload: bytes = b"") -> None:
        if self.dead.is_set():
            raise ReplicaDead(f"replica {self.name} is dead")
        try:
            with self._wlock:
                send_frame(self._sock, header, payload)
        except (ConnectionError, OSError) as e:
            self._mark_dead()
            raise ReplicaDead(f"replica {self.name}: {e}")

    def request(self, header: dict, payload: bytes = b"",
                timeout: float = 30.0) -> Tuple[dict, bytes]:
        """Send one op and wait for its reply (metrics/deploy/stop)."""
        rid = header.setdefault("id", uuid.uuid4().hex)
        call = _SyncCall()
        self.register(rid, call)
        try:
            self.send(header, payload)
        except ReplicaDead:
            self.pop_pending(rid)
            raise
        return call.wait(timeout)

    def _read_loop(self) -> None:
        try:
            while True:
                header, payload = recv_frame(self._sock)
                self._on_frame(self, header, payload)
        except (ConnectionError, OSError, ValueError):
            self._mark_dead()

    def _mark_dead(self) -> None:
        with self._death_lock:  # exactly one thread runs the death path
            if self.dead.is_set():
                return
            self.dead.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._plock:
            orphans = list(self._pending.items())
            self._pending.clear()
        self._on_death(self, orphans)

    def close(self) -> None:
        self.dead.set()  # suppress the death path: this is deliberate
        try:
            self._sock.close()
        except OSError:
            pass


def _router_metrics():
    from ..telemetry import default_registry
    reg = default_registry()
    return (reg.gauge("mxtpu_fleet_replicas",
                      "Live replica processes currently routable."),
            reg.counter("mxtpu_fleet_routed_total",
                        "Requests dispatched to a replica.",
                        label="replica"),
            reg.counter("mxtpu_fleet_retried_total",
                        "Requests re-dispatched after a replica died or "
                        "shed (each retry counts once)."),
            reg.counter("mxtpu_fleet_shed_total",
                        "Requests shed with QueueFull after every live "
                        "replica was saturated or dead."))


class FleetRouter:
    """Least-loaded request router over process replicas.

    ``add_replica(name, addr)`` connects; ``submit(x)`` returns a
    :class:`RouterFuture`. A heartbeat thread polls every replica's
    ``metrics`` op (queue depth / p95 / active version) at
    ``MXTPU_FLEET_HEARTBEAT_MS``; picks minimize router-side in-flight +
    heartbeat queue depth. Replica death retries its un-acked ids on
    survivors (zero dropped in-flight); saturation shed raises
    ``QueueFull``. ``rolling_deploy`` drains one replica at a time onto
    the target version while the version floor keeps client-visible tags
    monotone.
    """

    def __init__(self, heartbeat_ms: Optional[float] = None):
        self._heartbeat_s = (fleet_heartbeat_ms() if heartbeat_ms is None
                             else float(heartbeat_ms)) / 1000.0
        self._lock = threading.RLock()
        self._replicas: Dict[str, ReplicaClient] = {}
        self._state: Dict[str, dict] = {}
        self._inflight: Dict[str, int] = {}
        self._rr = 0
        self._routed = 0
        self._version_floor: Tuple[int, Optional[str]] = (-1, None)
        self._kill_hook: Optional[Callable[[str], None]] = None
        self._closed = False
        (self._g_replicas, self._c_routed, self._c_retried,
         self._c_shed) = _router_metrics()
        self._hb_thread: Optional[threading.Thread] = None

    # -- membership ----------------------------------------------------
    def add_replica(self, name: str, addr: Tuple[str, int],
                    pid: Optional[int] = None,
                    connect_timeout: float = 10.0) -> None:
        check(name not in self._replicas or
              self._replicas[name].dead.is_set(),
              f"replica {name!r} already routed")
        client = ReplicaClient(name, addr, self._on_frame,
                               self._on_replica_death,
                               connect_timeout=connect_timeout, pid=pid)
        with self._lock:
            self._replicas[name] = client
            self._inflight.setdefault(name, 0)
        try:  # prime the load/version state so the first pick is informed
            self._poll_one(name, client, timeout=5.0)
        except Exception:
            pass
        self._g_replicas.set(self.live_count())
        if self._hb_thread is None:
            self._hb_thread = threading.Thread(
                target=self._heartbeat_loop, daemon=True,
                name="mxtpu-router-heartbeat")
            self._hb_thread.start()

    def remove_replica(self, name: str, drain: bool = True,
                       timeout: float = 30.0) -> None:
        """Stop routing to ``name``; with ``drain`` wait for its pending
        requests and send a drain-stop (never drops in-flight)."""
        with self._lock:
            client = self._replicas.pop(name, None)
            self._state.pop(name, None)
        if client is None:
            return
        if drain and not client.dead.is_set():
            deadline = time.monotonic() + timeout
            while client.pending_count() and time.monotonic() < deadline:
                time.sleep(0.02)
            try:
                client.request({"op": "stop"}, timeout=5.0)
            except Exception:
                pass
        client.close()
        with self._lock:
            self._inflight.pop(name, None)
        self._g_replicas.set(self.live_count())

    def live_count(self) -> int:
        with self._lock:
            return sum(1 for c in self._replicas.values()
                       if not c.dead.is_set())

    def states(self) -> Dict[str, dict]:
        """Heartbeat snapshot per replica (the autoscaler's observation):
        name -> {queue_depth, p95_ms, version, healthy}."""
        with self._lock:
            out = {}
            for name, client in self._replicas.items():
                s = dict(self._state.get(name, {}))
                s.setdefault("queue_depth", 0)
                s.setdefault("p95_ms", 0.0)
                s.setdefault("version", None)
                s["inflight"] = self._inflight.get(name, 0)
                s["healthy"] = not client.dead.is_set()
                out[name] = s
            return out

    def set_kill_hook(self, fn: Optional[Callable[[str], None]]) -> None:
        """Install the chaos executor: called with a replica name when a
        ``replica_kill@N`` plan fires (tests/launchers kill the process
        or abort the endpoint)."""
        self._kill_hook = fn

    # -- dispatch ------------------------------------------------------
    def submit(self, x, deadline_ms: Optional[float] = None) -> RouterFuture:
        arr = np.ascontiguousarray(np.asarray(x))
        rid = uuid.uuid4().hex
        header = _array_header("predict", rid, arr, deadline_ms=deadline_ms)
        fut = RouterFuture(rid, header, arr.tobytes())
        self._dispatch(fut)
        self._maybe_chaos_kill()
        return fut

    def predict(self, x, deadline_ms: Optional[float] = None,
                timeout: float = 30.0):
        return self.submit(x, deadline_ms=deadline_ms).result(timeout)

    def _dispatch(self, fut: RouterFuture) -> None:
        while True:
            client = self._pick(fut._tried)
            if client is None:
                self._c_shed.inc()
                fut.set_exception(QueueFull(
                    f"request {fut.id}: every replica saturated or dead "
                    f"(tried {sorted(fut._tried) or 'none'})"))
                return
            fut._tried.add(client.name)
            client.register(fut.id, fut)
            with self._lock:
                self._inflight[client.name] = \
                    self._inflight.get(client.name, 0) + 1
            try:
                client.send(fut._header, fut._payload)
            except ReplicaDead:
                # death path already re-owned the pending set; if we got
                # the orphan back it is in fut._tried and loops to the
                # next candidate
                if client.pop_pending(fut.id) is not None:
                    with self._lock:
                        self._inflight[client.name] = max(
                            0, self._inflight.get(client.name, 1) - 1)
                    continue
                return  # _on_replica_death re-dispatched it already
            with self._lock:
                self._routed += 1
            fut.replica = client.name
            self._c_routed.inc(label_value=client.name)
            return

    def _pick(self, exclude) -> Optional[ReplicaClient]:
        with self._lock:
            cands = [(n, c) for n, c in self._replicas.items()
                     if n not in exclude and not c.dead.is_set()]
            floor = self._version_floor[0]
            if floor >= 0:
                # monotonicity: never route a client that has seen vN to
                # a replica still announcing vN-1 (unknown versions pass:
                # a fresh replica spawned from CURRENT is at least vN)
                ok = [(n, c) for n, c in cands
                      if (lambda v: v is None or v >= floor)(
                          _version_num(self._state.get(n, {})
                                       .get("version")))]
                if ok:
                    cands = ok
            if not cands:
                return None
            best, best_score = None, None
            n_c = len(cands)
            start = self._rr
            for i in range(n_c):
                name, client = cands[(start + i) % n_c]
                score = (self._inflight.get(name, 0)
                         + int(self._state.get(name, {})
                               .get("queue_depth", 0)))
                if best_score is None or score < best_score:
                    best, best_score = client, score
            self._rr = (self._rr + 1) % max(1, n_c)
            return best

    # -- response / death paths ----------------------------------------
    def _on_frame(self, client: ReplicaClient, header: dict,
                  payload: bytes) -> None:
        rid = header.get("id")
        entry = client.pop_pending(rid)
        if entry is None:
            return  # late duplicate (request was retried elsewhere)
        if isinstance(entry, _SyncCall):
            entry.resolve(header, payload)
            return
        fut: RouterFuture = entry
        with self._lock:
            self._inflight[client.name] = max(
                0, self._inflight.get(client.name, 1) - 1)
        op = header.get("op")
        if op == "result":
            version = header.get("version")
            num = _version_num(version)
            with self._lock:
                if num is not None and num > self._version_floor[0]:
                    self._version_floor = (num, version)
            fut.version = version
            fut.replica = client.name
            fut.set_result(_array_of(header, payload))
        elif op == "error" and header.get("etype") == "QueueFull":
            # saturated replica: fail over to the others before shedding
            self._c_retried.inc()
            fut.retries += 1
            self._dispatch(fut)
        else:
            fut.set_exception(_typed_error(header.get("etype", ""),
                                           header.get("message", "")))

    def _on_replica_death(self, client: ReplicaClient, orphans) -> None:
        with self._lock:
            self._state.pop(client.name, None)
            self._inflight[client.name] = 0
        self._g_replicas.set(self.live_count())
        retried = 0
        for rid, entry in orphans:
            if isinstance(entry, _SyncCall):
                entry.fail(ReplicaDead(f"replica {client.name} died"))
                continue
            # zero-dropped-in-flight: every un-acked predict goes to a
            # survivor; the dead name stays in _tried so we never
            # re-route to the corpse
            self._c_retried.inc()
            entry.retries += 1
            retried += 1
            self._dispatch(entry)
        if retried:
            _LOG.warning("router: replica %s died; retried %d in-flight "
                         "request(s) on survivors", client.name, retried)

    # -- heartbeats ----------------------------------------------------
    def _poll_one(self, name: str, client: ReplicaClient,
                  timeout: float = 2.0) -> None:
        header, _ = client.request({"op": "metrics"}, timeout=timeout)
        if header.get("op") != "metrics":
            return
        with self._lock:
            self._state[name] = {
                "queue_depth": int(header.get("queue_depth", 0)),
                "p95_ms": float(header.get("p95_ms") or 0.0),
                "version": header.get("version"),
                "t": time.monotonic(),
            }

    def _heartbeat_loop(self) -> None:
        while not self._closed:
            with self._lock:
                snapshot = list(self._replicas.items())
            for name, client in snapshot:
                if self._closed or client.dead.is_set():
                    continue
                try:
                    self._poll_one(name, client)
                except Exception:
                    pass  # socket death is surfaced by the reader thread
            self._g_replicas.set(self.live_count())
            time.sleep(self._heartbeat_s)

    # -- chaos ---------------------------------------------------------
    def _maybe_chaos_kill(self) -> None:
        if self._kill_hook is None:
            return
        from ..contrib import chaos
        plan = chaos.active()
        if plan is None:
            return
        with self._lock:
            routed = self._routed
        victim_idx = plan.replica_kill_due(routed)
        if victim_idx is None:
            return
        with self._lock:
            live = sorted(n for n, c in self._replicas.items()
                          if not c.dead.is_set())
            if not live:
                return
            if 0 <= victim_idx < len(live):
                victim = live[victim_idx]
            else:  # -1 / out of range: the busiest replica
                victim = max(live, key=lambda n: self._inflight.get(n, 0))
        _LOG.warning("chaos: replica_kill firing at routed=%d -> %s",
                     routed, victim)
        self._kill_hook(victim)

    # -- deploy / shutdown ---------------------------------------------
    def rolling_deploy(self, version: str, timeout: float = 300.0
                       ) -> List[dict]:
        """Deploy ``version`` replica by replica (each drains its old
        model internally — the FleetServer hot-swap), never taking two
        replicas out of full service at once."""
        reports = []
        with self._lock:
            names = sorted(self._replicas)
        for name in names:
            with self._lock:
                client = self._replicas.get(name)
            if client is None or client.dead.is_set():
                continue
            header, _ = client.request({"op": "deploy", "version": version},
                                       timeout=timeout)
            if header.get("op") == "error":
                raise MXNetError(f"rolling deploy to {version!r} failed at "
                                 f"{name}: {header.get('message')}")
            reports.append(header.get("report", {}))
            try:  # refresh so the floor/pick sees the new tag promptly
                self._poll_one(name, client)
            except Exception:
                pass
        return reports

    def stop_fleet(self, drain: bool = True) -> None:
        """Send every replica a stop op (drain by default)."""
        with self._lock:
            names = sorted(self._replicas)
        for name in names:
            self.remove_replica(name, drain=drain)

    def metrics_json(self) -> dict:
        states = self.states()
        return {
            "replicas": states,
            "live": sum(1 for s in states.values() if s["healthy"]),
            "routed_total": self._routed,
            "version_floor": self._version_floor[1],
        }

    def close(self) -> None:
        self._closed = True
        with self._lock:
            clients = list(self._replicas.values())
            self._replicas.clear()
            self._state.clear()
        for c in clients:
            c.close()
        self._g_replicas.set(0)


# -- replica process entry --------------------------------------------------

def _build_counts(j: dict) -> Dict[str, float]:
    """The kernel builds and graph captures in a registry's JSON."""
    total = j.get("mxtpu_compile_total") or {}
    secs = j.get("mxtpu_compile_seconds_total") or {}
    by = total.get("by_label", {}) if isinstance(total, dict) else {}
    by_s = secs.get("by_label", {}) if isinstance(secs, dict) else {}
    return {"nvcc_builds": int(by.get("nvcc", 0)),
            "nvrtc_builds": int(by.get("nvrtc", 0)),
            "captures": int(by.get("graph_capture", 0)),
            "capture_s": float(by_s.get("graph_capture", 0.0))}


def replica_main(registry_root: str, model: str, host: str = "127.0.0.1",
                 port: int = 0, version: str = "current",
                 publish_aot: bool = False, ready_prefix: str =
                 "FLEET_REPLICA_READY", device: Optional[str] = None,
                 **server_kwargs) -> None:
    """Process entry of one fleet replica (``python -m
    mxnet_tpu_torch.serving.serve_fleet --replica`` and
    tests/dist/torch_fleet_replica_worker.py both land here).

    Builds a :class:`FleetServer` from the shared registry on ``device``
    (``"gpu"`` or ``"cpu"``; default the current context, the card), with
    the AOT bundle and the kernel-build cache, binds a
    :class:`ReplicaEndpoint`, prints one ``FLEET_REPLICA_READY {json}``
    line carrying the bound port plus the cold-start evidence — the
    warm-up's signature misses (``warm["compiles"]``, 0 with the bundle),
    ``aot_loaded``, the nvcc and NVRTC builds (0 with a warm cache) and
    the graph captures — then serves until SIGTERM / a ``stop`` op and
    exits resumable (75).
    """
    from ..context import Context
    from ..telemetry import default_registry
    from .aot import enable_compile_cache
    from .fleet import FleetServer
    from .registry import ModelRegistry
    reg = default_registry()
    cache_dir = enable_compile_cache()
    t0 = time.perf_counter()
    server = FleetServer(ModelRegistry(registry_root), model,
                         version=version,
                         ctx=Context(device) if device else None,
                         **server_kwargs)
    aot_published = 0
    if publish_aot:
        aot_published = server.publish_aot()
    endpoint = ReplicaEndpoint(server, host=host, port=port).start()
    print(ready_prefix + " " + json.dumps({
        "port": endpoint.addr[1],
        "pid": os.getpid(),
        "model": model,
        "version": server.active_version,
        "device": str(server.ctx),
        "warm_s": round(time.perf_counter() - t0, 3),
        "warm": server.cold_start_stats,
        "aot_published": aot_published,
        "compile_cache": cache_dir,
        **_build_counts(reg.render_json()),
    }), flush=True)
    endpoint.serve_forever()
