"""What the port's distributed tests share: free ports and the launcher
run (``python -m mxnet_tpu_torch.launch``) of a worker script's ranks."""
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_ports(n=1):
    """A base port with ``n`` free ports from it."""
    for _ in range(50):
        socks = []
        try:
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
            socks.append(s)
            for k in range(1, n):
                t = socket.socket()
                t.bind(("127.0.0.1", base + k))
                socks.append(t)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free port range")


def launch(n, args, extra_env=None, timeout=240):
    """Run ``args`` as ``n`` ranks through the port's launcher, on free
    ports: the coordinator's and the command channel's."""
    env = dict(os.environ)
    env["MXTPU_CMD_PORT_BASE"] = str(free_ports(n))
    # small tensors: one intra-op thread a rank keeps the ranks from
    # crowding out the tests that run beside them
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra_env or {})
    cmd = [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", str(n),
           "--coordinator", f"127.0.0.1:{free_ports()}"] + args
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=ROOT)


def worker(name):
    """The command of ``tests/dist/<name>``."""
    return [sys.executable, os.path.join(ROOT, "tests", "dist", name)]
