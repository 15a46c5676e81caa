"""A generation of the self-healing fleet on gloo ranks (run through
``python -m mxnet_tpu_torch.launch [--supervise]``, driven by
``tests/test_torch_supervisor.py``).

The supervisor relaunches this worker at whatever world it decided,
stamping ``MXTPU_SUPERVISE_GEN``; the worker rebuilds the rest from disk:

1. it brings its per-rank checkpoint dir up to the newest checkpoint any
   rank holds (checkpoints are the same on every rank: replicated
   weights, trainer states of the whole model);
2. it installs this generation's scripted chaos (``FLEET_EVENTS``, JSON
   keyed by generation: ``kill`` / ``kv_hang`` of a rank, at the
   checkpoint's step plus ``offset``), or, for an unsupervised
   reference segment, ``FLEET_STOP=STEP:WORLD`` (``resize@STEP:WORLD``:
   a final checkpoint at STEP and the resumable exit);
3. it trains ``FitLoop`` (a two-layer net, ``dist_sync`` over the group,
   momentum SGD, the global batch ``G`` at every world) and writes
   ``gen<g>_r<rank>.json`` with the step it started from, and, when it
   finishes, its final weights.

Below the target world a generation sleeps ``FLEET_STEP_SLEEP_MS`` a
step, so the shrunken fleet is still training when the capacity model
offers the lost slot back.
"""
import json
import os
import shutil
import signal
import sys
import time

# a SIGTERM before FitLoop installs its handler (the supervisor growing
# the fleet while this process still imports) exits resumable: nothing
# is trained yet
try:
    _RESUMABLE = int(os.environ.get("MXTPU_RESUMABLE_EXIT_CODE", "75"))
except ValueError:
    _RESUMABLE = 75
signal.signal(signal.SIGTERM, lambda *_: os._exit(_RESUMABLE))

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

N, G, SEED, EPOCHS = 64, 8, 7, 3       # 8 steps an epoch, 24 in all


def make_data():
    rs = np.random.RandomState(42)
    return (rs.rand(N, 6).astype(np.float32),
            rs.rand(N, 2).astype(np.float32))


def latest_step(ck):
    """Newest DONE-marked checkpoint step in ``ck`` (0 when none)."""
    best = 0
    if os.path.isdir(ck):
        for name in os.listdir(ck):
            if name.startswith("ckpt-") and "." not in name and \
                    os.path.exists(os.path.join(ck, name, "DONE")):
                try:
                    best = max(best, int(name.split("-", 1)[1]))
                except ValueError:
                    pass
    return best


def sync_ckpt(out_dir, rank):
    """Bring this rank's checkpoint dir up to the newest any rank holds
    (each rank replaces only its own dir; nobody writes before the first
    step's collective, which needs every rank past here)."""
    ck = os.path.join(out_dir, f"ckpt_r{rank}")
    peers = [os.path.join(out_dir, d) for d in os.listdir(out_dir)
             if d.startswith("ckpt_r")]
    best = max(peers, key=latest_step, default=None)
    if best and best != ck and latest_step(best) > latest_step(ck):
        if os.path.isdir(ck):
            shutil.rmtree(ck)
        shutil.copytree(best, ck)
    return ck


def chaos_spec(rank, gen, base):
    stop = os.environ.get("FLEET_STOP")
    if stop:
        step, world = stop.split(":")
        return f"resize@{int(step)}:{int(world)}"
    ev = json.loads(os.environ.get("FLEET_EVENTS", "{}")).get(str(gen))
    if not ev:
        return ""
    step = base + int(ev.get("offset", 2))
    if ev["kind"] == "kill":
        return f"kill@{step}" if rank == int(ev["rank"]) else ""
    if ev["kind"] == "kv_hang":
        return f"kv_hang:{int(ev['rank'])}@{step}"
    raise SystemExit(f"unknown scripted event {ev}")


def main():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    from mxnet_tpu_torch.base import env
    from mxnet_tpu_torch.contrib.chaos import ChaosKilled
    out_dir = os.environ["FLEET_OUT_DIR"]
    target = int(os.environ["FLEET_TARGET"])
    gen = int(os.environ.get("MXTPU_SUPERVISE_GEN", "0"))
    sleep_ms = float(os.environ.get("FLEET_STEP_SLEEP_MS", "0"))
    with mt.cpu():
        kvstore_server.init_distributed()
        kv = mt.kv.create("dist_sync")
        rank, nw = kv.rank, kv.num_workers
        ck = sync_ckpt(out_dir, rank)
        base = latest_step(ck)
        spec = chaos_spec(rank, gen, base)
        env.set("MXTPU_CHAOS", spec or None)
        X, Y = make_data()
        it = mt.io.NDArrayIter(X, Y, batch_size=G // nw, shuffle=True,
                               seed=SEED, num_parts=nw, part_index=rank)
        net = mt.gluon.nn.HybridSequential(prefix="fleet_")
        with net.name_scope():
            net.add(mt.gluon.nn.Dense(8, activation="relu", in_units=6),
                    mt.gluon.nn.Dense(2, in_units=8))
        mt.random.seed(3)
        net.initialize(mt.init.Xavier())
        tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9},
                              kvstore=kv)
        rec = {"gen": gen, "world": nw, "rank": rank, "start": base,
               "chaos": spec}
        path = os.path.join(out_dir, f"gen{gen}_r{rank}.json")
        with open(path, "w") as f:
            json.dump(rec, f)

        def on_step_end(step, loss):
            if nw < target and sleep_ms > 0:
                time.sleep(sleep_ms / 1000.0)

        loop = mt.fit.FitLoop(
            net, tr, lambda out, y: ((out - y) ** 2).sum(axis=1), it,
            ckpt_dir=ck, ckpt_every=int(os.environ.get("FLEET_CKPT_EVERY",
                                                       "2")),
            async_ckpt=False, heartbeat=False, seed=SEED,
            on_step_end=on_step_end)
        try:
            res = loop.fit(epochs=EPOCHS, batch_size=G)
        except ChaosKilled:
            # a real kill does not unwind the group's exit handshake
            os._exit(1)
        rec.update(end=res.step, elastic=res.elastic,
                   comm_health=bool(res.comm_health),
                   weights={k: p.tensor.detach().numpy().tolist()
                            for k, p in net.collect_params().items()})
        with open(path, "w") as f:
            json.dump(rec, f)
    print(f"FLEET_DONE rank {rank} world {nw} gen {gen} step {res.step}",
          flush=True)


if __name__ == "__main__":
    main()
