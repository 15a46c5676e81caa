"""Data-parallel training on N gloo ranks on the host (run through
``python -m mxnet_tpu_torch.launch -n N``): each rank steps a
``gluon.Trainer`` over ``mx.kv.create("dist_sync")``, and writes its
final weights for the test to hold against the JAX package and against
the other modes.

    torch_train_worker.py OUT_DIR MODE:OPT [MODE:OPT ...]

MODE joins with ``+``: ``perkey`` (``MXTPU_GRAD_BUCKET_MB=0``; default
one flat bucket), ``zero`` (``MXTPU_ZERO=1``), ``compress`` (2-bit
compression through ``compression_params``), ``overlap``
(``MXTPU_COMM_OVERLAP=on``), ``net`` (a two-layer net's real backward on
each rank's seeded batch; default each rank's seeded gradients set on
the same seeded parameters), e.g. ``zero+net+overlap:sgd``.
"""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

SHAPES = [(3, 2), (3, 3), (3, 4), (3, 5), (3, 6), (3, 7)]
STEPS = 3
OPTS = {"sgd": {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01},
        "adam": {"learning_rate": 0.01, "wd": 0.001}}


def grads(step, rank):
    """Rank ``rank``'s gradients at ``step`` (the test draws the same)."""
    rs = np.random.RandomState(1000 * step + rank)
    return [rs.randn(*s).astype(np.float32) for s in SHAPES]


def init_weights():
    rs = np.random.RandomState(0)
    return [rs.randn(*s).astype(np.float32) for s in SHAPES]


def batch(step, rank):
    rs = np.random.RandomState(500 + 10 * step + rank)
    return (rs.randn(4, 6).astype(np.float32),
            rs.randn(4, 3).astype(np.float32))


def run(mt, out_dir, mode, opt):
    import torch
    from mxnet_tpu_torch.base import env
    flags = set(mode.split("+"))
    env.set("MXTPU_GRAD_BUCKET_MB", "0" if "perkey" in flags else None)
    env.set("MXTPU_ZERO", "1" if "zero" in flags else None)
    env.set("MXTPU_COMM_OVERLAP", "on" if "overlap" in flags else None)
    comp = {"type": "2bit", "threshold": 0.5} if "compress" in flags \
        else None
    launched = 0
    with mt.cpu():
        kv = mt.kv.create("dist_sync")
        rank, n = kv.rank, kv.num_workers
        if "net" in flags:
            net = mt.gluon.nn.HybridSequential()
            net.add(mt.gluon.nn.Dense(5, in_units=6),
                    mt.gluon.nn.Dense(3, in_units=5))
            net.initialize(mt.init.Xavier(), generator=mt.random.seed(3))
            params = net.collect_params()
            tr = mt.gluon.Trainer(params, opt, dict(OPTS[opt]), kvstore=kv,
                                  compression_params=comp)
            for step in range(STEPS):
                x, y = (mt.nd.array(a) for a in batch(step, rank))
                with mt.autograd.record():
                    loss = ((net(x) - y) ** 2).mean()
                with tr.overlap_scope() as scope:
                    assert scope.active == ("overlap" in flags)
                    loss.backward()
                launched += getattr(scope, "launched_in_backward", 0)
                tr.step(4)
            names = sorted(params.keys())
            ws = [params[k].data().asnumpy() for k in names]
        else:
            ps = []
            for j, (s, w) in enumerate(zip(SHAPES, init_weights())):
                p = mt.gluon.Parameter(f"p{j}", shape=s)
                p.initialize(mt.init.Constant(0.0))
                p.set_data(w)
                ps.append(p)
            tr = mt.gluon.Trainer(ps, opt, dict(OPTS[opt]), kvstore=kv,
                                  compression_params=comp)
            for step in range(STEPS):
                for p, g in zip(ps, grads(step, rank)):
                    p.grad()._data.copy_(torch.from_numpy(g))
                    p._fresh_grad = True
                tr.step(4)
            ws = [p.data().asnumpy() for p in ps]
            names = [p.name for p in ps]
        counts = {"allreduce": tr.last_allreduce_collectives,
                  "reduce_scatter": tr.last_reduce_scatter_collectives,
                  "allgather": tr.last_allgather_collectives}
        tag = f"{mode}:{opt}"
        if "zero" in flags:
            assert tr._zero.distributed and tr._zero.world == n
            own = {i for i, r in enumerate(tr._zero.owners) if r == rank}
            assert set(tr._updaters[0].states) == own, \
                "optimizer state lives on its owner alone"
            states = tr.get_states_bytes()      # gather-on-save
            if rank == 0:
                with open(os.path.join(out_dir, f"{tag}.states"),
                          "wb") as f:
                    f.write(states)
        np.savez(os.path.join(out_dir, f"{tag}_r{rank}.npz"),
                 names=np.array(names), counts=np.array(
                     [counts[k] for k in sorted(counts)]),
                 launched=np.array(launched),
                 **{f"w{k}": w for k, w in enumerate(ws)})
        kv.barrier()
    print(f"worker {rank}/{n}: {tag} done {counts}", flush=True)


def main():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    with mt.cpu():
        assert kvstore_server.init_distributed()
    for spec in sys.argv[2:]:
        mode, opt = spec.split(":")
        run(mt, sys.argv[1], mode, opt)


if __name__ == "__main__":
    main()
