"""The cross-rank planes on gloo ranks (run through
``python -m mxnet_tpu_torch.launch -n N``, driven by
``tests/test_torch_elastic_group.py``).

    torch_planes_worker.py OUT_DIR

A two-layer net through ``FitLoop`` over ``dist_sync`` with a ``local``
fallback at world 1, the global batch ``G`` at every world, the flags
from the environment (``MXTPU_ZERO``, ``MXTPU_NUMERICS``,
``MXTPU_CHAOS``, ``MXTPU_RUN_REPORT_DIR`` ...). Writes
``planes_r<rank>.json``: the numerics summary, the run report's path,
the final weights.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

N, G = 32, 8


def main():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    out = sys.argv[1]
    with mt.cpu():
        kvstore_server.init_distributed()
        kv = mt.kv.create("dist_sync")
        rank, nw = kv.rank, kv.num_workers
        rs = np.random.RandomState(42)
        X = rs.rand(N, 6).astype(np.float32)
        Y = rs.rand(N, 2).astype(np.float32)
        it = mt.io.NDArrayIter(X, Y, batch_size=G // nw, shuffle=False,
                               num_parts=nw, part_index=rank)
        net = mt.gluon.nn.HybridSequential(prefix="pl_")
        with net.name_scope():
            net.add(mt.gluon.nn.Dense(8, activation="relu", in_units=6),
                    mt.gluon.nn.Dense(2, in_units=8))
        mt.random.seed(3)
        net.initialize(mt.init.Xavier())
        tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9},
                              kvstore=kv if nw > 1 else mt.kv.create("local"))
        loop = mt.fit.FitLoop(net, tr,
                              lambda o, y: ((o - y) ** 2).sum(axis=1), it,
                              heartbeat=False)
        res = loop.fit(epochs=1, batch_size=G)
        rec = {"rank": rank, "world": nw, "numerics": res.numerics,
               "run_report": res.run_report, "zero": res.zero,
               "skipped": res.skipped_steps,
               "weights": {k: p.tensor.detach().numpy().tolist()
                           for k, p in net.collect_params().items()}}
    with open(os.path.join(out, f"planes_r{rank}.json"), "w") as f:
        json.dump(rec, f, default=str)
    print(f"PLANES_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
