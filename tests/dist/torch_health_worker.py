"""The comm-health plane on gloo ranks (run through
``python -m mxnet_tpu_torch.launch -n N``, driven by
``tests/test_torch_collective_health.py``).

    torch_health_worker.py OUT_DIR

Each rank joins the group, runs the clock handshake, then 6 steps of a
``gluon.Trainer`` over ``dist_sync`` (chaos from ``MXTPU_CHAOS``, the
ledger and watchdog from ``MXTPU_COLL_*``), a comm-health check after
every step, and writes ``health_r<rank>.json``: its ledger records (kind,
key, seq), the last comparison and the summary, the flight records its
watchdog wrote and its final weight.
"""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def main():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    from mxnet_tpu_torch.contrib import chaos
    from mxnet_tpu_torch.telemetry import collective as coll
    out = sys.argv[1]
    with mt.cpu():
        kvstore_server.init_distributed()
        kv = mt.kv.create("dist_sync")
        rank = kv.rank
        spec = os.environ.get("MXTPU_CHAOS", "")
        if os.environ.get("HEALTH_SLOW_RANK") == str(rank):
            spec = "kv_slow:1.0@150"     # this rank enters every exchange late
        plan = chaos.install(chaos.ChaosPlan(spec))
        coll.reset_health()
        off = coll.sync_clocks()
        net = mt.gluon.nn.Dense(3, in_units=4, prefix="hw_")
        net.initialize(mt.init.One())
        tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.1}, kvstore=kv)
        rs = np.random.RandomState(rank)
        for step in range(6):
            x = mt.nd.array(rs.rand(2, 4).astype(np.float32))
            with mt.autograd.record():
                loss = (net(x) ** 2).sum()
            loss.backward()
            tr.step(2)
            coll.health_check(kv)
        res = {"rank": rank, "clock_offset_ms": off,
               "records": [[r["kind"], r["key"], r["seq"]]
                           for r in coll.ledger.records()],
               "summary": coll.health_summary(),
               "injected": dict(plan.injected),
               "weight": net.weight.detach().numpy().tolist()}
    with open(os.path.join(out, f"health_r{rank}.json"), "w") as f:
        json.dump(res, f, default=str)
    print(f"HEALTH_OK {rank}", flush=True)


if __name__ == "__main__":
    main()
