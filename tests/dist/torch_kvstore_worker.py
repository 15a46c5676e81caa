"""The dist kvstore on N gloo ranks on the host (run through
``python -m mxnet_tpu_torch.launch -n N``): push / pull sums, several keys,
rank 0's init, 2-bit wire compression (only the packed codes cross), the
ZeRO plane's collectives, and with ``profiler`` as the argument the
remote profiler commands over the worker command channel (rank 0
controls rank 1)."""
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def kvstore_checks(mt, kv, rank, nw):
    import torch
    shape = (3, 4)
    kv.init("w0", mt.nd.array(np.full(shape, 100.0 + rank, np.float32)))
    out = mt.nd.zeros(shape)
    kv.pull("w0", out=out)
    assert np.all(out.asnumpy() == 100.0), "init takes rank 0's value"
    for rnd in range(3):
        kv.push("w0", mt.nd.array(np.full(shape, rank + 1.0 + rnd,
                                          np.float32)))
        kv.pull("w0", out=out)
        want = sum(r + 1.0 + rnd for r in range(nw))
        assert np.allclose(out.asnumpy(), want), (rank, rnd)
    for k, s in (("a", (2, 3)), ("b", (5,))):
        kv.init(k, mt.nd.zeros(s))
        kv.push(k, [mt.nd.array(np.full(s, float(rank), np.float32)),
                    mt.nd.array(np.ones(s, np.float32))])
        o = mt.nd.zeros(s)
        kv.pull(k, out=o)
        assert np.allclose(o.asnumpy(), sum(r + 1.0 for r in range(nw)))

    # 2-bit wire compression: the payload is the packed codes (n/4
    # bytes) and the result the sum of every worker's decoded gradient
    kv2 = mt.kv.create("dist_sync")
    kv2.set_gradient_compression({"type": "2bit", "threshold": 0.5})
    shape = (4, 8)
    n = int(np.prod(shape))
    kv2.init("c0", mt.nd.zeros(shape))
    vals = np.linspace(-1.2, 1.2, n).reshape(shape).astype(np.float32)
    kv2.push("c0", mt.nd.array(vals * (rank + 1)))
    o = mt.nd.zeros(shape)
    kv2.pull("c0", out=o)
    assert kv2._last_wire_bytes == n // 4, kv2._last_wire_bytes
    want = sum(np.where(vals * (r + 1) >= 0.5, 0.5,
                        np.where(vals * (r + 1) <= -0.5, -0.5, 0.0))
               for r in range(nw))
    np.testing.assert_array_equal(o.asnumpy(), want.astype(np.float32))

    # the ZeRO plane's collectives
    flat = torch.arange(12, dtype=torch.float32) * (rank + 1)
    all_parts = [[(0, 5)], [(5, 12)]] + [[] for _ in range(nw - 2)]
    got = kv.zero_reduce_scatter("_gbkt0", mt.nd.NDArray(flat),
                                 all_parts[rank], all_parts=all_parts)
    tot = np.arange(12, dtype=np.float32) * sum(range(1, nw + 1))
    for (lo, hi), g in zip(all_parts[rank], got):
        np.testing.assert_array_equal(g.asnumpy(), tot[lo:hi])
    payload = mt.nd.NDArray(torch.full((rank + 2,), float(rank)))
    ag = kv.zero_allgather("_gbkt0", {rank: payload})
    assert sorted(ag) == list(range(nw))
    for r in range(nw):
        np.testing.assert_array_equal(ag[r].numpy(),
                                      np.full(r + 2, float(r), np.float32))
    assert kv.zero_all_finite(True) is True
    assert kv.zero_all_finite(rank != nw - 1) is False
    flag = kv.zero_all_finite(torch.tensor(rank != 0))
    assert isinstance(flag, torch.Tensor) and not bool(flag)

    # the megastep refuses a real group with the JAX package's words
    from mxnet_tpu_torch import megastep
    net = mt.gluon.nn.Dense(2, in_units=3)
    net.initialize()
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1}, kvstore=kv)
    ms = megastep.Megastep(net, tr, mt.gluon.loss.L2Loss())
    x = mt.nd.array(np.ones((2, 3), np.float32))
    try:
        ms.run(x, mt.nd.array(np.ones((2, 2), np.float32)), 2, 1.0, None)
    except mt.MXNetError as e:
        assert "real multi-worker group" in str(e), e
    else:
        raise AssertionError("the megastep must refuse a real group")


def profiler_checks(mt, kv, rank, nw, out_dir):
    from mxnet_tpu_torch import profiler
    assert profiler._kvstore is kv, "create registers the store"
    if rank == 0:
        kv.send_profiler_command(
            "set_config", json.dumps({
                "filename": os.path.join(out_dir, "remote_prof.json"),
                "aggregate_stats": True}), rank=1)
        kv.send_profiler_command("state", "run", rank=1)
    kv.barrier()
    assert profiler.state() == ("run" if rank == 1 else "stop"), rank
    kv.init("w", mt.nd.zeros((4, 4)))
    for _ in range(3):
        kv.push("w", mt.nd.full((4, 4), float(rank + 1)))
        o = mt.nd.zeros((4, 4))
        kv.pull("w", out=o)
        (o * 2 + 1).asnumpy()
    kv.barrier()
    if rank == 0:
        kv.send_profiler_command("pause", rank=1)
        kv.send_profiler_command("resume", rank=1)
        trace = kv.send_profiler_command("dump", rank=1)[0]
        events = json.loads(trace)["traceEvents"]
        assert any(e.get("name", "").startswith("kv_push:w")
                   for e in events), events[:5]
        table = kv.send_profiler_command("dumps", rank=1)[0]
        assert "Total(ms)" in table, table[:200]
        try:
            kv.send_profiler_command("bogus")
        except mt.MXNetError as e:
            assert "unknown profiler command" in str(e)
        else:
            raise AssertionError("an unknown command must raise")
        profiler.set_state("stop", profile_process="server")
    kv.barrier()
    assert profiler.state() == "stop"
    assert os.path.exists(os.path.join(out_dir, "remote_prof.json")) \
        or rank != 1


def main():
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    what = sys.argv[1]
    with mt.cpu():
        assert kvstore_server.init_distributed()
        kv = mt.kv.create("dist_sync")
        rank, nw = kv.rank, kv.num_workers
        assert kv.type == "dist_tpu_sync" and nw == int(
            os.environ["MXTPU_NUM_WORKERS"])
        if what == "profiler":
            profiler_checks(mt, kv, rank, nw, sys.argv[2])
        else:
            kvstore_checks(mt, kv, rank, nw)
        kv.barrier()
    print(f"worker {rank}/{nw}: {what} checks passed", flush=True)


if __name__ == "__main__":
    main()
