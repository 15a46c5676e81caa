"""Each cross-process collective of ``mxnet_tpu_torch.parallel.collectives``
held to its numpy definition, on N gloo ranks on the host (run through
``python -m mxnet_tpu_torch.launch -n N``). Every rank draws every rank's
inputs from one seed, so each can compute the definition itself."""
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))


def main():
    import torch
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    from mxnet_tpu_torch.parallel import collectives as C
    with mt.cpu():
        assert kvstore_server.init_distributed()
    info = kvstore_server.group_info()
    rank, n = info["rank"], info["world"]
    assert info["backend"] == "gloo" and C.world() == n and C.rank() == rank
    rs = np.random.RandomState(7)
    xs = [rs.randn(5, 3).astype(np.float32) for _ in range(n)]
    mine = torch.from_numpy(xs[rank].copy())

    for op, want in (("sum", sum(xs[1:], xs[0].copy())),
                     ("mean", sum(xs[1:], xs[0].copy()) / n),
                     ("max", np.maximum.reduce(xs)),
                     ("min", np.minimum.reduce(xs))):
        t = mine.clone()
        out = C.cross_process_allreduce(t, op=op)
        assert out is t, "allreduce is in place"
        np.testing.assert_allclose(t.numpy(), want, rtol=1e-6, atol=1e-7,
                                   err_msg=op)

    got = C.cross_process_allgather(mine)
    np.testing.assert_array_equal(got.numpy(), np.stack(xs))

    # ragged segments of a 40-element buffer: rank r owns every
    # parameter-sized run whose index is r mod n (rank n-1 may own none)
    flat = [rs.randn(40).astype(np.float32) for _ in range(n)]
    bounds = [0, 3, 10, 11, 25, 26, 40]
    segs = list(zip(bounds, bounds[1:]))
    all_parts = [[s for k, s in enumerate(segs) if k % n == r]
                 for r in range(n)]
    total = sum(flat[1:], flat[0].copy())
    local = torch.from_numpy(flat[rank].copy())
    for ap in (all_parts, None):
        outs = C.cross_process_reduce_scatter(local, all_parts[rank],
                                              all_parts=ap)
        assert len(outs) == len(all_parts[rank])
        for (lo, hi), o in zip(all_parts[rank], outs):
            np.testing.assert_allclose(o.numpy(), total[lo:hi], rtol=1e-6,
                                       atol=1e-7)
    np.testing.assert_array_equal(local.numpy(), flat[rank])

    sizes = [r + 1 for r in range(n)]
    rag = C.cross_process_allgather_ragged(
        torch.arange(sizes[rank], dtype=torch.float32) + 10 * rank)
    for r, t in enumerate(rag):
        np.testing.assert_array_equal(
            t.numpy(), np.arange(sizes[r], dtype=np.float32) + 10 * r)
    rag2 = C.cross_process_allgather_ragged(
        torch.arange(sizes[rank], dtype=torch.float32), sizes=sizes)
    assert [t.numel() for t in rag2] == sizes

    blobs = C.cross_process_exchange_bytes(b"r%d" % rank * (rank + 1))
    assert blobs == [b"r%d" % r * (r + 1) for r in range(n)]
    objs = C.cross_process_allgather_object({"rank": rank, "sq": rank ** 2})
    assert objs == [{"rank": r, "sq": r * r} for r in range(n)]
    roster = C.cross_process_reform("t", expect=n)
    assert [m["rank"] for m in roster] == list(range(n))
    assert len({m["pid"] for m in roster}) == n
    try:
        C.cross_process_reform("bad", expect=n + 1)
    except mt.MXNetError as e:
        assert "expects world" in str(e)
    else:
        raise AssertionError("a wrong expected world must raise")
    C.barrier()
    assert C.loopback_psum(mine) is mine
    print(f"worker {rank}/{n}: collectives passed "
          f"{sorted(k for k, v in C.routes.items() if v)}", flush=True)


if __name__ == "__main__":
    main()
