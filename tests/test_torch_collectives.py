"""The port's cross-process collectives (``parallel/collectives.py``) and
2-bit gradient compression (``gradient_compression.py``) against their
definitions and the JAX package.

- ``tests/dist/torch_collectives_worker.py`` on 2 and 3 gloo ranks
  started by the port's launcher: every collective held to its numpy
  definition.
- ``_tile_layout`` equal to the JAX function for ragged layouts.
- ``GradientCompression``: the packed bytes and the residuals equal the
  JAX package's on the same seeded gradients, f32 and bf16, across steps
  of error feedback; ``unpack`` inverts ``pack``.
- Outside a group each collective is its one-rank identity, the
  mesh-taking ones over a one-rank mesh too.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.gradient_compression import GradientCompression as JGC
from mxnet_tpu.parallel import collectives as jcoll

from mxnet_tpu_torch.gradient_compression import GradientCompression as TGC
from mxnet_tpu_torch.parallel import collectives as tcoll

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_common import launch, worker  # noqa: E402


@pytest.mark.parametrize("n", [2, 3])
def test_collectives_on_gloo_ranks(n):
    proc = launch(n, worker("torch_collectives_worker.py"))
    out = proc.stdout + proc.stderr
    assert proc.returncode == 0, out[-3000:]
    for r in range(n):
        assert f"worker {r}/{n}: collectives passed" in out, out[-3000:]


LAYOUTS = [
    ([[(0, 5)], [(5, 12)]], 12),
    ([[(0, 3), (10, 11), (25, 26)], [(3, 10), (11, 25)], [(26, 40)]], 40),
    ([[(0, 40)], [], []], 40),
    ([[], [(0, 1)]], 1),
    ([[(0, 2), (4, 6)], [(2, 4), (6, 8)], [], [(8, 9)]], 9),
]


@pytest.mark.parametrize("all_parts,n", LAYOUTS)
def test_tile_layout_matches_jax(all_parts, n):
    tc, tT, tperm = tcoll._tile_layout(all_parts, n)
    jc, jT, jperm = jcoll._tile_layout(all_parts, n)
    assert (tc, tT) == (jc, jT)
    np.testing.assert_array_equal(tperm, jperm)
    assert tperm.dtype == jperm.dtype == np.int64


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,thr", [((37,), 0.5), ((6, 9), 0.1),
                                       ((4, 4, 4), 1.0)])
def test_compression_bytes_and_residuals_match_jax(shape, thr, dtype):
    rs = np.random.RandomState(11)
    t, j = TGC("2bit", thr), JGC("2bit", thr)
    tdt = getattr(torch, dtype)
    for _ in range(4):
        g = (0.7 * rs.randn(*shape)).astype(np.float32)
        gt = torch.from_numpy(g).to(tdt)
        gj = jnp.asarray(g).astype(dtype)
        tp, tn = t.compress_packed("k", gt)
        jpk, jn = j.compress_packed("k", gj)
        assert tn == jn
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jpk))
        assert tp.dtype == torch.uint8 and tp.numel() == -(-tn // 4)
        np.testing.assert_array_equal(
            t._residuals["k"].float().numpy(),
            np.asarray(j._residuals["k"]).astype(np.float32))
        td = t.decode_packed(tp, tn, shape, tdt)
        jd = j.decode_packed(jpk, jn, shape, gj.dtype)
        np.testing.assert_array_equal(td.float().numpy(),
                                      np.asarray(jd).astype(np.float32))


def test_pack_unpack_round_trip():
    q = torch.tensor([1, 0, -1, -1, 0, 1, 1], dtype=torch.int8)
    packed = TGC.pack(q)
    assert packed.tolist() == [0b10100001, 0b00010100]
    np.testing.assert_array_equal(TGC.unpack(packed, 7).numpy(), q.numpy())
    np.testing.assert_array_equal(
        np.asarray(JGC().pack(jnp.asarray(q.numpy()))), packed.numpy())
    with pytest.raises(Exception, match="unsupported compression"):
        TGC("1bit")
    with pytest.raises(Exception, match="threshold"):
        TGC("2bit", 0.0)


def test_one_rank_identities_outside_a_group():
    x = torch.arange(10, dtype=torch.float32)
    assert tcoll.world() == 1 and tcoll.rank() == 0
    assert tcoll.backend() is None
    assert tcoll.cross_process_allreduce(x) is x
    assert torch.equal(tcoll.cross_process_allgather(x), x[None])
    outs = tcoll.cross_process_reduce_scatter(x, [(0, 3), (7, 10)],
                                              all_parts=[[(0, 3), (7, 10)]])
    assert [o.tolist() for o in outs] == [[0.0, 1.0, 2.0], [7.0, 8.0, 9.0]]
    assert tcoll.cross_process_allgather_ragged(x[:3])[0] is not None
    assert tcoll.cross_process_exchange_bytes(b"ab") == [b"ab"]
    assert tcoll.cross_process_allgather_object({"a": 1}) == [{"a": 1}]
    assert [m["rank"] for m in tcoll.cross_process_reform("x", 1)] == [0]
    tcoll.barrier()
    assert tcoll.loopback_psum(x) is x
    assert torch.equal(tcoll.loopback_psum(x, [x, x]), 2 * x)
    assert jnp.array_equal(jcoll.loopback_psum(jnp.arange(3.0)),
                           jnp.arange(3.0))


@pytest.mark.parametrize("name", ["allreduce", "allgather", "reduce_scatter",
                                  "broadcast", "ppermute_ring", "all_to_all",
                                  "device_allreduce",
                                  "measure_allreduce_bandwidth",
                                  "make_host_mesh"])
def test_mesh_functions_raise_a10(name):
    """The mesh-taking functions are ported (the name is kept from when
    they raised naming A10): at world 1 each runs over a one-rank mesh as
    its definition gives (the identity; the bandwidth probe measures
    nothing to move), and without a mesh each refuses, as the JAX
    functions need one."""
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.parallel.mesh import make_mesh
    assert callable(getattr(jcoll, name))
    fn = getattr(tcoll, name)
    with mt.cpu():
        mesh = make_mesh({"dp": 1})
        x = torch.arange(4.0)
        if name == "make_host_mesh":
            assert fn().shape == {"hosts": 1}
            return
        if name == "measure_allreduce_bandwidth":
            assert fn(mesh, size_mb=0.01, axis="dp", iters=1) == 0.0
            with pytest.raises(mt.MXNetError, match="Mesh"):
                fn(None)
            return
        if name == "device_allreduce":
            assert fn([x], mesh, axis="dp")[0] is x
        else:
            assert fn(x, mesh, "dp") is x
        with pytest.raises(mt.MXNetError, match="Mesh"):
            fn([x] if name == "device_allreduce" else x, None)
