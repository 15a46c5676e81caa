"""The port's meshes against the JAX package's: ``parallel/{mesh,sharding,
compat}.py``, the mesh collectives of ``parallel/collectives.py``, ring
attention and the GPipe pipeline.

The port's ranks run over gloo through the launcher
(``tests/dist/torch_mesh_worker.py``, each rank on its local blocks,
rank 0 writing the gathered results); the JAX functions run here on the
8-device CPU mesh of ``tests/conftest.py``, on the same numpy inputs.
The mesh examples' recipes (``tests/dist/torch_mesh_examples.py``) are
held to the JAX examples' own functions. Tolerances are the JAX tests'
own (``tests/test_parallel.py``):
ring attention 1e-4, the pipeline 1e-5 forward and 1e-4 gradients, the
collectives exact (they move f32 values; sums of two or four terms).
The collectives' gradients are held to their definitions: a rank's loss
is its own term and the group's loss their sum (the module docstring of
``parallel/collectives.py``).
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

from mxnet_tpu import parallel as jpar
from mxnet_tpu.parallel import collectives as jcoll
from mxnet_tpu.parallel.ring_attention import attention as jattention

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.parallel import collectives as tcoll
from mxnet_tpu_torch.parallel import compat as tcompat
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import sharding as tsh

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "dist"))
from torch_dist_common import launch, worker  # noqa: E402
import torch_mesh_worker as W  # noqa: E402
import torch_mesh_examples as W_EX  # noqa: E402


def _run(tmp_path_factory, n, cases):
    out = tmp_path_factory.mktemp(f"mesh{n}")
    proc = launch(n, worker("torch_mesh_worker.py") + [str(out)] + cases,
                  timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    assert proc.stdout.count("MESH_WORKER_OK") == n
    return {c: dict(np.load(out / f"{c}.npz")) for c in cases}


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return _run(tmp_path_factory, 2, ["coll", "ring_causal", "ring_full",
                                      "pipe"])


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return _run(tmp_path_factory, 4, ["coll", "pipe"])


def _jmesh(**axes):
    n = int(np.prod(list(axes.values())))
    return jpar.make_mesh(axes, jax.devices()[:n])


def _coll_inputs(n):
    rs = np.random.RandomState(11)
    return (rs.randn(2 * n, 4).astype(np.float32),
            rs.randn(2 * n, 4).astype(np.float32))


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_forward_against_jax(n, two, four):
    got = (two if n == 2 else four)["coll"]
    x, w = _coll_inputs(n)
    m = _jmesh(dp=n)
    sharded = jax.device_put(jnp.asarray(x), NamedSharding(m, JP("dp")))
    np.testing.assert_array_equal(
        got["allgather"], np.asarray(jcoll.allgather(sharded, m, "dp")))
    np.testing.assert_array_equal(
        got["reduce_scatter"],
        np.asarray(jcoll.reduce_scatter(jnp.asarray(x), m, "dp")))
    np.testing.assert_array_equal(
        got["ppermute"], np.asarray(jcoll.ppermute_ring(sharded, m, "dp")))
    np.testing.assert_array_equal(
        got["all_to_all"],
        np.asarray(jcoll.all_to_all(sharded, m, "dp", split_axis=1,
                                    concat_axis=0)))
    # the JAX allreduce / broadcast take replicated inputs: the port's
    # block versions against their definitions, and the JAX functions'
    # own definitions checked on the same values
    blocks = x.reshape(n, 2, 4)
    np.testing.assert_allclose(got["allreduce"], blocks.sum(0), rtol=0,
                               atol=1e-6)
    np.testing.assert_array_equal(got["max"], blocks.max(0))
    np.testing.assert_array_equal(got["broadcast"], blocks[n - 1])
    np.testing.assert_allclose(
        np.asarray(jcoll.allreduce(jnp.asarray(blocks[0]), m, "dp")),
        n * blocks[0], rtol=1e-6)
    assert float(got["bw"]) > 0


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_gradients_are_the_transposes(n, two, four):
    got = (two if n == 2 else four)["coll"]
    x, w = _coll_inputs(n)
    wb = w.reshape(n, 2, 4)
    np.testing.assert_allclose(got["allreduce_grad"],
                               np.tile(wb.sum(0), (n, 1)), atol=1e-6)
    np.testing.assert_allclose(got["allgather_grad"], n * w, atol=1e-6)
    np.testing.assert_allclose(got["reduce_scatter_grad"], w, atol=0)
    np.testing.assert_array_equal(got["ppermute_grad"],
                                  np.roll(wb, -1, axis=0).reshape(-1, 4))
    np.testing.assert_allclose(got["all_to_all_grad"], x, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_against_jax(causal, two):
    got = two["ring_causal" if causal else "ring_full"]
    q, k, v, w = W.ring_inputs()
    m = _jmesh(sp=2)
    spec = NamedSharding(m, JP(None, "sp"))
    want = jpar.ring_attention(*(jax.device_put(jnp.asarray(a), spec)
                                 for a in (q, k, v)), m, axis="sp",
                               causal=causal)
    np.testing.assert_allclose(got["out"], np.asarray(want), atol=1e-4)
    # the gradients against the plain attention's
    grads = jax.grad(lambda a, b, c: jnp.sum(
        jattention(a, b, c, causal=causal) * w), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    for name, g in zip("qkv", grads):
        np.testing.assert_allclose(got[f"d{name}"], np.asarray(g),
                                   atol=1e-4)


@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_against_jax(S, two, four):
    got = (two if S == 2 else four)["pipe"]
    ws, x = W.pipe_inputs(S)
    m = _jmesh(pp=S)
    params = jax.device_put(jnp.asarray(ws), NamedSharding(m, JP("pp")))

    def stage_fn(p, h):
        return jnp.tanh(h @ p)

    y = jpar.pipeline_apply(stage_fn, params, jnp.asarray(x), m, "pp",
                            n_microbatches=4)
    np.testing.assert_allclose(got["y"], np.asarray(y), atol=1e-5)

    def seq(p, h):
        for i in range(S):
            h = jnp.tanh(h @ p[i])
        return jnp.sum(h)

    gw, gx = jax.grad(seq, argnums=(0, 1))(jnp.asarray(ws), jnp.asarray(x))
    np.testing.assert_allclose(got["dw"], np.asarray(gw), atol=1e-4)
    np.testing.assert_allclose(got["dx"], np.asarray(gx), atol=1e-4)


def test_mesh_at_world_one_matches_jax_shapes():
    """Without a group: every axis of size 1, ``-1`` inferred, the
    collectives the identity, and the sizes the JAX mesh reads."""
    with mt.cpu():
        m = tmesh.make_mesh({"dp": -1, "tp": 1})
        jm = jpar.make_mesh({"dp": -1, "tp": 1}, jax.devices()[:1])
        assert dict(zip(m.axis_names, m.devices.shape)) == \
            dict(zip(jm.axis_names, jm.devices.shape))
        assert tmesh.axis_size(m, "tp") == 1 and m.group("dp") is None
        assert tmesh.axis_size(m, "sp") == jpar.mesh.axis_size(jm, "sp")
        with tmesh.MeshScope(m):
            assert tmesh.current_mesh() is m
        assert tmesh.current_mesh() is None
        x = torch.arange(6.0).reshape(2, 3)
        for fn in (tcoll.allreduce, tcoll.allgather, tcoll.reduce_scatter,
                   tcoll.broadcast):
            assert fn(x, m, "dp") is x
        assert tcoll.ppermute_ring(x, m, "dp") is x
        assert tcoll.all_to_all(x, m, "dp") is x
        tcoll.barrier(m)
        assert tcoll.make_host_mesh().shape == {"hosts": 1}
        with pytest.raises(mt.MXNetError, match="cannot infer"):
            tmesh.make_mesh({"dp": -1, "tp": 3}, devices=[0, 1])
        with pytest.raises(mt.MXNetError, match="needs 4 devices"):
            tmesh.make_mesh({"dp": 4})
        with pytest.raises(mt.MXNetError, match="no axis"):
            tcoll.allreduce(x, m, "sp")
        with pytest.raises(mt.MXNetError, match="Mesh"):
            tcoll.allreduce(x, object(), "dp")


def test_sharding_rules_and_shard_map():
    """``P``, ``ShardingPlan.spec_for`` and ``MP_RULES_TRANSFORMER`` choose
    what the JAX package's choose; ``local_block`` / ``gather`` at world 1
    keep the tensor; ``shard_map`` runs ``f`` with the mesh current."""
    from mxnet_tpu.parallel import sharding as jsh
    assert tuple(tsh.P(None, "tp")) == tuple(jsh.P(None, "tp"))
    rules = [(r"dense.*weight", ("dp", None)), (r"bias", ("dp",))]
    tplan = tsh.ShardingPlan([(p, tsh.P(*s)) for p, s in rules])
    jplan = jsh.ShardingPlan([(p, jsh.P(*s)) for p, s in rules])
    for name, shape in (("dense0_weight", (4, 3)), ("dense0_bias", (4,)),
                        ("conv0_weight", (4, 3, 3, 3)), ("x", ())):
        assert tuple(tplan.spec_for(name, shape)) == \
            tuple(jplan.spec_for(name, shape))
    tmp = tsh.ShardingPlan(tsh.MP_RULES_TRANSFORMER)
    jmp = jsh.ShardingPlan(jsh.MP_RULES_TRANSFORMER)
    for name in ("layer0/w_qkv", "layer0/wo", "embed", "layer1/ffn_in",
                 "layer1/ffn_out", "ln_f_scale"):
        assert tuple(tmp.spec_for(name, (8, 8))) == \
            tuple(jmp.spec_for(name, (8, 8)))
    with mt.cpu():
        m = tmesh.make_mesh({"dp": 1})
        x = torch.arange(12.0).reshape(4, 3)
        assert torch.equal(tsh.local_block(x, tsh.P("dp"), m), x)
        assert torch.equal(tsh.gather(x, tsh.P("dp"), m), x)
        assert torch.equal(tsh.shard_batch(x, m), x)
        with pytest.raises(mt.MXNetError, match="more entries"):
            tsh.local_block(x, tsh.P("dp", None, None), m)
        seen = []
        f = tcompat.shard_map(
            lambda a: seen.append((tcompat.axis_index("dp"),
                                   tmesh.current_mesh())) or a * 2,
            mesh=m, in_specs=(tsh.P("dp"),), out_specs=tsh.P("dp"))
        assert torch.equal(f(x), x * 2) and seen == [(0, m)]
        assert tcompat.HAVE_SHARD_MAP
        with pytest.raises(mt.MXNetError, match="names axis"):
            tcompat.shard_map(lambda a: a, m, (tsh.P("tp"),), tsh.P())


# ---------------------------------------------------------------------
# the mesh examples' recipes (tests/dist/torch_mesh_examples.py)
# ---------------------------------------------------------------------

def _example(path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LC = dict(dp=1, sp=2, seq_len=32, batch=2, d_model=16, n_heads=2, layers=1,
          vocab=17, steps=3, lr=3e-3)


def test_long_context_example_against_jax(tmp_path):
    """The recipe of ``examples/long_context/train_long_context.py`` on two
    gloo ranks ({dp: 1, sp: 2}, ring attention) against the example's own
    ``build_params`` and ``forward`` with its Adam step, on two of the CPU
    mesh's devices: losses and final weights within 1e-4 (f32)."""
    ex = _example("examples/long_context/train_long_context.py")
    a = LC
    params = ex.build_params(jax.random.PRNGKey(0), a["vocab"],
                             a["d_model"], a["n_heads"], 4 * a["d_model"],
                             a["layers"])
    flat = {"embed": params["embed"], "out": params["out"]}
    for i, layer in enumerate(params["layers"]):
        flat.update({f"layers/{i}/{k}": v for k, v in layer.items()})
    np.savez(tmp_path / "init.npz", **{k: np.asarray(v)
                                       for k, v in flat.items()})
    mesh = jpar.make_mesh({"dp": a["dp"], "sp": a["sp"]},
                          jax.devices()[:a["dp"] * a["sp"]])
    rs = np.random.RandomState(0)
    pat = rs.randint(1, a["vocab"], (a["batch"], 16))
    fixed = np.tile(pat, (1, (a["seq_len"] + 16) // 16 + 1))[
        :, :a["seq_len"] + 1]
    toks, tgts = (jnp.asarray(x.astype(np.int32))
                  for x in (fixed[:, :-1], fixed[:, 1:]))

    def loss_fn(p):
        logits = ex.forward(p, toks, mesh, a["n_heads"])
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return jnp.mean(-jnp.take_along_axis(logp, tgts[..., None],
                                             axis=-1)[..., 0])
    m = jax.tree_util.tree_map(jnp.zeros_like, params)
    v = jax.tree_util.tree_map(jnp.zeros_like, params)
    losses = []
    for t in range(1, a["steps"] + 1):
        loss, g = jax.value_and_grad(loss_fn)(params)
        m = jax.tree_util.tree_map(lambda x, y: 0.9 * x + 0.1 * y, m, g)
        v = jax.tree_util.tree_map(lambda x, y: 0.999 * x + 0.001 * y * y,
                                   v, g)
        lr_t = a["lr"] * np.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)
        params = jax.tree_util.tree_map(
            lambda w, mi, vi: w - lr_t * mi / (jnp.sqrt(vi) + 1e-8),
            params, m, v)
        losses.append(float(loss))
    args = [f"--{k.replace('_', '-')}={val}" for k, val in a.items()]
    proc = launch(2, worker("torch_mesh_examples.py") +
                  ["long_context", str(tmp_path), "--cpu"] + args,
                  timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    got = dict(np.load(tmp_path / "long_context.npz"))
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-4)
    want = [params["embed"], params["out"]] + [
        layer[k] for layer in params["layers"]
        for k in ("qkv", "proj", "ff1", "ff2")]
    for j, w in enumerate(want):
        np.testing.assert_allclose(got[f"w{j}"], np.asarray(w), atol=1e-4)


MF = dict(dp=1, mp=2, num_users=40, num_items=20, factors=8, batch_size=16,
          steps=3, lr=0.05)


def test_matrix_factorization_example_against_jax(tmp_path):
    """The recipe of ``examples/model_parallel/matrix_factorization.py``
    on two gloo ranks ({dp: 1, mp: 2}: each rank holds half the rows of
    both tables) against the example's step (its loss and SGD, written
    here, with its tables sharded ``P("mp", None)`` on two CPU devices)
    from the same initial tables on the example's ratings: losses and
    final tables within 1e-5 (f32)."""
    a = MF
    rs = np.random.RandomState(5)
    ue = (rs.randn(a["num_users"], a["factors"]) * 0.01).astype(np.float32)
    ie = (rs.randn(a["num_items"], a["factors"]) * 0.01).astype(np.float32)
    np.savez(tmp_path / "init.npz", user_embed=ue, item_embed=ie)
    users, items, ratings = W_EX.mf_data(a["num_users"], a["num_items"])
    mesh = jpar.make_mesh({"dp": a["dp"], "mp": a["mp"]},
                          jax.devices()[:a["dp"] * a["mp"]])
    sh = NamedSharding(mesh, JP("mp", None))
    params = {"user_embed": jax.device_put(jnp.asarray(ue), sh),
              "item_embed": jax.device_put(jnp.asarray(ie), sh)}

    def loss_fn(p, u, i, r):
        pred = jnp.sum(p["user_embed"][u] * p["item_embed"][i], axis=1)
        return jnp.mean(jnp.square(pred - r))
    losses = []
    for s in range(a["steps"]):
        b0 = (s * a["batch_size"]) % (len(users) - a["batch_size"])
        sl = slice(b0, b0 + a["batch_size"])
        loss, g = jax.value_and_grad(loss_fn)(
            params, jnp.asarray(users[sl].astype(np.int32)),
            jnp.asarray(items[sl].astype(np.int32)), jnp.asarray(ratings[sl]))
        params = jax.tree_util.tree_map(lambda w, gr: w - a["lr"] * gr,
                                        params, g)
        losses.append(float(loss))
    args = [f"--{k.replace('_', '-')}={val}" for k, val in a.items()]
    proc = launch(2, worker("torch_mesh_examples.py") +
                  ["matrix_factorization", str(tmp_path), "--cpu"] + args,
                  timeout=240)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    got = dict(np.load(tmp_path / "matrix_factorization.npz"))
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    for k in ("user_embed", "item_embed"):
        np.testing.assert_allclose(got[k], np.asarray(params[k]), atol=1e-5)
