"""The port's transformer LM over meshes against the JAX package's
``models/transformer.py`` on the 8-device CPU mesh: three SGD steps of
``make_train_step(config, mesh)`` on ``{tp: 2}``, ``{sp: 2}`` (ring
attention), ``{dp: 2}``, the MoE LM on ``{ep: 2}`` and ``{ep: 2, tp: 2}``,
and ``make_pipeline_train_step`` on ``{pp: 2}`` with 2 microbatches.

The JAX side runs here from ``init_params(PRNGKey(0), config)``; its
initial weights go to the port's ranks (gloo, through the launcher:
``tests/dist/torch_mesh_worker.py``) in ``inputs.npz`` and cross through
``convert.from_transformer_params(mesh=)``, which cuts each rank's
blocks (``w_qkv`` in the port's head-wise layout). The workers gather the
weights back to the global pytree (``gather_params``). Tolerance: f32,
1e-4 on the losses (relative) and on every weight (absolute), the JAX
tests' f32 tolerance (``tests/test_parallel.py``).
"""
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mxnet_tpu import parallel as jpar
from mxnet_tpu.models import transformer as jtf

from mxnet_tpu_torch.models.transformer import flat_params

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "dist"))
from torch_dist_common import launch, worker  # noqa: E402
import torch_mesh_worker as W  # noqa: E402

CASES2 = ["tf_tp", "tf_sp", "tf_dp", "tf_pp", "tf_ep"]
CASES4 = ["tf_tpep"]


def _cfg(moe):
    return jtf.TransformerConfig(**(W.MOE_CFG if moe else W.TF_CFG))


def _init(moe):
    p = jtf.init_params(jax.random.PRNGKey(0), _cfg(moe))
    return {k: np.asarray(v) for k, v in flat_params(p).items()}


def _jax_run(case, init):
    moe = case in ("tf_ep", "tf_tpep")
    cfg = _cfg(moe)
    axes = W.TF_MESH[case]
    n = int(np.prod(list(axes.values())))
    mesh = jpar.make_mesh(axes, jax.devices()[:n])
    from mxnet_tpu_torch.models.transformer import nest_params
    params = jax.tree_util.tree_map(jnp.asarray, nest_params(init))
    tok, tgt = (jnp.asarray(a, jnp.int32) for a in W.tf_tokens())
    losses = []
    if case == "tf_pp":
        step, prepare = jtf.make_pipeline_train_step(cfg, mesh, lr=W.LR,
                                                     n_microbatches=2)
        pp = prepare(params)
        for _ in range(3):
            loss, pp = step(pp, tok, tgt)
            losses.append(float(loss))
        out = {"embed": pp["embed"], "ln_f_scale": pp["ln_f_scale"],
               "ln_f_bias": pp["ln_f_bias"]}
        S = 2
        lps = cfg.n_layers // S
        for k, v in flat_params(pp["stages"]).items():
            v = np.asarray(v)
            for s in range(S):
                for j in range(lps):
                    out[f"layer{s * lps + j}/{k}"] = v[s, j]
    else:
        step, shard = jtf.make_train_step(cfg, mesh, lr=W.LR)
        params = shard(params)
        for _ in range(3):
            loss, params = step(params, tok, tgt)
            losses.append(float(loss))
        out = flat_params(params)
    return np.asarray(losses), {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = {}
    for moe in (False, True):
        tag = "tf/moe/" if moe else "tf/dense/"
        inputs.update({tag + k: v for k, v in _init(moe).items()})
    got = {}
    for n, cases in ((2, CASES2), (4, CASES4)):
        out = tmp_path_factory.mktemp(f"tf{n}")
        np.savez(out / "inputs.npz", **inputs)
        proc = launch(n, worker("torch_mesh_worker.py") + [str(out)] + cases,
                      timeout=400)
        assert proc.returncode == 0, \
            proc.stdout[-3000:] + proc.stderr[-6000:]
        got.update({c: dict(np.load(out / f"{c}.npz")) for c in cases})
    return got, inputs


@pytest.mark.parametrize("case", CASES2 + CASES4)
def test_mesh_train_steps_against_jax(case, runs):
    got, inputs = runs
    moe = case in ("tf_ep", "tf_tpep")
    tag = "tf/moe/" if moe else "tf/dense/"
    init = {k[len(tag):]: v for k, v in inputs.items() if k.startswith(tag)}
    losses, want = _jax_run(case, init)
    np.testing.assert_allclose(got[case]["losses"], losses, rtol=1e-4)
    assert set(want) == {k[len("param/"):] for k in got[case]
                         if k.startswith("param/")}
    for k, v in want.items():
        np.testing.assert_allclose(got[case][f"param/{k}"], v, atol=1e-4,
                                   err_msg=f"{case} {k}")
        # the weights moved: three steps changed them
        if k.endswith(("w_qkv", "ffn_in", "w_in")):
            assert np.abs(v - init[k]).max() > 1e-5
