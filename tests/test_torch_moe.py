"""The port's Mixture-of-Experts FFN (mxnet_tpu_torch/parallel/moe.py)
against the JAX package's parallel/moe.py on the same numpy inputs.

Compared for top-1 (Switch) and top-2 (GShard) routing, at a capacity
factor that drops tokens (0.5) and one that drops none (4.0): the output,
the aux loss, and the gradients of ``sum(out * w) + aux`` with respect to
``x`` and every parameter. The routing itself is read off both packages
the same way: the Jacobian of the output with respect to ``b_out`` is, per
token and expert, the combine weight of a kept token and 0 for a dropped
or unrouted one; the two packages' patterns must be identical and their
weights within tolerance. Tolerances: f32 2e-5 (summation order only);
bf16 2e-2, the JAX side in a subprocess with
``--xla_allow_excess_precision=false`` (see test_torch_transformer.py).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops.registry import NotPortedError
from mxnet_tpu_torch.parallel import moe as tmoe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, T, D, FF, E = 2, 8, 16, 32, 4
NAMES = ("gate", "w_in", "b_in", "w_out", "b_out")
CASES = [(k, cf) for k in (1, 2) for cf in (0.5, 4.0)]


def _inputs():
    """x, the output weighting w, and the parameters (nonzero biases so
    their gradients are exercised), as float32 numpy."""
    rs = np.random.RandomState(3)
    params = {"gate": rs.randn(D, E) * 0.5, "w_in": rs.randn(E, D, FF) * 0.2,
              "b_in": rs.randn(E, FF) * 0.1, "w_out": rs.randn(E, FF, D) * 0.2,
              "b_out": rs.randn(E, D) * 0.1}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    return (rs.randn(B, T, D).astype(np.float32),
            rs.randn(B, T, D).astype(np.float32), params)


def _jax_run(k, cf, dtype="float32"):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.parallel import moe as jmoe
    x, w, params = _inputs()
    dt = jnp.dtype(dtype)
    x = jnp.asarray(x).astype(dt)
    params = {n: jnp.asarray(v).astype(jnp.float32 if n == "gate" else dt)
              for n, v in params.items()}

    def objective(x, params):
        out, aux = jmoe.moe_ffn(x, params, E, cf, k)
        return jnp.sum(out.astype(jnp.float32) * w) + aux

    out, aux = jmoe.moe_ffn(x, params, E, cf, k)
    gx, gp = jax.grad(objective, argnums=(0, 1))(x, params)

    def by_bias(b_out):
        return jmoe.moe_ffn(x, dict(params, b_out=b_out), E, cf, k)[0]

    jac = jax.jacrev(by_bias)(params["b_out"])       # (B, T, D, E, D)
    res = {"out": out, "aux": aux, "grad/x": gx, "routing": jac[:, :, 0, :, 0]}
    res.update({f"grad/{n}": gp[n] for n in NAMES})
    return {key: np.asarray(v, np.float32) for key, v in res.items()}


def _port_run(k, cf, dtype=torch.float32):
    x, w, params = _inputs()
    x = torch.from_numpy(x).to(dtype).requires_grad_()
    params = {n: torch.from_numpy(v).to(torch.float32 if n == "gate"
                                        else dtype).requires_grad_()
              for n, v in params.items()}
    out, aux = tmoe.moe_ffn(x, params, E, cf, k)
    assert out.dtype == dtype and aux.dtype == torch.float32
    obj = (out.float() * torch.from_numpy(w)).sum() + aux
    grads = torch.autograd.grad(obj, [x] + [params[n] for n in NAMES])
    jac = torch.autograd.functional.jacobian(
        lambda b_out: tmoe.moe_ffn(x.detach(), dict(
            {n: p.detach() for n, p in params.items()}, b_out=b_out), E, cf,
            k)[0], params["b_out"].detach())
    res = {"out": out, "aux": aux, "grad/x": grads[0],
           "routing": jac[:, :, 0, :, 0]}
    res.update({f"grad/{n}": g for n, g in zip(NAMES, grads[1:])})
    return {key: v.detach().float().numpy() for key, v in res.items()}


def _compare(want, got, tol):
    assert set(got) == set(want)
    # identical routing: the same (token, expert) pairs kept
    np.testing.assert_array_equal(got["routing"] != 0, want["routing"] != 0)
    for key in sorted(want):
        assert np.isfinite(got[key]).all(), key
        np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=tol,
                                   err_msg=key)


@pytest.mark.parametrize("k,cf", CASES)
def test_f32_moe_ffn_matches_jax(k, cf):
    want = _jax_run(k, cf)
    got = _port_run(k, cf)
    _compare(want, got, 2e-5)
    kept = (got["routing"] != 0).sum()
    if cf == 4.0:      # nothing dropped: every token reaches its k experts
        assert kept == B * T * k
    else:              # capacity max(1, ceil(16 * 0.5 * k / 4)) per expert
        assert kept <= E * max(1, int(np.ceil(B * T * cf * k / E))) < B * T * k


@pytest.fixture(scope="module")
def bf16_ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_moe") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(out))


@pytest.mark.parametrize("k,cf", CASES)
def test_bf16_moe_ffn_matches_jax(bf16_ref, k, cf):
    pre = f"{k}/{cf}/"
    want = {key[len(pre):]: v for key, v in bf16_ref.items()
            if key.startswith(pre)}
    _compare(want, _port_run(k, cf, torch.bfloat16), 2e-2)


def test_moe_ffn_shapes_and_balance():
    """tests/test_parallel.py's property: top-1 routing of a near-uniform
    router at init gives a finite output and an aux loss near 1 (its
    minimum)."""
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(2, 8, 16).astype(np.float32))
    params = tmoe.init_moe_params(torch.Generator().manual_seed(0), 16, 32,
                                  4)
    out, aux = tmoe.moe_ffn(x, params, 4)
    assert out.shape == x.shape
    assert torch.isfinite(out).all()
    assert 0.9 < float(aux) < 2.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_moe_params_has_the_jax_names_shapes_and_dtypes(dtype):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.parallel import moe as jmoe
    jp = jmoe.init_moe_params(jax.random.PRNGKey(0), 16, 32, 4,
                              dtype=jnp.dtype(str(dtype)[6:]))
    tp = tmoe.init_moe_params(torch.Generator().manual_seed(0), 16, 32, 4,
                              dtype=dtype)
    assert tp.keys() == jp.keys()
    for name, w in jp.items():
        assert tuple(tp[name].shape) == w.shape, name
        assert str(tp[name].dtype)[6:] == str(w.dtype), name
    assert tp["gate"].dtype == torch.float32
    assert not tp["b_in"].any() and not tp["b_out"].any()


def test_router_gets_gradients_only_through_the_combine_weights():
    """No gradient path through the dispatch: with the aux loss and the
    combine weights cut off, the gate receives none."""
    x, _, params = _inputs()
    gate = torch.from_numpy(params["gate"]).requires_grad_()
    p = {n: torch.from_numpy(v) for n, v in params.items()}
    out, aux = tmoe.moe_ffn(torch.from_numpy(x), dict(p, gate=gate), E)
    (g_aux,) = torch.autograd.grad(aux, [gate], retain_graph=True)
    (g_out,) = torch.autograd.grad(out.sum(), [gate])
    assert g_aux.abs().sum() > 0 and g_out.abs().sum() > 0
    p0 = dict(p, w_out=torch.zeros_like(p["w_out"]),
              b_out=torch.zeros_like(p["b_out"]))
    out0, _ = tmoe.moe_ffn(torch.from_numpy(x), dict(p0, gate=gate), E)
    (g0,) = torch.autograd.grad(out0.sum(), [gate], allow_unused=True)
    assert g0 is None or not g0.any()


def test_moe_param_specs_needs_a_mesh():
    with pytest.raises(NotPortedError, match="A10"):
        tmoe.moe_param_specs(None)


if __name__ == "__main__":
    np.savez(sys.argv[1], **{f"{k}/{cf}/{key}": v for k, cf in CASES
                             for key, v in _jax_run(k, cf, "bfloat16").items()})
