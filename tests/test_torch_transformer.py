"""The port's transformer LM (mxnet_tpu_torch/models/transformer.py) against
the JAX package's models/transformer.py on one device.

The JAX ``init_params`` pytree is carried across with
``convert.from_transformer_params``; the same numpy tokens go through both.
Compared: ``forward``'s logits, ``loss_fn`` and three ``make_train_step``
steps (every loss and every parameter after the last step). On the CPU both
packages take plain attention (the JAX package's flash kernel is for a TPU,
the port's for the card: tests/test_torch_flash_attention.py holds them).

Tolerances: f32 2e-5 (summation order only); bf16 2e-2
(test_fused_epilogue.py's bf16 tolerance). The bf16 JAX reference runs in a
subprocess with XLA_FLAGS --xla_allow_excess_precision=false: without it
XLA's CPU backend skips the bf16 rounding between fused ops, so its bf16
model is more precise than bf16 arithmetic (and than the port, which rounds
at every op as the card does).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, convert
from mxnet_tpu_torch.models import transformer as ttf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (config kwargs, batch, T); "wide" has head dim 64 and T % 128 == 0,
# the shape that takes the flash kernel on the card
CASES = {"small": (dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2,
                        d_ff=64), 2, 16),
         "wide": (dict(vocab_size=64, d_model=128, n_heads=2, n_layers=2,
                       d_ff=256), 1, 128)}
LR, STEPS = 0.5, 3


def _tokens(case):
    _, b, t = CASES[case]
    rs = np.random.RandomState(2)
    return (rs.randint(0, 64, (b, t)).astype(np.int32),
            rs.randint(0, 64, (b, t)).astype(np.int32))


def _jax_run(case, dtype):
    """The JAX package's init_params, forward, loss_fn and STEPS train
    steps; returns {key: float32 array} with the parameters under
    'init/<path>' and 'final/<path>'."""
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.models import transformer as jtf
    kw, _, _ = CASES[case]
    cfg = jtf.TransformerConfig(
        **kw, dtype=jnp.bfloat16 if dtype == "bfloat16" else None)
    params = jtf.init_params(jax.random.PRNGKey(0), cfg)
    tok, tgt = (jnp.asarray(a) for a in _tokens(case))
    # the step donates its parameters: copy the initial ones out first
    res = {f"init/{k}": np.asarray(v, np.float32)
           for k, v in _flat(params).items()}
    res["logits"] = jax.jit(jtf.forward, static_argnums=2)(params, tok, cfg)
    res["loss"] = jax.jit(jtf.loss_fn, static_argnums=3)(params, tok, tgt,
                                                         cfg)
    step, _ = jtf.make_train_step(cfg, lr=LR)
    losses = []
    for _ in range(STEPS):
        loss, params = step(params, tok, tgt)
        losses.append(loss)
    res["losses"] = jnp.stack(losses)
    res.update({f"final/{k}": v for k, v in _flat(params).items()})
    return {k: np.asarray(v, np.float32) for k, v in res.items()}


def _flat(params):
    out = {}
    for k, v in params.items():
        for kk, vv in (v.items() if isinstance(v, dict) else [(None, v)]):
            out[k if kk is None else f"{k}/{kk}"] = vv
    return out


def _nest(flat):
    out = {}
    for k, v in flat.items():
        head, _, tail = k.partition("/")
        if tail:
            out.setdefault(head, {})[tail] = v
        else:
            out[head] = v
    return out


@pytest.fixture(scope="module")
def bf16_ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_tf") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(out))


def _port_run(ref, case, dtype):
    """The port from the JAX initial parameters: logits, loss, the losses of
    STEPS train steps and the final parameters, as float32 numpy."""
    kw, _, _ = CASES[case]
    cfg = ttf.TransformerConfig(**kw, dtype=getattr(torch, dtype))
    init = {k[5:]: v for k, v in ref.items() if k.startswith("init/")}
    if dtype == "bfloat16":
        import ml_dtypes
        init = {k: v.astype(ml_dtypes.bfloat16) for k, v in init.items()}
    params = convert.from_transformer_params(_nest(init), cfg, device="cpu")
    tok, tgt = (torch.from_numpy(a) for a in _tokens(case))
    got = {"logits": ttf.forward(params, tok, cfg),
           "loss": ttf.loss_fn(params, tok, tgt, cfg)}
    step, shard = ttf.make_train_step(cfg, lr=LR)
    params = shard(params)
    losses = []
    for _ in range(STEPS):
        loss, out = step(params, tok, tgt)
        assert out is params and loss.dtype == torch.float32
        losses.append(loss)
    got["losses"] = torch.stack(losses)
    for k, v in _flat(params).items():
        assert v.dtype == getattr(torch, dtype), k
        got[f"final/{k}"] = v
    return {k: v.detach().float().numpy() for k, v in got.items()}


def _compare(ref, got, tol):
    want_keys = {k for k in ref if not k.startswith("init/")}
    assert set(got) == want_keys
    for k in sorted(want_keys):
        assert np.isfinite(got[k]).all(), k
        np.testing.assert_allclose(got[k], ref[k], rtol=tol, atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("case", sorted(CASES))
def test_f32_forward_loss_and_train_steps_match_jax(case):
    ref = _jax_run(case, "float32")
    _compare(ref, _port_run(ref, case, "float32"), 2e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_forward_loss_and_train_steps_match_jax(bf16_ref, case):
    ref = {k[len(case) + 1:]: v for k, v in bf16_ref.items()
           if k.startswith(case + "/")}
    _compare(ref, _port_run(ref, case, "bfloat16"), 2e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_has_the_jax_shapes_dtypes_and_scales(dtype):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.models import transformer as jtf
    kw = dict(vocab_size=512, d_model=128, n_heads=2, n_layers=3, d_ff=256)
    jp = _flat(jtf.init_params(jax.random.PRNGKey(1), jtf.TransformerConfig(
        **kw, dtype=jnp.dtype(dtype))))
    tp = _flat(ttf.init_params(torch.Generator().manual_seed(1),
                               ttf.TransformerConfig(
                                   **kw, dtype=getattr(torch, dtype)),
                               device="cpu"))
    assert tp.keys() == jp.keys()
    for k, w in jp.items():
        mine = tp[k]
        assert tuple(mine.shape) == w.shape and mine.dtype == getattr(
            torch, dtype) and str(w.dtype) == dtype, k
        want, got = np.asarray(w, np.float32), mine.float().numpy()
        if k.endswith(("_scale", "_bias", "_b")):
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            # same distribution, not the same draws: std within 3 %
            assert abs(got.std() / want.std() - 1) < 0.03, k
            assert abs(got.mean()) < 0.1 * want.std(), k


def test_converter_rejects_missing_extra_misshaped_and_mistyped():
    cfg = ttf.TransformerConfig(**CASES["small"][0])
    good = {k: v.numpy() for k, v in _flat(ttf.init_params(
        torch.Generator().manual_seed(0), cfg, device="cpu")).items()}
    params = convert.from_transformer_params(_nest(good), cfg, device="cpu")
    assert _flat(params).keys() == good.keys()
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(v.numpy(), good[k])
    broken = [{k: v for k, v in good.items() if k != "layer1/wo"},
              {**good, "layer0/extra": np.zeros(1, np.float32)},
              {**good, "ln_f_bias_2": np.zeros(32, np.float32)},
              {**good, "layer0/w_qkv": good["layer0/w_qkv"].T.copy()},
              {**good, "embed": good["embed"].astype(np.float64)}]
    for params in broken:
        with pytest.raises(MXNetError):
            convert.from_transformer_params(_nest(params), cfg, device="cpu")


def test_transformer_entry_points_default_to_the_card(monkeypatch):
    """No device given and no card: raise, never carry on on the CPU."""
    cfg = ttf.TransformerConfig(**CASES["small"][0])
    params = ttf.init_params(torch.Generator(), cfg, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        ttf.init_params(torch.Generator(), cfg)
    with pytest.raises(MXNetError, match="CUDA"):
        convert.from_transformer_params(
            {k: v.numpy() if isinstance(v, torch.Tensor) else
             {kk: vv.numpy() for kk, vv in v.items()}
             for k, v in params.items()}, cfg)
    assert mt.models.transformer is ttf


@pytest.mark.parametrize("what", ["mesh_forward", "mesh_step", "moe",
                                  "remat", "pipeline"])
def test_unported_parts_raise(what):
    kw = CASES["small"][0]
    cfg = ttf.TransformerConfig(**kw)
    params = ttf.init_params(torch.Generator(), cfg, device="cpu")
    tok = torch.zeros((1, 8), dtype=torch.int64)
    with pytest.raises(MXNetError):
        if what == "mesh_forward":
            ttf.forward(params, tok, cfg, mesh=object())
        elif what == "mesh_step":
            ttf.make_train_step(cfg, mesh=object())
        elif what == "moe":
            ttf.init_params(torch.Generator(),
                            ttf.TransformerConfig(**kw, n_experts=2),
                            device="cpu")
        elif what == "remat":
            ttf.forward(params, tok, ttf.TransformerConfig(**kw, remat=True))
        else:
            ttf.make_pipeline_train_step(cfg, mesh=object())


if __name__ == "__main__":
    np.savez(sys.argv[1], **{f"{case}/{k}": v for case in CASES
                             for k, v in _jax_run(case, "bfloat16").items()})
