"""The port's optimizer ops, optimizers and LR schedulers against the JAX
package's.

The same numpy inputs go through mxnet_tpu (JAX on the CPU) and
mxnet_tpu_torch (``ctx=mx.cpu()``):

- every name and alias of the JAX ``ops/optimizer_ops.py`` is in the
  port's registry with the same ``num_outputs`` and ``variadic``;
- every dense optimizer op (22 of the 23; ``_sparse_adagrad_update``
  needs row-sparse gradients and raises), with and without gradient
  clipping;
- each of the 15 optimizer classes of ``optimizer/optimizer.py`` (and
  ``GroupAdaGrad``) for 3 steps through ``get_updater`` on three weights,
  with ``lr_mult`` / ``wd_mult`` and ``clip_gradient``, in f32 and with
  ``multi_precision`` on bf16 weights (the f32 masters compared);
- the five schedulers, warm-up included;
- ``Updater.get_states`` / ``set_states``: a run stopped and resumed from
  the pickled states equals one that was not, Adam's step counter
  included;
- in bf16 without multi-precision, the grouped rules' ops against the JAX
  ops run in a subprocess under ``--xla_allow_excess_precision=false``
  (without it XLA's CPU backend keeps f32 between the ops of one
  update; the port rounds at every op, as XLA does with it).

Tolerances: f32 1e-6 relative and absolute for one op (the order of the
ops is the JAX package's, and a division by a scalar may round once
differently); 1e-5 relative, 1e-6 absolute after 3 optimizer steps
(``tests/test_optimizer_aggregation.py``); bf16 bit for bit.
SGLD's noise comes from a torch generator, so it is taken out of both
sides (its update is linear in the noise at wd 0) and the rest compared.
"""
import ast
import math
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = None          # mt.cpu(), set at import below
OP_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_registered():
    """(name, aliases) of every ``register(...)`` in the JAX package's
    ops/optimizer_ops.py, read from its source."""
    tree = ast.parse(open(os.path.join(ROOT, "mxnet_tpu", "ops",
                                       "optimizer_ops.py")).read())
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        for dec in node.decorator_list:
            if isinstance(dec, ast.Call) and getattr(dec.func, "id", "") \
                    == "register":
                aliases = []
                for kw in dec.keywords:
                    if kw.arg == "aliases":
                        aliases = [e.value for e in kw.value.elts]
                out.append((dec.args[0].value, aliases))
    return out


import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402

CPU = mt.cpu()


def test_every_optimizer_op_is_registered_with_the_same_metadata():
    from mxnet_tpu.ops import registry as jreg
    ops = _jax_registered()
    assert len(ops) == 23
    for name, aliases in ops:
        j, t = jreg.get_op(name), treg.get_op(name)
        for a in aliases:
            assert treg.get_op(a) is t
        assert t.variadic == j.variadic, name
        if callable(j.num_outputs):
            for n_in, params in ((6, {}), (12, {"num_weights": 3})):
                assert t.num_outputs(n_in, params) == \
                    j.num_outputs(n_in, params), name
        else:
            assert t.num_outputs == j.num_outputs, name
        assert hasattr(mt.nd, name) or name.startswith("_")


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

SHAPES = [(3, 5), (4,), (2, 3, 2)]


def _inputs(kind, shape, rs):
    if kind in ("var", "n", "d", "hist"):          # must stay >= 0
        return rs.rand(*shape).astype(np.float32) + 0.5
    if kind == "gavg":
        return 0.1 * rs.randn(*shape).astype(np.float32)
    if kind == "rescale_t":
        return np.array([0.5], np.float32)
    return rs.randn(*shape).astype(np.float32)


# name -> (input kinds, params); every op also runs with clipping
OP_CASES = {
    "sgd_update": (("w", "g"), dict(lr=0.1, wd=0.01)),
    "sgd_mom_update": (("w", "g", "m"), dict(lr=0.1, momentum=0.9, wd=0.01)),
    "mp_sgd_update": (("w", "g", "w32"), dict(lr=0.1, wd=0.01)),
    "mp_sgd_mom_update": (("w", "g", "m", "w32"),
                          dict(lr=0.1, momentum=0.9, wd=0.01)),
    "nag_mom_update": (("w", "g", "m"), dict(lr=0.1, momentum=0.9, wd=0.01)),
    "adam_update": (("w", "g", "m", "var"),
                    dict(lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6,
                         wd=0.01)),
    "signsgd_update": (("w", "g"), dict(lr=0.1, wd=0.01)),
    "signum_update": (("w", "g", "m"),
                      dict(lr=0.1, momentum=0.9, wd=0.01, wd_lh=0.02)),
    "rmsprop_update": (("w", "g", "n"),
                       dict(lr=0.01, gamma1=0.9, epsilon=1e-6, wd=0.01,
                            clip_weights=0.9)),
    "rmspropalex_update": (("w", "g", "n", "gavg", "m"),
                           dict(lr=0.01, gamma1=0.9, gamma2=0.8,
                                epsilon=1e-6, wd=0.01)),
    "ftrl_update": (("w", "g", "m", "n"),
                    dict(lr=0.1, lamda1=0.05, beta=1.5, wd=0.01)),
    "ftml_update": (("w", "g", "d", "var", "m"),
                    dict(lr=0.05, beta1=0.6, beta2=0.99, epsilon=1e-6,
                         t=3, wd=0.01)),
    "_adamw_update": (("w", "g", "m", "var", "rescale_t"),
                      dict(lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6,
                           wd=0.01, eta=0.7)),
    "_mp_adamw_update": (("w", "g", "m", "var", "w32", "rescale_t"),
                         dict(lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6,
                              wd=0.01, eta=0.7)),
    "_contrib_group_adagrad_update": (("w", "g", "hist"),
                                      dict(lr=0.1, epsilon=1e-5)),
}
MULTI_CASES = {
    "multi_sgd_update": (("w", "g"), {}),
    "multi_sgd_mom_update": (("w", "g", "m"), dict(momentum=0.9)),
    "multi_mp_sgd_update": (("w", "g", "w32"), {}),
    "multi_mp_sgd_mom_update": (("w", "g", "m", "w32"), dict(momentum=0.9)),
    "multi_adam_update": (("w", "g", "m", "var"),
                          dict(beta1=0.8, beta2=0.99, epsilon=1e-6)),
    "multi_nag_mom_update": (("w", "g", "m"), dict(momentum=0.9)),
    "multi_rmsprop_update": (("w", "g", "n"),
                             dict(gamma1=0.9, epsilon=1e-6,
                                  clip_weights=0.9)),
}


def _op_arrays(kinds, shapes, rs):
    arrays = []
    for shape in shapes:
        w = None
        for k in kinds:
            if k == "w32":
                arrays.append(w.copy())
            elif k == "hist":
                arrays.append(_inputs(k, shape[:1], rs))
            else:
                a = _inputs(k, shape, rs)
                if k == "w":
                    w = a
                arrays.append(a)
    return arrays


def _run_both(name, arrays, params):
    import jax.numpy as jnp
    from mxnet_tpu.ops import registry as jreg
    jout = jreg.get_op(name)(*[jnp.asarray(a) for a in arrays], **params)
    tout = treg.get_op(name).fn(*[torch.from_numpy(a.copy())
                                  for a in arrays], **params)
    jout = jout if isinstance(jout, tuple) else (jout,)
    tout = tout if isinstance(tout, tuple) else (tout,)
    assert len(jout) == len(tout)
    return [np.asarray(j, np.float32) for j in jout], \
        [t.float().numpy() for t in tout]


@pytest.mark.parametrize("clip", [-1.0, 0.8])
@pytest.mark.parametrize("name", sorted(OP_CASES))
def test_optimizer_op_matches_jax(name, clip):
    rs = np.random.RandomState(abs(hash(name)) % 1000)
    kinds, params = OP_CASES[name]
    params = dict(params, rescale_grad=0.5)
    if name == "ftml_update":
        params["clip_grad"] = clip
        params["rescale_grad"] = 0.5
    elif name.startswith("_") and "adamw" in name:
        params.pop("rescale_grad")
        params["clip_gradient"] = clip
    else:
        params["clip_gradient"] = clip
    arrays = _op_arrays(kinds, [(3, 5)], rs)
    for g, w in zip(*_run_both(name, arrays, params)):
        np.testing.assert_allclose(w, g, **OP_TOL)


@pytest.mark.parametrize("clip", [-1.0, 0.8])
@pytest.mark.parametrize("name", sorted(MULTI_CASES))
def test_multi_optimizer_op_matches_jax(name, clip):
    rs = np.random.RandomState(abs(hash(name)) % 1000 + 1)
    kinds, params = MULTI_CASES[name]
    params = dict(params, lrs=(0.1, 0.05, 0.2), wds=(0.01, 0.0, 0.02),
                  rescale_grad=0.5, clip_gradient=clip, num_weights=3)
    arrays = _op_arrays(kinds, SHAPES, rs)
    jout, tout = _run_both(name, arrays, params)
    assert len(tout) == treg.get_op(name).num_outputs(len(arrays), params)
    for g, w in zip(jout, tout):
        np.testing.assert_allclose(w, g, **OP_TOL)


def test_multi_op_is_the_one_tensor_op_bit_for_bit():
    """The multi-tensor op and its one-tensor op are the same rule."""
    rs = np.random.RandomState(4)
    arrays = [torch.from_numpy(a) for a in
              _op_arrays(("w", "g", "m", "var"), SHAPES, rs)]
    multi = treg.get_op("multi_adam_update").fn(
        *arrays, lrs=(0.1, 0.05, 0.2), wds=(0.01, 0.0, 0.02),
        rescale_grad=0.5, num_weights=3)
    for i in range(3):
        one = treg.get_op("adam_update").fn(
            *arrays[4 * i:4 * i + 4], lr=(0.1, 0.05, 0.2)[i],
            wd=(0.01, 0.0, 0.02)[i], rescale_grad=0.5)
        for k in range(3):
            assert torch.equal(one[k], multi[3 * k + i])


def test_optimizer_ops_through_mx_nd_and_the_not_ported_op():
    rs = np.random.RandomState(5)
    w, g, m = (mt.nd.array(rs.randn(3, 4).astype(np.float32), ctx=CPU)
               for _ in range(3))
    want = treg.get_op("sgd_mom_update").fn(w.tensor, g.tensor, m.tensor,
                                            lr=0.1, momentum=0.9)
    ptr = w.tensor.data_ptr()
    mt.nd.sgd_mom_update(w, g, m, lr=0.1, momentum=0.9, out=(w, m))
    assert w.tensor.data_ptr() == ptr       # written in place
    assert torch.equal(w.tensor, want[0]) and torch.equal(m.tensor, want[1])
    # _sparse_adagrad_update is ported: the JAX op's values
    from mxnet_tpu.ops import registry as jreg
    h = np.abs(rs.randn(3, 4)).astype(np.float32)
    args = [rs.randn(3, 4).astype(np.float32) for _ in range(2)] + [h]
    want = jreg.get_op("_sparse_adagrad_update").fn(
        *args, lr=0.1, wd=0.01, rescale_grad=0.5, clip_gradient=0.3)
    got = mt.nd._internal._sparse_adagrad_update(
        *(mt.nd.array(a, ctx=CPU) for a in args), lr=0.1, wd=0.01,
        rescale_grad=0.5, clip_gradient=0.3)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.asnumpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def _bf16_jax_ops(out):
    """Subprocess body: the grouped rules' ops on bf16 inputs in JAX."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import registry as jreg
    res = {}
    for name, (arrays, params) in _bf16_cases().items():
        outs = jreg.get_op(name)(*[jnp.asarray(a, jnp.bfloat16)
                                   for a in arrays], **params)
        for k, o in enumerate(outs if isinstance(outs, tuple) else (outs,)):
            res[f"{name}/{k}"] = np.asarray(o.astype(jnp.float32))
    np.savez(out, **res)


def _bf16_cases():
    rs = np.random.RandomState(9)
    cases = {}
    for name in ("sgd_update", "sgd_mom_update", "nag_mom_update",
                 "adam_update", "rmsprop_update", "rmspropalex_update"):
        kinds, params = OP_CASES[name]
        params = dict(params, rescale_grad=0.25, clip_gradient=0.8)
        cases[name] = (_op_arrays(kinds, [(8, 16)], rs), params)
    return cases


def test_bf16_ops_match_jax_without_excess_precision(tmp_path):
    out = str(tmp_path / "bf16.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    ref = dict(np.load(out))
    for name, (arrays, params) in _bf16_cases().items():
        outs = treg.get_op(name).fn(*[torch.from_numpy(a).bfloat16()
                                      for a in arrays], **params)
        for k, o in enumerate(outs if isinstance(outs, tuple) else (outs,)):
            assert o.dtype == torch.bfloat16
            np.testing.assert_array_equal(o.float().numpy(),
                                          ref[f"{name}/{k}"],
                                          err_msg=f"{name}/{k}")


# float64: every scalar a power-of-two fraction, so rounding it to float32
# (the port's rule for op scalars) changes nothing, and both packages
# compute in float64 from the same values
F64_PARAMS = {
    "sgd_update": dict(lr=0.125, wd=2 ** -6),
    "sgd_mom_update": dict(lr=0.125, momentum=0.875, wd=2 ** -6),
    "nag_mom_update": dict(lr=0.125, momentum=0.875, wd=2 ** -6),
    "adam_update": dict(lr=2 ** -7, beta1=0.75, beta2=127 / 128,
                        epsilon=2 ** -20, wd=2 ** -6),
    "signsgd_update": dict(lr=0.125, wd=2 ** -6),
    "signum_update": dict(lr=0.125, momentum=0.875, wd=2 ** -6,
                          wd_lh=2 ** -5),
    "rmsprop_update": dict(lr=2 ** -7, gamma1=0.875, epsilon=2 ** -20,
                           wd=2 ** -6, clip_weights=0.875),
    "rmspropalex_update": dict(lr=2 ** -7, gamma1=0.875, gamma2=0.75,
                               epsilon=2 ** -20, wd=2 ** -6),
    "ftrl_update": dict(lr=0.125, lamda1=2 ** -4, beta=1.5, wd=2 ** -6),
    "ftml_update": dict(lr=2 ** -4, beta1=0.5, beta2=0.75, epsilon=2 ** -20,
                        t=3, wd=2 ** -6, clip_grad=0.75, rescale_grad=0.5),
    "_adamw_update": dict(lr=2 ** -7, beta1=0.75, beta2=127 / 128,
                          epsilon=2 ** -20, wd=2 ** -6, eta=0.75,
                          clip_gradient=0.75),
    "_contrib_group_adagrad_update": dict(lr=0.125, epsilon=2 ** -17),
}


def _f64_cases():
    rs = np.random.RandomState(11)
    cases = {}
    for name, params in F64_PARAMS.items():
        if "clip_grad" not in params and "eta" not in params:
            params = dict(params, rescale_grad=0.5, clip_gradient=0.75)
        arrays = _op_arrays(OP_CASES[name][0], [(8, 16)], rs)
        cases[name] = ([a.astype(np.float64) * (1 + 1e-3 * rs.rand(*a.shape))
                        if a.size > 1 else a.astype(np.float64)
                        for a in arrays], params)
    return cases


def _f64_jax_ops(out):
    """Subprocess body: the dense ops on float64 inputs in JAX (x64)."""
    import jax.numpy as jnp
    from mxnet_tpu.ops import registry as jreg
    res = {}
    for name, (arrays, params) in _f64_cases().items():
        outs = jreg.get_op(name)(*[jnp.asarray(a) for a in arrays],
                                 **params)
        for k, o in enumerate(outs if isinstance(outs, tuple) else (outs,)):
            assert o.dtype == jnp.float64, (name, o.dtype)
            res[f"{name}/{k}"] = np.asarray(o)
    np.savez(out, **res)


def test_f64_ops_match_jax_in_f64(tmp_path):
    """float64 weights keep float64 arithmetic, the roots of Ftrl, FTML
    and group AdaGrad included: a float32 rounding anywhere would leave a
    relative error near 1e-8, far above this tolerance."""
    out = str(tmp_path / "f64.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               JAX_ENABLE_X64="1")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out,
                           "f64"], env=env, cwd=ROOT, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    ref = dict(np.load(out))
    for name, (arrays, params) in _f64_cases().items():
        outs = treg.get_op(name).fn(*[torch.from_numpy(a.copy())
                                      for a in arrays], **params)
        for k, o in enumerate(outs if isinstance(outs, tuple) else (outs,)):
            assert o.dtype == torch.float64
            np.testing.assert_allclose(o.numpy(), ref[f"{name}/{k}"],
                                       rtol=1e-12, atol=1e-14,
                                       err_msg=f"{name}/{k}")


# ---------------------------------------------------------------------------
# the optimizers
# ---------------------------------------------------------------------------

CLASSES = {
    "sgd": dict(momentum=0.9), "sgld": {},
    "signum": dict(momentum=0.9, wd_lh=0.01), "signsgd": {},
    "nag": dict(momentum=0.9), "adam": dict(learning_rate=0.01),
    "nadam": dict(learning_rate=0.01), "adagrad": {}, "adadelta": {},
    "rmsprop": dict(learning_rate=0.01, centered=True, clip_weights=2.0),
    "ftrl": dict(learning_rate=0.1, lamda1=0.02),
    "ftml": dict(learning_rate=0.02), "dcasgd": dict(momentum=0.9),
    "lbsgd": dict(momentum=0.9), "test": {}, "groupadagrad": {},
}
WSHAPES = [(4, 3), (5,), (2, 3, 2)]
STEPS = 3


def _flat_state(s):
    if s is None:
        return []
    if isinstance(s, (tuple, list)):
        return [x for y in s for x in _flat_state(y)]
    return [s]


def _sgld_noise(n_params, shapes, lrs, seed_fn, draw):
    """The noise SGLD added to each weight over STEPS steps, replayed."""
    seed_fn()
    total = [np.zeros(s, np.float32) for s in shapes]
    for _ in range(STEPS):
        for i in range(n_params):
            total[i] += draw(shapes[i]) * math.sqrt(lrs[i])
    return total


def _run_optimizer(pkg, name, kw, mp, clip, grads, weights):
    """STEPS updates of three weights through one package's updater:
    (weights, flattened states) as float32 numpy."""
    dtype = "bfloat16" if mp else "float32"
    if pkg == "jax":
        import mxnet_tpu as mx
        from mxnet_tpu import nd
        mx.random.seed(7)
        arr = lambda a: nd.array(a)     # noqa: E731
        opt = mx.optimizer.create(name, **kw, multi_precision=mp,
                                  clip_gradient=clip)
        upd = mx.optimizer.get_updater(opt)
    else:
        arr = lambda a: mt.nd.array(a, ctx=CPU)     # noqa: E731
        extra = {"generator": torch.Generator().manual_seed(7)} \
            if name == "sgld" else {}
        opt = mt.optimizer.create(name, **kw, multi_precision=mp,
                                  clip_gradient=clip, **extra)
        upd = mt.optimizer.get_updater(opt)
    opt.set_lr_mult({0: 0.5, 2: 2.0})
    opt.set_wd_mult({1: 3.0})
    ws = [arr(w).astype(dtype) for w in weights]
    ptrs = [w._data.data_ptr() for w in ws] if pkg == "port" else None
    for step in range(STEPS):
        for i, w in enumerate(ws):
            upd(i, arr(grads[step][i]).astype(dtype), w)
    if ptrs is not None:           # the port writes in place
        assert [w._data.data_ptr() for w in ws] == ptrs
    states = [np.asarray(s.astype("float32").asnumpy())
              for i in range(len(ws)) for s in _flat_state(upd.states[i])]
    return [w.astype("float32").asnumpy() for w in ws], states, opt


@pytest.mark.parametrize("mp", [False, True], ids=["f32", "mp_bf16"])
@pytest.mark.parametrize("clip", [None, 0.7], ids=["noclip", "clip"])
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_optimizer_class_matches_jax(name, clip, mp):
    rs = np.random.RandomState(sorted(CLASSES).index(name))
    kw = dict(CLASSES[name], rescale_grad=0.5)
    if name not in ("groupadagrad", "sgld"):
        kw["wd"] = 0.01
    weights = [rs.randn(*s).astype(np.float32) for s in WSHAPES]
    grads = [[rs.randn(*s).astype(np.float32) for s in WSHAPES]
             for _ in range(STEPS)]
    if mp:   # the masters start from the bf16 weights, in both packages
        weights = [torch.from_numpy(w).bfloat16().float().numpy()
                   for w in weights]
    jw, js, jopt = _run_optimizer("jax", name, kw, mp, clip, grads, weights)
    tw, ts, topt = _run_optimizer("port", name, kw, mp, clip, grads,
                                  weights)
    assert len(js) == len(ts)
    if name == "sgld":
        import jax.random as jr
        import mxnet_tpu as mx
        from mxnet_tpu import random as jrand
        lrs = [topt._get_lr(i) for i in range(3)]
        jn = _sgld_noise(3, WSHAPES, lrs, lambda: mx.random.seed(7),
                         lambda s: np.asarray(jr.normal(jrand.next_key(), s)))
        gen = torch.Generator().manual_seed(7)
        tn = _sgld_noise(3, WSHAPES, lrs, lambda: None,
                         lambda s: torch.randn(s, generator=gen).numpy())
        if mp:     # the f32 masters carry the noise
            jw = [s for s in js]
            tw = [s for s in ts]
        jw = [a - n for a, n in zip(jw, jn)]
        tw = [a - n for a, n in zip(tw, tn)]
        js = ts = []
    for a, b in zip(tw, jw):
        if mp and name != "sgld":
            # bf16 weights are the masters rounded: one bf16 ulp apart at
            # most where the f32 masters straddle a rounding boundary
            np.testing.assert_allclose(a, b, rtol=2 ** -7, atol=1e-6)
        else:
            np.testing.assert_allclose(a, b, **STEP_TOL)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a, b, **STEP_TOL)
    assert topt.num_update == jopt.num_update
    assert topt._index_update_count == jopt._index_update_count


def test_sgld_noise_comes_from_the_given_generator():
    rs = np.random.RandomState(0)
    w0 = rs.randn(64, 64).astype(np.float32)
    outs = []
    for _ in range(2):
        opt = mt.optimizer.SGLD(learning_rate=0.01,
                                generator=torch.Generator().manual_seed(3))
        w = mt.nd.array(w0, ctx=CPU)
        opt.update(0, w, mt.nd.zeros((64, 64), ctx=CPU), None)
        outs.append(w.asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])
    noise = outs[0] - w0
    assert abs(noise.std() - 0.1) < 0.01        # N(0, lr): std sqrt(lr)
    pickle.loads(pickle.dumps(opt))             # pickles without it


def test_optimizer_registry_and_lr_resolution():
    assert sorted(mt.optimizer.Optimizer.opt_registry) == sorted(
        list(CLASSES) + [])
    with pytest.raises(mt.MXNetError):
        mt.optimizer.create("nosuch")
    opt = mt.optimizer.SGD(learning_rate=0.2, wd=0.1,
                           param_idx2name={3: "fc_weight"})
    opt.set_lr_mult({"fc_weight": 0.5})
    opt.set_wd_mult({0: 2.0})
    assert opt._get_lr(3) == 0.1 and opt._get_lr(0) == 0.2
    assert opt._get_wd(0) == 0.2 and opt._get_wd(3) == 0.1
    net = mt.gluon.nn.Dense(2, in_units=3, device="cpu")
    p = net.collect_params()[net.prefix + "weight"]
    p.lr_mult, p.wd_mult = 3.0, 0.0
    opt = mt.optimizer.SGD(learning_rate=0.1, wd=0.1, param_dict={0: p})
    assert opt._get_lr(0) == pytest.approx(0.3) and opt._get_wd(0) == 0.0
    sched = mt.lr_scheduler.FactorScheduler(step=2, factor=0.5)
    opt = mt.optimizer.SGD(learning_rate=0.4, lr_scheduler=sched)
    assert sched.base_lr == 0.4 and opt.learning_rate == 0.4
    with pytest.raises(mt.MXNetError, match="lr_scheduler"):
        opt.set_learning_rate(0.1)


# ---------------------------------------------------------------------------
# schedulers
# ---------------------------------------------------------------------------

SCHEDULERS = {
    "LRScheduler": None,
    "FactorScheduler": dict(step=3, factor=0.5, stop_factor_lr=0.01,
                            base_lr=0.4, warmup_steps=2,
                            warmup_begin_lr=0.05),
    "MultiFactorScheduler": dict(step=[3, 7, 9], factor=0.3, base_lr=0.4,
                                 warmup_steps=2, warmup_mode="constant",
                                 warmup_begin_lr=0.02),
    "PolyScheduler": dict(max_update=12, base_lr=0.4, pwr=2, final_lr=0.01,
                          warmup_steps=3, warmup_begin_lr=0.1),
    "CosineScheduler": dict(max_update=12, base_lr=0.4, final_lr=0.01,
                            warmup_steps=3),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_matches_jax(name):
    from mxnet_tpu import lr_scheduler as jls
    kw = SCHEDULERS[name]
    if kw is None:     # the base class: warm-up only
        for mode in ("linear", "constant"):
            j = jls.LRScheduler(0.4, 5, 0.1, mode)
            t = mt.lr_scheduler.LRScheduler(0.4, 5, 0.1, mode)
            assert [t.get_warmup_lr(n) for n in range(5)] == \
                [j.get_warmup_lr(n) for n in range(5)]
        with pytest.raises(mt.MXNetError):
            mt.lr_scheduler.LRScheduler(warmup_mode="cubic")
        return
    j, t = getattr(jls, name)(**kw), getattr(mt.lr_scheduler, name)(**kw)
    got = [t(n) for n in range(16)]
    assert got == [j(n) for n in range(16)]
    assert len(set(got)) > 3


# ---------------------------------------------------------------------------
# Updater states
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["adam", "sgd", "rmsprop"])
def test_updater_states_resume_equals_uninterrupted(name):
    rs = np.random.RandomState(2)
    kw = dict(CLASSES[name], wd=0.01)
    weights = [rs.randn(*s).astype(np.float32) for s in WSHAPES]
    grads = [[rs.randn(*s).astype(np.float32) for s in WSHAPES]
             for _ in range(4)]

    def run(stop_at):
        opt = mt.optimizer.create(name, **kw)
        upd = mt.optimizer.get_updater(opt)
        ws = [mt.nd.array(w, ctx=CPU) for w in weights]
        for step in range(4):
            if step == stop_at:
                blob = upd.get_states()
                opt = mt.optimizer.create(name, **kw)
                upd = mt.optimizer.get_updater(opt)
                with CPU:
                    upd.set_states(blob)
                assert opt._index_update_count == {0: 2, 1: 2, 2: 2}
                assert opt.num_update == 2
            for i, w in enumerate(ws):
                upd(i, mt.nd.array(grads[step][i], ctx=CPU), w)
        return [w.asnumpy() for w in ws], upd

    (ref, uref), (got, ugot) = run(None), run(2)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    for i in range(3):
        for a, b in zip(_flat_state(uref.states[i]),
                        _flat_state(ugot.states[i])):
            np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())
    blob = ugot.get_states(dump_optimizer=True)
    fresh = mt.optimizer.get_updater(mt.optimizer.create(name))
    with CPU:
        fresh.set_states(blob)
    assert fresh.optimizer._index_update_count == {0: 4, 1: 4, 2: 4}


if __name__ == "__main__":
    if sys.argv[2:] == ["f64"]:
        _f64_jax_ops(sys.argv[1])
    else:
        _bf16_jax_ops(sys.argv[1])
