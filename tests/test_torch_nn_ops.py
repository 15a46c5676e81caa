"""The ``ops/nn.py`` operators of the port against the JAX package's.

Every op name and alias that ``mxnet_tpu/ops/nn.py`` registers is in the
port's registry with the same ``num_outputs``, ``aux_inputs`` and ``rng``.
Then parity on the CPU, the same numpy inputs through both packages'
registered functions (``jax.vjp`` on the JAX side, torch autograd on the
port's): the options ``tests/op_cases.py`` does not reach (1-d and 3-d and
channel-last convolutions, Deconvolution's stride / pad / adj, every pool
type and convention, every activation, the softmax options, the
normalisations), the loss heads' defined gradients, the fused epilogue
ops through ``mx.nd`` with the mode from ``autograd.record()``, and
Dropout's rules (its mask comes from a torch generator, so it is held to
its definition, not to JAX's draws).

Tolerances are the JAX package's own (``tests/test_gluon.py``): f32 1e-5
for forward values and 1e-4 for gradients, relative and absolute.
"""
import ast
import os

import numpy as np
import pytest
import torch

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import fused_bn_act as tk
from mxnet_tpu_torch.ops import registry as treg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


def _registered_in_jax_nn():
    """Names and aliases of the ``register(...)`` decorators of the JAX
    package's ops/nn.py, read from its source."""
    tree = ast.parse(open(os.path.join(ROOT, "mxnet_tpu", "ops",
                                       "nn.py")).read())
    names = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.FunctionDef):
            continue
        for dec in node.decorator_list:
            if isinstance(dec, ast.Call) and getattr(dec.func, "id", "") \
                    == "register":
                names.append(dec.args[0].value)
                for kw in dec.keywords:
                    if kw.arg == "aliases":
                        names += [e.value for e in kw.value.elts]
    return names


def test_every_nn_op_and_alias_is_registered_with_the_same_metadata():
    names = _registered_in_jax_nn()
    assert len(names) == 40 and len(set(names)) == 40
    ported = set(treg.list_ops())
    assert set(names) <= ported
    for n in names:
        j, t = jreg.get_op(n), treg.get_op(n)
        assert t.name == j.name, n
        assert t.num_outputs == j.num_outputs, n
        assert t.aux_inputs == j.aux_inputs, n
        assert t.rng == j.rng, n
        assert t.differentiable == j.differentiable, n
        assert t.variadic == j.variadic, n


# ---------------------------------------------------------------------------
# parity: forward and gradients of the registered functions
# ---------------------------------------------------------------------------

def _jax_fwd_vjp(name, inputs, params, diff, cot_seed):
    import jax
    import jax.numpy as jnp
    fn = jreg.get_op(name).fn
    arrs = [jnp.asarray(a) for a in inputs]

    def f(*d):
        full = list(arrs)
        for i, v in zip(diff, d):
            full[i] = v
        out = fn(*full, **params)
        return out[0] if isinstance(out, tuple) else out

    out, vjp = jax.vjp(f, *[arrs[i] for i in diff])
    cot = np.asarray(np.random.RandomState(cot_seed).randn(*out.shape),
                     np.float32)
    grads = vjp(jnp.asarray(cot).astype(out.dtype)) if diff else ()
    return np.asarray(out), [np.asarray(g) for g in grads], cot


def _port_fwd_grad(name, inputs, params, diff, cot):
    fn = treg.get_op(name).fn
    ts = [torch.from_numpy(np.array(a)) for a in inputs]
    for i in diff:
        ts[i].requires_grad_(True)
    out = fn(*ts, **params)
    out = out[0] if isinstance(out, tuple) else out
    if diff:
        out.backward(torch.from_numpy(cot).to(out.dtype))
    return out.detach().numpy(), [ts[i].grad.numpy() for i in diff]


def _parity(name, inputs, params, diff=(0,), fwd=FWD, grad=GRAD, seed=0):
    want, wgrads, cot = _jax_fwd_vjp(name, inputs, params, diff, seed)
    got, ggrads = _port_fwd_grad(name, inputs, params, diff, cot)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, err_msg=f"{name} forward", **fwd)
    for k, (g, w) in enumerate(zip(ggrads, wgrads)):
        np.testing.assert_allclose(g, w, err_msg=f"{name} grad {k}", **grad)


RS = np.random.RandomState(7)     # the case tables, built at import


def _n(*shape, seed=None):
    rs = RS if seed is None else np.random.RandomState(seed)
    return rs.randn(*shape).astype(np.float32)


CONV = [
    ("Convolution", (_n(2, 3, 9), _n(4, 3, 3)),
     {"kernel": (3,), "num_filter": 4, "no_bias": True, "stride": (2,),
      "pad": (1,)}),
    ("Convolution", (_n(2, 9, 3), _n(4, 3, 3), _n(4)),
     {"kernel": (3,), "num_filter": 4, "layout": "NWC", "dilate": (2,)}),
    ("Convolution", (_n(1, 2, 5, 6, 4), _n(3, 2, 3, 3, 2)),
     {"kernel": (3, 3, 2), "num_filter": 3, "no_bias": True,
      "pad": (1, 0, 1)}),
    ("Convolution", (_n(1, 5, 6, 4, 4), _n(4, 3, 3, 2, 2), _n(4)),
     {"kernel": (3, 3, 2), "num_filter": 4, "layout": "NDHWC",
      "num_group": 2, "stride": (2, 1, 1)}),
    ("Convolution", (_n(2, 7, 7, 4), _n(6, 3, 3, 2), _n(6)),
     {"kernel": (3, 3), "num_filter": 6, "layout": "NHWC", "num_group": 2,
      "dilate": (2, 2), "pad": (2, 2)}),
    ("Deconvolution", (_n(2, 3, 4, 5), _n(3, 2, 3, 3)),
     {"kernel": (3, 3), "num_filter": 2, "stride": (2, 2), "pad": (1, 1),
      "adj": (1, 0)}),
    ("Deconvolution", (_n(2, 4, 5, 3), _n(3, 4, 2, 2), _n(4)),
     {"kernel": (2, 2), "num_filter": 4, "stride": (2, 2), "no_bias": False,
      "layout": "NHWC"}),
    ("Deconvolution", (_n(1, 2, 6), _n(2, 3, 3)),
     {"kernel": (3,), "num_filter": 3, "stride": (3,), "dilate": (2,),
      "adj": (2,)}),
    ("Deconvolution", (_n(1, 2, 3, 3, 2), _n(2, 2, 2, 2, 2)),
     {"kernel": (2, 2, 2), "num_filter": 2, "stride": (2, 2, 2),
      "pad": (1, 0, 0)}),
    ("FullyConnected", (_n(3, 4, 5), _n(6, 5), _n(6)),
     {"num_hidden": 6, "flatten": False}),
    ("FullyConnected", (_n(3, 2, 5), _n(6, 10)),
     {"num_hidden": 6, "no_bias": True}),
]


@pytest.mark.parametrize("case", range(len(CONV)))
def test_convolution_family_matches_jax(case):
    name, inputs, params = CONV[case]
    _parity(name, inputs, params, diff=tuple(range(len(inputs))),
            grad=dict(rtol=1e-4, atol=2e-4))


@pytest.mark.parametrize("hw", [12, 16, 24])
def test_strided_1x1_channel_last_convolution_at_8_threads(hw):
    """A ResNet downsample convolution (1x1, stride 2, NHWC, 8 -> 16
    channels, batch 4): at 8 intra-op threads PyTorch's CPU build alone
    gives it a wrong weight gradient or crashes
    (``tools/torch_cpu_strided_conv_probe.py``); the port's convolution
    matches JAX at 8 threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        _parity("Convolution", (_n(4, hw, hw, 8, seed=hw),
                                _n(16, 1, 1, 8, seed=hw + 1)),
                {"kernel": (1, 1), "num_filter": 16, "no_bias": True,
                 "stride": (2, 2), "layout": "NHWC"}, diff=(0, 1),
                grad=dict(rtol=1e-4, atol=2e-4))
    finally:
        torch.set_num_threads(prev)


def test_deconvolution_target_shape_must_be_the_output_extent():
    x, w = torch.zeros(1, 2, 4, 4), torch.zeros(2, 3, 3, 3)
    kw = {"kernel": (3, 3), "num_filter": 3, "stride": (2, 2)}
    out = treg.get_op("Deconvolution").fn(x, w, target_shape=(9, 9), **kw)
    assert out.shape == (1, 3, 9, 9)
    with pytest.raises(MXNetError, match="target_shape"):
        treg.get_op("Deconvolution").fn(x, w, target_shape=(10, 10), **kw)


POOL = [
    ((2, 3, 7, 7), {"kernel": (3, 3), "stride": (2, 2),
                    "pooling_convention": "full", "pool_type": "max"}),
    ((2, 3, 7, 6), {"kernel": (3, 2), "stride": (2, 2), "pad": (1, 1),
                    "pooling_convention": "full", "pool_type": "avg"}),
    ((2, 3, 7, 6), {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                    "pool_type": "avg", "count_include_pad": False}),
    ((2, 3, 8, 7), {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
                    "pooling_convention": "full", "pool_type": "avg",
                    "count_include_pad": False}),
    ((2, 8, 7, 3), {"kernel": (2, 2), "stride": (2, 2), "pool_type": "sum",
                    "layout": "NHWC", "pooling_convention": "full"}),
    ((2, 3, 6, 6), {"kernel": (2, 2), "stride": (2, 2), "pool_type": "lp",
                    "p_value": 3}),
    ((2, 3, 9), {"kernel": (3,), "stride": (2,), "pad": (1,),
                 "pool_type": "max"}),
    ((2, 9, 3), {"kernel": (2,), "stride": (2,), "pool_type": "avg",
                 "layout": "NWC", "pooling_convention": "full"}),
    ((1, 2, 5, 4, 6), {"kernel": (2, 2, 3), "stride": (2, 1, 2),
                       "pool_type": "max", "pooling_convention": "full"}),
    ((1, 5, 4, 6, 2), {"kernel": (3, 2, 2), "stride": (1, 2, 2),
                       "pad": (1, 0, 1), "pool_type": "avg",
                       "layout": "NDHWC", "count_include_pad": False}),
    ((2, 3, 5, 4), {"kernel": (5, 5), "stride": (1, 1), "pad": (3, 3),
                    "pool_type": "max"}),
    ((2, 3, 5, 4), {"global_pool": True, "pool_type": "max",
                    "kernel": (1, 1)}),
    ((2, 5, 4, 3), {"global_pool": True, "pool_type": "lp", "p_value": 2,
                    "kernel": (1, 1), "layout": "NHWC"}),
    ((2, 3, 5, 4, 2), {"global_pool": True, "pool_type": "sum",
                       "kernel": (1, 1, 1)}),
    ((2, 3, 5), {"global_pool": True, "pool_type": "avg", "kernel": (1,)}),
]


@pytest.mark.parametrize("case", range(len(POOL)))
def test_pooling_conventions_and_types_match_jax(case):
    shape, params = POOL[case]
    _parity("Pooling", (_n(*shape, seed=100 + case),), params)


ACTS = [("Activation", {"act_type": a}) for a in
        ("relu", "sigmoid", "tanh", "softrelu", "softsign")] + \
    [("LeakyReLU", {"act_type": a, "slope": 0.3}) for a in
     ("leaky", "elu", "selu", "gelu", "rrelu")]


@pytest.mark.parametrize("name,params", ACTS,
                         ids=[p["act_type"] for _, p in ACTS])
def test_activations_match_jax(name, params):
    _parity(name, (_n(4, 3, 5, seed=len(params["act_type"])),), params)


def test_prelu_per_channel_gamma_matches_jax():
    _parity("LeakyReLU", (_n(2, 3, 4, 4, seed=1),
                           np.array([0.1, 0.2, 0.3], np.float32)),
            {"act_type": "prelu"}, diff=(0, 1))


SOFTMAX = [
    ("softmax", (_n(3, 5),), {"axis": 0, "temperature": 0.5}),
    ("softmax", (_n(2, 4, 3),), {"axis": 1, "dtype": "float64"}),
    ("log_softmax", (_n(3, 6), np.array([2, 6, 1], np.float32)),
     {"use_length": True}),
    ("log_softmax", (_n(4, 3),), {"temperature": 3.0}),
    ("softmin", (_n(3, 4), np.array([1, 0, 4], np.float32)),
     {"use_length": True, "temperature": 2.0}),
    ("softmax", (_n(4, 2, 3), np.array([[1, 2], [0, 1], [2, 2]],
                                       np.float32).T.copy()),
     {"use_length": True, "axis": 0}),
    ("SoftmaxActivation", (_n(2, 3, 4),), {"mode": "channel"}),
    ("SoftmaxActivation", (_n(2, 3, 4),), {}),
    ("softmax_cross_entropy", (_n(4, 5), np.array([1, 0, 4, 2], np.float32)),
     {}),
]


@pytest.mark.parametrize("case", range(len(SOFTMAX)))
def test_softmax_family_options_match_jax(case):
    name, inputs, params = SOFTMAX[case]
    if params.get("dtype") == "float64":      # JAX runs without x64
        params = dict(params, dtype="float32")
    _parity(name, inputs, params)


NORMS = [
    ("LayerNorm", (_n(3, 4, 5), _n(4) + 1, _n(4)), {"axis": 1, "eps": 1e-3}),
    ("InstanceNorm", (_n(2, 3, 4, 5), _n(3) + 1, _n(3)), {"eps": 1e-4}),
    ("L2Normalization", (_n(2, 3, 4),), {"mode": "channel"}),
    ("L2Normalization", (_n(2, 3, 4, 2),), {"mode": "spatial"}),
    ("LRN", (_n(2, 5, 3, 3),), {"nsize": 5, "alpha": 0.1, "beta": 0.5,
                                 "knorm": 1.0}),
]


@pytest.mark.parametrize("case", range(len(NORMS)))
def test_normalisations_match_jax(case):
    name, inputs, params = NORMS[case]
    _parity(name, inputs, params, diff=tuple(range(len(inputs))))


def test_layer_norm_returns_mean_and_var_as_jax():
    import jax.numpy as jnp
    x, g, b = _n(3, 4, 5, seed=2), _n(5, seed=3), _n(5, seed=4)
    want = jreg.get_op("LayerNorm").fn(*map(jnp.asarray, (x, g, b)),
                                       output_mean_var=True)
    got = treg.get_op("LayerNorm").fn(*map(torch.from_numpy, (x, g, b)),
                                      output_mean_var=True)
    assert len(got) == len(want) == 3
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **FWD)


MISC = [
    ("UpSampling", (_n(1, 2, 3, 4),), {"scale": 2, "sample_type": "bilinear"},
     (0,)),
    ("UpSampling", (_n(1, 2, 2, 3),), {"scale": 3}, (0,)),
    ("GridGenerator", (_n(2, 6),), {"transform_type": "affine",
                                    "target_shape": (3, 4)}, (0,)),
    ("Embedding", (np.array([[0, 5, -1], [2, -4, 3]], np.float32), _n(4, 3)),
     {"input_dim": 4, "output_dim": 3}, (1,)),
    ("SequenceMask", (_n(2, 4, 3), np.array([1, 3], np.float32)),
     {"use_sequence_length": True, "axis": 1, "value": -2.0}, (0,)),
    ("SequenceLast", (_n(2, 4, 3), np.array([4, 2], np.float32)),
     {"use_sequence_length": True, "axis": 1}, (0,)),
    ("SequenceLast", (_n(4, 2, 3),), {}, (0,)),
    ("SequenceReverse", (_n(4, 2, 3),), {}, (0,)),
]


@pytest.mark.parametrize("case", range(len(MISC)))
def test_upsampling_embedding_and_sequence_ops_match_jax(case):
    name, inputs, params, diff = MISC[case]
    _parity(name, inputs, params, diff=diff)


# ---------------------------------------------------------------------------
# the heads' defined gradients
# ---------------------------------------------------------------------------

def _label(hi, shape, seed):
    return np.random.RandomState(seed).randint(0, hi, shape) \
        .astype(np.float32)


HEADS = [
    ("SoftmaxOutput", (_n(4, 5), _label(5, (4,), 1)), {}),
    ("SoftmaxOutput", (_n(4, 5), np.array([1, -1, 3, -1], np.float32)),
     {"use_ignore": True, "normalization": "valid", "grad_scale": 2.0}),
    ("SoftmaxOutput", (_n(4, 5), np.array([-1, -1, -1, -1], np.float32)),
     {"use_ignore": True, "normalization": "valid"}),
    ("SoftmaxOutput", (_n(4, 5), _label(5, (4,), 2)),
     {"normalization": "batch", "smooth_alpha": 0.1}),
    ("Softmax", (_n(3, 4, 6), _label(4, (3, 6), 3)),
     {"multi_output": True, "ignore_label": 2, "use_ignore": True,
      "normalization": "valid"}),
    ("LinearRegressionOutput", (_n(3, 4), _n(3, 4)), {"grad_scale": 0.5}),
    ("MAERegressionOutput", (_n(3, 4), _n(12)), {"grad_scale": 3.0}),
    ("LogisticRegressionOutput", (_n(3, 4), _n(3, 4)), {"grad_scale": 2.0}),
    ("SVMOutput", (_n(4, 5), _label(5, (4,), 4)),
     {"margin": 0.5, "regularization_coefficient": 2.0}),
    ("SVMOutput", (_n(4, 5), _label(5, (4,), 5)),
     {"use_linear": True, "margin": 0.3}),
    ("MakeLoss", (_n(3, 4),), {"grad_scale": 0.5}),
    ("MakeLoss", (_n(3, 4),), {"normalization": "batch"}),
    ("MakeLoss", (_n(3, 4),), {"normalization": "valid",
                               "valid_thresh": 0.2, "grad_scale": 3.0}),
    ("IdentityAttachKLSparseReg", (RS.uniform(0.05, 0.95, (4, 6))
                                   .astype(np.float32),),
     {"sparseness_target": 0.2, "penalty": 0.01}),
]


@pytest.mark.parametrize("case", range(len(HEADS)))
def test_heads_give_the_jax_packages_defined_gradient(case):
    """Forward and the data gradient against ``jax.vjp`` of the JAX op,
    which returns its custom_vjp's gradient."""
    name, inputs, params = HEADS[case]
    _parity(name, inputs, params, seed=case)


def test_head_gradients_go_through_mx_nd_record_backward():
    x, y = _n(4, 5, seed=5), _label(5, (4,), 6)
    with mt.cpu():
        tx = mt.nd.array(x)
        tx.attach_grad()
        with mt.autograd.record():
            out = mt.nd.SoftmaxOutput(tx, mt.nd.array(y), grad_scale=0.5)
        out.backward()
    jx = jnd.array(x)
    jx.attach_grad()
    with jag.record():
        jout = jnd.SoftmaxOutput(jx, jnd.array(y), grad_scale=0.5)
    jout.backward()
    np.testing.assert_allclose(out.asnumpy(), jout.asnumpy(), **FWD)
    np.testing.assert_allclose(tx.grad.asnumpy(), jx.grad.asnumpy(), **GRAD)


# ---------------------------------------------------------------------------
# BatchNorm and the fused epilogue ops through mx.nd
# ---------------------------------------------------------------------------

def _bn_inputs(c, channel_last, seed):
    rs = np.random.RandomState(seed)
    shape = (2, 3, 4, c) if channel_last else (2, c, 3, 4)
    return [(rs.randn(*shape) * 2 + 1).astype(np.float32),
            (rs.rand(c) + 0.5).astype(np.float32),
            rs.randn(c).astype(np.float32),
            rs.randn(c).astype(np.float32),
            (rs.rand(c) + 0.5).astype(np.float32)]


@pytest.mark.parametrize("name,res", [("BatchNorm", False),
                                      ("_contrib_fused_bn_relu", False),
                                      ("_contrib_fused_bn_add_relu", True)])
@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_ops_through_mx_nd_match_jax(name, res, train):
    """``mx.nd`` fills ``_training`` from autograd's mode in both packages:
    under ``record()`` the batch statistics, outside it the moving ones.
    The outputs (out, mean, var) and the gradients of data, residual,
    gamma and beta match; the moving statistics are not written by the
    op, in either package."""
    ins = _bn_inputs(5, name != "BatchNorm", 3)
    if res:
        ins.insert(1, np.random.RandomState(4).randn(*ins[0].shape)
                   .astype(np.float32))
    params = {"fix_gamma": False} if name == "BatchNorm" else {}
    if name == "BatchNorm":
        params["axis"] = 1
    diff = list(range(len(ins) - 2))
    cot = np.random.RandomState(5).randn(*ins[0].shape).astype(np.float32)

    def run(nd, ag, ctx):
        with ctx:
            arrs = [nd.array(a) for a in ins]
            for i in diff:
                arrs[i].attach_grad()
            scope = ag.record() if train else ag.pause()
            with scope:
                outs = getattr(nd, name)(*arrs, **params) \
                    if hasattr(nd, name) \
                    else getattr(nd._internal, name)(*arrs, **params)
            if train:
                outs[0].backward(nd.array(cot))
            return ([o.asnumpy() for o in outs],
                    [arrs[i].grad.asnumpy() for i in diff] if train else [],
                    [a.asnumpy() for a in arrs[-2:]])

    import contextlib
    want = run(jnd, jag, contextlib.nullcontext())
    tk.reset_launches()
    got = run(mt.nd, mt.autograd, mt.cpu())
    assert not any(tk.launches.values())     # host: plain versions
    for g, w in zip(got[0], want[0]):
        np.testing.assert_allclose(g, w, **FWD)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, **GRAD)
    for g, start in zip(got[2], ins[-2:]):
        np.testing.assert_array_equal(g, start)


# ---------------------------------------------------------------------------
# Dropout
# ---------------------------------------------------------------------------

def _dropout(x, training, **kw):
    return treg.get_op("Dropout").fn(torch.from_numpy(x), _training=training,
                                     **kw)


def test_dropout_is_the_identity_outside_training():
    x = _n(50, 40, seed=6)
    np.testing.assert_array_equal(_dropout(x, False, p=0.5).numpy(), x)
    np.testing.assert_array_equal(_dropout(x, True, p=0.0).numpy(), x)
    with mt.cpu():                         # mx.nd: the mode from autograd
        out = mt.nd.Dropout(mt.nd.array(x), p=0.5)
        np.testing.assert_array_equal(out.asnumpy(), x)
        with mt.autograd.record():
            dropped = mt.nd.Dropout(mt.nd.array(x), p=0.5)
        assert (dropped.asnumpy() == 0).any()
        with mt.autograd.record(train_mode=False):
            kept = mt.nd.Dropout(mt.nd.array(x), p=0.5)
        np.testing.assert_array_equal(kept.asnumpy(), x)
    # mode="always" drops outside training too
    assert (_dropout(x, False, p=0.5, mode="always").numpy() == 0).any()


def test_dropout_keeps_x_over_one_minus_p_at_rate_p():
    p, n = 0.3, 200_000
    x = np.random.RandomState(7).uniform(0.5, 2.0, (n,)).astype(np.float32)
    gen = torch.Generator().manual_seed(11)
    out = _dropout(x, True, p=p, generator=gen).numpy()
    kept = out != 0
    want = (torch.from_numpy(x) / (1.0 - p)).numpy()
    np.testing.assert_array_equal(out[kept], want[kept])
    sigma = np.sqrt(p * (1 - p) / n)
    assert abs((1 - kept.mean()) - p) <= 3 * sigma
    # the same generator state gives the same mask
    again = _dropout(x, True, p=p,
                     generator=torch.Generator().manual_seed(11)).numpy()
    np.testing.assert_array_equal(out, again)


def test_dropout_axes_broadcast_the_mask():
    x = np.random.RandomState(8).uniform(0.5, 2.0, (6, 5, 40)) \
        .astype(np.float32)
    out = _dropout(x, True, p=0.5, axes=(1,),
                   generator=torch.Generator().manual_seed(3)).numpy()
    kept = out != 0
    assert (kept == kept[:, :1, :]).all()          # one mask along axis 1
    assert 0 < kept.mean() < 1
    out2 = _dropout(x, True, p=0.5, axes=(0, -1),
                    generator=torch.Generator().manual_seed(4)).numpy()
    kept2 = out2 != 0
    assert (kept2 == kept2[:1, :, :1]).all()


def test_dropout_gradient_is_the_mask_over_keep():
    x = torch.from_numpy(np.random.RandomState(9).uniform(
        0.5, 2.0, (30, 20)).astype(np.float32))
    x.requires_grad_(True)
    out = treg.get_op("Dropout").fn(
        x, p=0.25, _training=True, generator=torch.Generator().manual_seed(1))
    out.sum().backward()
    mask = (out.detach() != 0).float()
    torch.testing.assert_close(x.grad, mask / 0.75, rtol=0, atol=0)
