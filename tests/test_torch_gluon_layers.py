"""Gluon's layers, deferred initialisation, initializers and losses in the
port against the JAX package.

Each layer is built in both packages without its input width where it
can defer it, initialised, and called once: the parameter names (after
the block's prefix) and the resolved shapes must be the JAX package's.
The JAX weights are then carried across with ``convert`` and both run
``record()`` / ``net(x)`` / ``backward()`` on the same numpy input and
head gradient: outputs, the input's gradient and every parameter's
``grad()`` are compared (running statistics too, for the BatchNorm
layers). Initializers: the deterministic ones value for value, the name
rules of every registered one, and the random ones by their bounds and
moments (the two packages draw from different generators). Losses: value
and the prediction's gradient.

Tolerances are the JAX package's (``tests/test_gluon.py``): f32 1e-5
forward, 1e-4 gradients.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, nd
from mxnet_tpu import initializer as jinit
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, convert
from mxnet_tpu_torch import initializer as tinit
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.parameter import DeferredInitializationError
from mxnet_tpu_torch.ops.registry import NotPortedError

CPU = mt.cpu()
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _no_tf32():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = prev


@pytest.fixture(autouse=True)
def _jax_name_scope():
    """The JAX blocks of these tests take their names in a scope of their
    own, so the JAX package's global block counters, which other test
    files' names depend on, do not move."""
    from mxnet_tpu.gluon.block import nn_block_scope
    with nn_block_scope("gluon_layers_"):
        yield


def _n(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# (id, make(nn, **device), input shapes); each layer is made with the
# widths it can defer left unset
LAYERS = [
    ("dense", lambda nn, **d: nn.Dense(5, activation="tanh", **d),
     [(4, 3, 2)]),
    ("dense_noflat", lambda nn, **d: nn.Dense(4, flatten=False,
                                               use_bias=False, **d),
     [(3, 2, 6)]),
    ("conv1d", lambda nn, **d: nn.Conv1D(4, 3, strides=2, padding=1, **d),
     [(2, 3, 9)]),
    ("conv1d_nwc", lambda nn, **d: nn.Conv1D(4, 3, layout="NWC",
                                             activation="relu", **d),
     [(2, 9, 3)]),
    ("conv2d_nhwc", lambda nn, **d: nn.Conv2D(6, 3, padding=1, groups=2,
                                              layout="NHWC",
                                              activation="sigmoid", **d),
     [(2, 6, 6, 4)]),
    ("conv3d", lambda nn, **d: nn.Conv3D(3, (2, 3, 3), padding=(0, 1, 1),
                                         **d),
     [(1, 2, 4, 5, 5)]),
    ("conv1d_t", lambda nn, **d: nn.Conv1DTranspose(
        3, 3, strides=2, output_padding=1, **d), [(2, 4, 5)]),
    ("conv2d_t_nhwc", lambda nn, **d: nn.Conv2DTranspose(
        4, 3, strides=2, padding=1, output_padding=1, layout="NHWC", **d),
     [(2, 4, 4, 3)]),
    ("conv3d_t", lambda nn, **d: nn.Conv3DTranspose(2, 2, strides=2,
                                                    use_bias=False, **d),
     [(1, 3, 2, 3, 2)]),
    ("batchnorm", lambda nn, **d: nn.BatchNorm(axis=1, **d), [(3, 4, 2, 2)]),
    ("instancenorm", lambda nn, **d: nn.InstanceNorm(scale=True, **d),
     [(2, 3, 5)]),
    ("layernorm", lambda nn, **d: nn.LayerNorm(**d), [(3, 4, 6)]),
    ("flatten", lambda nn, **d: nn.Flatten(**d), [(2, 3, 4)]),
    ("leaky", lambda nn, **d: nn.LeakyReLU(0.2, **d), [(3, 5)]),
    ("prelu", lambda nn, **d: nn.PReLU(**d), [(3, 5)]),
    ("elu", lambda nn, **d: nn.ELU(0.7, **d), [(3, 5)]),
    ("selu", lambda nn, **d: nn.SELU(**d), [(3, 5)]),
    ("gelu", lambda nn, **d: nn.GELU(**d), [(3, 5)]),
    ("swish", lambda nn, **d: nn.Swish(1.5, **d), [(3, 5)]),
    ("maxpool1d_ceil", lambda nn, **d: nn.MaxPool1D(3, 2, ceil_mode=True,
                                                    **d), [(2, 3, 8)]),
    ("maxpool2d_ceil", lambda nn, **d: nn.MaxPool2D(3, 2, 1, ceil_mode=True,
                                                    **d), [(2, 3, 8, 7)]),
    ("maxpool2d_nhwc", lambda nn, **d: nn.MaxPool2D(2, layout="NHWC", **d),
     [(2, 6, 6, 3)]),
    ("maxpool3d_ceil", lambda nn, **d: nn.MaxPool3D(2, ceil_mode=True, **d),
     [(1, 2, 5, 4, 3)]),
    ("avgpool1d", lambda nn, **d: nn.AvgPool1D(2, ceil_mode=True,
                                               count_include_pad=False, **d),
     [(2, 3, 7)]),
    ("avgpool2d_pad", lambda nn, **d: nn.AvgPool2D(
        3, 2, 1, count_include_pad=False, **d), [(2, 3, 7, 6)]),
    ("avgpool2d_ceil", lambda nn, **d: nn.AvgPool2D(3, 2, 1, ceil_mode=True,
                                                    **d), [(2, 3, 8, 6)]),
    ("avgpool3d_ndhwc", lambda nn, **d: nn.AvgPool3D(2, layout="NDHWC", **d),
     [(1, 4, 4, 2, 3)]),
    ("gmax1d", lambda nn, **d: nn.GlobalMaxPool1D(**d), [(2, 3, 5)]),
    ("gmax2d", lambda nn, **d: nn.GlobalMaxPool2D(layout="NHWC", **d),
     [(2, 4, 3, 5)]),
    ("gmax3d", lambda nn, **d: nn.GlobalMaxPool3D(**d), [(1, 2, 3, 3, 2)]),
    ("gavg1d", lambda nn, **d: nn.GlobalAvgPool1D(**d), [(2, 3, 5)]),
    ("gavg3d", lambda nn, **d: nn.GlobalAvgPool3D(**d), [(1, 2, 3, 3, 2)]),
    ("reflectionpad", lambda nn, **d: nn.ReflectionPad2D(2, **d),
     [(1, 2, 4, 5)]),
    ("lambda", lambda nn, **d: nn.Lambda("tanh", **d), [(3, 4)]),
    ("hybridlambda", lambda nn, **d: nn.HybridLambda(
        lambda F, x: F.LeakyReLU(x, slope=0.1), **d), [(3, 4)]),
    ("hybridlambda_name", lambda nn, **d: nn.HybridLambda("sigmoid", **d),
     [(3, 4)]),
    ("fused_bn_relu", lambda nn, **d: nn.FusedBatchNormReLU(axis=-1, **d),
     [(2, 3, 3, 4)]),
    ("fused_bn_add_relu", lambda nn, **d: nn.FusedBatchNormAddReLU(axis=-1,
                                                                   **d),
     [(2, 3, 3, 4), (2, 3, 3, 4)]),
] + [(f"activation_{a}", lambda nn, a=a, **d: nn.Activation(a, **d),
      [(3, 5)]) for a in ("relu", "sigmoid", "tanh", "softrelu",
                          "softsign")]


def _sequential(nn, **d):
    net = nn.Sequential(**d)
    with net.name_scope():
        net.add(nn.Dense(8, activation="relu", **d))
        net.add(nn.Dense(3, **d))
    return net


LAYERS.append(("sequential", _sequential, [(4, 6)]))


def _shapes(block):
    strip = len(block.prefix)
    return {k[strip:]: tuple(p.shape)
            for k, p in block.collect_params().items()}


def _loop(nd_, ag, block, arrays, cot, grads_of):
    """``record()`` / ``block(x)`` / ``backward(cot)``: output, input
    gradients and each parameter's ``grad()``."""
    ins = [nd_.array(a) for a in arrays]
    for x in ins:
        x.attach_grad()
    with ag.record():
        out = block(*ins)
    out.backward(nd_.array(cot))
    strip = len(block.prefix)
    params = {k[strip:]: p.grad().asnumpy()
              for k, p in block.collect_params().items()
              if p.grad_req != "null" and k[strip:] in grads_of}
    return out.asnumpy(), [x.grad.asnumpy() for x in ins], params


@pytest.mark.parametrize("case", [c[0] for c in LAYERS])
def test_layer_with_deferred_init_matches_jax(case):
    _, build, shapes = next(c for c in LAYERS if c[0] == case)
    arrays = [_n(s, i + 3) for i, s in enumerate(shapes)]
    mx.random.seed(4)
    jb = build(jnn)
    tb = build(tnn, device="cpu")
    declared = _shapes(jb)
    assert _shapes(tb) == declared                # 0 where deferred
    jb.initialize(mx.init.Xavier())
    tb.initialize(mt.init.Xavier())
    with autograd.pause():
        jy = jb(*[nd.array(a) for a in arrays])
    tb(*[torch.from_numpy(a) for a in arrays])   # resolves the port's
    assert _shapes(tb) == _shapes(jb)
    params = {k: p.data().asnumpy() for k, p in jb.collect_params().items()}
    for k in params:            # gamma / beta away from their 1 / 0 start
        if k.endswith(("gamma", "beta", "running_mean")):
            params[k] = _n(params[k].shape, len(k))
            jb.collect_params()[k].set_data(nd.array(params[k]))
    convert.from_mxnet_tpu_params(tb, params, prefix=jb.prefix)
    cot = _n(jy.shape, 1)
    want = _loop(nd, autograd, jb, arrays, cot, _shapes(jb))
    with CPU:
        got = _loop(mt.nd, mt.autograd, tb, arrays, cot, _shapes(jb))
    np.testing.assert_allclose(got[0], want[0], err_msg="output", **FWD)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, err_msg="input grad", **GRAD)
    assert got[2].keys() == want[2].keys()
    for k in want[2]:
        np.testing.assert_allclose(got[2][k], want[2][k], err_msg=k, **GRAD)
    for k, p in jb.collect_params().items():     # running statistics
        if p.grad_req == "null":
            np.testing.assert_allclose(
                tb.collect_params()[tb.prefix + k[len(jb.prefix):]]
                .data().asnumpy(), p.data().asnumpy(), err_msg=k, **FWD)


def test_embedding_and_dropout_layers_match_jax():
    idx = np.array([[0, 3, 9], [2, 2, 7]], np.float32)
    mx.random.seed(1)
    jb = jnn.Embedding(10, 4)
    tb = tnn.Embedding(10, 4, device="cpu")
    jb.initialize()
    convert.from_mxnet_tpu_params(
        tb, {k: p.data().asnumpy() for k, p in jb.collect_params().items()},
        prefix=jb.prefix)
    cot = _n((2, 3, 4), 2)
    want = _loop(nd, autograd, jb, [idx], cot, {"weight"})
    with CPU:
        got = _loop(mt.nd, mt.autograd, tb, [idx], cot, {"weight"})
    np.testing.assert_allclose(got[0], want[0], **FWD)
    np.testing.assert_allclose(got[2]["weight"], want[2]["weight"], **GRAD)
    with pytest.raises(NotPortedError, match="A11"):
        tnn.Embedding(10, 4, sparse_grad=True, device="cpu")
    # Dropout outside training is the identity in both
    x = _n((4, 6), 3)
    drop = tnn.Dropout(0.5, device="cpu")
    np.testing.assert_array_equal(drop(torch.from_numpy(x)).numpy(), x)
    np.testing.assert_array_equal(jnn.Dropout(0.5)(nd.array(x)).asnumpy(), x)
    with mt.autograd.train_mode():
        out = drop(torch.from_numpy(x)).numpy()
    assert (out == 0).any() and np.allclose(out[out != 0],
                                            2 * x[out != 0])


# ---------------------------------------------------------------------------
# deferred initialisation
# ---------------------------------------------------------------------------

def test_deferred_parameters_resolve_on_the_first_forward_only():
    net = tnn.Dense(3, device="cpu")
    w = net.collect_params()[net.prefix + "weight"]
    assert w.shape == (3, 0) and w.tensor is None
    with pytest.raises(DeferredInitializationError):
        w.data()
    with pytest.raises(MXNetError, match="not initialized"):
        net(torch.zeros(2, 5))
    net.initialize(generator=torch.Generator().manual_seed(8))
    with pytest.raises(DeferredInitializationError):
        w.data()
    net(torch.zeros(2, 5))
    assert w.shape == (3, 5) and w.initialized
    assert w.tensor is net.weight and w.device == torch.device("cpu")
    t, ptr = net.weight, net.weight.data_ptr()
    net(torch.zeros(4, 5))                     # never rebound
    assert net.weight is t and net.weight.data_ptr() == ptr
    # the generator initialize() was given draws the deferred weight
    twin = tnn.Dense(3, device="cpu")
    twin.initialize(generator=torch.Generator().manual_seed(8))
    twin(torch.zeros(1, 5))
    assert torch.equal(twin.weight, net.weight)
    assert float(net.weight.detach().abs().max()) <= 0.07
    # set_data creates a deferred parameter from the value's shape
    other = tnn.Dense(3, device="cpu")
    p = other.collect_params()[other.prefix + "weight"]
    p.set_data(np.ones((3, 7), np.float32))
    assert p.shape == (3, 7) and torch.equal(other.weight, torch.ones(3, 7))
    fresh = tnn.Dense(3, device="cpu")
    with pytest.raises(MXNetError, match="does not match"):
        fresh.collect_params()[fresh.prefix + "weight"].set_data(
            np.ones((4, 7), np.float32))


def test_a_layer_that_cannot_defer_demands_its_shape():
    with pytest.raises(MXNetError, match="must be fully known"):
        tnn.Embedding(0, 4, device="cpu")


def test_initialize_default_is_uniform_0_07_as_in_the_jax_package():
    """C4: with no initializer given, ``initialize()`` draws weights from
    U(-0.07, 0.07), the JAX package's (and MXNet's) default; before this
    fix the port used Xavier."""
    mx.random.seed(0)
    jb = jnn.Dense(64, in_units=256)
    jb.initialize()
    tb = tnn.Dense(64, in_units=256, device="cpu")
    tb.initialize()
    for w in (jb.weight.data().asnumpy(), tb.weight.detach().numpy()):
        assert np.abs(w).max() <= 0.07
        assert abs(w.std() - 0.07 / np.sqrt(3)) < 0.002


# ---------------------------------------------------------------------------
# initializers
# ---------------------------------------------------------------------------

def _jax_fill(init, name, shape):
    arr = nd.zeros(shape)
    init(jinit.InitDesc(name), arr)
    return arr.asnumpy()


def _port_fill(init, name, shape, seed=0):
    arr = torch.zeros(shape)
    init(tinit.InitDesc(name), arr, torch.Generator().manual_seed(seed))
    return arr.numpy()


DETERMINISTIC = [
    ("constant", lambda m: m.Constant(0.3), (3, 4)),
    ("zero", lambda m: m.Zero(), (3, 4)),
    ("one", lambda m: m.One(), (3, 4)),
    ("bilinear", lambda m: m.Bilinear(), (2, 3, 4, 4)),
    ("bilinear_odd", lambda m: m.Bilinear(), (1, 1, 5, 5)),
    ("lstmbias", lambda m: m.LSTMBias(forget_bias=2.0), (12,)),
]


@pytest.mark.parametrize("case", [c[0] for c in DETERMINISTIC])
def test_deterministic_initializers_match_jax(case):
    _, make, shape = next(c for c in DETERMINISTIC if c[0] == case)
    np.testing.assert_array_equal(_port_fill(make(tinit), "w_weight", shape),
                                  _jax_fill(make(jinit), "w_weight", shape))


_NAMES = ("conv0_bias", "bn0_gamma", "bn0_beta", "bn0_running_mean",
          "bn0_running_var", "x_moving_mean", "x_moving_var")


@pytest.mark.parametrize("name", ["zero", "one", "constant", "uniform",
                                  "normal", "orthogonal", "xavier",
                                  "msraprelu", "bilinear", "lstmbias"])
def test_initializer_name_rules_match_jax(name):
    """Every registered initializer sends bias / gamma / beta / running
    statistics to the same fixed values as the JAX package's."""
    t, j = tinit.create(name), jinit.create(name)
    assert type(t).__name__ == type(j).__name__
    for pname in _NAMES:
        np.testing.assert_array_equal(_port_fill(t, pname, (5,)),
                                      _jax_fill(j, pname, (5,)))


def test_create_takes_names_aliases_and_none_as_jax():
    for name in ("zeros", "ones", "gaussian", "xavier_uniform", "msra",
                 "Constant", "uniform"):
        assert type(tinit.create(name)).__name__ == \
            type(jinit.create(name)).__name__
    assert isinstance(tinit.create(None), tinit.Uniform)
    assert tinit.create(None).scale == jinit.create(None).scale == 0.07
    with pytest.raises(MXNetError):
        tinit.create("no_such_init")
    # a dumped initializer in the descriptor's attrs wins over the name
    desc = tinit.InitDesc("fc_bias",
                          {"__init__": tinit.Constant(0.5).dumps()})
    arr = torch.zeros(3)
    tinit.Zero()(desc, arr)
    jarr = nd.zeros((3,))
    jinit.Zero()(jinit.InitDesc("fc_bias", {"__init__":
                                            jinit.Constant(0.5).dumps()}),
                 jarr)
    np.testing.assert_array_equal(arr.numpy(), jarr.asnumpy())


def test_mixed_initializer_dispatches_as_jax():
    mk = (lambda m: m.Mixed([".*bias", ".*"], [m.Constant(2.0), m.One()]))
    for name in ("fc_bias", "fc_weight"):
        np.testing.assert_array_equal(_port_fill(mk(tinit), name, (4,)),
                                      _jax_fill(mk(jinit), name, (4,)))
    with pytest.raises(MXNetError, match="catch-all"):
        tinit.Mixed(["a$"], [tinit.One()])("b", torch.zeros(1))


def test_random_initializers_follow_their_rules():
    big = (400, 300)
    u = _port_fill(tinit.Uniform(0.2), "w", big)
    assert np.abs(u).max() <= 0.2 and abs(u.std() - 0.2 / np.sqrt(3)) < 2e-3
    g = _port_fill(tinit.Normal(0.5), "w", big)
    assert abs(g.std() - 0.5) < 5e-3 and abs(g.mean()) < 5e-3
    fan = (400 + 300) / 2.0
    x = _port_fill(tinit.Xavier(), "w", big)
    assert np.abs(x).max() <= np.sqrt(3 / fan)
    assert abs(x.std() - np.sqrt(1 / fan)) < 1e-3
    xg = _port_fill(tinit.Xavier("gaussian", "in", 2), "w", big)
    assert abs(xg.std() - np.sqrt(2 / 300)) < 1e-3
    m = _port_fill(tinit.MSRAPrelu(slope=0.5), "w", big)
    assert abs(m.std() - np.sqrt(2.0 / 1.25 / fan)) < 1e-3
    for shape in ((6, 10), (10, 6), (4, 2, 3)):
        q = _port_fill(tinit.Orthogonal(scale=1.5), "w", shape)
        q2 = q.reshape(shape[0], -1)
        gram = q2 @ q2.T if q2.shape[0] <= q2.shape[1] else q2.T @ q2
        np.testing.assert_allclose(gram, 2.25 * np.eye(len(gram)),
                                   atol=1e-5)
    # the generator decides the draw
    np.testing.assert_array_equal(_port_fill(tinit.Uniform(), "w", (9,), 3),
                                  _port_fill(tinit.Uniform(), "w", (9,), 3))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _sign(shape, seed):
    return np.sign(_n(shape, seed)) + (np.sign(_n(shape, seed)) == 0)


LOSSES = [
    ("l2", lambda m: m.L2Loss(weight=2.0), [(4, 3), (4, 3)], True),
    ("l1", lambda m: m.L1Loss(), [(4, 3, 2), (4, 6)], True),
    ("sbce", lambda m: m.SigmoidBinaryCrossEntropyLoss(weight=0.5),
     [(4, 5), "binary"], True),
    ("sbce_pos_weight", lambda m: m.SigmoidBCELoss(),
     [(4, 5), "binary", (4, 5)], False),
    ("sbce_from_sigmoid", lambda m: m.SigmoidBCELoss(from_sigmoid=True),
     [(4, 5), "binary"], False),
    ("kldiv", lambda m: m.KLDivLoss(from_logits=False), [(3, 6), "probs"],
     True),
    ("kldiv_logp", lambda m: m.KLDivLoss(axis=1), [(3, 6), "probs"], False),
    ("huber", lambda m: m.HuberLoss(rho=0.7), [(4, 5), (4, 5)], True),
    ("hinge", lambda m: m.HingeLoss(margin=0.5), [(4, 5), "signed"], True),
    ("sqhinge", lambda m: m.SquaredHingeLoss(), [(4, 5), "signed"], False),
    ("logistic", lambda m: m.LogisticLoss(), [(4, 5), "signed"], True),
    ("logistic_binary", lambda m: m.LogisticLoss(label_format="binary"),
     [(4, 5), "binary"], False),
    ("triplet", lambda m: m.TripletLoss(margin=0.5),
     [(4, 5), (4, 5), (4, 5)], False),
    ("cosine", lambda m: m.CosineEmbeddingLoss(margin=0.2),
     [(4, 5), (4, 5), "pm1"], True),
    ("softmax_ce_dense", lambda m: m.SoftmaxCrossEntropyLoss(
        sparse_label=False), [(4, 5), "probs"], True),
]


def _loss_inputs(specs):
    out = []
    for i, s in enumerate(specs):
        rs = np.random.RandomState(20 + i)
        if s == "binary":
            out.append(rs.randint(0, 2, (4, 5)).astype(np.float32))
        elif s == "signed":
            out.append((rs.randint(0, 2, (4, 5)) * 2 - 1).astype(np.float32))
        elif s == "pm1":
            out.append(np.array([1, -1, 1, -1], np.float32))
        elif s == "probs":
            shape = out[0].shape
            p = rs.rand(*shape).astype(np.float32) + 0.1
            out.append(p / p.sum(-1, keepdims=True))
        else:
            out.append(rs.randn(*s).astype(np.float32))
    return out


@pytest.mark.parametrize("case", [c[0] for c in LOSSES])
def test_loss_matches_jax(case):
    _, make, specs, weighted = next(c for c in LOSSES if c[0] == case)
    arrays = _loss_inputs(specs)
    if case == "sbce_from_sigmoid":
        arrays[0] = 1 / (1 + np.exp(-arrays[0]))
    lead = arrays[0].shape[:1]
    sw_shape = lead if case == "cosine" \
        else lead + (1,) * (arrays[0].ndim - 1)
    sw = np.random.RandomState(9).rand(*sw_shape).astype(np.float32) \
        if weighted else None

    def run(nd_, ag, lmod):
        ins = [nd_.array(a) for a in arrays]
        ins[0].attach_grad()
        if case == "sbce_pos_weight":          # (pred, label, None, pw)
            ins.insert(2, None)
        elif sw is not None:
            ins.append(nd_.array(sw))
        with ag.record():
            out = make(lmod)(*ins)
        out.backward()
        return out.asnumpy(), ins[0].grad.asnumpy()

    want = run(nd, autograd, jloss)
    with CPU:
        got = run(mt.nd, mt.autograd, tloss)
    np.testing.assert_allclose(got[0], want[0], err_msg="loss", **FWD)
    np.testing.assert_allclose(got[1], want[1], err_msg="grad", **GRAD)


def test_ctc_loss_waits_for_the_ctc_op():
    with pytest.raises(NotPortedError, match="A14"):
        tloss.CTCLoss()
