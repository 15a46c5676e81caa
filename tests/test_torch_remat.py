"""Backward rematerialisation in the port (mxnet_tpu_torch/util.py,
MXNET_BACKWARD_DO_MIRROR), after tests/test_remat.py.

The JAX package wraps the traced forward in ``jax.checkpoint``; the port
runs it through ``torch.utils.checkpoint`` (non-reentrant). Gradients must
be bit-identical to the plain backward under every policy (``full``,
``dots``, ``convs``); ``hybridize(mirror=True)`` and
``SPMDTrainer(remat=True)`` must follow the plain path's trajectory (and
the JAX package's with remat, at f32 2e-5 / 1e-5 as
tests/test_torch_spmd.py holds the MLP trainer); the recompute must move
BatchNorm's running statistics once and draw Dropout's masks once.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import MXNetError, convert, util
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.parallel import SPMDTrainer

CPU = tmx.cpu()
POLICIES = ["full", "dots", "convs"]


def _deep_mlp(mx, width=64, depth=6):
    """tests/test_remat.py's net, in either package."""
    mx.random.seed(0)
    net = mx.gluon.nn.HybridSequential(prefix="remat_mlp_")
    with net.name_scope():
        for _ in range(depth):
            net.add(mx.gluon.nn.Dense(width, activation="relu"))
        net.add(mx.gluon.nn.Dense(4))
    return net


def _mlp_pair():
    """The JAX deep MLP and the port's with its weights."""
    jnet = _deep_mlp(jmx)
    jnet.initialize(jmx.init.Xavier())
    with jmx.autograd.pause():
        jnet(jmx.nd.ones((2, 8)))
    with tmx.cpu():
        tnet = _deep_mlp(tmx)
    convert.from_mxnet_tpu_params(
        tnet, {k: p.data().asnumpy() for k, p in
               jnet.collect_params().items()}, prefix=jnet.prefix)
    return jnet, tnet


def _grads(net, x, mirror):
    """Gradients of sum(net(x)^2) by name, the net run through
    apply_mirror(., mirror)."""
    fn = util.apply_mirror(lambda t: net(t), mirror)
    with tmx.autograd.train_mode():
        loss = (fn(x) ** 2).sum()
    names = [p.name for p in net.collect_params().values()]
    ws = [p.tensor for p in net.collect_params().values()]
    return dict(zip(names, torch.autograd.grad(loss, ws)))


def test_mirror_enabled_resolution(monkeypatch):
    monkeypatch.delenv("MXNET_BACKWARD_DO_MIRROR", raising=False)
    assert not util.mirror_enabled()
    assert util.mirror_enabled(True)
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    assert util.mirror_enabled()
    assert not util.mirror_enabled(False)   # explicit arg wins over env
    from mxnet_tpu.util import mirror_enabled as jmirror
    for value in ("1", "0", "true", ""):
        monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", value)
        assert util.mirror_enabled() == jmirror()


def test_bad_policy_raises(monkeypatch):
    monkeypatch.setenv("MXNET_BACKWARD_MIRROR_POLICY", "bogus")
    with pytest.raises(MXNetError, match="bogus"):
        util.apply_mirror(lambda x: x, True)
    util.apply_mirror(lambda x: x, False)   # off: the policy is not read
    _, net = _mlp_pair()
    tr = SPMDTrainer(net, tloss.SoftmaxCrossEntropyLoss(), remat=True)
    with pytest.raises(MXNetError, match="bogus"):
        tr.step(np.zeros((2, 8), np.float32), np.zeros(2, np.float32))


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_gradients_are_bit_identical(policy, monkeypatch):
    monkeypatch.setenv("MXNET_BACKWARD_MIRROR_POLICY", policy)
    _, net = _mlp_pair()
    x = torch.from_numpy(np.random.RandomState(0).randn(8, 8)
                         .astype(np.float32))
    plain = _grads(net, x, False)
    remat = _grads(net, x, True)
    assert plain.keys() == remat.keys()
    for k in plain:
        assert torch.equal(plain[k], remat[k]), k


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_recomputes_what_it_does_not_save(policy, monkeypatch):
    """Ops dispatched in backward, against the plain backward's: full
    reruns the convolution and the hidden Dense's product; dots keeps the
    product (the convolution reruns); convs keeps both."""
    monkeypatch.setenv("MXNET_BACKWARD_MIRROR_POLICY", policy)
    with tmx.cpu():
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Conv2D(4, 3, in_channels=2, layout="NHWC"),
                tmx.gluon.nn.Activation("relu"), tmx.gluon.nn.Flatten(),
                tmx.gluon.nn.Dense(8, activation="relu", in_units=64),
                tmx.gluon.nn.Dense(3, in_units=8))
        net.initialize()
    x = torch.randn(2, 6, 6, 2)
    ws = [p.tensor for p in net.collect_params().values()]

    class Ops(torch.utils._python_dispatch.TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))

    def backward_ops(mirror):
        out = (util.apply_mirror(lambda t: net(t), mirror)(x) ** 2).sum()
        with Ops() as ops:
            torch.autograd.grad(out, ws)
        return ops.seen

    plain, remat = backward_ops(False), backward_ops(True)
    assert "convolution" not in plain
    assert remat.count("convolution") == (policy != "convs")
    assert remat.count("mm") == plain.count("mm") + (policy == "full")


def test_hybridize_mirror_same_grads_and_matches_jax():
    jnet, tnet = _mlp_pair()
    x = np.random.RandomState(2).randn(4, 8).astype(np.float32)
    calls = []
    tnet[0].register_forward_hook(lambda *a: calls.append(1))

    def grads():
        with tmx.autograd.record():
            loss = (tnet(tmx.nd.array(x, ctx=CPU)) ** 2).sum()
        loss.backward()
        return {k: p.grad().asnumpy() for k, p in
                sorted(tnet.collect_params().items())}

    g_plain = grads()
    assert len(calls) == 1
    tnet.hybridize(mirror=True)
    calls.clear()
    g_remat = grads()
    assert len(calls) == 2                  # the forward and its recompute
    for k in g_plain:
        np.testing.assert_array_equal(g_remat[k], g_plain[k], err_msg=k)
    jnet.hybridize(mirror=True)
    with jmx.autograd.record():
        jl = (jnet(jmx.nd.array(x)) ** 2).sum()
    jl.backward()
    for k, p in jnet.collect_params().items():
        np.testing.assert_allclose(g_remat[tnet.prefix + k[len(jnet.prefix):]],
                                   p.grad().asnumpy(), rtol=2e-5, atol=2e-5,
                                   err_msg=k)
    tnet.hybridize(False)
    calls.clear()
    grads()
    assert len(calls) == 1


def _run_spmd(net, remat, data, label, steps=True):
    tr = SPMDTrainer(net, tloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
                     optimizer_params={"learning_rate": 0.1}, remat=remat)
    if steps:
        return tr.run_steps(torch.from_numpy(data), torch.from_numpy(label))
    return torch.stack([tr.step(torch.from_numpy(d), torch.from_numpy(lb))
                        for d, lb in zip(data, label)])


def test_spmd_remat_same_trajectory_and_matches_jax():
    """tests/test_remat.py test_spmd_remat_same_trajectory, and the JAX
    trainer with remat=True (1e-5, as test_torch_spmd.py's MLP)."""
    rs = np.random.RandomState(0)
    data = rs.randn(3, 8, 8).astype(np.float32)
    label = rs.randint(0, 4, (3, 8)).astype(np.float32)
    out = {}
    for remat in (False, True):
        jnet, tnet = _mlp_pair()
        out[remat] = (_run_spmd(tnet, remat, data, label),
                      {k: p.tensor.detach().clone() for k, p in
                       tnet._collect_params_with_prefix().items()})
    for k, w in out[False][1].items():
        assert torch.equal(out[True][1][k], w), k
    assert torch.equal(out[True][0], out[False][0])
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.parallel.spmd import SPMDTrainer as JTrainer
    jtr = JTrainer(jnet, jloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
                   optimizer_params={"learning_rate": 0.1}, remat=True)
    jl = np.asarray(jtr.run_steps(data, label))
    np.testing.assert_allclose(out[True][0].numpy(), jl, rtol=1e-5,
                               atol=1e-6)
    for k, p in jnet._collect_params_with_prefix().items():
        np.testing.assert_allclose(out[True][1][k].numpy(),
                                   p.data().asnumpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_env_flag_turns_spmd_remat_on(monkeypatch):
    """remat=None follows MXNET_BACKWARD_DO_MIRROR, read when the step is
    built; an explicit remat=False wins."""
    rs = np.random.RandomState(1)
    data = rs.randn(1, 8, 8).astype(np.float32)
    label = rs.randint(0, 4, (1, 8)).astype(np.float32)
    monkeypatch.setenv("MXNET_BACKWARD_DO_MIRROR", "1")
    for remat, want in ((None, 2), (False, 1), (True, 2)):
        _, tnet = _mlp_pair()
        calls = []
        tnet[0].register_forward_hook(lambda *a: calls.append(1))
        _run_spmd(tnet, remat, data, label)
        assert len(calls) == want, remat


def _bn_net():
    with tmx.cpu():
        net = tmx.gluon.nn.HybridSequential(prefix="remat_bn_")
        with net.name_scope():
            net.add(tmx.gluon.nn.Conv2D(6, 3, in_channels=3, layout="NHWC"),
                    tmx.gluon.nn.BatchNorm(axis=-1, in_channels=6),
                    tmx.gluon.nn.Activation("relu"),
                    tmx.gluon.nn.FusedBatchNormReLU(axis=-1, in_channels=6),
                    tmx.gluon.nn.GlobalAvgPool2D(layout="NHWC"),
                    tmx.gluon.nn.Dense(4, in_units=6))
        net.initialize(tmx.init.Xavier(), generator=torch.Generator()
                       .manual_seed(3))
    return net


@pytest.mark.parametrize("policy", POLICIES)
def test_batchnorm_running_stats_move_once_under_remat(policy, monkeypatch):
    """After a remat step the running statistics, like every weight, are
    bit for bit those of a plain step: the recompute leaves them alone."""
    monkeypatch.setenv("MXNET_BACKWARD_MIRROR_POLICY", policy)
    rs = np.random.RandomState(2)
    data = rs.randn(2, 4, 8, 8, 3).astype(np.float32)
    label = rs.randint(0, 4, (2, 4)).astype(np.float32)
    state = {}
    for remat in (False, True):
        net = _bn_net()
        params = net._collect_params_with_prefix()
        before = {k: p.tensor.clone() for k, p in params.items()
                  if "running" in k}
        _run_spmd(net, remat, data, label)
        state[remat] = {k: p.tensor.detach().clone()
                        for k, p in params.items()}
        assert all(not torch.equal(state[remat][k], v)
                   for k, v in before.items())
    assert any("running_mean" in k for k in state[True])
    for k, v in state[False].items():
        assert torch.equal(state[True][k], v), k


@pytest.mark.parametrize("where", ["step", "run_steps", "hybridize"])
def test_dropout_draws_each_mask_once_under_remat(where):
    """A Dropout net under remat trains as without it: the recompute reuses
    the forward's masks (same losses, same weights, the generator advanced
    by the same draws)."""
    rs = np.random.RandomState(3)
    data = rs.randn(2, 8, 8).astype(np.float32)
    label = rs.randint(0, 4, (2, 8)).astype(np.float32)
    out = {}
    for remat in (False, True):
        gen = torch.Generator().manual_seed(7)
        with tmx.cpu():
            net = tmx.gluon.nn.HybridSequential(prefix="remat_drop_")
            with net.name_scope():
                net.add(tmx.gluon.nn.Dense(32, activation="relu",
                                           in_units=8),
                        tmx.gluon.nn.Dropout(0.5, generator=gen),
                        tmx.gluon.nn.Dense(4, in_units=32))
            net.initialize(tmx.init.Xavier(),
                           generator=torch.Generator().manual_seed(1))
        if where == "hybridize":
            net.hybridize(mirror=remat)
            losses = []
            for d, lb in zip(data, label):
                with tmx.autograd.record():
                    loss = tloss.SoftmaxCrossEntropyLoss()(
                        net(tmx.nd.array(d, ctx=CPU)),
                        tmx.nd.array(lb, ctx=CPU)).mean()
                loss.backward()
                losses.append(loss._data)
            losses = torch.stack(losses)
            grads = [p.grad()._data for p in net.collect_params().values()]
        else:
            losses = _run_spmd(net, remat, data, label,
                               steps=where == "run_steps")
            grads = []
        out[remat] = (losses, [p.tensor.detach().clone() for p in
                               net.collect_params().values()], grads,
                      gen.get_state())
    for a, b in zip(out[False], out[True]):
        if isinstance(a, list):
            assert all(torch.equal(x, y) for x, y in zip(a, b))
        else:
            assert torch.equal(a, b)


def test_replayed_hands_the_recompute_the_forward_values():
    draws = []

    def f(x):
        m = util.replayed(lambda: torch.rand(x.shape))
        draws.append(m)
        assert util.is_recomputing() == (len(draws) == 2)
        return (x * m).sum()

    x = torch.randn(5, requires_grad=True)
    y = util.apply_mirror(f, True)(x)
    (g,) = torch.autograd.grad(y, [x])
    assert len(draws) == 2 and draws[0] is draws[1]
    assert torch.equal(g, draws[0])
    assert not util.is_recomputing()
    assert util.replayed(lambda: 3) == 3
