"""The port's training slice against the JAX package: SPMDTrainer.run_steps
on a small-depth channel-last ResNetV1 (the bench model's blocks, fused
epilogues included), weights carried across with mxnet_tpu_torch.convert.

The same numpy inputs go through mxnet_tpu (JAX on the CPU, the Pallas
epilogue kernels in interpret mode) and mxnet_tpu_torch (device="cpu", the
kernels' plain versions): one run_steps call of K=1, then one of K=2.
Compared after each: the losses, every weight, momentum buffer and running
statistic.

The JAX reference runs in a subprocess with XLA_FLAGS
--xla_allow_excess_precision=false. Without it, XLA's CPU backend drops the
bf16 rounding between fused ops, so its bf16 step is more precise than
bf16 arithmetic (and than the port, which rounds at every op as the card
does); with it, the two bf16 step-1 gradients agree to under 1% (L2).

Inputs are 64x64 (batch 4): at 32x32 the last stage normalises over only
4 rows and even the f32 trajectory is chaotic after 3 steps at lr 0.05.
Tolerances, as a fraction of each tensor's largest value (state) or
relative (losses):
  f32   losses 1e-4, state 1e-3 after every step (summation order and
        convolution algorithms differ, nothing else);
  bf16  step 1: loss 2e-2 (test_fused_epilogue.py's bf16 tolerance),
        state L2-relative 2e-2 (weights: of the update); steps 2-3:
        losses 5e-2 and finite state only - one different bf16 rounding
        of a weight cast at step 2 sends the two trajectories apart.
        Adam's first step moves a weight by lr * sign(g) wherever |g| is
        far above epsilon, so where bf16 rounding flips the sign of a
        gradient at the noise level its update flips by 2 lr (measured:
        0.065 % of the stem conv's weights). There the step-1 weights are
        held element by element: at most 0.1 % of a tensor's updates off
        by more than 2e-2 lr, none by more than a flip (2 lr, 2e-2 over),
        while m and v, which carry the gradient itself, keep the L2 2e-2.
  f16   (SGD; the fused epilogue's f16 kernels) step 1: loss 1e-3,
        the change of every running statistic L2 5e-3, the classifier's
        updates and momenta L2 2e-2; every other update no farther (L2,
        relative to the f32 update) from the JAX package's f32 step than
        the JAX f16 step is, plus 0.1, and all of them together within
        L2 0.1 of the JAX f16 updates; steps 2-3 finite state only. The
        forward agrees closely (loss to the bit, statistics to 6e-4),
        but the step-1 gradient of this small net is ill-conditioned in
        16 bits (both packages' f16 updates sit 5-26 % from the f32
        update, bf16's up to 84 %): f16 rounds 8x finer than bf16, so
        the two packages' f32 summation orders flip far more of its
        outputs by one unit (0.16 % of the stem BatchNorm's against
        0.006 % in bf16), and BatchNorm's backward sums amplify the
        flips. Measured on the CPU: single tensors' updates differ by up
        to 16 % between the packages, the port's lies at most 0.058
        farther from the f32 step than JAX's, all updates together
        differ by 6.2 %, the classifier's by 0.12 %. Later steps are
        chaotic in every dtype (a 1e-4 perturbation moves the f32
        step-3 loss by 10 %).
Adam runs at its defaults (lr 1e-3, beta1 0.9, beta2 0.999, epsilon
1e-8) with wd 1e-4.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
    BottleneckV1 as TBottleneck, ResNetV1 as TResNet)
from mxnet_tpu_torch.parallel import SPMDTrainer as TTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC = ([1, 1, 1, 1], [8, 16, 32, 64, 128])
OPT = {"learning_rate": 0.05, "momentum": 0.9}
ADAM = {"learning_rate": 0.001, "wd": 1e-4, "beta1": 0.9, "beta2": 0.999,
        "epsilon": 1e-8}
SIZE, BATCH, K = 64, 4, 3


def _data():
    rs = np.random.RandomState(1)
    return (rs.rand(K, BATCH, SIZE, SIZE, 3).astype(np.float32),
            rs.randint(0, 10, (K, BATCH)).astype(np.float32))


def _jax_reference(out_path):
    """Subprocess body: the JAX trainer's trajectory in f32 and bf16."""
    import jax.numpy as jnp
    import mxnet_tpu as mx
    from mxnet_tpu import autograd, nd
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.gluon.model_zoo.vision.resnet import (
        BottleneckV1, ResNetV1)
    from mxnet_tpu.parallel import SPMDTrainer
    data, label = _data()
    res = {}
    for opt, dtype in (("sgd", "float32"), ("sgd", "bfloat16"),
                       ("sgd", "float16"), ("adam", "float32"),
                       ("adam", "bfloat16")):
        mx.random.seed(0)
        net = ResNetV1(BottleneckV1, *SPEC, classes=10, layout="NHWC",
                       stem_s2d=True)
        net.initialize(mx.init.Xavier())
        with autograd.pause():
            net(nd.array(data[0, :1]))

        pre = dtype if opt == "sgd" else f"adam/{dtype}"

        def state(tag):
            for k, p in net.collect_params().items():
                res[f"{pre}/{tag}/param/{k[len(net.prefix):]}"] = \
                    p.data().asnumpy()
            st = tr._opt_state
            slots = [("mom", st or ())] if opt == "sgd" else \
                [("mom", st[0] if st else ()), ("var", st[1] if st else ())]
            for kind, arrs in slots:
                for p, m in zip(tr._trainable, arrs):
                    res[f"{pre}/{tag}/{kind}/"
                        f"{p.name[len(net.prefix):]}"] = np.asarray(m)

        tr = SPMDTrainer(net, jloss.SoftmaxCrossEntropyLoss(),
                         optimizer=opt,
                         optimizer_params=OPT if opt == "sgd" else ADAM,
                         dtype=None if dtype == "float32"
                         else jnp.dtype(dtype))
        state("init")
        res[f"{pre}/loss1"] = np.asarray(tr.run_steps(data[:1], label[:1]))
        state("step1")
        res[f"{pre}/loss23"] = np.asarray(tr.run_steps(data[1:], label[1:]))
        state("step3")
    np.savez(out_path, **res)


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("jax_ref") / "ref.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_allow_excess_precision=false")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), out],
                          env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return dict(np.load(out))


def _ref_state(ref, dtype, tag):
    pre = f"{dtype}/{tag}/"
    out = {"param": {}, "mom": {}, "var": {}}
    for k, v in ref.items():
        if k.startswith(pre):
            kind, name = k[len(pre):].split("/", 1)
            out[kind][name] = v
    return out


def _port_state(net, tr):
    strip = len(net.prefix)
    state = tr.optimizer_state.items()
    if tr.optimizer == "adam":
        mom = {k[strip:]: m.float().numpy().copy() for k, (m, _) in state}
        var = {k[strip:]: v.float().numpy().copy() for k, (_, v) in state}
    else:
        mom = {k[strip:]: m.float().numpy().copy() for k, m in state}
        var = {}
    return {"param": {k[strip:]: p.data().asnumpy()
                      for k, p in net.collect_params().items()},
            "mom": mom, "var": var}


def _max_err(a, b):
    """Largest difference as a fraction of the reference's largest value."""
    return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-6)


def _l2_err(a, b):
    return float(np.linalg.norm(a - b)) / max(float(np.linalg.norm(b)),
                                              1e-12)


def _check_trajectory(jax_ref, opt, dtype):
    """run_steps of K=1 then K=2 from the JAX trainer's initial weights;
    losses, weights, running statistics and optimizer state against the
    JAX trainer's after each call (tolerances in the module docstring)."""
    pre = dtype if opt == "sgd" else f"adam/{dtype}"
    init = _ref_state(jax_ref, pre, "init")["param"]
    tnet = TResNet(TBottleneck, *SPEC, classes=10, layout="NHWC",
                   stem_s2d=True, device="cpu")
    convert.from_mxnet_tpu_params(
        tnet, {tnet.prefix + k: v for k, v in init.items()})
    tr = TTrainer(tnet, tloss.SoftmaxCrossEntropyLoss(), optimizer=opt,
                  optimizer_params=OPT if opt == "sgd" else ADAM,
                  dtype=None if dtype == "float32"
                  else getattr(torch, dtype))
    data, label = (torch.from_numpy(a) for a in _data())

    loss1 = tr.run_steps(data[:1], label[:1]).numpy()
    got1, want1 = _port_state(tnet, tr), _ref_state(jax_ref, pre, "step1")
    loss23 = tr.run_steps(data[1:], label[1:]).numpy()
    got3, want3 = _port_state(tnet, tr), _ref_state(jax_ref, pre, "step3")
    for got, want in ((got1, want1), (got3, want3)):
        for kind in ("param", "mom", "var"):
            assert got[kind].keys() == want[kind].keys(), kind
        assert len(got["mom"]) > 0
        assert (len(got["var"]) > 0) == (opt == "adam")
        for arrs in got.values():
            assert all(np.isfinite(a).all() for a in arrs.values())

    if dtype == "float32":
        np.testing.assert_allclose(loss1, jax_ref[f"{pre}/loss1"],
                                   rtol=1e-4)
        np.testing.assert_allclose(loss23, jax_ref[f"{pre}/loss23"],
                                   rtol=1e-4)
        for got, want in ((got1, want1), (got3, want3)):
            for kind in ("param", "mom", "var"):
                for k in want[kind]:
                    assert _max_err(got[kind][k], want[kind][k]) <= 1e-3, \
                        (kind, k)
        return
    np.testing.assert_allclose(loss1, jax_ref[f"{pre}/loss1"], rtol=2e-2)
    assert np.isfinite(loss23).all()
    if dtype == "float16":
        np.testing.assert_allclose(loss1, jax_ref[f"{pre}/loss1"],
                                   rtol=1e-3)
        f32 = _ref_state(jax_ref, "float32", "step1")["param"]
        assert all(np.array_equal(v, _ref_state(jax_ref, "float32", "init")
                                  ["param"][k]) for k, v in init.items())
        upd, ref_upd = [], []
        for k, w in want1["param"].items():
            mine, ref = got1["param"][k] - init[k], w - init[k]
            if k.endswith(("running_mean", "running_var")):
                assert _l2_err(mine, ref) <= 5e-3, k
            elif k.startswith("dense"):
                assert _l2_err(mine, ref) <= 2e-2, k
            else:
                # no farther from the f32 step than the JAX f16 step is,
                # give or take 0.1 of the f32 update
                exact = f32[k] - init[k]
                assert _l2_err(mine, exact) <= \
                    _l2_err(ref, exact) + 0.1, k
                upd.append(mine.ravel())
                ref_upd.append(ref.ravel())
        assert _l2_err(np.concatenate(upd), np.concatenate(ref_upd)) \
            <= 0.1
        for k, m in want1["mom"].items():
            if k.startswith("dense"):
                assert _l2_err(got1["mom"][k], m) <= 2e-2, k
        return
    np.testing.assert_allclose(loss23, jax_ref[f"{pre}/loss23"], rtol=5e-2)
    lr = ADAM["learning_rate"]
    for k, w in want1["param"].items():
        moved = k.endswith(("running_mean", "running_var"))
        ref = w if moved else w - init[k]
        mine = got1["param"][k] if moved else got1["param"][k] - init[k]
        if opt == "adam" and not moved:
            d = np.abs(mine - ref)
            assert (d > 2e-2 * lr).mean() <= 1e-3, k
            assert d.max() <= 2 * lr * (1 + 2e-2), k
        else:
            assert _l2_err(mine, ref) <= 2e-2, k
    for kind in ("mom", "var"):
        for k, m in want1[kind].items():
            assert _l2_err(got1[kind][k], m) <= 2e-2, (kind, k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_run_steps_matches_jax_trainer(jax_ref, dtype):
    _check_trajectory(jax_ref, "sgd", dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adam_run_steps_matches_jax_trainer(jax_ref, dtype):
    """Adam with weight decay and its bias correction by step t, K = 3
    over two run_steps calls."""
    _check_trajectory(jax_ref, "adam", dtype)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_dense_sgd_update_rule_matches_jax(momentum):
    """The update rule alone (with and without momentum, with weight decay)
    on a 2-layer MLP, where the forward leaves no room for drift."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon import loss as jloss
    from mxnet_tpu.gluon import nn as jnn
    from mxnet_tpu.parallel import SPMDTrainer as JTrainer
    mx.random.seed(3)
    jnet = jnn.HybridSequential()
    with jnet.name_scope():
        jnet.add(jnn.Dense(16, activation="relu", in_units=12))
        jnet.add(jnn.Dense(5, in_units=16))
    jnet.initialize(mx.init.Xavier())
    tnet = tnn.HybridSequential(device="cpu")
    with tnet.name_scope():
        tnet.add(tnn.Dense(16, activation="relu", in_units=12,
                           device="cpu"))
        tnet.add(tnn.Dense(5, in_units=16, device="cpu"))
    convert.from_mxnet_tpu_params(
        tnet, {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()},
        prefix=jnet.prefix)
    opt = {"learning_rate": 0.1, "momentum": momentum, "wd": 1e-3}
    rs = np.random.RandomState(4)
    data = rs.randn(2, 6, 12).astype(np.float32)
    label = rs.randint(0, 5, (2, 6)).astype(np.float32)
    jtr = JTrainer(jnet, jloss.SoftmaxCrossEntropyLoss(),
                   optimizer_params=opt)
    ttr = TTrainer(tnet, tloss.SoftmaxCrossEntropyLoss(),
                   optimizer_params=opt)
    jl = np.asarray(jtr.run_steps(data, label))
    tl = ttr.run_steps(torch.from_numpy(data),
                       torch.from_numpy(label)).numpy()
    np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)
    for k, p in tnet.collect_params().items():
        want = jnet.collect_params()[jnet.prefix + k[len(tnet.prefix):]]
        np.testing.assert_allclose(p.data().asnumpy(),
                                   want.data().asnumpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert bool(ttr.optimizer_state) == (momentum != 0.0)


def _port_net(seed):
    net = TResNet(TBottleneck, *SPEC, classes=10, layout="NHWC",
                  stem_s2d=True, device="cpu")
    net.initialize(generator=torch.Generator().manual_seed(seed))
    return net


def test_step_and_run_steps_agree():
    """K calls to step() and one run_steps() give the same trajectory."""
    a, b = _port_net(5), _port_net(5)
    rs = np.random.RandomState(6)
    data = torch.from_numpy(rs.rand(2, 2, 32, 32, 3).astype(np.float32))
    label = torch.from_numpy(rs.randint(0, 10, (2, 2)).astype(np.float32))
    ta = TTrainer(a, tloss.SoftmaxCrossEntropyLoss(), optimizer_params=OPT)
    tb = TTrainer(b, tloss.SoftmaxCrossEntropyLoss(), optimizer_params=OPT)
    la = torch.stack([ta.step(data[0], label[0]), ta.step(data[1], label[1])])
    lb = tb.run_steps(data, label)
    torch.testing.assert_close(la, lb, rtol=0, atol=0)
    for (k, p), (_, q) in zip(a.collect_params().items(),
                              b.collect_params().items()):
        torch.testing.assert_close(p.tensor, q.tensor, rtol=0, atol=0)


def test_step_and_run_steps_agree_under_adam():
    """K calls to step() and one run_steps() give the same Adam trajectory
    (the device step count t moves the bias correction in both)."""
    a, b = _port_net(7), _port_net(7)
    rs = np.random.RandomState(8)
    data = torch.from_numpy(rs.rand(3, 2, 32, 32, 3).astype(np.float32))
    label = torch.from_numpy(rs.randint(0, 10, (3, 2)).astype(np.float32))
    opt = dict(ADAM, wd=1e-3)
    ta = TTrainer(a, tloss.SoftmaxCrossEntropyLoss(), optimizer="adam",
                  optimizer_params=opt)
    tb = TTrainer(b, tloss.SoftmaxCrossEntropyLoss(), optimizer="adam",
                  optimizer_params=opt)
    la = torch.stack([ta.step(data[k], label[k]) for k in range(3)])
    lb = torch.cat([tb.run_steps(data[:1], label[:1]),
                    tb.run_steps(data[1:], label[1:])])
    torch.testing.assert_close(la, lb, rtol=0, atol=0)
    assert int(ta._t) == int(tb._t) == 3
    for (k, p), (_, q) in zip(a.collect_params().items(),
                              b.collect_params().items()):
        torch.testing.assert_close(p.tensor, q.tensor, rtol=0, atol=0)
    for (m, v), (m2, v2) in zip(ta.optimizer_state.values(),
                                tb.optimizer_state.values()):
        torch.testing.assert_close(m, m2, rtol=0, atol=0)
        torch.testing.assert_close(v, v2, rtol=0, atol=0)


def test_trainer_takes_ndarray_inputs():
    """data / label as mx.nd arrays (as the JAX trainer's _prepare takes
    them) give the trajectory of the same values as tensors; the trainer
    leaves autograd's training mode as it found it."""
    import mxnet_tpu_torch as mt
    a, b = _port_net(9), _port_net(9)
    rs = np.random.RandomState(10)
    data = rs.rand(2, 2, 32, 32, 3).astype(np.float32)
    label = rs.randint(0, 10, (2, 2)).astype(np.float32)
    ta = TTrainer(a, tloss.SoftmaxCrossEntropyLoss(), optimizer_params=OPT)
    tb = TTrainer(b, tloss.SoftmaxCrossEntropyLoss(), optimizer_params=OPT)
    cpu = mt.cpu()
    assert not mt.autograd.is_training()
    la = ta.run_steps(mt.nd.array(data, ctx=cpu), mt.nd.array(label, ctx=cpu))
    la1 = ta.step(mt.nd.array(data[0], ctx=cpu),
                  mt.nd.array(label[0], ctx=cpu))
    assert not mt.autograd.is_training()
    lb = tb.run_steps(torch.from_numpy(data), torch.from_numpy(label))
    lb1 = tb.step(torch.from_numpy(data[0]), torch.from_numpy(label[0]))
    torch.testing.assert_close(la, lb, rtol=0, atol=0)
    torch.testing.assert_close(la1, lb1, rtol=0, atol=0)
    with mt.autograd.train_mode():
        ta.step(data[1], label[1])       # numpy arrays too
        assert mt.autograd.is_training()


def test_trainer_refuses_uninitialized_params_and_other_optimizers():
    from mxnet_tpu_torch import MXNetError
    net = tnn.Dense(3, in_units=4, device="cpu")
    tr = TTrainer(net, tloss.SoftmaxCrossEntropyLoss())
    with pytest.raises(MXNetError, match="not initialized"):
        tr.step(torch.zeros(2, 4), torch.zeros(2))
    with pytest.raises(MXNetError, match="sgd"):
        TTrainer(net, tloss.SoftmaxCrossEntropyLoss(), optimizer="nag")
    with pytest.raises(MXNetError, match="mesh"):
        TTrainer(net, tloss.SoftmaxCrossEntropyLoss(), mesh=object())


# ---------------------------------------------------------------------------
# the K-step CUDA graph (marked cuda: skips without a card; this file's
# card tests import no JAX, so they run on the card as
#     python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
#         tests/test_torch_spmd.py
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA-graph path runs only there)")
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = prev


def _card_pair(opt, params):
    """Two trainers over the same start weights on the card."""
    src = _port_net(12)
    weights = {k: p.data().asnumpy() for k, p in src.collect_params().items()}
    out = []
    for _ in range(2):
        net = TResNet(TBottleneck, *SPEC, classes=10, layout="NHWC",
                      stem_s2d=True, device="cuda")
        convert.from_mxnet_tpu_params(net, weights, prefix=src.prefix)
        out.append((net, TTrainer(net, tloss.SoftmaxCrossEntropyLoss(),
                                  optimizer=opt, optimizer_params=params)))
    return out


def _max_rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("opt,params", [("sgd", OPT), ("adam", ADAM)])
def test_graph_run_steps_follows_eager_steps(card, opt, params):
    """run_steps three times (eager first call, then two replays, the last
    on new data) against 3 K eager step() calls: losses and state within
    1e-3 of each tensor's largest value (cuDNN may pick other algorithms
    under capture); every BN ticket counter back at 0."""
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    (ng, tg), (ne, te) = _card_pair(opt, params)
    rs = np.random.RandomState(13)
    batches = [(torch.from_numpy(rs.rand(2, 2, 32, 32, 3).astype(np.float32))
                .cuda(), torch.from_numpy(rs.randint(0, 10, (2, 2)).astype(
                    np.float32)).cuda()) for _ in range(3)]
    for d, lab in batches:
        lg = tg.run_steps(d, lab)
        le = torch.stack([te.step(d[k], lab[k]) for k in range(2)])
        assert _max_rel(lg, le) <= 1e-3
    torch.cuda.synchronize()
    assert len(tg._graphs) == 1
    for (_, p), (_, q) in zip(ng.collect_params().items(),
                              ne.collect_params().items()):
        assert _max_rel(p.tensor, q.tensor) <= 1e-3, p.name
    assert all(int(v.abs().sum()) == 0 for v in tk._tickets.values())


@pytest.mark.cuda
def test_graph_replay_calls_no_wrapper_and_refuses_a_rebound_parameter(card):
    from mxnet_tpu_torch import MXNetError
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    (net, tr), _ = _card_pair("sgd", OPT)
    d = torch.rand(2, 2, 32, 32, 3, device="cuda")
    lab = torch.zeros(2, 2, device="cuda")
    tr.run_steps(d, lab)                 # eager K steps, then the capture
    before = dict(tk.launches)
    tr.run_steps(d, lab)                 # a replay
    torch.cuda.synchronize()
    assert tk.launches == before
    net.output.weight = torch.nn.Parameter(net.output.weight.detach()
                                           .clone())
    with pytest.raises(MXNetError, match="rebound"):
        tr.run_steps(d, lab)



@pytest.mark.cuda
@pytest.mark.parametrize("remat", [False, True])
def test_graph_trains_a_hybrid_forward_block(card, remat):
    """A user block (``params.get`` + ``hybrid_forward`` over ``mx.nd``,
    a Dropout between) through run_steps' graph, with and without remat:
    the replay follows eager steps, the ``params.get`` weight gets its
    gradient inside the graph, and remat's recompute draws no new mask
    (its trajectory is the plain one's)."""
    import mxnet_tpu_torch as mx

    class Net(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.drop = tnn.Dropout(0.5)    # the default generator
            self.w = self.params.get("w", shape=(8, 4))

        def hybrid_forward(self, F, x, w):
            return F.dot(self.drop(F.tanh(x)), w)

    rs = np.random.RandomState(2)
    w0 = rs.randn(8, 4).astype(np.float32)
    d = torch.from_numpy(rs.randn(2, 6, 8).astype(np.float32)).cuda()
    lab = torch.from_numpy(rs.randint(0, 4, (2, 6)).astype(
        np.float32)).cuda()
    runs = {}
    for how in ("graph", "eager", "plain"):
        with mx.gpu(0):
            net = Net(prefix=f"user_{how}_")
        net.w.set_data(w0)
        torch.cuda.manual_seed(5)
        tr = TTrainer(net, tloss.SoftmaxCrossEntropyLoss(),
                      optimizer_params={"learning_rate": 0.5},
                      remat=remat and how != "plain")
        if how == "eager":
            losses = torch.stack([tr.step(d[k], lab[k]) for _ in range(2)
                                  for k in range(2)])
        else:
            losses = torch.cat([tr.run_steps(d, lab) for _ in range(2)])
        torch.cuda.synchronize()
        runs[how] = (losses, net.w.tensor.detach().clone())
    assert _max_rel(runs["graph"][0], runs["eager"][0]) <= 1e-6
    assert _max_rel(runs["graph"][1], runs["eager"][1]) <= 1e-6
    assert torch.equal(runs["graph"][0], runs["plain"][0])
    assert torch.equal(runs["graph"][1], runs["plain"][1])
    assert float((runs["graph"][1].cpu() - torch.from_numpy(w0)).abs()
                 .max()) > 0


if __name__ == "__main__":
    _jax_reference(sys.argv[1])
