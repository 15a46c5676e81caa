"""The port's ops, layers and ResNet v1 against the JAX package.

Same numpy inputs through mxnet_tpu (JAX on the CPU) and mxnet_tpu_torch
(device="cpu"); forward values and gradients compared. Tolerances: f32
2e-5 for single ops (summation order only), 1e-4 for the small ResNet's
logits (a dozen layers deep); bf16 2e-2 (test_fused_epilogue.py's).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, nd
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon import nn as jnn
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.ndarray.ndarray import from_jax
from mxnet_tpu.ops import nn as jops

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import MXNetError, convert
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.ops import nn as tops

RS = np.random.RandomState(3)


@pytest.fixture(autouse=True)
def _no_tf32():
    """f32 comparisons need full-precision convolutions and matmuls."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = prev


def _tol(dtype):
    return dict(rtol=2e-5, atol=2e-5) if dtype == "float32" \
        else dict(rtol=2e-2, atol=2e-2)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _jvjp(fn, args, cot):
    import jax
    out, vjp = jax.vjp(fn, *args)
    return out, vjp(cot)


def _both(a, dtype, grad=True):
    """(jax array, torch leaf) of one numpy input in ``dtype``."""
    import jax.numpy as jnp
    j = jnp.asarray(a).astype(jnp.dtype(dtype))
    t = torch.from_numpy(a).to(getattr(torch, dtype))
    return j, t.requires_grad_(grad)


# ---------------------------------------------------------------------------
# single ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout,k,stride,pad", [
    ("NHWC", 3, 1, 1), ("NHWC", 1, 2, 0), ("NHWC", 4, 1, 0),
    ("NCHW", 3, 2, 1)])
def test_convolution_matches_jax(layout, k, stride, pad, dtype):
    cin, cout = 6, 5
    xs = (2, 9, 9, cin) if layout == "NHWC" else (2, cin, 9, 9)
    ws = (cout, k, k, cin) if layout == "NHWC" else (cout, cin, k, k)
    x, w = RS.randn(*xs).astype(np.float32), RS.randn(*ws).astype(np.float32)
    (jx, tx), (jw, tw) = _both(x, dtype), _both(w, dtype)

    def jf(a, b):
        return jops._convolution(a, b, kernel=(k, k), stride=(stride, stride),
                                 pad=(pad, pad), num_filter=cout,
                                 no_bias=True, layout=layout)

    jout = jf(jx, jw)
    tout = tops.convolution(tx, tw, stride=stride, pad=pad, layout=layout)
    assert tout.shape == tuple(jout.shape) and tout.dtype == tx.dtype
    tol = _tol(dtype) if dtype == "float32" else dict(rtol=2e-2, atol=1e-1)
    np.testing.assert_allclose(_np(tout), _np(jout), **tol)
    dy = RS.randn(*jout.shape).astype(np.float32)
    jdy, tdy = _both(dy, dtype, grad=False)
    _, (jgx, jgw) = _jvjp(jf, (jx, jw), jdy)
    tout.backward(tdy)
    np.testing.assert_allclose(_np(tx.grad), _np(jgx), err_msg="dx", **tol)
    np.testing.assert_allclose(_np(tw.grad), _np(jgw), err_msg="dw", **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [-1, 1])
def test_batch_norm_train_and_inference_match_jax(axis, dtype):
    c = 6
    x = (RS.randn(4, 5, 3, c) * 2 + 3).astype(np.float32)
    if axis == 1:
        x = np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))
    g = (RS.rand(c) + 0.5).astype(np.float32)
    b = RS.randn(c).astype(np.float32)
    mm, mv = RS.randn(c).astype(np.float32), (RS.rand(c) + .5).astype(
        np.float32)
    (jx, tx), (jg, tg), (jb, tb) = (_both(x, dtype), _both(g, "float32"),
                                    _both(b, "float32"))
    tol = _tol(dtype)

    def jf(a, gg, bb):
        return jops._batch_norm(a, gg, bb, mm, mv, eps=1e-5, fix_gamma=False,
                                axis=axis, _training=True)

    import jax
    (jo, jm, jv), vjp = jax.vjp(jf, jx, jg, jb)
    to, tm, tv = tops.batch_norm(tx, tg, tb, torch.from_numpy(mm),
                                 torch.from_numpy(mv), eps=1e-5,
                                 fix_gamma=False, axis=axis, _training=True)
    for mine, ref in ((to, jo), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(_np(mine), _np(ref), **tol)
    dy = RS.randn(*x.shape).astype(np.float32)
    jdy, tdy = _both(dy, dtype, grad=False)
    jgrads = vjp((jdy, 0 * jm, 0 * jv))
    to.backward(tdy)
    for name, mine, ref in zip(("dx", "dgamma", "dbeta"),
                               (tx.grad, tg.grad, tb.grad), jgrads):
        np.testing.assert_allclose(_np(mine), _np(ref), err_msg=name, **tol)
    # inference: moving statistics
    jo2, _, _ = jops._batch_norm(jx, jg, jb, mm, mv, eps=1e-5,
                                 fix_gamma=False, axis=axis, _training=False)
    to2, _, _ = tops.batch_norm(tx, tg, tb, torch.from_numpy(mm),
                                torch.from_numpy(mv), eps=1e-5,
                                fix_gamma=False, axis=axis, _training=False)
    np.testing.assert_allclose(_np(to2), _np(jo2), **tol)


@pytest.mark.parametrize("fused", [False, True])
def test_batch_norm_layer_running_stats_match_jax(fused):
    """MXNet's running-stat rule: running * 0.9 + batch * 0.1 with the
    biased batch variance (not PyTorch's unbiased one), train then eval."""
    c = 5
    x = (RS.randn(3, 4, 4, c) * 3 + 1).astype(np.float32)
    res = RS.randn(3, 4, 4, c).astype(np.float32)
    jcls = jnn.FusedBatchNormAddReLU if fused else jnn.BatchNorm
    tcls = tnn.FusedBatchNormAddReLU if fused else tnn.BatchNorm
    jl = jcls(axis=-1)
    jl.initialize()
    tl = tcls(axis=-1, in_channels=c, device="cpu")
    tl.initialize()
    args_j = (nd.array(x), nd.array(res)) if fused else (nd.array(x),)
    args_t = (torch.from_numpy(x), torch.from_numpy(res)) if fused \
        else (torch.from_numpy(x),)
    for _ in range(2):
        with autograd.record():
            jy = jl(*args_j)
        with mt.autograd.record():
            ty = tl(*args_t)
        np.testing.assert_allclose(_np(ty), jy.asnumpy(), rtol=2e-5,
                                   atol=2e-5)
    np.testing.assert_allclose(_np(tl.running_mean),
                               jl.running_mean.data().asnumpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(tl.running_var),
                               jl.running_var.data().asnumpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(tl(*args_t)), jl(*args_j).asnumpy(),
                               rtol=2e-5, atol=2e-5)


_MODES = {"outside_record": (lambda ag: ag.pause(), False),
          "record": (lambda ag: ag.record(), True),
          "record_predict": (lambda ag: ag.record(train_mode=False), False)}


@pytest.mark.parametrize("mode", list(_MODES))
@pytest.mark.parametrize("kind", ["BatchNorm", "FusedBatchNormReLU",
                                  "FusedBatchNormAddReLU"])
def test_batch_norm_mode_comes_from_autograd(kind, mode):
    """A fresh layer (nn.Module's training flag left as built) follows
    autograd's mode, as the JAX package's does: outside record() and under
    record(train_mode=False) it normalises by the moving statistics and
    keeps them; under record() it uses the batch statistics and blends
    them into the running ones."""
    rs = np.random.RandomState(21)
    c = 5
    x = (rs.randn(3, 4, 4, c) * 3 + 1).astype(np.float32)
    res = rs.randn(3, 4, 4, c).astype(np.float32)
    mm = rs.randn(c).astype(np.float32)
    mv = (rs.rand(c) + 0.5).astype(np.float32)
    jl = getattr(jnn, kind)(axis=-1, in_channels=c)
    jl.initialize()
    jl.running_mean.set_data(nd.array(mm))
    jl.running_var.set_data(nd.array(mv))
    tl = getattr(tnn, kind)(axis=-1, in_channels=c, device="cpu")
    tl.initialize()
    tp = tl.collect_params()
    tp[tl.prefix + "running_mean"].set_data(mm)
    tp[tl.prefix + "running_var"].set_data(mv)
    add = kind == "FusedBatchNormAddReLU"
    scope, moves = _MODES[mode]
    with scope(autograd):
        jy = jl(nd.array(x), nd.array(res)) if add else jl(nd.array(x))
    targs = [mt.nd.array(a, ctx=mt.cpu()) for a in ((x, res) if add
                                                   else (x,))]
    with scope(mt.autograd):
        ty = tl(*targs)
    assert isinstance(ty, mt.nd.NDArray) and tl.training
    np.testing.assert_allclose(ty.asnumpy(), jy.asnumpy(), rtol=2e-5,
                               atol=2e-5)
    for name, start in (("running_mean", mm), ("running_var", mv)):
        got = tp[tl.prefix + name].data().asnumpy()
        np.testing.assert_allclose(
            got, getattr(jl, name).data().asnumpy(), rtol=1e-6, atol=1e-6)
        assert (not np.array_equal(got, start)) == moves, name


@pytest.mark.parametrize("kernel,pad", [((3, 3), (0, 0)), ((3, 3), (1, 1)),
                                        ((2, 2), (0, 0)), ((2, 3), (1, 0))])
def test_pooling_stride_defaults_to_one(kernel, pad):
    """C2: no stride given means stride 1, as in the JAX package."""
    import jax.numpy as jnp
    x = np.random.RandomState(22).randn(1, 6, 6, 2).astype(np.float32)
    jout = jops._pooling(jnp.asarray(x), kernel=kernel, pool_type="max",
                         pad=pad, layout="NHWC")
    tout = tops.pooling(torch.from_numpy(x), kernel=kernel, pool_type="max",
                        pad=pad, layout="NHWC")
    assert tout.shape == tuple(jout.shape)
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("residual", [False, True])
def test_fused_epilogue_flag_off_takes_the_composed_chain(
        monkeypatch, residual, dtype):
    """MXTPU_FUSED_EPILOGUE=0 in both packages: the fused op lowers to
    BatchNorm -> (add) -> ReLU; forward and gradients (dx, dres, dgamma,
    dbeta) against the JAX package, and the fused kernels are not
    called."""
    import jax
    from mxnet_tpu_torch.ops import nn as tops_mod
    monkeypatch.setenv("MXTPU_FUSED_EPILOGUE", "0")

    def no_kernels(*a, **k):
        raise AssertionError("the fused kernels ran with the flag off")
    monkeypatch.setattr(tops_mod, "fused_bn_act", no_kernels)
    rs = np.random.RandomState(23)
    c = 6
    x = (rs.randn(2, 5, 3, c) * 2 + 1).astype(np.float32)
    r = rs.randn(2, 5, 3, c).astype(np.float32)
    g = (rs.rand(c) + 0.5).astype(np.float32)
    b = rs.randn(c).astype(np.float32)
    mm, mv = np.zeros(c, np.float32), np.ones(c, np.float32)
    (jx, tx), (jr, tr), (jg, tg), (jb, tb) = (
        _both(x, dtype), _both(r, dtype), _both(g, "float32"),
        _both(b, "float32"))

    def jf(a, rr, gg, bb):
        return jops._fused_bn_act_impl(a, rr if residual else None, gg, bb,
                                       mm, mv, 1e-5, False, False, -1, True)

    (jo, jm, jv), vjp = jax.vjp(jf, jx, jr, jg, jb)
    to, tm, tv = tops.fused_bn_act_impl(
        tx, tr if residual else None, tg, tb, torch.from_numpy(mm),
        torch.from_numpy(mv), eps=1e-5, axis=-1, _training=True)
    tol = _tol(dtype)
    for mine, ref in ((to, jo), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(_np(mine), _np(ref), **tol)
    dy = rs.randn(*x.shape).astype(np.float32)
    jdy, tdy = _both(dy, dtype, grad=False)
    jgrads = vjp((jdy, 0 * jm, 0 * jv))
    to.backward(tdy)
    names = ("dx", "dres", "dgamma", "dbeta")
    for name, mine, ref in zip(names, (tx.grad, tr.grad, tg.grad, tb.grad),
                               jgrads):
        if name == "dres" and not residual:
            assert mine is None
            continue
        np.testing.assert_allclose(_np(mine), _np(ref), err_msg=name, **tol)


def test_resid8_flag_raises_rather_than_compute_something_else(monkeypatch):
    """MXNET_RESID_DTYPE (8-bit saved residuals, ported with A13,
    tests/test_torch_resid8.py) changes what the backward reads, never
    the forward: every op that reads it in the JAX package computes the
    forward it computes without it; a bad value raises."""
    x = torch.randn(1, 4, 4, 2, generator=torch.Generator().manual_seed(0))
    w = torch.ones(3, 1, 1, 2)
    g, b = torch.ones(2), torch.zeros(2)
    calls = [lambda: tops.convolution(x, w, layout="NHWC"),
             lambda: tops.relu(x),
             lambda: tops.batch_norm(x, g, b, g, g, axis=-1,
                                     _training=True)[0],
             lambda: tops.fused_bn_act_impl(x, None, g, b, b, g,
                                            _training=True)[0]]
    monkeypatch.setenv("MXTPU_FUSED_EPILOGUE", "0")
    want = [call() for call in calls]
    monkeypatch.setenv("MXNET_RESID_DTYPE", "fp8")
    for call, ref in zip(calls, want):
        assert torch.equal(call(), ref)
    monkeypatch.setenv("MXNET_RESID_DTYPE", "fp7")
    with pytest.raises(MXNetError, match="expected fp8"):
        tops.relu(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_pooling_matches_jax(layout, dtype):
    shape = (2, 9, 7, 4) if layout == "NHWC" else (2, 4, 9, 7)
    x = RS.randn(*shape).astype(np.float32)
    tol = _tol(dtype)
    for kw in (dict(kernel=(3, 3), pool_type="max", stride=(2, 2),
                    pad=(1, 1)),
               dict(kernel=(1, 1), pool_type="avg", global_pool=True)):
        jx, tx = _both(x, dtype)
        jf = lambda a: jops._pooling(a, layout=layout, **kw)  # noqa: E731
        jout, (jg,) = _jvjp(jf, (jx,), jf(jx) * 0 + 1)
        tout = tops.pooling(tx, layout=layout, **kw)
        assert tout.shape == tuple(jout.shape)
        np.testing.assert_allclose(_np(tout), _np(jout), **tol)
        tout.backward(torch.ones_like(tout))
        np.testing.assert_allclose(_np(tx.grad), _np(jg), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_and_softmax_ce_loss_match_jax(dtype):
    """FullyConnected -> SoftmaxCrossEntropyLoss (log_softmax upcasts to
    f32 and returns data's dtype), value and gradients."""
    x = RS.randn(4, 2, 1, 6).astype(np.float32)
    w = RS.randn(5, 12).astype(np.float32)
    bias = RS.randn(5).astype(np.float32)
    label = np.array([0, 4, 2, 9], np.float32)      # 9 clips to class 4
    (jx, tx), (jw, tw), (jb, tb) = (_both(x, dtype), _both(w, dtype),
                                    _both(bias, dtype))
    jlf = jloss.SoftmaxCrossEntropyLoss()
    tlf = tloss.SoftmaxCrossEntropyLoss()

    def jf(a, ww, bb):
        out = jops._fully_connected(a, ww, bb, num_hidden=5)
        return jlf(from_jax(out), nd.array(label))._data

    jout = jf(jx, jw, jb)
    _, jgrads = _jvjp(jf, (jx, jw, jb), jout * 0 + 1)
    tout = tlf(tops.fully_connected(tx, tw, tb), torch.from_numpy(label))
    assert tout.shape == (4,) and tout.dtype == tx.dtype
    tol = _tol(dtype)
    np.testing.assert_allclose(_np(tout), _np(jout), **tol)
    tout.backward(torch.ones_like(tout))
    for name, mine, ref in zip(("dx", "dw", "db"), (tx.grad, tw.grad,
                                                    tb.grad), jgrads):
        np.testing.assert_allclose(_np(mine), _np(ref), err_msg=name, **tol)


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_space_to_depth_stem_matches_jax(layout):
    """The reshape codes (0, -4, -3) and the (2, 1) pad written out as
    view / permute / pad, with the stem conv's weight carried across."""
    from mxnet_tpu.gluon.block import nn_block_scope
    from mxnet_tpu_torch.gluon.block import name_scope
    scope = f"s2d_test_{layout}_"     # the stem's conv is named in it
    mx.random.seed(0)
    with nn_block_scope(scope):
        jstem = jres.SpaceToDepthStem(8, layout=layout)
    jstem.initialize(mx.init.Xavier())
    shape = (2, 16, 12, 3) if layout == "NHWC" else (2, 3, 16, 12)
    x = RS.rand(*shape).astype(np.float32)
    with autograd.pause():
        want = jstem(nd.array(x)).asnumpy()
    with name_scope(scope):
        tstem = tres.SpaceToDepthStem(8, layout=layout, device="cpu")
    convert.from_mxnet_tpu_params(
        tstem, {k: p.data().asnumpy()
                for k, p in jstem.collect_params().items()})
    got = _np(tstem(torch.from_numpy(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _small_pair(layout="NHWC"):
    mx.random.seed(0)
    spec = ([1, 1, 1, 1], [8, 16, 32, 64, 128])
    jnet = jres.ResNetV1(jres.BottleneckV1, *spec, classes=10,
                         layout=layout, stem_s2d=True)
    jnet.initialize(mx.init.Xavier())
    shape = (4, 32, 32, 3) if layout == "NHWC" else (4, 3, 32, 32)
    x = RS.rand(*shape).astype(np.float32)
    with autograd.pause():
        jnet(nd.array(x))
    tnet = tres.ResNetV1(tres.BottleneckV1, *spec, classes=10,
                         layout=layout, stem_s2d=True, device="cpu")
    convert.from_mxnet_tpu_params(
        tnet, {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()},
        prefix=jnet.prefix)
    return jnet, tnet, x


@pytest.mark.parametrize("layout", ["NHWC", "NCHW"])
def test_small_resnet_forward_matches_jax(layout):
    """Logits in inference mode and in training mode (batch statistics,
    fused epilogues for NHWC), f32, tolerance 1e-4."""
    jnet, tnet, x = _small_pair(layout)
    with autograd.pause():
        want_eval = jnet(nd.array(x)).asnumpy()
    with autograd.record():
        want_train = jnet(nd.array(x)).asnumpy()
    with mt.autograd.pause():
        got_eval = _np(tnet(torch.from_numpy(x)))
    with mt.autograd.record():
        got_train = _np(tnet(torch.from_numpy(x)))
    np.testing.assert_allclose(got_eval, want_eval, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_train, want_train, rtol=1e-4, atol=1e-4)
    n_fused = sum(isinstance(m, tnn.FusedBatchNormReLU)
                  for m in tnet.modules())
    assert n_fused == (12 if layout == "NHWC" else 0)


def test_resnet50_structure_matches_jax():
    """resnet50_v1(NHWC, s2d): 48 fused epilogue blocks (16 with the
    residual add), and the same parameter names and shapes as the JAX net
    after its deferred initialisation."""
    jnet = jres.resnet50_v1(layout="NHWC", stem_s2d=True)
    jnet.initialize(mx.init.Xavier())
    with autograd.pause():
        jnet(nd.array(np.zeros((1, 32, 32, 3), np.float32)))
    tnet = tres.resnet50_v1(layout="NHWC", stem_s2d=True, device="cpu")
    fused = [m for m in tnet.modules()
             if isinstance(m, tnn.FusedBatchNormReLU)]
    assert len(fused) == 48
    assert sum(isinstance(m, tnn.FusedBatchNormAddReLU) for m in fused) == 16
    want = {k[len(jnet.prefix):]: tuple(p.shape)
            for k, p in jnet.collect_params().items()}
    got = {k[len(tnet.prefix):]: p.shape
           for k, p in tnet.collect_params().items()}
    assert got == want
    grad_req = {k[len(jnet.prefix):]: p.grad_req
                for k, p in jnet.collect_params().items()}
    assert {k[len(tnet.prefix):]: p.grad_req
            for k, p in tnet.collect_params().items()} == grad_req


def test_entry_points_default_to_the_card(monkeypatch):
    """No device given and no card: raise, never carry on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        tres.resnet50_v1(layout="NHWC", stem_s2d=True)
    with pytest.raises(MXNetError, match="CUDA"):
        mt.random.seed(0)
    assert mt.context.resolve_device("cpu") == torch.device("cpu")
    assert mt.gpu(1) == torch.device("cuda", 1)


def test_convert_rejects_missing_extra_and_misshaped_names():
    jnet, tnet, _ = _small_pair()
    params = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    first = next(iter(params))
    for broken in ({k: v for k, v in params.items() if k != first},
                   {**params, jnet.prefix + "extra_weight": np.zeros(1)},
                   {**params, first: np.zeros((1, 2))}):
        with pytest.raises(MXNetError):
            convert.from_mxnet_tpu_params(tnet, broken, prefix=jnet.prefix)


def test_initialize_follows_mxnet_name_rules():
    net = tnn.BatchNorm(axis=-1, in_channels=4, device="cpu")
    dense = tnn.Dense(3, in_units=50, device="cpu")
    net.initialize()
    dense.initialize(mt.init.Xavier(), generator=mt.random.seed(1, "cpu"))
    assert torch.equal(net.gamma, torch.ones(4))
    assert torch.equal(net.running_var, torch.ones(4))
    assert torch.equal(net.beta, torch.zeros(4))
    assert torch.equal(dense.bias, torch.zeros(3))
    bound = (3.0 / ((50 + 3) / 2.0)) ** 0.5
    assert 0 < float(dense.weight.detach().abs().max()) <= bound
