"""The port's ``CachedOp`` and ``hybridize()`` against the JAX package's on
the CPU (after tests/test_gluon.py, tests/test_serving.py's CachedOp
cases, tests/test_env_flags.py, tests/test_memory.py and
tests/test_telemetry.py).

On the CPU an entry runs the block eagerly (there is no graph), with the
keys, cache and counters the card's graphs use. Each case builds the
block in both packages with the same weights (``convert``) and feeds the
same numpy inputs: hybridized outputs and gradients match the eager port
bit for bit and the JAX CachedOp at f32 2e-5 (the small ResNet at 1e-4
for logits and running statistics and 1e-3 of each gradient's largest
value, as tests/test_torch_gluon.py holds it); ``cache_info`` after every
call equals the JAX CachedOp's for the same calls.
"""
import gc

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.cached_op import CachedOp as JCachedOp

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.cached_op import CachedOp as TCachedOp

RS = np.random.RandomState(5)


def _pair(make, shape):
    """``make(mx)`` built in both packages, the port's on the CPU with the
    JAX block's weights."""
    jmx.random.seed(3)
    jb = make(jmx)
    jb.initialize(jmx.init.Xavier())
    with jmx.autograd.pause():
        jb(jmx.nd.array(np.zeros(shape, np.float32)))
    with tmx.cpu():
        tb = make(tmx)
        tb.initialize(tmx.init.Xavier())
    with tmx.autograd.pause():
        tb(tmx.nd.array(np.zeros(shape, np.float32), ctx=tmx.cpu()))
    convert.from_mxnet_tpu_params(
        tb, {k: p.data().asnumpy() for k, p in jb.collect_params().items()},
        prefix=jb.prefix)
    return jb, tb


def _mlp(mx):
    net = mx.gluon.nn.HybridSequential(prefix="co_mlp_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(16, activation="tanh"),
                mx.gluon.nn.Dense(3))
    return net


def _conv_bn(mx):
    net = mx.gluon.nn.HybridSequential(prefix="co_cbn_")
    with net.name_scope():
        net.add(mx.gluon.nn.Conv2D(6, kernel_size=3, padding=1,
                                   layout="NHWC"),
                mx.gluon.nn.BatchNorm(axis=-1),
                mx.gluon.nn.Activation("relu"),
                mx.gluon.nn.GlobalAvgPool2D(layout="NHWC"),
                mx.gluon.nn.Dense(4))
    return net


def _resnet(mx):
    from importlib import import_module
    res = import_module(mx.__name__ + ".gluon.model_zoo.vision.resnet")
    return res.ResNetV1(res.BottleneckV1, [1, 1, 1, 1],
                        [8, 16, 32, 64, 128], classes=10, layout="NHWC",
                        stem_s2d=True, prefix="co_res_")


CASES = {"mlp": (_mlp, (4, 10), 2e-5, 2e-5),
         "conv_bn": (_conv_bn, (3, 6, 6, 2), 2e-5, 2e-5),
         "resnet": (_resnet, (4, 32, 32, 3), 1e-4, 1e-3)}


def _close(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} x {scale}"


def _step(mx, net, x, cot, ctx=None):
    """One recorded call and backward with a fixed cotangent; the output
    and every gradient by short name."""
    kw = {} if ctx is None else {"ctx": ctx}
    with mx.autograd.record():
        y = net(mx.nd.array(x, **kw))
    y.backward(mx.nd.array(cot, **kw))
    params = [(k[len(net.prefix):], p)
              for k, p in net.collect_params().items()]
    grads = [(k, p.grad().asnumpy().copy()) for k, p in params
             if p.grad_req != "null"]
    data = [(k, p.data().asnumpy().copy()) for k, p in params]
    return y.asnumpy(), grads, data


@pytest.mark.parametrize("case", sorted(CASES))
def test_hybridized_outputs_grads_and_moving_stats(case):
    make, shape, rel_out, rel_grad = CASES[case]
    jb, tb = _pair(make, shape)
    with tmx.cpu():
        eager = _pair(make, shape)[1]
    out_shape = jb(jmx.nd.array(np.zeros(shape, np.float32))).shape
    jb.hybridize()
    tb.hybridize()
    for _ in range(2):
        x = RS.rand(*shape).astype(np.float32)
        cot = RS.randn(*out_shape).astype(np.float32)
        jy, jg, jd = _step(jmx, jb, x, cot)
        ty, tg, td = _step(tmx, tb, x, cot, tmx.cpu())
        ey, eg, ed = _step(tmx, eager, x, cot, tmx.cpu())
        np.testing.assert_array_equal(ty, ey)
        _close(ty, jy, rel_out, "output")
        # against the eager port in build order, against JAX by name
        assert len(tg) == len(jg) == len(eg) > 0
        for (k, t), (_, e) in zip(tg, eg):
            np.testing.assert_array_equal(t, e, err_msg=k)
            _close(t, dict(jg)[k], rel_grad, k)
        for (k, t), (_, e) in zip(td, ed):
            # the BN moving statistics after the step, the weights
            np.testing.assert_array_equal(t, e, err_msg=k)
            _close(t, dict(jd)[k], rel_out, k)
    # inference: the moving statistics predict
    x = RS.rand(*shape).astype(np.float32)
    _close(tb(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy(),
           jb(jmx.nd.array(x)).asnumpy(), rel_out, "inference")
    assert tb._cached_op.cache_info() == jb._cached_op.cache_info()


def _calls(mx, op, batches, mode):
    """Run ``op`` over the batch sizes, returning cache_info after each."""
    infos = []
    for b in batches:
        x = mx.nd.ones((b, 10))
        if mode == "pause":
            with mx.autograd.pause():
                op(x)
        elif mode == "record":
            with mx.autograd.record():
                op(x).backward()
        else:
            with mx.autograd.train_mode():
                op(x)
        infos.append(tuple(op.cache_info()))
    return infos


SEQUENCES = {
    # tests/test_serving.py: the hot signature survives LRU eviction
    "lru_keeps_hot": (2, [1, 2, 1, 4, 1, 2], "pause"),
    "unbounded_when_zero": (0, [1, 2, 3, 4, 5, 1], "pause"),
    "record": (3, [2, 2, 3, 2, 4, 5, 2], "record"),
    "train_mode": (None, [2, 3, 2], "train"),
}


@pytest.mark.parametrize("seq", sorted(SEQUENCES))
def test_cache_info_sequences_equal_jax(seq):
    size, batches, mode = SEQUENCES[seq]
    jb, tb = _pair(_mlp, (1, 10))
    jop, top = JCachedOp(jb, cache_size=size), TCachedOp(tb, cache_size=size)
    with tmx.cpu():
        got = _calls(tmx, top, batches, mode)
    assert got == _calls(jmx, jop, batches, mode)
    if seq == "unbounded_when_zero":
        assert got[-1][2:] == (0, 5, None)


def test_mixed_modes_share_the_jax_keys():
    """A recorded call and a train-mode call of one shape are one JAX
    signature (the train mode is the key, not recording); inference is
    another."""
    jb, tb = _pair(_mlp, (1, 10))
    jb.hybridize()
    tb.hybridize()
    got, want = [], []
    for mx, net, out, kw in ((jmx, jb, want, {}),
                             (tmx, tb, got, {"ctx": tmx.cpu()})):
        x = mx.nd.ones((2, 10), **kw)
        with mx.autograd.record():
            net(x).backward()
        out.append(tuple(net._cached_op.cache_info()))
        with mx.autograd.train_mode():
            net(x)
        out.append(tuple(net._cached_op.cache_info()))
        net(x)
        out.append(tuple(net._cached_op.cache_info()))
    assert got == want


def test_env_cache_size_zero_is_unbounded(monkeypatch):
    monkeypatch.setenv("MXTPU_CACHEDOP_CACHE_SIZE", "0")
    jb, tb = _pair(_mlp, (1, 10))
    jb.hybridize()
    tb.hybridize()
    for b in range(1, 6):
        jb(jmx.nd.ones((b, 10)))
        tb(tmx.nd.ones((b, 10), ctx=tmx.cpu()))
    assert tb._cached_op.cache_info() == jb._cached_op.cache_info()
    assert tb._cached_op.cache_info().maxsize is None


def test_deferred_init_counts_as_the_jax_cachedop():
    """A net with deferred shapes: the first call resolves them eagerly
    and keys the signature on them, one miss as in JAX."""
    infos = []
    for mx, kw in ((jmx, {}), (tmx, {"ctx": tmx.cpu()})):
        with mx.cpu() if mx is tmx else _nothing():
            net = mx.gluon.nn.Dense(4, prefix="co_def_")
            net.initialize(mx.init.Xavier())
        net.hybridize()
        run = []
        for b in (2, 2, 3):
            y = net(mx.nd.ones((b, 7), **kw))
            run.append(tuple(net._cached_op.cache_info()))
        assert y.shape == (3, 4)
        infos.append(run)
    assert infos[0] == infos[1]


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.mark.parametrize("flag", ["MXNET_EXEC_BULK_EXEC_INFERENCE",
                                  "MXNET_EXEC_BULK_EXEC_TRAIN"])
def test_bulk_exec_flags_run_op_by_op(monkeypatch, flag):
    """tests/test_env_flags.py:101: with the flag off the hybridized
    block runs imperatively and builds no cache entry."""
    jb, tb = _pair(_mlp, (1, 10))
    x = np.ones((2, 10), np.float32)
    train = flag.endswith("TRAIN")

    def run(mx, net, kw):
        if train:
            with mx.autograd.record():
                y = net(mx.nd.array(x, **kw))
            y.backward()
            return y.asnumpy()
        return net(mx.nd.array(x, **kw)).asnumpy()
    tb.hybridize()
    bulk = run(tmx, tb, {"ctx": tmx.cpu()})
    monkeypatch.setenv(flag, "0")
    jb.hybridize()
    tb.hybridize()       # a fresh CachedOp
    imp = run(tmx, tb, {"ctx": tmx.cpu()})
    run(jmx, jb, {})
    np.testing.assert_array_equal(bulk, imp)
    assert not len(tb._cached_op._cache)
    assert jb._cached_op is None or not jb._cached_op._cache


@pytest.mark.parametrize("flag,value", [("MXTPU_FUSED_EPILOGUE", "0"),
                                        ("MXNET_SAFE_ACCUMULATION", "1")])
def test_trace_flags_are_part_of_the_key(monkeypatch, flag, value):
    """Toggling a flag that op implementations read builds a new entry
    (a new capture on the card) instead of replaying the other's."""
    jb, tb = _pair(_conv_bn, (2, 6, 6, 2))
    jb.hybridize()
    tb.hybridize()
    x = RS.rand(2, 6, 6, 2).astype(np.float32)
    got, want = [], []
    for setting in (None, value, None):
        if setting is None:
            monkeypatch.delenv(flag, raising=False)
        else:
            monkeypatch.setenv(flag, setting)
        with jmx.autograd.record():
            jb(jmx.nd.array(x))
        with tmx.autograd.record():
            tb(tmx.nd.array(x, ctx=tmx.cpu()))
        want.append(tuple(jb._cached_op.cache_info()))
        got.append(tuple(tb._cached_op.cache_info()))
    assert got == want
    assert [g[1] for g in got] == [1, 2, 2]


def test_cast_is_a_new_signature():
    jb, tb = _pair(_mlp, (1, 10))
    jb.hybridize()
    tb.hybridize()
    got, want = [], []
    for mx, net, out, kw in ((jmx, jb, want, {}),
                             (tmx, tb, got, {"ctx": tmx.cpu()})):
        net(mx.nd.ones((2, 10), **kw))
        net.cast("float16")
        y = net(mx.nd.ones((2, 10), dtype="float16", **kw))
        assert y.dtype == np.float16
        net.cast("float32")
        net(mx.nd.ones((2, 10), **kw))
        out.append(tuple(net._cached_op.cache_info()))
    assert got == want


def test_nested_hybridized_blocks_run_inside_the_outer_entry():
    """Only the outermost hybridized block has entries; its children run
    inline (the JAX CachedOp inlines them into its trace)."""
    jb, tb = _pair(_mlp, (1, 10))
    tb.hybridize()
    with tmx.autograd.record():
        tb(tmx.nd.ones((2, 10), ctx=tmx.cpu())).backward()
    assert tb._cached_op.cache_info().misses == 1
    for child in tb.children():
        assert child._active and (child._cached_op is None
                                  or not len(child._cached_op._cache))


def test_hybridize_mirror_gradients_equal_plain():
    """``hybridize(mirror=True)`` recomputes inside the backward: the
    gradients are the plain backward's bit for bit."""
    _, plain = _pair(_conv_bn, (2, 6, 6, 2))
    _, remat = _pair(_conv_bn, (2, 6, 6, 2))
    plain.hybridize()
    remat.hybridize(mirror=True)
    x = RS.rand(2, 6, 6, 2).astype(np.float32)
    cot = RS.randn(2, 4).astype(np.float32)
    a = _step(tmx, plain, x, cot, tmx.cpu())
    b = _step(tmx, remat, x, cot, tmx.cpu())
    np.testing.assert_array_equal(a[0], b[0])
    for (k, u), (_, v) in zip(a[1] + a[2], b[1] + b[2]):
        np.testing.assert_array_equal(u, v, err_msg=k)


def test_trainers_run_a_hybridized_net_inline():
    """SPMDTrainer's step is its own program: the hybridized net runs
    inline and its CachedOp builds no entry."""
    from mxnet_tpu_torch.parallel import SPMDTrainer
    _, tb = _pair(_mlp, (1, 10))
    tb.hybridize()
    trn = SPMDTrainer(tb, tmx.gluon.loss.SoftmaxCrossEntropyLoss(),
                      optimizer="sgd", optimizer_params={"learning_rate": 0.1})
    trn.step(np.ones((4, 10), np.float32), np.zeros((4,), np.float32))
    trn.run_steps(np.ones((2, 4, 10), np.float32),
                  np.zeros((2, 4), np.float32))
    assert tb._cached_op is None or not len(tb._cached_op._cache)


def test_memory_analysis_per_signature():
    """tests/test_memory.py:456: one record per warm signature, cached
    until ``refresh``, recorded in the program registry."""
    from mxnet_tpu_torch.telemetry import default_registry
    _, tb = _pair(_mlp, (1, 10))
    op = TCachedOp(tb)
    assert op.memory_analysis() == {}
    op(tmx.nd.array(RS.randn(4, 10).astype(np.float32), ctx=tmx.cpu()))
    report = op.memory_analysis()
    assert len(report) == 1
    stats = next(iter(report.values()))
    params = sum(p.tensor.numel() * 4
                 for p in tb.collect_params().values())
    assert stats["argument_bytes"] == 4 * 10 * 4 + params
    assert stats["output_bytes"] == 4 * 3 * 4
    assert stats["temp_bytes"] == 0 and stats["graph_pool"] == {}
    assert op.memory_analysis() == report
    g = default_registry().get("mxtpu_program_argument_bytes")
    assert g is not None and g.value > 0


def test_cache_gauges_are_monotone_in_the_registry():
    """tests/test_telemetry.py:237-255: the registry's
    ``mxtpu_cachedop_cache_*`` totals take a hybridized net's traffic and
    never go down when a cache dies."""
    from mxnet_tpu_torch import telemetry
    reg = telemetry.default_registry()
    before = reg.render_json().get("mxtpu_cachedop_cache_misses", 0)
    with tmx.cpu():
        net = tmx.gluon.nn.Dense(4)
        net.initialize(tmx.init.Xavier())
    net.hybridize()
    x = tmx.nd.ones((2, 8), ctx=tmx.cpu())
    net(x)           # miss (fresh signature)
    net(x)           # hit
    after = reg.render_json()
    assert after["mxtpu_cachedop_cache_misses"] > before
    assert after["mxtpu_cachedop_cache_hits"] >= 1
    hits, misses = (after["mxtpu_cachedop_cache_hits"],
                    after["mxtpu_cachedop_cache_misses"])
    del net, x
    gc.collect()
    final = reg.render_json()
    assert final["mxtpu_cachedop_cache_hits"] >= hits
    assert final["mxtpu_cachedop_cache_misses"] >= misses


def test_dropout_draws_a_new_mask_each_call():
    with tmx.cpu():
        net = tmx.gluon.nn.HybridSequential()
        net.add(tmx.gluon.nn.Dropout(0.5))
    net.hybridize()
    x = tmx.nd.ones((64, 64), ctx=tmx.cpu())
    with tmx.autograd.record():
        a = net(x).asnumpy()
        b = net(x).asnumpy()
    assert (a == 0).any() and not np.array_equal(a, b)
    assert net._cached_op.cache_info().misses == 1
    np.testing.assert_array_equal(net(x).asnumpy(), x.asnumpy())


def test_aot_half_is_the_serving_fleet(tmp_path):
    """The AOT half serves the serving fleet: the warm inference
    signatures export (training ones do not) and install in a fresh op
    over the same architecture with no hit or miss counted; its calls
    then hit, with the JAX block's outputs (f32 2e-5)."""
    jb, tb = _pair(_mlp, (1, 10))
    op = TCachedOp(tb)
    xs = [np.random.RandomState(b).rand(b, 10).astype(np.float32)
          for b in (1, 3)]
    for x in xs:
        op(tmx.nd.array(x, ctx=tmx.cpu()))
    with tmx.autograd.record():
        op(tmx.nd.array(xs[0], ctx=tmx.cpu()))
    path = str(tmp_path / "aot.bin")
    assert op.aot_export(path) == 2
    fresh = TCachedOp(tb)
    assert fresh.aot_load(path) == 2
    assert fresh.cache_info() == (0, 0, 0, 2, 256)
    for x in xs:
        np.testing.assert_allclose(
            fresh(tmx.nd.array(x, ctx=tmx.cpu())).asnumpy(),
            jb(jmx.nd.array(x)).asnumpy(), rtol=2e-5, atol=2e-5)
    assert fresh.cache_info().hits == 2 and fresh.cache_info().misses == 0
