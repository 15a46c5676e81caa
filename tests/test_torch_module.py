"""``mx.mod`` (Module, BucketingModule, SequentialModule), ``FeedForward``,
``callback.module_checkpoint``, ``mx.Executor`` and ``AttrScope``: the
port against the JAX package on the CPU (cases after
``tests/test_symbol_module.py``'s Module, BucketingModule, checkpoint,
monitor and callback cases).

The same numpy inputs and weights go through both packages; f32 results
agree within 2e-5 of each tensor's largest value (the ROADMAP's f32
tolerance), those through a fused BN op's plain version within 2e-3.

The fused BN ops' moving statistics after a training step are held to
the JAX package's Gluon fused blocks, not to its Executor: the JAX
Executor blends only ``BatchNorm``'s (``AUX_UPDATERS``) and leaves a
``_contrib_fused_bn_relu`` node's as they were, which
``test_fused_bn_executor_fault_of_jax_and_the_ports_repair`` shows side
by side with the port's repair.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.symbol import symbol as tsym

CPU = mt.cpu()


def _reset():
    jsym._NAME_COUNTER.clear()
    tsym._NAME_COUNTER.clear()


def _close(got, want, tol=2e-5, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err} of max"


def _both(run, *args, **kw):
    """``run(mx, *args)`` under each package's CPU context: (jax, port)."""
    out = []
    for mx in (jmx, mt):
        _reset()
        with mx.cpu():
            out.append(run(mx, *args, **kw))
    return out


def _mlp(mx, num_hidden=32, classes=10):
    data = mx.sym.var("data")
    w1, b1 = mx.sym.var("fc1_weight"), mx.sym.var("fc1_bias")
    h = mx.sym.FullyConnected(data, w1, b1, num_hidden=num_hidden,
                              name="fc1")
    h = mx.sym.Activation(h, act_type="relu")
    w2, b2 = mx.sym.var("fc2_weight"), mx.sym.var("fc2_bias")
    h = mx.sym.FullyConnected(h, w2, b2, num_hidden=classes, name="fc2")
    return mx.sym.SoftmaxOutput(h, mx.sym.var("softmax_label"),
                                name="softmax")


def _synthetic(n=512, d=16, classes=10, seed=0):
    rs = np.random.RandomState(seed)
    centers = rs.randn(classes, d).astype(np.float32) * 3
    labels = rs.randint(0, classes, n)
    data = centers[labels] + rs.randn(n, d).astype(np.float32)
    return data, labels.astype(np.float32)


def _mlp_params(d=16, hidden=32, classes=10, seed=1):
    rs = np.random.RandomState(seed)
    return {"fc1_weight": rs.randn(hidden, d).astype(np.float32) * 0.1,
            "fc1_bias": rs.randn(hidden).astype(np.float32) * 0.01,
            "fc2_weight": rs.randn(classes, hidden).astype(np.float32) * 0.1,
            "fc2_bias": np.zeros(classes, np.float32)}


def _nd_params(mx, values):
    return {k: mx.nd.array(v) for k, v in values.items()}


def _numpy(params):
    return {k: v.asnumpy() for k, v in params.items()}


# ---------------------------------------------------------------------------
# Module: fit, score, predict, checkpoints
# ---------------------------------------------------------------------------

def _fit(mx, epochs, kvstore="local"):
    data, labels = _synthetic()
    it = mx.io.NDArrayIter(data, labels, batch_size=64)
    mod = mx.mod.Module(_mlp(mx))
    mod.fit(it, num_epoch=epochs, optimizer="sgd", kvstore=kvstore,
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9},
            arg_params=_nd_params(mx, _mlp_params()))
    arg, _ = mod.get_params()
    return _numpy(arg), dict(mod.score(it, "acc"))["accuracy"]


def test_module_train_converges():
    """Module.fit over an NDArrayIter, 5 epochs of SGD momentum: the
    weights the JAX Module reaches, and its accuracy."""
    (jw, jacc), (tw, tacc) = _both(_fit, 5)
    for k in jw:
        _close(tw[k], jw[k], what=k)
    assert tacc == jacc and tacc > 0.85


@pytest.mark.parametrize("kvstore,update_on_kv", [
    ("local_allreduce_device", "1"), ("local_allreduce_device", "0")])
def test_module_update_through_a_kvstore(kvstore, update_on_kv,
                                         monkeypatch):
    """``update`` with a kvstore: the store updates
    (MXNET_UPDATE_ON_KVSTORE=1) or only aggregates and the Module updates
    (0); either way the weights of the plain path and of JAX."""
    monkeypatch.setenv("MXNET_UPDATE_ON_KVSTORE", update_on_kv)
    (jw, _), (tw, _) = _both(_fit, 1, kvstore)
    _reset()
    with CPU:
        pw, _ = _fit(mt, 1)
    for k in jw:
        _close(tw[k], jw[k], what=k)
        _close(tw[k], pw[k], what=k)


def _predict_and_checkpoint(mx, prefix):
    data, labels = _synthetic(128)
    it = mx.io.NDArrayIter(data, labels, batch_size=32)
    mod = mx.mod.Module(_mlp(mx, 16))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params=_nd_params(mx, _mlp_params(hidden=16)))
    preds = mod.predict(it)
    mod.save_checkpoint(prefix, 3)
    return preds.asnumpy()


def test_module_predict_and_checkpoint(tmp_path):
    """predict over a DataIter; save_checkpoint in one package and
    Module.load in the other predicts the same."""
    jp, tp = _both(_predict_and_checkpoint, str(tmp_path / "m"))
    assert tp.shape == (128, 10)
    _close(tp, jp)
    data, labels = _synthetic(128)
    for mx in (jmx, mt):
        with mx.cpu():
            it = mx.io.NDArrayIter(data, labels, batch_size=32)
            mod = mx.mod.Module.load(str(tmp_path / "m"), 3,
                                     context=mx.cpu())
            mod.bind(data_shapes=it.provide_data,
                     label_shapes=it.provide_label)
            mod.init_params()
            _close(mod.predict(it).asnumpy(), jp)


def _bn_executor(mx, x):
    data = mx.sym.var("data")
    g, b = mx.sym.var("gamma"), mx.sym.var("beta")
    net = mx.sym.Group([mx.sym.BatchNorm(data, g, b, fix_gamma=False,
                                         name="bn2")[0]])
    ex = net.simple_bind(mx.cpu(), data=x.shape, gamma=(4,), beta=(4,))
    ex.aux_dict["bn2_moving_var"][:] = np.ones(4, np.float32)
    ex.arg_dict["gamma"][:] = np.ones(4, np.float32)
    ex.arg_dict["data"][:] = x
    ex.forward(is_train=True)
    return (net.list_auxiliary_states(), ex.outputs[0].asnumpy(),
            ex.aux_dict["bn2_moving_mean"].asnumpy(),
            ex.aux_dict["bn2_moving_var"].asnumpy())


def test_module_batchnorm_aux_states():
    """A training forward through BatchNorm moves its aux states, as in
    the JAX executor."""
    x = np.random.RandomState(0).randn(8, 4).astype(np.float32) + 7
    (ja, jo, jm, jv), (ta, to, tm, tv) = _both(_bn_executor, x)
    assert ta == ja == ["bn2_moving_mean", "bn2_moving_var"]
    assert not np.allclose(tm, 0.0)
    for got, want in ((to, jo), (tm, jm), (tv, jv)):
        _close(got, want)


def _fit_with_callbacks(mx):
    rs = np.random.RandomState(0)
    X = rs.randn(64, 8).astype(np.float32)
    Y = (X.sum(1) > 0).astype(np.float32)
    data = mx.sym.Variable("data")
    fc = mx.sym.FullyConnected(data, mx.sym.Variable("fc_weight"),
                               mx.sym.Variable("fc_bias"), num_hidden=2,
                               name="fc")
    out = mx.sym.Softmax(fc, mx.sym.Variable("softmax_label"),
                         name="softmax")
    seen = {"batches": [], "epochs": [], "monitor": 0}

    def stat(x):
        seen["monitor"] += 1
        return x.abs().mean()

    def batch_cb(param):
        seen["batches"].append((param.epoch, param.nbatch))

    def epoch_cb(epoch, sym, arg_params, aux_params):
        seen["epochs"].append((epoch, sorted(arg_params)))

    mod = mx.mod.Module(out, data_names=["data"],
                        label_names=["softmax_label"])
    # a warm start from arg_params, the rest from the initializer
    mod.fit(mx.io.NDArrayIter(X, Y, batch_size=16), num_epoch=2,
            arg_params={"fc_weight": mx.nd.zeros((2, 8))},
            allow_missing=True, initializer=mx.init.Zero(),
            optimizer="sgd", optimizer_params={"learning_rate": 0.5},
            batch_end_callback=batch_cb, epoch_end_callback=epoch_cb,
            monitor=mx.Monitor(1, stat_func=stat, pattern=".*fc.*"))
    m = mx.metric.Accuracy()
    mod.score(mx.io.NDArrayIter(X, Y, batch_size=16), m)
    arg, _ = mod.get_params()
    return seen, m.get()[1], _numpy(arg)


def test_module_fit_with_monitor_and_callbacks():
    """The fit harness's edges (ref test_module.py): the monitor fires,
    batch and epoch callbacks get the reference's payloads, arg_params
    warm-start with allow_missing; the same calls and weights as JAX."""
    (js, jacc, jw), (ts, tacc, tw) = _both(_fit_with_callbacks)
    assert ts["batches"] == js["batches"] == [(e, b) for e in range(2)
                                              for b in range(4)]
    assert ts["epochs"] == js["epochs"] == [
        (0, ["fc_bias", "fc_weight"]), (1, ["fc_bias", "fc_weight"])]
    assert ts["monitor"] > 0 and js["monitor"] > 0
    assert tacc == jacc and tacc > 0.6
    for k in jw:
        _close(tw[k], jw[k], what=k)


def _inputs_need_grad(mx):
    rs = np.random.RandomState(4)
    x = rs.randn(6, 16).astype(np.float32)
    mod = mx.mod.Module(_mlp(mx))
    mod.bind(data_shapes=[("data", (6, 16))],
             label_shapes=[("softmax_label", (6,))], inputs_need_grad=True)
    mod.init_params(arg_params=_nd_params(mx, _mlp_params()))
    mod.forward_backward(mx.io.DataBatch([mx.nd.array(x)],
                                         [mx.nd.array(np.arange(6.0))]))
    return (mod.get_input_grads()[0].asnumpy(),
            mod.get_outputs()[0].asnumpy(),
            [d.name for d in mod.data_shapes], mod.output_shapes)


def test_module_input_grads_and_shapes():
    """``inputs_need_grad``: the data's gradient, outputs, data and output
    shapes as JAX has them."""
    (jg, jo, jd, js), (tg, to, td, ts) = _both(_inputs_need_grad)
    _close(tg, jg)
    _close(to, jo)
    assert td == jd and ts == js == [("softmax_output", (6, 10))]


def _resume(mx, prefix, interrupted):
    """Three SGD momentum steps, or one step, module_checkpoint, load with
    the optimizer states and two more steps."""
    data, labels = _synthetic(96)
    batches = [mx.io.DataBatch([mx.nd.array(data[i:i + 32])],
                               [mx.nd.array(labels[i:i + 32])])
               for i in range(0, 96, 32)]
    opt = dict(optimizer="sgd",
               optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    mod = mx.mod.Module(_mlp(mx))
    mod.bind(data_shapes=[("data", (32, 16))],
             label_shapes=[("softmax_label", (32,))])
    mod.init_params(arg_params=_nd_params(mx, _mlp_params()))
    mod.init_optimizer(**opt)
    for b in batches[:1 if interrupted else 3]:
        mod.forward_backward(b)
        mod.update()
    if interrupted:
        mx.callback.module_checkpoint(mod, prefix,
                                      save_optimizer_states=True)(0)
        mod = mx.mod.Module.load(prefix, 1, load_optimizer_states=True,
                                 context=mx.cpu())
        mod.bind(data_shapes=[("data", (32, 16))],
                 label_shapes=[("softmax_label", (32,))])
        mod.init_params()
        mod.init_optimizer(**opt)
        for b in batches[1:]:
            mod.forward_backward(b)
            mod.update()
    return _numpy(mod.get_params()[0])


def test_module_checkpoint_and_load_resume(tmp_path):
    """``callback.module_checkpoint`` (with the optimizer states) and
    ``Module.load(load_optimizer_states=True)``: the resumed run's weights
    bit for bit the uninterrupted one's in the port; the JAX run without
    the interruption agrees within f32."""
    _reset()
    with CPU:
        plain = _resume(mt, str(tmp_path / "p"), False)
        resumed = _resume(mt, str(tmp_path / "p"), True)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "p-0001.params", "p-0001.states", "p-symbol.json"]
    for k in plain:
        np.testing.assert_array_equal(resumed[k], plain[k])
    _reset()
    with jmx.cpu():
        jplain = _resume(jmx, str(tmp_path / "j"), False)
    for k in plain:
        _close(plain[k], jplain[k], what=k)


# ---------------------------------------------------------------------------
# BucketingModule
# ---------------------------------------------------------------------------

def _bucket_gen(mx):
    def sym_gen(seq_len):
        # the weight is bucket-independent (applied per time step)
        data = mx.sym.var("data")
        h = mx.sym.FullyConnected(data, mx.sym.var("w"), num_hidden=4,
                                  no_bias=True, flatten=False)
        h = mx.sym.reshape(h, shape=(-3, 4))
        out = mx.sym.SoftmaxOutput(h, mx.sym.var("softmax_label"))
        return out, ("data",), ("softmax_label",)
    return sym_gen


def _bucketing(mx):
    rs = np.random.RandomState(2)
    bm = mx.mod.BucketingModule(_bucket_gen(mx), default_bucket_key=8)
    bm.bind(data_shapes=[("data", (2, 8, 6))],
            label_shapes=[("softmax_label", (16,))])
    bm.init_params(arg_params={"w": mx.nd.array(
        rs.randn(4, 6).astype(np.float32) * 0.3)})
    bm.init_optimizer(optimizer="sgd",
                      optimizer_params={"learning_rate": 0.1,
                                        "momentum": 0.9})
    outs = []
    for key in (8, 4, 8, 6):
        batch = mx.io.DataBatch(
            [mx.nd.array(rs.randn(2, key, 6).astype(np.float32))],
            [mx.nd.array(rs.randint(0, 4, 2 * key).astype(np.float32))],
            bucket_key=key)
        bm.forward(batch, is_train=True)
        bm.backward()
        bm.update()
        outs.append(bm.get_outputs()[0].asnumpy())
    execs = [bm._buckets[k]._exec for k in (8, 4, 6)]
    shared = all(e.arg_dict["w"] is execs[0].arg_dict["w"] for e in execs)
    return outs, bm.get_params()[0]["w"].asnumpy(), shared, sorted(
        bm._buckets)


def test_bucketing_module():
    """One executor a bucket over the same weight, one optimizer: outputs
    and the trained weight as the JAX BucketingModule's."""
    (jo, jw, jshared, jk), (to, tw, tshared, tk) = _both(_bucketing)
    assert tshared and jshared and tk == jk == [4, 6, 8]
    for got, want in zip(to, jo):
        _close(got, want)
    _close(tw, jw)


def _shares(mx):
    def gen(bucket_key):
        data = mx.sym.Variable("data")
        fc = mx.sym.FullyConnected(data, mx.sym.Variable("w"),
                                   num_hidden=2, no_bias=True,
                                   flatten=False, name="fc")
        return fc, ["data"], []

    mod = mx.mod.BucketingModule(gen, default_bucket_key=8)
    mod.bind(data_shapes=[("data", (4, 8, 6))], label_shapes=None)
    mod.init_params(mx.init.Constant(0.5))
    mod.forward(mx.io.DataBatch([mx.nd.ones((4, 8, 6))], []),
                is_train=False)
    out8 = mod.get_outputs()[0].asnumpy()
    mod.switch_bucket(4, [("data", (4, 4, 6))], None)
    shared = mod._buckets[4]._exec.arg_dict["w"] is \
        mod._buckets[8]._exec.arg_dict["w"]
    mod.forward(mx.io.DataBatch([mx.nd.ones((4, 4, 6))], []),
                is_train=False)
    out4 = mod.get_outputs()[0].asnumpy()
    # a write through one bucket's array is seen by the other
    mod._buckets[8]._exec.arg_dict["w"] += 0.5
    mod.forward(mx.io.DataBatch([mx.nd.ones((4, 4, 6))], []),
                is_train=False)
    return shared, out8, out4, mod.get_outputs()[0].asnumpy()


def test_bucketing_module_shares_parameters_across_buckets():
    (js, j8, j4, jw), (ts, t8, t4, tw) = _both(_shares)
    assert ts and js
    np.testing.assert_allclose(t8[0, 0], 0.5 * 6, rtol=1e-6)
    np.testing.assert_allclose(t4[0, 0], 0.5 * 6, rtol=1e-6)
    np.testing.assert_allclose(tw[0, 0], 1.0 * 6, rtol=1e-6)
    for got, want in ((t8, j8), (t4, j4), (tw, jw)):
        _close(got, want)
    # the port's buckets hold one storage
    _reset()
    with CPU:
        mod = mt.mod.BucketingModule(lambda k: _bucket_gen(mt)(k), 8)
        mod.bind(data_shapes=[("data", (2, 8, 6))],
                 label_shapes=[("softmax_label", (16,))])
        mod.init_params()
        mod.switch_bucket(4, [("data", (2, 4, 6))],
                          [("softmax_label", (8,))])
        ptrs = {m._exec.arg_dict["w"].tensor.data_ptr()
                for m in mod._buckets.values()}
    assert len(ptrs) == 1


# ---------------------------------------------------------------------------
# SequentialModule, FeedForward
# ---------------------------------------------------------------------------

def _sequential(mx):
    rs = np.random.RandomState(5)
    data = mx.sym.var("data")
    h = mx.sym.Activation(mx.sym.FullyConnected(
        data, mx.sym.var("a_weight"), mx.sym.var("a_bias"), num_hidden=12,
        name="a"), act_type="tanh", name="a_act")
    head = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        mx.sym.var("hidden"), mx.sym.var("b_weight"), mx.sym.var("b_bias"),
        num_hidden=3, name="b"), mx.sym.var("softmax_label"),
        name="softmax")
    m1 = mx.mod.Module(h, data_names=["data"], label_names=None)
    m2 = mx.mod.Module(head, data_names=["hidden"],
                       label_names=["softmax_label"])
    seq = mx.mod.SequentialModule().add(m1).add(m2, take_labels=True,
                                                auto_wiring=True)
    seq.bind(data_shapes=[("data", (8, 5))],
             label_shapes=[("softmax_label", (8,))])
    values = {"a_weight": rs.randn(12, 5) * 0.3, "a_bias": rs.randn(12) * 0.1,
              "b_weight": rs.randn(3, 12) * 0.3, "b_bias": np.zeros(3)}
    seq.init_params(arg_params={k: mx.nd.array(v.astype(np.float32))
                                for k, v in values.items()},
                    allow_missing=True)
    seq.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.2})
    outs = []
    for _ in range(3):
        batch = mx.io.DataBatch(
            [mx.nd.array(rs.randn(8, 5).astype(np.float32))],
            [mx.nd.array(rs.randint(0, 3, 8).astype(np.float32))])
        seq.forward(batch, is_train=True)
        seq.backward()
        seq.update()
        outs.append(seq.get_outputs()[0].asnumpy())
    return outs, _numpy(seq.get_params()[0]), seq.output_names


def test_sequential_module_matches_jax():
    """Two Modules chained (auto-wired, the labels to the last): three
    forward / backward / update steps, outputs and weights as JAX's."""
    (jo, jw, jn), (to, tw, tn) = _both(_sequential)
    assert tn == jn == ["softmax_output"]
    for got, want in zip(to, jo):
        _close(got, want)
    assert sorted(tw) == sorted(jw)
    for k in jw:
        _close(tw[k], jw[k], what=k)


def _feedforward(mx, prefix):
    data, labels = _synthetic(256)
    it = mx.io.NDArrayIter(data, labels, batch_size=32)
    model = mx.model.FeedForward(
        _mlp(mx), ctx=mx.cpu(), num_epoch=2, optimizer="sgd",
        arg_params=_nd_params(mx, _mlp_params()),
        optimizer_params={"learning_rate": 0.3})
    model.fit(it)
    preds = model.predict(it).asnumpy()
    acc = dict(model.score(it))["accuracy"]
    model.save(prefix)
    back = mx.model.FeedForward.load(prefix, 2)
    return preds, acc, _numpy(back.arg_params)


def test_feedforward_fit_predict_save_load(tmp_path):
    """The deprecated FeedForward: fit, predict, score, save and load as
    in the JAX package."""
    (jp, jacc, jw), (tp, tacc, tw) = _both(
        _feedforward, str(tmp_path / "ff"))
    _close(tp, jp)
    assert tacc == jacc
    for k in jw:
        _close(tw[k], jw[k], what=k)


# ---------------------------------------------------------------------------
# the fused BN ops under Module (fault 1 of the JAX package)
# ---------------------------------------------------------------------------

def _fused_symbol(mx):
    """conv -> fused BN+ReLU -> conv -> fused BN+add(data)+ReLU -> pool
    -> FC -> SoftmaxOutput, NHWC: the node kinds an exported ResNet's
    blocks have."""
    data = mx.sym.var("data")

    def bn(i):
        # shaped variables: the JAX package has no shape hint for these ops
        return [mx.sym.var(f"bn{i}_{n}", shape=(4,)) for n in
                ("gamma", "beta", "moving_mean", "moving_var")]
    x = mx.sym.Convolution(data, num_filter=4, kernel=(3, 3), pad=(1, 1),
                           no_bias=True, layout="NHWC", name="c1")
    x = mx.sym.contrib.fused_bn_relu(x, *bn(1), momentum=0.8, name="bn1")[0]
    x = mx.sym.Convolution(x, num_filter=4, kernel=(3, 3), pad=(1, 1),
                           no_bias=True, layout="NHWC", name="c2")
    x = mx.sym.contrib.fused_bn_add_relu(x, data, *bn(2), momentum=0.8,
                                         name="bn2")[0]
    x = mx.sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(1, 1),
                       layout="NHWC")
    x = mx.sym.FullyConnected(mx.sym.flatten(x), num_hidden=3, name="fc")
    return mx.sym.SoftmaxOutput(x, mx.sym.var("softmax_label"),
                                name="softmax")


def _fused_values(mx):
    sym = _fused_symbol(mx)
    shapes, _, aux = sym.infer_shape(data=(6, 5, 5, 4), softmax_label=(6,))
    rs = np.random.RandomState(8)
    args = {n: (rs.randn(*s) * 0.4).astype(np.float32)
            for n, s in zip(sym.list_arguments(), shapes)
            if n not in ("data", "softmax_label")}
    for n in args:
        if n.endswith("gamma"):
            args[n] = 1 + args[n] * 0.1
    aux = {n: (np.zeros(s) if "mean" in n else np.ones(s)).astype(
        np.float32) for n, s in zip(sym.list_auxiliary_states(), aux)}
    x = (rs.randn(6, 5, 5, 4) * 2 + 1).astype(np.float32)
    y = rs.randint(0, 3, 6).astype(np.float32)
    return sym, args, aux, x, y


def _fused_module_step(mx):
    sym, args, aux, x, y = _fused_values(mx)
    mod = mx.mod.Module(sym)
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(arg_params=_nd_params(mx, args),
                    aux_params=_nd_params(mx, aux))
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    mod.forward_backward(mx.io.DataBatch([mx.nd.array(x)],
                                         [mx.nd.array(y)]))
    grads = {k: v.asnumpy() for k, v in mod._exec.grad_dict.items()}
    mod.update()
    arg, auxv = mod.get_params()
    return (mod.get_outputs()[0].asnumpy(), grads, _numpy(arg),
            _numpy(auxv))


def _jax_gluon_fused_stats():
    """The JAX Gluon fused blocks' running statistics after one training
    forward over the same inputs: conv, FusedBatchNormReLU, conv,
    FusedBatchNormAddReLU(x, data)."""
    from mxnet_tpu.gluon.nn import FusedBatchNormAddReLU, FusedBatchNormReLU
    _reset()
    _, args, aux, x, _ = _fused_values(jmx)
    nd = jmx.nd
    out = {}
    h = nd.array(x)
    for i, cls in ((1, FusedBatchNormReLU), (2, FusedBatchNormAddReLU)):
        h = nd.Convolution(h, nd.array(args[f"c{i}_weight"]), num_filter=4,
                           kernel=(3, 3), pad=(1, 1), no_bias=True,
                           layout="NHWC")
        blk = cls(axis=-1, momentum=0.8, epsilon=1e-5, center=True,
                  scale=True, prefix=f"bn{i}_")
        blk.initialize()
        with jmx.autograd.pause():
            blk(h, nd.array(x)) if i == 2 else blk(h)
        blk.gamma.set_data(nd.array(args[f"bn{i}_gamma"]))
        blk.beta.set_data(nd.array(args[f"bn{i}_beta"]))
        blk.running_mean.set_data(nd.zeros((4,)))
        blk.running_var.set_data(nd.ones((4,)))
        with jmx.autograd.record():
            h = blk(h, nd.array(x)) if i == 2 else blk(h)
        out[f"bn{i}_moving_mean"] = blk.running_mean.data().asnumpy()
        out[f"bn{i}_moving_var"] = blk.running_var.data().asnumpy()
    return out


def test_fused_bn_module_step_matches_jax():
    """One Module step over fused BN nodes: outputs, gradients and
    updated weights as the JAX Module's (2e-3: the fused kernels' plain
    versions); the moving statistics as the JAX Gluon fused blocks'."""
    (jo, jg, jw, _), (to, tg, tw, taux) = _both(_fused_module_step)
    _close(to, jo, 2e-3, "outputs")
    for k in jg:
        _close(tg[k], jg[k], 2e-3, f"grad {k}")
        if k in jw:
            _close(tw[k], jw[k], 2e-3, k)
    want = _jax_gluon_fused_stats()
    assert sorted(taux) == sorted(want)
    for k in want:
        _close(taux[k], want[k], 2e-3, k)
        assert not np.allclose(taux[k], 0.0 if "mean" in k else 1.0), k


@pytest.mark.parametrize("op", ["fused_bn_relu", "fused_bn_add_relu"])
def test_fused_bn_executor_fault_of_jax_and_the_ports_repair(op):
    """A one-node graph, 4x3x3x8 NHWC, training forward: the JAX
    Executor leaves the fused op's moving statistics as they were (its
    AUX_UPDATERS knows only BatchNorm); the port blends them like the
    JAX Gluon fused block, and like BatchNorm."""
    rs = np.random.RandomState(3)
    x = (rs.randn(4, 3, 3, 8) * 2 + 3).astype(np.float32)
    r = rs.randn(4, 3, 3, 8).astype(np.float32)
    got = {}
    for mx in (jmx, mt):
        _reset()
        with mx.cpu():
            data = mx.sym.var("data")
            extra = [mx.sym.var("res")] if op == "fused_bn_add_relu" else []
            sym = getattr(mx.sym.contrib, op)(data, *extra, name="bn")[0]
            shapes = {"data": x.shape, **({"res": r.shape} if extra else {}),
                      **{f"bn_{n}": (8,) for n in ("gamma", "beta",
                                                   "moving_mean",
                                                   "moving_var")}}
            ex = sym.simple_bind(mx.cpu(), **shapes)
            ex.arg_dict["bn_gamma"][:] = np.ones(8, np.float32)
            ex.aux_dict["bn_moving_var"][:] = np.ones(8, np.float32)
            feed = {"data": mx.nd.array(x)}
            if extra:
                feed["res"] = mx.nd.array(r)
            ex.forward(is_train=True, **feed)
            got[mx] = (ex.aux_dict["bn_moving_mean"].asnumpy(),
                       ex.aux_dict["bn_moving_var"].asnumpy())
    want_mean = 0.9 * 0 + 0.1 * x.reshape(-1, 8).mean(0)
    want_var = 0.9 * 1 + 0.1 * x.reshape(-1, 8).var(0)
    np.testing.assert_array_equal(got[jmx][0], np.zeros(8, np.float32))
    np.testing.assert_array_equal(got[jmx][1], np.ones(8, np.float32))
    _close(got[mt][0], want_mean, 2e-5, "port moving_mean")
    _close(got[mt][1], want_var, 2e-5, "port moving_var")


# ---------------------------------------------------------------------------
# AttrScope, mx.Executor
# ---------------------------------------------------------------------------

def _attr_scope(mx):
    with mx.AttrScope(ctx_group="dev1", lr_tag="a"):
        w = mx.sym.var("w")
        with mx.AttrScope(ctx_group="dev2"):
            fc = mx.sym.FullyConnected(mx.sym.var("data"), w, num_hidden=2,
                                       no_bias=True, name="fc")
        v = mx.sym.var("v", attr={"own": "1"})
    plain = mx.sym.var("p")
    return (fc.attr_dict(), w.attr("ctx_group"), v.attr_dict(),
            plain.attr_dict(), mx.attribute.current().get())


def test_attr_scope_on_var_and_ops():
    """AttrScope's attributes on variables and op nodes, nested scopes
    winning on a shared key, ``attr=`` replacing the scope's, nothing
    outside a scope."""
    j, t = _both(_attr_scope)
    assert t == j
    assert t[0]["fc"] == {"ctx_group": "dev2", "lr_tag": "a"}
    assert t[1] == "dev1" and t[3] == {} and t[4] == {}


def test_executor_is_the_symbol_executor():
    assert mt.Executor is mt.symbol.executor.Executor
    assert jmx.Executor is jmx.symbol.executor.Executor
    assert mt.mod is mt.module and mt.mod.Module is mt.module.Module
    _reset()
    with CPU:
        ex = mt.Executor(mt.sym.var("a") * 2.0, CPU,
                         {"a": mt.nd.array([1.0, 2.0])})
        np.testing.assert_array_equal(ex.forward()[0].asnumpy(), [2, 4])
