"""``mx.sym``, the executor and the symbol half of quantization, the port
against the JAX package on the CPU (cases after ``tests/
test_symbol_module.py``'s symbol / executor half).

- graphs built the same way in both packages (node counters reset) write
  the same JSON, and each package loads the other's;
- lists, internals, ``infer_shape`` (with the reference's backfill of
  parameter shapes) and ``infer_type``;
- ``Executor``: forward, backward (write and add), BatchNorm's aux update
  in a training forward, ``simple_bind``, ``reshape`` sharing parameters,
  the monitor;
- ``calib_graph`` and ``quantize_model`` (naive and entropy, examples
  counted) on an MLP, run through both executors;
- ``model.save_checkpoint`` / ``load_checkpoint`` across packages;
- the parts still to port raise naming A14; a JAX control-flow graph
  loads and runs.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.ops.registry import NotPortedError
from mxnet_tpu_torch.symbol import symbol as tsym

CPU = mt.cpu()


def _reset():
    jsym._NAME_COUNTER.clear()
    tsym._NAME_COUNTER.clear()


def _mlp(mx, num_hidden=16, classes=5):
    data = mx.sym.var("data")
    net = mx.sym.FullyConnected(data, name="fc1", num_hidden=num_hidden)
    net = mx.sym.Activation(net, name="relu1", act_type="relu")
    net = mx.sym.FullyConnected(net, name="fc2", num_hidden=classes)
    return mx.sym.SoftmaxOutput(net, mx.sym.var("softmax_label"),
                                name="softmax")


def _convnet(mx):
    data = mx.sym.var("data")
    x = mx.sym.Convolution(data, kernel=(3, 3), pad=(1, 1), num_filter=4,
                           no_bias=True)
    x = mx.sym.BatchNorm(x, fix_gamma=False, momentum=0.8)[0]
    x = mx.sym.Activation(x, act_type="relu")
    x = mx.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
    y = mx.sym.flatten(x) * 2.0 + 1
    return mx.sym.Group([mx.sym.FullyConnected(y, num_hidden=3), x])


@pytest.mark.parametrize("build", [_mlp, _convnet])
def test_json_is_the_jax_json_and_loads_across(build, tmp_path):
    _reset()
    j = build(jmx)
    _reset()
    t = build(mt)
    assert t.tojson() == j.tojson()
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    assert t.list_auxiliary_states() == j.list_auxiliary_states()
    assert t.get_internals().list_outputs() == \
        j.get_internals().list_outputs()
    j.save(str(tmp_path / "j.json"))
    t2 = mt.sym.load(str(tmp_path / "j.json"))
    assert t2.tojson() == j.tojson()
    t.save(str(tmp_path / "t.json"))
    assert jmx.sym.load(str(tmp_path / "t.json")).tojson() == t.tojson()


def test_infer_shape_and_type_match_jax():
    _reset()
    j = _convnet(jmx)
    _reset()
    t = _convnet(mt)
    assert t.infer_shape(data=(2, 3, 8, 8)) == \
        tuple(list(v) for v in j.infer_shape(data=(2, 3, 8, 8)))
    jp = j.infer_shape_partial()
    tp = t.infer_shape_partial()
    assert tp[0] == jp[0]
    tt = t.infer_type(data="float32")
    assert [str(d).split(".")[-1] if d is not None else None
            for d in tt[0]] == [None if d is None else str(d)
                                for d in j.infer_type(data="float32")[0]]
    with pytest.raises(mt.MXNetError, match="cannot infer shape"):
        t.infer_shape()


def _params(sym, shapes, seed=0):
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {n: (rs.rand(*s).astype(np.float32) - 0.5)
            for n, s in zip(sym.list_arguments(), arg_shapes)}
    aux = {n: (rs.rand(*s).astype(np.float32) + 0.5)
           for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, aux


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_executor_forward_backward_aux_match_jax(grad_req):
    _reset()
    j = _convnet(jmx)
    _reset()
    t = _convnet(mt)
    args, aux = _params(j, {"data": (2, 3, 8, 8)})
    rs = np.random.RandomState(1)
    heads = [rs.rand(2, 3).astype(np.float32),
             rs.rand(2, 4, 4, 4).astype(np.float32)]
    jex = j.bind(jmx.cpu(), {k: jmx.nd.array(v) for k, v in args.items()},
                 grad_req=grad_req,
                 aux_states={k: jmx.nd.array(v) for k, v in aux.items()})
    tex = t.bind(CPU, {k: mt.nd.array(v, ctx=CPU) for k, v in args.items()},
                 grad_req=grad_req,
                 aux_states={k: mt.nd.array(v, ctx=CPU)
                             for k, v in aux.items()})
    for _ in range(2):                     # "add" accumulates
        jo = jex.forward(is_train=True)
        to = tex.forward(is_train=True)
        jex.backward([jmx.nd.array(h) for h in heads])
        tex.backward([mt.nd.array(h, ctx=CPU) for h in heads])
    for a, b in zip(to, jex.outputs):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), rtol=1e-5,
                                   atol=1e-5)
    for k, g in jex.grad_dict.items():
        np.testing.assert_allclose(tex.grad_dict[k].asnumpy(), g.asnumpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    for k, v in jex.aux_dict.items():
        np.testing.assert_allclose(tex.aux_dict[k].asnumpy(), v.asnumpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        assert not np.allclose(v.asnumpy(), aux[k])    # moved by training
    # an inference forward leaves the aux states as they are
    before = {k: v.asnumpy() for k, v in tex.aux_dict.items()}
    tex.forward(is_train=False)
    for k, v in tex.aux_dict.items():
        np.testing.assert_array_equal(v.asnumpy(), before[k])


def test_simple_bind_reshape_and_softmax_head_match_jax():
    _reset()
    j = _mlp(jmx)
    _reset()
    t = _mlp(mt)
    jex = j.simple_bind(jmx.cpu(), data=(4, 6), softmax_label=(4,))
    tex = t.simple_bind(CPU, data=(4, 6), softmax_label=(4,))
    assert sorted(tex.arg_dict) == sorted(jex.arg_dict)
    args, _ = _params(j, {"data": (4, 6), "softmax_label": (4,)}, seed=2)
    args["softmax_label"] = np.array([0, 1, 2, 4], np.float32)
    for k, v in args.items():
        jex.arg_dict[k][:] = jmx.nd.array(v)
        tex.arg_dict[k][:] = mt.nd.array(v, ctx=CPU)
    jex.forward(is_train=True)
    tex.forward(is_train=True)
    jex.backward()
    tex.backward()
    for k in ("fc1_weight", "fc2_bias", "data"):
        np.testing.assert_allclose(tex.grad_dict[k].asnumpy(),
                                   jex.grad_dict[k].asnumpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    tex2 = tex.reshape(data=(7, 6), softmax_label=(7,))
    assert tex2.arg_dict["fc1_weight"] is tex.arg_dict["fc1_weight"]
    tex.arg_dict["fc1_weight"][:] = tex.arg_dict["fc1_weight"] + 1.0
    o1 = tex.forward(data=mt.nd.ones((4, 6), ctx=CPU))[0].asnumpy()
    o2 = tex2.forward(data=mt.nd.ones((7, 6), ctx=CPU))[0].asnumpy()
    np.testing.assert_allclose(o1[0], o2[0], rtol=1e-6)


def test_monitor_installs_on_the_executor():
    _reset()
    t = _mlp(mt)
    tex = t.simple_bind(CPU, data=(2, 6), softmax_label=(2,))
    mon = mt.monitor.Monitor(1, pattern=".*")
    mon.install(tex)
    mon.tic()
    tex.forward()
    names = [k for _, k, _ in mon.toc()]
    assert "softmax_output" in names and "fc1_output" in names and \
        "relu1_output" in names


def _calib(n, seed):
    rs = np.random.RandomState(seed)
    return [rs.rand(4, 6).astype(np.float32) * 2 for _ in range(n)]


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_calib_graph_and_quantize_model_match_jax(mode):
    _reset()
    j = _mlp(jmx)
    _reset()
    t = _mlp(mt)
    args, _ = _params(j, {"data": (4, 6), "softmax_label": (4,)}, seed=3)
    del args["data"], args["softmax_label"]
    label = np.zeros(4, np.float32)
    batches = _calib(3, 4)
    jc = jq.calib_graph(j, {k: jmx.nd.array(v) for k, v in args.items()},
                        {}, [{"data": jmx.nd.array(b),
                              "softmax_label": jmx.nd.array(label)}
                             for b in batches], mode=mode)
    tc = tq.calib_graph(t, {k: mt.nd.array(v, ctx=CPU)
                            for k, v in args.items()},
                        {}, [{"data": mt.nd.array(b, ctx=CPU),
                              "softmax_label": mt.nd.array(label, ctx=CPU)}
                             for b in batches], mode=mode)
    assert sorted(tc) == sorted(jc)
    for k in jc:
        np.testing.assert_allclose(tc[k], jc[k], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    # quantize_model: 5 examples in batches of 4 take two batches
    jqs, jqa, _ = jq.quantize_model(
        j, {k: jmx.nd.array(v) for k, v in args.items()}, {},
        calib_mode=mode, num_calib_examples=5,
        calib_data=[{"data": jmx.nd.array(b),
                     "softmax_label": jmx.nd.array(label)}
                    for b in batches])
    with CPU:
        tqs, tqa, _ = tq.quantize_model(
            t, {k: mt.nd.array(v) for k, v in args.items()}, {},
            calib_mode=mode, num_calib_examples=5,
            calib_data=[{"data": mt.nd.array(b),
                         "softmax_label": mt.nd.array(label)}
                        for b in batches])
    assert sorted(tqa) == sorted(jqa)
    for k, v in jqa.items():
        np.testing.assert_array_equal(tqa[k].asnumpy(), v.asnumpy())
    # the calibrated ranges are attributes of the graph: equal to 1e-6
    jn = {n["name"]: n["attrs"] for n in json.loads(jqs.tojson())["nodes"]}
    tn = {n["name"]: n["attrs"] for n in json.loads(tqs.tojson())["nodes"]}
    assert sorted(jn) == sorted(tn)
    for name, attrs in jn.items():
        for key, val in attrs.items():
            if key.endswith("calib_range"):
                assert abs(float(tn[name][key]) - float(val)) <= \
                    1e-6 * abs(float(val)), (name, key)
            else:
                assert tn[name][key] == val, (name, key)
    x = _calib(1, 5)[0]
    jout = jqs.bind(jmx.cpu(), {"data": jmx.nd.array(x),
                                "softmax_label": jmx.nd.array(label),
                                **jqa}).forward()[0].asnumpy()
    with CPU:
        tout = tqs.bind(CPU, {"data": mt.nd.array(x),
                              "softmax_label": mt.nd.array(label),
                              **tqa}).forward()[0].asnumpy()
    np.testing.assert_allclose(tout, jout, rtol=1e-4, atol=1e-5)


def test_checkpoints_across_packages(tmp_path):
    _reset()
    t = _mlp(mt)
    args, _ = _params(t, {"data": (2, 6), "softmax_label": (2,)})
    with CPU:
        mt.model.save_checkpoint(str(tmp_path / "t"), 3, t,
                                 {k: mt.nd.array(v) for k, v in
                                  args.items()}, {})
    sym, arg, aux = jmx.model.load_checkpoint(str(tmp_path / "t"), 3)
    assert sym.tojson() == t.tojson() and aux == {}
    for k, v in args.items():
        np.testing.assert_array_equal(arg[k].asnumpy(), v)
    jmx.model.save_checkpoint(str(tmp_path / "j"), 1, sym, arg, {})
    with CPU:
        sym2, arg2, _ = mt.model.load_checkpoint(str(tmp_path / "j"), 1)
    assert sym2.tojson() == t.tojson()
    for k, v in args.items():
        np.testing.assert_array_equal(arg2[k].asnumpy(), v)


def test_the_parts_still_to_port_name_a14(tmp_path):
    # control flow, partitioning and module_checkpoint came with A14's
    # first two slices (tests/test_torch_control_flow.py,
    # test_torch_subgraph.py, test_torch_module.py): a JAX foreach graph
    # loads and runs in the port
    data = jmx.sym.var("data")
    out, _ = jmx.sym.contrib.foreach(lambda x, s: (x * 2, s), data,
                                     [jmx.sym.var("s")])
    (tmp_path / "cf.json").write_text(out.tojson())
    back = mt.sym.load(str(tmp_path / "cf.json"))
    assert back.list_arguments() == out.list_arguments()
    x = np.arange(6, dtype=np.float32).reshape(3, 2)
    got = back.bind(CPU, {"data": mt.nd.array(x, ctx=CPU),
                          "s": mt.nd.zeros((2,), ctx=CPU)}).forward()
    np.testing.assert_array_equal(got[0].asnumpy(), 2 * x)
    with pytest.raises(jmx.base.MXNetError, match="registered"):
        _mlp(jmx).optimize_for("default")
    with pytest.raises(mt.MXNetError, match="registered"):
        _mlp(mt).optimize_for("default")
    assert callable(mt.callback.module_checkpoint(None, "p"))
    # the long tail's ops still raise naming the queue
    with pytest.raises(NotPortedError, match="A14"):
        mt.sym.Correlation
    with pytest.raises(NotPortedError, match="A14"):
        mt.nd.contrib.fft
    with pytest.raises(NotImplementedError, match="get_symbol"):
        mt.autograd.get_symbol(mt.nd.ones((1,), ctx=CPU))
    assert isinstance(mt.sym.FullyConnected, type(lambda: 0))
    with pytest.raises(NotPortedError):
        mt.sym.no_such_op
    assert torch.is_tensor(mt.nd.ones((1,), ctx=CPU)._data)
