"""Graph partitioning (``subgraph.py``, ``Symbol.optimize_for``), the port
against the JAX package on the CPU (cases after ``tests/test_subgraph.py``):
the same regions (node kinds after partitioning), the partitioned graph's
outputs equal to the unpartitioned graph's and to the JAX package's,
training through a region (batch statistics, the outer moving statistics
updated) with its gradients, region-to-region edges, shape and type
inference through regions, the registry and the errors. f32 within 2e-5
of each tensor's largest value; a region walks the unpartitioned graph's
ops in the same order, so partitioned against unpartitioned is bit for
bit.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import subgraph as jsub
from mxnet_tpu.symbol import executor as jexe
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import subgraph as tsub
from mxnet_tpu_torch.symbol import executor as texe
from mxnet_tpu_torch.symbol import symbol as tsym

CPU = mt.cpu()
PKGS = ((jmx, jsym, jsub, jexe), (mt, tsym, tsub, texe))


def _reset():
    jsym._NAME_COUNTER.clear()
    tsym._NAME_COUNTER.clear()


def _close(got, want, tol=2e-5):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) / scale <= tol


def _ops(sym):
    return [n.op.name for n in sym._topo() if n.op is not None]


def _mlp(mx, S):
    x = mx.sym.var("data")
    fc1 = S.create("FullyConnected", [x, mx.sym.var("w1"), mx.sym.var("b1")],
                   {"num_hidden": 8}, name="fc1")
    act = S.create("Activation", [fc1], {"act_type": "relu"}, name="relu1")
    return S.create("FullyConnected",
                    [act, mx.sym.var("w2"), mx.sym.var("b2")],
                    {"num_hidden": 4}, name="fc2")


def _softmax_tail(mx, S):
    x = mx.sym.var("data")
    fc = S.create("FullyConnected", [x, mx.sym.var("w1"), mx.sym.var("b1")],
                  {"num_hidden": 8}, name="fc1")
    act = S.create("Activation", [fc], {"act_type": "relu"}, name="relu1")
    return S.create("softmax", [act], {"axis": -1}, name="sm")


def _two_consumers(mx, S):
    x = mx.sym.var("data")
    fc = S.create("FullyConnected", [x, mx.sym.var("w1"), mx.sym.var("b1")],
                  {"num_hidden": 8}, name="fc1")
    a = S.create("exp", [fc], {}, name="e")
    b = S.create("log", [S.create("abs", [fc], {}, name="ab")], {}, name="l")
    return S.Group([a, b])


def _diamond(mx, S):
    x = mx.sym.var("data")
    s_ = S.create("exp", [x], {}, name="s")
    t = S.create("abs", [x], {}, name="t")
    return S.create("elemwise_add", [s_, t], {}, name="m")


def _params(mx):
    rs = np.random.RandomState(0)
    return {"w1": mx.nd.array(rs.randn(8, 6).astype(np.float32) * 0.3),
            "b1": mx.nd.array(rs.randn(8).astype(np.float32) * 0.1),
            "w2": mx.nd.array(rs.randn(4, 8).astype(np.float32) * 0.3),
            "b2": mx.nd.array(np.zeros(4, np.float32))}


def _downstream_only(sub):
    class DownstreamOnly(sub.SubgraphProperty):
        class _Sel(sub.SubgraphSelector):
            def select(self, node):
                return node.op is not None

            def select_input(self, node, input_node):
                return False

        def create_selector(self):
            return self._Sel()
    return DownstreamOnly()


CASES = {
    "xla_whole_graph": (_mlp, lambda sub: sub.get_subgraph_property("XLA")),
    "named_chain": (_mlp, lambda sub: sub.NamedOpProperty(
        ["FullyConnected", "Activation"])),
    "partial": (_softmax_tail, lambda sub: sub.NamedOpProperty(
        ["FullyConnected", "Activation"])),
    "two_consumers": (_two_consumers, lambda sub: sub.NamedOpProperty(
        ["FullyConnected"])),
    "region_to_region": (_diamond, _downstream_only),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_partitioned_graph_matches_jax(case):
    """The same regions as the JAX partitioner; outputs equal to the
    unpartitioned graph's bit for bit and to JAX's within f32."""
    build, prop = CASES[case]
    x = np.random.RandomState(len(case)).randn(3, 6).astype(np.float32)
    res = []
    for mx, S, sub, exe in PKGS:
        _reset()
        with mx.cpu():
            sym = build(mx, S)
            fused = sub.partition_graph(sym, prop(sub)) \
                if case != "xla_whole_graph" else sym.optimize_for("XLA")
            p = {k: v for k, v in _params(mx).items()
                 if k in sym.list_arguments()}
            xs = mx.nd.array(x)
            ref = exe.eval_symbol(sym, ["data"], [xs], p)
            got = exe.eval_symbol(fused, ["data"], [xs], p)
            ref = [r.asnumpy() for r in (ref if isinstance(ref, list)
                                         else [ref])]
            got = [g.asnumpy() for g in (got if isinstance(got, list)
                                         else [got])]
        res.append((sorted(_ops(fused)), ref, got))
    (jops, jref, jgot), (tops, tref, tgot) = res
    assert tops == jops
    if case == "region_to_region":
        assert set(tops) == {"_subgraph"}
    for a, b in zip(tgot, tref):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tgot, jgot):
        _close(a, b)


def _bn_region(mx, S):
    x = mx.sym.var("data")
    bn = S.create("BatchNorm", [x, mx.sym.var("g"), mx.sym.var("b"),
                                mx.sym.var("mm"), mx.sym.var("mv")],
                  {"fix_gamma": False}, name="bn0")
    return S.create("relu", [bn[0]], {}, name="r0")


def test_training_through_a_region_updates_the_outer_aux():
    """A BatchNorm + relu region in a training walk: batch statistics, and
    the moving statistics collected under the outer graph's names, as the
    JAX walk gives them."""
    rs = np.random.RandomState(0)
    xv = (rs.randn(8, 4) * 3 + 1).astype(np.float32)
    res = []
    for mx, S, sub, exe in PKGS:
        _reset()
        fused = sub.partition_graph(_bn_region(mx, S),
                                    sub.NamedOpProperty(["BatchNorm",
                                                         "relu"]))
        assert _ops(fused) == ["_subgraph"]
        if mx is jmx:
            import jax.numpy as arr
            conv = arr.asarray
        else:
            conv = torch.from_numpy
        collect = {}
        outs = exe._walk(fused, {"data": conv(xv), "g": conv(np.ones(4,
                         np.float32)), "b": conv(np.zeros(4, np.float32))},
                         {"mm": conv(np.zeros(4, np.float32)),
                          "mv": conv(np.ones(4, np.float32))}, True,
                         collect_aux=collect)
        res.append((np.asarray(outs[0]), {k: np.asarray(v) for k, v in
                                          collect.items()}))
    (jo, jc), (to, tc) = res
    assert set(tc) == set(jc) == {"mm", "mv"}
    _close(to, jo)
    for k in jc:
        _close(tc[k], jc[k])
    _close(tc["mm"], 0.1 * xv.mean(0))


def _bn_net(mx, S):
    x = mx.sym.var("data")
    h = S.create("Convolution", [x, mx.sym.var("cw")],
                 {"kernel": (3, 3), "pad": (1, 1), "num_filter": 4,
                  "no_bias": True}, name="conv")
    bn = S.create("BatchNorm", [h, mx.sym.var("g"), mx.sym.var("b"),
                                mx.sym.var("mm"), mx.sym.var("mv")],
                  {"fix_gamma": False, "momentum": 0.7}, name="bn0")
    r = S.create("relu", [bn[0]], {}, name="r0")
    return S.create("FullyConnected", [S.create("flatten", [r], {},
                                                name="fl"),
                                       mx.sym.var("fw"), mx.sym.var("fb")],
                    {"num_hidden": 3}, name="fc")


def test_partitioned_executor_training_step():
    """An Executor over the partitioned conv / BN / relu / FC graph: a
    training forward and backward equal to the unpartitioned graph's bit
    for bit (outputs, every gradient, the moving statistics) in the port,
    and to the JAX package's partitioned executor within f32."""
    rs = np.random.RandomState(2)
    vals = {"data": rs.randn(2, 3, 5, 5), "cw": rs.randn(4, 3, 3, 3) * 0.3,
            "g": 1 + rs.randn(4) * 0.1, "b": rs.randn(4) * 0.1,
            "fw": rs.randn(3, 100) * 0.1, "fb": np.zeros(3)}
    vals = {k: v.astype(np.float32) for k, v in vals.items()}
    head = rs.randn(2, 3).astype(np.float32)

    def step(mx, S, sym):
        with mx.cpu():
            ex = sym.bind(
                mx.cpu(), {k: mx.nd.array(v) for k, v in vals.items()},
                args_grad={k: mx.nd.zeros(v.shape) for k, v in vals.items()},
                aux_states={"mm": mx.nd.zeros((4,)),
                            "mv": mx.nd.ones((4,))})
            out = ex.forward(is_train=True)[0].asnumpy()
            ex.backward(out_grads=mx.nd.array(head))
            return [out] + [ex.grad_dict[k].asnumpy() for k in sorted(vals)] \
                + [ex.aux_dict[k].asnumpy() for k in ("mm", "mv")]

    got = {}
    for mx, S, sub, _ in PKGS:
        _reset()
        sym = _bn_net(mx, S)
        fused = sym.optimize_for("XLA")
        assert _ops(fused) == ["_subgraph"]
        got[mx] = (step(mx, S, sym), step(mx, S, fused))
    (tplain, tfused), (_, jfused) = got[mt], got[jmx]
    for a, b in zip(tfused, tplain):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tfused, jfused):
        _close(a, b)
    assert not np.allclose(tfused[-2], 0.0)


def test_property_registry_and_errors():
    for mx, S, sub, _ in PKGS:
        assert "XLA" in sub.list_subgraph_properties()
        assert sub.get_subgraph_property("XLA") is not None
        with pytest.raises(Exception, match="registered"):
            sub.get_subgraph_property("nope")
        _reset()
        fused = _mlp(mx, S).optimize_for("XLA")
        with pytest.raises(Exception, match="partitioned"):
            fused.tojson()
        with pytest.raises(TypeError):
            _mlp(mx, S).optimize_for("XLA", dedup_subgraph=True)
    assert sorted(tsub.list_subgraph_properties()) == \
        sorted(jsub.list_subgraph_properties())


def test_fused_graph_shape_and_type_inference_and_bind():
    """optimize_for then infer_shape / infer_type / simple_bind: the
    weights' shapes come through the region, as in JAX."""
    res = []
    for mx, S, sub, _ in PKGS:
        _reset()
        with mx.cpu():
            fused = _mlp(mx, S).optimize_for("XLA")
            args, outs, aux = fused.infer_shape(data=(2, 6))
            ex = fused.simple_bind(mx.cpu(), data=(2, 6))
            out = ex.forward()[0]
            xs = S.var("data", shape=(2, 6))
            fc = S.create("FullyConnected",
                          [xs, S.var("w1", shape=(8, 6)),
                           S.var("b1", shape=(8,))], {"num_hidden": 8},
                          name="fc1")
            _, out_t, _ = fc.optimize_for("XLA").infer_type(data=np.float32)
        dt = out_t[0]
        res.append((args, outs, aux, out.shape, np.dtype(
            mt.base.numpy_dtype(dt) if isinstance(dt, torch.dtype)
            else dt)))
    assert res[1] == res[0]
    assert res[1][1] == [(2, 4)] and (8, 6) in res[1][0]
    assert res[1][4] == np.float32
