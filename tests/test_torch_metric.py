"""``mx.metric`` and ``mx.callback`` of the port against the JAX
package's, on the CPU.

Every metric of the registry is fed the same labels and predictions
(numpy, made from a seed) in both packages, over three updates, the port
with its own NDArrays, with torch tensors and with numpy arrays: ``get``,
``get_global`` and ``get_name_value`` agree at 1e-6 relative, also after
``reset_local``. ``create`` resolves the same names and aliases, lists
become composite metrics, and a callable becomes a ``CustomMetric``. The
callbacks log the JAX package's lines; ``do_checkpoint`` writes the
symbol checkpoint layout and ``module_checkpoint`` saves a module every
``period`` epochs, as the JAX callback does.
"""
import logging

import numpy as np
import pytest
import torch

from mxnet_tpu import callback as jcb
from mxnet_tpu import metric as jmetric
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import callback as tcb
from mxnet_tpu_torch import metric as tmetric

TOL = dict(rtol=1e-6, atol=1e-7)
N, K = 12, 5


def _inputs(kind, step):
    """(labels, preds) of one update for a metric family."""
    rs = np.random.RandomState(100 + step)
    if kind == "class":
        label = rs.randint(0, K, (N,)).astype(np.float32)
        pred = rs.rand(N, K).astype(np.float32)
        pred /= pred.sum(axis=1, keepdims=True)
        return [label], [pred]
    if kind == "binary":
        label = rs.randint(0, 2, (N,)).astype(np.float32)
        pred = rs.rand(N, 2).astype(np.float32)
        return [label], [pred]
    if kind == "binary1d":
        label = rs.randint(0, 2, (N,)).astype(np.float32)
        return [label], [rs.rand(N).astype(np.float32)]
    if kind == "regress":
        return ([rs.randn(N).astype(np.float32)],
                [rs.randn(N).astype(np.float32)])
    if kind == "regress2d":
        return ([rs.randn(N, 3).astype(np.float32)],
                [rs.randn(N, 3).astype(np.float32)])
    if kind == "seq":
        label = rs.randint(0, K, (3, 4)).astype(np.float32)
        label[0, 0] = 0
        pred = rs.rand(3, 4, K).astype(np.float32)
        pred /= pred.sum(axis=-1, keepdims=True)
        return [label], [pred]
    if kind == "loss":
        return [None], [rs.rand(N).astype(np.float32)]
    raise ValueError(kind)


CASES = [
    ("acc", (), "class"), ("accuracy", (), "class"),
    ("top_k_accuracy", (3,), "class"), ("f1", (), "binary"),
    ("f1", (), "binary1d"), ("mcc", (), "binary"), ("mae", (), "regress"),
    ("mse", (), "regress2d"), ("rmse", (), "regress"),
    ("ce", (), "class"), ("crossentropy", (), "class"),
    ("nll_loss", (), "class"), ("perplexity", (), "seq"),
    ("pearsonr", (), "regress"), ("loss", (), "loss"),
    ("torch", (), "loss"), ("caffe", (), "loss"),
]


def _convert(arrays, how):
    out = []
    for a in arrays:
        if a is None or how == "numpy":
            out.append(a)
        elif how == "nd":
            out.append(mt.nd.array(a, ctx=mt.cpu()))
        else:
            out.append(torch.from_numpy(a))
    return out


def _check(tm, jm):
    for fn in ("get", "get_global"):
        (tn, tv), (jn, jv) = getattr(tm, fn)(), getattr(jm, fn)()
        assert tn == jn
        np.testing.assert_allclose(tv, jv, **TOL)
    tnv, jnv = tm.get_name_value(), jm.get_name_value()
    assert [n for n, _ in tnv] == [n for n, _ in jnv]
    np.testing.assert_allclose([v for _, v in tnv], [v for _, v in jnv],
                               **TOL)


@pytest.mark.parametrize("how", ["nd", "torch", "numpy"])
@pytest.mark.parametrize("name,args,kind", CASES)
def test_metric_matches_jax(name, args, kind, how):
    tm, jm = tmetric.create(name, *args), jmetric.create(name, *args)
    assert type(tm).__name__ == type(jm).__name__ and tm.name == jm.name
    for step in range(3):
        labels, preds = _inputs(kind, step)
        jm.update([None if l is None else jnd.array(l) for l in labels],
                  [jnd.array(p) for p in preds])
        tm.update(_convert(labels, how), _convert(preds, how))
        _check(tm, jm)
    tm.reset_local()
    jm.reset_local()
    labels, preds = _inputs(kind, 9)
    jm.update([None if l is None else jnd.array(l) for l in labels],
              [jnd.array(p) for p in preds])
    tm.update(_convert(labels, how), _convert(preds, how))
    _check(tm, jm)
    tm.reset()
    assert np.isnan(tm.get()[1]) or isinstance(tm.get()[1], list)


def test_perplexity_ignore_label_and_axis_match_jax():
    labels, preds = _inputs("seq", 0)
    tm = tmetric.Perplexity(ignore_label=0)
    jm = jmetric.Perplexity(ignore_label=0)
    tm.update(labels, preds)
    jm.update([jnd.array(l) for l in labels], [jnd.array(p) for p in preds])
    _check(tm, jm)


def test_composite_custom_and_np_match_jax():
    labels, preds = _inputs("class", 1)

    def feval(label, pred):
        return float((pred.argmax(axis=1) == label).sum()), len(label)

    def mean_pred(label, pred):
        return float(pred.mean())

    for spec in (["acc", "ce"], feval, [feval, "top_k_accuracy"]):
        args = (3,) if isinstance(spec, list) and "top_k_accuracy" in spec \
            else ()
        tm, jm = tmetric.create(spec, *args), jmetric.create(spec, *args)
        tm.update(labels, preds)
        jm.update([jnd.array(l) for l in labels],
                  [jnd.array(p) for p in preds])
        _check(tm, jm)
    tm, jm = tmetric.np(mean_pred), jmetric.np(mean_pred)
    tm.update(labels, preds)
    jm.update([jnd.array(l) for l in labels], [jnd.array(p) for p in preds])
    _check(tm, jm)
    comp = tmetric.CompositeEvalMetric(["mae", "mse"])
    comp.update_dict({"y": labels[0]}, {"p": preds[0].max(axis=1)})
    jcomp = jmetric.CompositeEvalMetric(["mae", "mse"])
    jcomp.update_dict({"y": labels[0]}, {"p": preds[0].max(axis=1)})
    _check(comp, jcomp)
    assert comp.get_metric(1).name == "mse"


def test_create_and_register_match_jax():
    assert sorted(tmetric._METRIC_REGISTRY) == \
        sorted(jmetric._METRIC_REGISTRY)
    m = tmetric.Accuracy()
    assert tmetric.create(m) is m
    for bad in ("nosuch", 3):
        with pytest.raises(mt.MXNetError):
            tmetric.create(bad)

    @tmetric.register
    class Half(tmetric.EvalMetric):
        def __init__(self):
            super().__init__("half")

        def update(self, labels, preds):
            self._inc(0.5, 1)

    h = tmetric.create("half")
    h.update([1], [1])
    assert h.get() == ("half", 0.5)
    del tmetric._METRIC_REGISTRY["half"]
    with pytest.raises(mt.MXNetError, match="use Accuracy"):
        tmetric.TopKAccuracy(top_k=1)


class _Param:
    def __init__(self, epoch, nbatch, metric):
        self.epoch, self.nbatch, self.eval_metric = epoch, nbatch, metric


def _lines(cb_mod, metric_mod, caplog, make):
    caplog.clear()
    m = metric_mod.create("mae")
    m.update([np.ones(4, np.float32)], [np.zeros(4, np.float32)])
    cb = make(cb_mod)
    with caplog.at_level(logging.INFO):
        for nbatch in range(7):
            cb(_Param(2, nbatch, m))
    return [r.getMessage() for r in caplog.records]


@pytest.mark.parametrize("make", [
    lambda cb: cb.log_train_metric(2),
    lambda cb: cb.log_train_metric(3, auto_reset=True),
    lambda cb: cb.ProgressBar(total=6, length=10)])
def test_callbacks_log_as_jax(caplog, make):
    assert _lines(tcb, tmetric, caplog, make) == \
        _lines(jcb, jmetric, caplog, make)


def test_speedometer_lines_match_jax(caplog):
    def strip(lines):
        return [l.split("\tSpeed:")[0] + "\t" + l.split("\t", 2)[-1]
                for l in lines]
    make = lambda cb: cb.Speedometer(batch_size=8, frequent=2)  # noqa
    t, j = _lines(tcb, tmetric, caplog, make), _lines(jcb, jmetric, caplog,
                                                      make)
    assert len(t) == len(j) == 3 and strip(t) == strip(j)
    assert all("samples/sec" in l for l in t)


def test_checkpoint_callbacks_need_symbol_and_module(tmp_path):
    # do_checkpoint came with symbol/, module_checkpoint with module/
    cb = tcb.do_checkpoint(str(tmp_path / "m"), period=2)
    with mt.cpu():
        sym = mt.sym.FullyConnected(mt.sym.var("data"), num_hidden=2,
                                    name="fc")
        arg = {"fc_weight": mt.nd.ones((2, 3)), "fc_bias": mt.nd.zeros((2,))}
    cb(0, sym, arg, {})
    assert not (tmp_path / "m-0001.params").exists()
    cb(1, sym, arg, {})
    assert (tmp_path / "m-0002.params").exists()
    assert (tmp_path / "m-symbol.json").read_text() == sym.tojson()
    saved = []

    class _Mod:
        def save_checkpoint(self, prefix, epoch, states):
            saved.append((prefix, epoch, states))

    mcb = tcb.module_checkpoint(_Mod(), "prefix", period=2,
                                save_optimizer_states=True)
    jsaved = []
    jmod = type("_JMod", (), {"save_checkpoint": lambda self, *a:
                              jsaved.append(a)})()
    jcb_ = jcb.module_checkpoint(jmod, "prefix", period=2,
                                 save_optimizer_states=True)
    for epoch in range(5):
        mcb(epoch)
        jcb_(epoch)
    assert saved == jsaved == [("prefix", 2, True), ("prefix", 4, True)]
