"""``mx.rnn`` in the port against the JAX package: the symbol-era cells
bound through the Executor, ``BucketSentenceIter`` and
``encode_sentences``.

Each cell's graph is built in both packages; the argument, output and
auxiliary names must be the JAX package's, and the port's Executor, fed
the same numpy arguments, must give the JAX Executor's outputs (1e-5)
and, after ``backward`` with the same head gradients, its argument
gradients (1e-4 of each one's largest value). Cases: the four RNN cases
of ``tests/test_legacy_rnn_image.py:12-49``; every cell kind, stacked,
bidirectional and with the modifiers; ``FusedRNNCell`` in every mode,
TNC and NTC, one-way and bidirectional, with and without
``get_next_state``; the state zeros ops that ``begin_state(like=)``
emits; and ``BucketSentenceIter`` feeding one bound executor a bucket
over three buckets, batch for batch the JAX iterator's, the losses the
JAX executors'.
"""
import random

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import rnn as jrnn

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import rnn as trnn

CPU = tmx.cpu()
FWD = dict(rtol=1e-5, atol=1e-5)


def _near(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _bind_run(m, ctx, sym, shapes, seed):
    """Bind ``sym`` with ``shapes``, fill every argument from ``seed``, run
    a training forward and a backward with seeded head gradients."""
    ex = sym.simple_bind(ctx, **shapes)
    rs = np.random.RandomState(seed)
    for name in sym.list_arguments():
        arr = ex.arg_dict[name]
        arr[:] = (rs.randn(*arr.shape) * 0.3).astype(np.float32)
    outs = ex.forward(is_train=True)
    heads = [m.nd.array(rs.randn(*o.shape).astype(np.float32))
             for o in outs]
    ex.backward(heads)
    return [o.asnumpy() for o in outs], \
        {k: v.asnumpy() for k, v in ex.grad_dict.items() if v is not None}


def _sym_case(make, shapes, seed=0):
    """``make(rnn_module, sym_module)`` -> a Symbol, in both packages."""
    jsym = make(jrnn, jmx.sym)
    tsym = make(trnn, tmx.sym)
    assert tsym.list_arguments() == jsym.list_arguments()
    assert tsym.list_outputs() == jsym.list_outputs()
    assert tsym.list_auxiliary_states() == jsym.list_auxiliary_states()
    jouts, jgrads = _bind_run(jmx, jmx.cpu(), jsym, shapes, seed)
    with CPU:
        touts, tgrads = _bind_run(tmx, CPU, tsym, shapes, seed)
    assert len(touts) == len(jouts)
    for k, (a, b) in enumerate(zip(touts, jouts)):
        np.testing.assert_allclose(a, b, err_msg=f"output {k}", **FWD)
    assert sorted(tgrads) == sorted(jgrads)
    for k in jgrads:
        _near(tgrads[k], jgrads[k], 1e-4, f"grad {k}")
    return touts, tsym


def _merged(cell_fn, length, layout="NTC"):
    def make(rnn, sym):
        data = sym.var("data")
        cell = cell_fn(rnn)
        # zero states shaped from the data (a bidirectional cell's own
        # default is plain variables, which need their shapes bound)
        outputs, _ = cell.unroll(length, inputs=data,
                                 begin_state=cell.begin_state(like=data),
                                 layout=layout, merge_outputs=True)
        return outputs
    return make


def test_symbol_lstm_cell_unroll():
    outs, tsym = _sym_case(_merged(lambda r: r.LSTMCell(16, prefix="l_"), 3),
                           {"data": (2, 3, 8)})
    args = tsym.list_arguments()
    assert "l_i2h_weight" in args and "l_h2h_weight" in args
    assert outs[0].shape == (2, 3, 16)


def test_fused_rnn_cell_symbol():
    def make(rnn, sym):
        cell = rnn.FusedRNNCell(12, num_layers=2, mode="lstm",
                                get_next_state=True)
        out, states = cell.unroll(5, inputs=sym.var("data"), layout="TNC")
        assert len(states) == 2
        return sym.Group([out] + states)
    outs, _ = _sym_case(make, {"data": (5, 3, 6)}, 1)
    assert [o.shape for o in outs] == [(5, 3, 12), (2, 3, 12), (2, 3, 12)]


def test_bucket_sentence_iter():
    sentences = [[1, 2, 3], [4, 5, 6, 7, 8], [1, 2], [3] * 12]
    batches = []
    for rnn in (jrnn, trnn):
        random.seed(0)
        np.random.seed(0)
        it = rnn.BucketSentenceIter(sentences, batch_size=2, buckets=[5, 15],
                                    invalid_label=0)
        assert it.default_bucket_key == 15
        assert it.provide_data[0].shape == (2, 15)
        with CPU:
            batches.append([(b.bucket_key, b.data[0].asnumpy(),
                             b.label[0].asnumpy()) for b in it])
    assert len(batches[1]) == len(batches[0]) == 1
    for (tk, td, tl), (jk, jd, jl) in zip(*batches):
        assert tk == jk and td.shape[0] == 2
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)


def test_encode_sentences():
    sents = [["a", "b"], ["b", "c"], ["c", "d", "a"]]
    res, vocab = trnn.encode_sentences(sents)
    assert (res, vocab) == jrnn.encode_sentences(sents)
    assert res[0][1] == res[1][0]
    more, vocab2 = trnn.encode_sentences([["a", "zz"]], vocab=dict(vocab),
                                         unknown_token="<unk>")
    assert (more, vocab2) == jrnn.encode_sentences(
        [["a", "zz"]], vocab=dict(vocab), unknown_token="<unk>")
    with pytest.raises(tmx.MXNetError, match="unknown token"):
        trnn.encode_sentences([["zz"]], vocab=dict(vocab))


@pytest.mark.parametrize("kind", ["RNNCell", "GRUCell", "stack", "bidir",
                                  "modifiers"])
def test_symbol_cells_match_jax(kind):
    def cell(rnn):
        if kind == "RNNCell":
            return rnn.RNNCell(6, activation="relu", prefix="r_")
        if kind == "GRUCell":
            return rnn.GRUCell(6, prefix="g_")
        if kind == "stack":
            stack = rnn.SequentialRNNCell()
            stack.add(rnn.LSTMCell(6, prefix="s0_"))
            stack.add(rnn.GRUCell(5, prefix="s1_"))
            return stack
        if kind == "bidir":
            return rnn.BidirectionalCell(rnn.LSTMCell(4, prefix="bl_"),
                                         rnn.GRUCell(4, prefix="br_"))
        stack = rnn.SequentialRNNCell()
        stack.add(rnn.ResidualCell(rnn.GRUCell(5, prefix="m0_")))
        stack.add(rnn.DropoutCell(0.0))
        stack.add(rnn.ZoneoutCell(rnn.RNNCell(5, prefix="m1_"), 0.2, 0.2))
        return stack
    outs, _ = _sym_case(_merged(cell, 4), {"data": (3, 4, 5)}, 2)
    assert outs[0].shape[:2] == (3, 4)


@pytest.mark.parametrize("mode,bid,layout,nxt", [
    ("lstm", True, "NTC", True), ("gru", False, "TNC", True),
    ("rnn_tanh", True, "TNC", False), ("rnn_relu", False, "NTC", False)])
def test_fused_cell_modes(mode, bid, layout, nxt):
    def make(rnn, sym):
        cell = rnn.FusedRNNCell(5, num_layers=2, mode=mode,
                                bidirectional=bid, get_next_state=nxt,
                                prefix="f_")
        out, states = cell.unroll(4, inputs=sym.var("data"), layout=layout)
        return sym.Group([out] + states) if nxt else out
    shape = (4, 3, 6) if layout == "TNC" else (3, 4, 6)
    outs, tsym = _sym_case(make, {"data": shape}, 3)
    assert tsym.list_arguments() == ["data", "f_parameters"]
    assert len(outs) == (1 if not nxt else 3 if mode == "lstm" else 2)


def test_begin_state_like_emits_the_state_zeros_ops():
    for rnn, sym in ((jrnn, jmx.sym), (trnn, tmx.sym)):
        data = sym.var("data")
        states = rnn.LSTMCell(4, prefix="z_").begin_state(like=data)
        fused = rnn.FusedRNNCell(4, num_layers=2, prefix="zf_").begin_state(
            like=data)
        assert len(states) == 2 and len(fused) == 2
    with CPU:
        ex = tmx.sym.Group(states + fused).simple_bind(CPU, data=(5, 3, 2))
        outs = ex.forward()
    assert [o.shape for o in outs] == [(5, 4), (5, 4), (2, 3, 4), (2, 3, 4)]
    assert not any(o.asnumpy().any() for o in outs)


def _lm_symbol(rnn, sym, vocab, width):
    """The bucketing LM: embedding, a fused LSTM over NTC, a softmax
    head; the same graph for every bucket (its length from the data)."""
    data = sym.var("data")
    label = sym.var("softmax_label")
    embed = sym.Embedding(data, input_dim=vocab, output_dim=width,
                          name="embed")
    cell = rnn.FusedRNNCell(width, num_layers=1, mode="lstm", prefix="lm_")
    out, _ = cell.unroll(0, inputs=embed, layout="NTC")
    pred = sym.FullyConnected(sym.reshape(out, shape=(-1, width)),
                              num_hidden=vocab, name="pred")
    return sym.SoftmaxOutput(pred, sym.reshape(label, shape=(-1,)),
                             name="softmax")


def test_bucket_iter_feeds_one_executor_a_bucket():
    vocab, width, batch = 20, 8, 4
    rs = np.random.RandomState(8)
    sentences = [list(rs.randint(1, vocab, rs.randint(2, 13)))
                 for _ in range(60)]
    losses = []
    for m, rnn, ctx in ((jmx, jrnn, jmx.cpu()), (tmx, trnn, CPU)):
        random.seed(1)
        np.random.seed(1)
        with ctx:
            losses.append(_bucket_run(m, rnn, ctx, sentences, vocab, width,
                                      batch))
    assert len(losses[1]) == len(losses[0]) > 3
    for (tk, tl, tg), (jk, jl, jg) in zip(*losses):
        assert tk == jk
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
        _near(tg, jg, 1e-4, f"bucket {tk} grad")


def _bucket_run(m, rnn, ctx, sentences, vocab, width, batch):
    """One pass of the bucketing iterator, one executor a bucket sharing
    the weights; (bucket, loss, parameter gradient) for each batch."""
    it = rnn.BucketSentenceIter(sentences, batch, buckets=[4, 8, 12],
                                invalid_label=0)
    sym = _lm_symbol(rnn, m.sym, vocab, width)
    weights = np.random.RandomState(9)
    shared, execs, run = {}, {}, []
    for b in it:
        key = b.bucket_key
        if key not in execs:
            execs[key] = sym.simple_bind(ctx, data=(batch, key),
                                         softmax_label=(batch, key))
            for name, arr in execs[key].arg_dict.items():
                if name in ("data", "softmax_label"):
                    continue
                if name not in shared:
                    shared[name] = (weights.randn(*arr.shape)
                                    * 0.2).astype(np.float32)
                arr[:] = shared[name]
        ex = execs[key]
        ex.arg_dict["data"][:] = b.data[0].asnumpy()
        ex.arg_dict["softmax_label"][:] = b.label[0].asnumpy()
        prob = ex.forward(is_train=True)[0].asnumpy()
        ex.backward()
        lab = b.label[0].asnumpy().reshape(-1).astype(int)
        run.append((key, float(-np.log(prob[np.arange(lab.size), lab]
                                       + 1e-12).mean()),
                    ex.grad_dict["lm_parameters"].asnumpy()))
    assert sorted(execs) == [4, 8, 12]
    return run
