"""The fused RNN op, ``gluon.rnn`` and ``gluon.contrib.rnn`` in the port
against the JAX package.

The same numpy inputs, made from a seed, go through the JAX function and
its port on the CPU; layers and cells are built in both packages with
one prefix and the JAX weights are carried across
(``convert.from_mxnet_tpu_params``). Tolerances: f32 outputs 1e-5 (as
``tests/test_rnn.py:88``), gradients 1e-4 of each tensor's largest
value, bf16 2e-2 of it. Cases: the op in every mode, one-way and
bidirectional, two layers, with ``state_outputs`` (outputs, final states
and the gradients of data, parameters and states); the dtypes of out, h
and c for f32 and bf16 data; the dropout between layers (keep rate,
``1 / keep`` scaling, placement, training only) and the arguments the JAX
op ignores; ``tests/test_numeric_gradients.py:184``; the ten cases of
``tests/test_rnn.py`` (the fused layers also against ``torch.nn``); the
RNN cases of ``tests/test_gluon_contrib.py`` and every conv cell;
``hybridize()``; ``convert`` of a FusedRNNCell's flat parameters; and
the whole slice, ``examples/rnn/word_language_model.py``'s ``RNNModel``
(2 layers, width 16, vocab 50) carried from the JAX package (the same
logits), then three SGD steps with its gradient clipping: losses and
weights against the JAX package's.
"""
import itertools
import os
import runpy
import sys

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.contrib import rnn as jcrnn
from mxnet_tpu.ops.rnn_op import rnn_param_size as j_param_size

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon.contrib import rnn as tcrnn
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.ops import rnn_op

CPU = tmx.cpu()
FWD = dict(rtol=1e-5, atol=1e-5)
MODES = ("lstm", "gru", "rnn_tanh", "rnn_relu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ids = itertools.count()


def _pfx(kind):
    return f"{kind}{next(_ids)}_"


def _near(got, want, tol, what):
    """``got`` within ``tol`` of ``want``'s largest magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _carry(jnet, tnet):
    convert.from_mxnet_tpu_params(
        tnet, {k: v.data().asnumpy() for k, v in
               jnet.collect_params().items()})


def _f32(a):
    return np.asarray(a.asnumpy(), np.float32)


# ---------------------------------------------------------------------------
# the op
# ---------------------------------------------------------------------------

def _op_arrays(mode, bid, seed, t=5, n=3, i=4, h=6, layers=2):
    rs = np.random.RandomState(seed)
    d = 2 if bid else 1
    size = j_param_size(layers, i, h, bid, mode)
    arrays = [rs.randn(t, n, i).astype(np.float32),
              (rs.randn(size) * 0.3).astype(np.float32),
              (rs.randn(layers * d, n, h) * 0.3).astype(np.float32)]
    if mode == "lstm":
        arrays.append((rs.randn(layers * d, n, h) * 0.3).astype(np.float32))
    kw = dict(state_size=h, num_layers=layers, mode=mode,
              bidirectional=bid, state_outputs=True)
    return arrays, kw


def _op_run(m, arrays, kw, seed, dtype=None):
    """Outputs and the gradients of every input of ``nd.RNN``, the loss
    the sum of each output times a fixed head."""
    nds = [m.nd.array(a) for a in arrays]
    if dtype is not None:
        nds[:2] = [x.astype(dtype) for x in nds[:2]]
    for x in nds:
        x.attach_grad()
    with m.autograd.record():
        outs = m.nd.RNN(*nds, **kw)
        rs = np.random.RandomState(seed + 100)
        loss = None
        for o in outs:
            term = m.nd.sum(o.astype("float32")
                            * m.nd.array(rs.randn(*o.shape)
                                         .astype(np.float32)))
            loss = term if loss is None else loss + term
    loss.backward()
    return outs, [_f32(x.grad) for x in nds]


@pytest.mark.parametrize("mode,bid", [(m, b) for m in MODES
                                      for b in (False, True)])
def test_op_matches_jax(mode, bid):
    seed = MODES.index(mode) * 2 + int(bid)
    arrays, kw = _op_arrays(mode, bid, seed)
    jouts, jgrads = _op_run(jmx, arrays, kw, seed)
    with CPU:
        touts, tgrads = _op_run(tmx, arrays, kw, seed)
    assert len(touts) == len(jouts) == (3 if mode == "lstm" else 2)
    for k, (t, j) in enumerate(zip(touts, jouts)):
        np.testing.assert_allclose(_f32(t), _f32(j), err_msg=f"out {k}",
                                   **FWD)
    for k, (t, j) in enumerate(zip(tgrads, jgrads)):
        _near(t, j, 1e-4, f"grad of input {k}")


def test_op_dtypes_follow_jax_promotion():
    """f32 states with bf16 data and parameters: out, h and c in f32, as
    JAX promotes ``h @ R.T`` and the gate sums; all-f32 stays f32."""
    seed = MODES.index("lstm") * 2 + 1
    arrays, kw = _op_arrays("lstm", True, seed)
    for dtype in (None, "bfloat16"):
        jouts, jgrads = _op_run(jmx, arrays, kw, seed, dtype)
        with CPU:
            touts, tgrads = _op_run(tmx, arrays, kw, seed, dtype)
        assert [str(o.dtype) for o in jouts] == ["float32"] * 3
        assert [o.dtype for o in touts] == [np.float32] * 3
        tol = 1e-5 if dtype is None else 2e-2
        for k, (t, j) in enumerate(zip(touts, jouts)):
            _near(_f32(t), _f32(j), tol, f"{dtype} out {k}")
        for k, (t, j) in enumerate(zip(tgrads, jgrads)):
            _near(t, j, 1e-4 if dtype is None else 2e-2,
                  f"{dtype} grad {k}")


def test_op_num_outputs_match_jax():
    j = jmx.ops.registry.get_op("RNN")
    t = treg.get_op("RNN")
    for mode in MODES:
        for so in (False, True):
            params = {"mode": mode, "state_outputs": so}
            assert t.num_outputs(3, params) == j.num_outputs(3, params)
    assert t.rng and j.rng
    for name in ("_state_zeros", "_rnn_state_zeros"):
        assert treg.get_op(name).num_outputs == 1


def test_op_ignores_the_arguments_jax_ignores():
    arrays, kw = _op_arrays("lstm", False, 3)
    with CPU:
        nds = [tmx.nd.array(a) for a in arrays]
        want = tmx.nd.RNN(*nds, **kw)
        got = tmx.nd.RNN(*nds, projection_size=2, lstm_state_clip_min=-0.01,
                         lstm_state_clip_max=0.01, lstm_state_clip_nan=True,
                         use_sequence_length=False, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def test_op_dropout_between_layers_only_in_training():
    """p = 0.5 over three layers: each mask drawn from the generator
    after a layer but the last, the kept units scaled by 1 / keep, the
    keep rate 1 - p; outside training, no dropout."""
    t, n, i, h, layers, p = 40, 25, 4, 16, 3, 0.5
    rs = np.random.RandomState(5)
    size = rnn_op.rnn_param_size(layers, i, h, False, "rnn_tanh")
    x = torch.from_numpy(rs.randn(t, n, i).astype(np.float32))
    w = torch.from_numpy((rs.randn(size) * 0.3).astype(np.float32))
    h0 = torch.zeros(layers, n, h)
    kw = dict(state_size=h, num_layers=layers, mode="rnn_tanh", p=p)
    gen = torch.Generator().manual_seed(3)
    got = rnn_op.rnn(x, w, h0, _training=True, generator=gen, **kw)
    plain = rnn_op.rnn(x, w, h0, _training=False, **kw)
    nodrop = rnn_op.rnn(x, w, h0, **{**kw, "p": 0.0}, _training=True)
    assert torch.equal(plain, nodrop)
    # the same by hand: one layer at a time, the masks from the same stream
    weights = rnn_op.unpack(w, layers, i, h, False, "rnn_tanh")
    ref_gen = torch.Generator().manual_seed(3)
    y, keeps = x, []
    for layer in range(layers):
        y, _, _ = rnn_op.run_layers(y, [weights[layer]], h0[layer:layer + 1],
                                    h0[layer:layer + 1], "rnn_tanh", False)
        if layer < layers - 1:
            mask = (torch.rand(y.shape, generator=ref_gen) < 1 - p).float()
            keeps.append(float(mask.mean()))
            y = y * mask / (1 - p)
    torch.testing.assert_close(got, y, rtol=0, atol=0)
    assert all(abs(k - (1 - p)) < 0.02 for k in keeps), keeps
    assert not torch.equal(got, plain)


def test_numeric_gradient_rnn_tanh():
    """``tests/test_numeric_gradients.py:184``: rnn_tanh, one layer. The
    port's gradients against the JAX package's, and against central
    differences in float64 (``torch.autograd.gradcheck``)."""
    t, b, i, h = 3, 2, 4, 5
    rs = np.random.RandomState(22)
    x = (rs.randn(t, b, i) * 0.3).astype(np.float32)
    p = (rs.randn(rnn_op.rnn_param_size(1, i, h, False, "rnn_tanh"))
         * 0.2).astype(np.float32)
    h0 = (rs.randn(1, b, h) * 0.2).astype(np.float32)
    kw = dict(state_size=h, num_layers=1, mode="rnn_tanh")
    _, jgrads = _op_run(jmx, [x, p, h0], {**kw, "state_outputs": True}, 9)
    with CPU:
        _, tgrads = _op_run(tmx, [x, p, h0], {**kw, "state_outputs": True},
                            9)
    for k, (tg, jg) in enumerate(zip(tgrads, jgrads)):
        _near(tg, jg, 1e-4, f"grad {k}")
    ins = [torch.from_numpy(a).double().requires_grad_() for a in (x, p, h0)]
    assert torch.autograd.gradcheck(
        lambda d, w, s: rnn_op.rnn(d, w, s, **kw), ins)


def test_state_zeros_ops():
    x = np.random.RandomState(1).randn(5, 2, 3).astype(np.float32)
    with CPU:
        a = tmx.nd.op._rnn_state_zeros(tmx.nd.array(x), num_states=4,
                                       state_size=7)
        b = tmx.nd.op._state_zeros(tmx.nd.array(x), num_hidden=6,
                                   batch_axis=1)
    assert a.shape == (4, 2, 7) and a.dtype == np.float32
    assert b.shape == (2, 6) and not b.asnumpy().any()


def test_symbol_rnn_outputs_match_jax():
    for mode in MODES:
        for so in (False, True):
            kw = dict(state_size=4, num_layers=1, mode=mode,
                      state_outputs=so, name="r")
            js = jmx.sym.RNN(jmx.sym.var("data"), **kw)
            ts = tmx.sym.RNN(tmx.sym.var("data"), **kw)
            assert ts.list_outputs() == js.list_outputs()
            assert ts.list_arguments() == js.list_arguments()


# ---------------------------------------------------------------------------
# gluon.rnn: the ten cases of tests/test_rnn.py
# ---------------------------------------------------------------------------

def _cell_case(make, x, unroll=None, grads=True):
    """Build ``make(m, prefix)`` in both packages, carry the weights, and
    run one step (or ``unroll``) under ``record()``: outputs, states and,
    with ``grads``, the gradients of the input and every parameter."""
    prefix = _pfx("cell")

    def run(m, jnet=None):
        net = make(m, prefix)
        net.initialize()
        if jnet is not None:
            _carry(jnet, net)
        xs = m.nd.array(x)
        xs.attach_grad()
        with m.autograd.record():
            if unroll is None:
                out, st = net(xs, net.begin_state(batch_size=x.shape[0]))
            else:
                out, st = net.unroll(unroll, xs, layout="NTC",
                                     merge_outputs=True)
            loss = m.nd.sum(out * out)
            for s in st:
                loss = loss + m.nd.sum(s)
        if not grads:
            return net, out.asnumpy(), [s.asnumpy() for s in st], None, {}
        loss.backward()
        pgrads = {k[len(prefix):]: p.grad().asnumpy()
                  for k, p in net.collect_params().items()}
        return net, out.asnumpy(), [s.asnumpy() for s in st], \
            xs.grad.asnumpy(), pgrads

    jnet, jout, jst, jgx, jg = run(jmx)
    with CPU:
        _, tout, tst, tgx, tg = run(tmx, jnet)
    np.testing.assert_allclose(tout, jout, err_msg="out", **FWD)
    assert len(tst) == len(jst)
    for k, (a, b) in enumerate(zip(tst, jst)):
        np.testing.assert_allclose(a, b, err_msg=f"state {k}", **FWD)
    if grads:
        _near(tgx, jgx, 1e-4, "input grad")
    assert sorted(tg) == sorted(jg)
    for k in jg:
        _near(tg[k], jg[k], 1e-4, f"grad {k}")
    return tout, tst


def test_rnn_cell_forward():
    x = np.random.RandomState(0).randn(2, 4).astype(np.float32)
    out, st = _cell_case(
        lambda m, p: m.gluon.rnn.RNNCell(6, input_size=4, prefix=p), x)
    assert out.shape == (2, 6) and st[0].shape == (2, 6)


def test_lstm_cell_unroll():
    x = np.random.RandomState(1).randn(2, 3, 4).astype(np.float32)
    out, st = _cell_case(
        lambda m, p: m.gluon.rnn.LSTMCell(6, input_size=4, prefix=p), x, 3)
    assert out.shape == (2, 3, 6) and len(st) == 2


def test_gru_cell():
    x = np.random.RandomState(2).randn(2, 4).astype(np.float32)
    out, _ = _cell_case(
        lambda m, p: m.gluon.rnn.GRUCell(6, input_size=4, prefix=p), x)
    assert out.shape == (2, 6)


def _stack(m, prefix):
    stack = m.gluon.rnn.SequentialRNNCell(prefix=prefix)
    with stack.name_scope():
        stack.add(m.gluon.rnn.LSTMCell(6, input_size=4))
        stack.add(m.gluon.rnn.LSTMCell(6, input_size=6))
    return stack


def test_sequential_stack():
    x = np.random.RandomState(3).randn(2, 3, 4).astype(np.float32)
    out, st = _cell_case(_stack, x, 3)
    assert out.shape == (2, 3, 6) and len(st) == 4


def _layer_case(make, x, states=False, layout_t=0):
    """A fused layer in both packages: output (and final states), and the
    gradients of the input and every parameter."""
    prefix = _pfx("layer")

    def run(m, jnet=None):
        net = make(m, prefix)
        net.initialize()
        if jnet is not None:
            _carry(jnet, net)
        xs = m.nd.array(x)
        xs.attach_grad()
        with m.autograd.record():
            if states:
                out, st = net(xs, net.begin_state(
                    batch_size=x.shape[1 - layout_t]))
            else:
                out, st = net(xs), []
            loss = m.nd.sum(out * out)
            for s in st:
                loss = loss + m.nd.sum(s * s)
        loss.backward()
        grads = {k[len(prefix):]: p.grad().asnumpy()
                 for k, p in net.collect_params().items()}
        return net, out.asnumpy(), [s.asnumpy() for s in st], \
            xs.grad.asnumpy(), grads

    jnet, jout, jst, jgx, jg = run(jmx)
    with CPU:
        tnet, tout, tst, tgx, tg = run(tmx, jnet)
    np.testing.assert_allclose(tout, jout, err_msg="out", **FWD)
    for k, (a, b) in enumerate(zip(tst, jst)):
        np.testing.assert_allclose(a, b, err_msg=f"state {k}", **FWD)
    _near(tgx, jgx, 1e-4, "input grad")
    assert sorted(tg) == sorted(jg)
    for k in jg:
        _near(tg[k], jg[k], 1e-4, f"grad {k}")
    return tnet, tout, tst


def test_fused_lstm_layer_shapes():
    x = np.random.RandomState(4).randn(5, 3, 8).astype(np.float32)
    net, out, st = _layer_case(
        lambda m, p: m.gluon.rnn.LSTM(16, num_layers=2, input_size=8,
                                      prefix=p), x, states=True)
    assert out.shape == (5, 3, 16)
    assert [s.shape for s in st] == [(2, 3, 16), (2, 3, 16)]
    with CPU:
        alone = net(tmx.nd.array(x))
    np.testing.assert_array_equal(alone.asnumpy(), out)


def test_fused_bidirectional():
    x = np.random.RandomState(5).randn(6, 2, 4).astype(np.float32)
    _, out, _ = _layer_case(
        lambda m, p: m.gluon.rnn.LSTM(8, num_layers=1, bidirectional=True,
                                      input_size=4, prefix=p), x)
    assert out.shape == (6, 2, 16)


@pytest.mark.parametrize("kind", ["LSTM", "GRU"])
def test_fused_layers_deferred_ntc_bidirectional(kind):
    """Two layers, bidirectional, NTC, ``input_size`` read from the first
    input, with explicit states."""
    x = np.random.RandomState(6).randn(3, 5, 4).astype(np.float32)

    def make(m, p):
        return getattr(m.gluon.rnn, kind)(6, num_layers=2, layout="NTC",
                                          bidirectional=True, prefix=p)

    prefix = _pfx("deferred")
    jnet = make(jmx, prefix)
    jnet.initialize()
    jnet(jmx.nd.array(x))          # resolves the deferred input width
    with CPU:
        tnet = make(tmx, prefix)
        tnet.initialize()
        _carry(jnet, tnet)
        assert tnet.l0_i2h_weight.shape == jnet.l0_i2h_weight.shape
    jout, jst = jnet(jmx.nd.array(x), jnet.begin_state(batch_size=3))
    with CPU:
        tout, tst = tnet(tmx.nd.array(x), tnet.begin_state(batch_size=3))
    np.testing.assert_allclose(tout.asnumpy(), jout.asnumpy(), **FWD)
    for a, b in zip(tst, jst):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **FWD)


def _torch_case(kind, t, n, i, h, seed):
    torch.manual_seed(seed)
    ref = getattr(torch.nn, kind)(i, h, num_layers=1)
    x = np.random.RandomState(seed).randn(t, n, i).astype(np.float32)
    with CPU:
        layer = getattr(tmx.gluon.rnn, kind)(h, num_layers=1, input_size=i)
        layer.initialize()
        for name in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                     "bias_hh_l0"):
            ours = {"weight_ih_l0": "l0_i2h_weight",
                    "weight_hh_l0": "l0_h2h_weight",
                    "bias_ih_l0": "l0_i2h_bias",
                    "bias_hh_l0": "l0_h2h_bias"}[name]
            getattr(layer, ours).set_data(tmx.nd.array(
                getattr(ref, name).detach().numpy()))
        out = layer(tmx.nd.array(x)).asnumpy()
    want, _ = ref(torch.tensor(x))
    np.testing.assert_allclose(out, want.detach().numpy(), atol=1e-5)


def test_fused_lstm_matches_torch():
    _torch_case("LSTM", 5, 3, 4, 6, 0)


def test_fused_gru_matches_torch():
    _torch_case("GRU", 4, 2, 3, 5, 1)


def test_lstm_backward_and_training():
    """``tests/test_rnn.py``'s running-sign task in the port: an LSTM
    and a Dense head under Adam learn it (the loss below 0.7 of the first
    in 40 steps). The trainer path's parity with the JAX package is the
    word LM's (``test_word_lm_three_sgd_steps_match_jax``)."""
    rs = np.random.RandomState(0)
    x = rs.randn(6, 16, 1).astype(np.float32)
    y = (np.cumsum(x, axis=0) > 0).astype(np.float32)
    with CPU:
        layer = tmx.gluon.rnn.LSTM(8, input_size=1)
        head = tmx.gluon.nn.Dense(1, flatten=False)
        layer.initialize()
        head.initialize()
        head(layer(tmx.nd.array(x)))            # resolves the head's width
        params = layer.collect_params()
        params.update(head.collect_params())
        trainer = tmx.gluon.Trainer(params, "adam", {"learning_rate": 0.02},
                                    kvstore=None)
        lossfn = tmx.gluon.loss.SigmoidBinaryCrossEntropyLoss()
        losses = []
        for _ in range(40):
            with tmx.autograd.record():
                loss = lossfn(head(layer(tmx.nd.array(x))), tmx.nd.array(y))
            loss.backward()
            trainer.step(batch_size=16)
            losses.append(float(loss.mean().asscalar()))
    assert losses[-1] < losses[0] * 0.7, (losses[0], losses[-1])


def test_bidirectional_cell():
    x = np.random.RandomState(7).randn(2, 3, 4).astype(np.float32)
    prefix = _pfx("bi")

    def run(m, jnet=None):
        cell = m.gluon.rnn.BidirectionalCell(
            m.gluon.rnn.LSTMCell(6, input_size=4, prefix=prefix + "l_"),
            m.gluon.rnn.LSTMCell(6, input_size=4, prefix=prefix + "r_"),
            prefix=prefix)
        cell.initialize()
        if jnet is not None:
            _carry(jnet, cell)
        outs, states = cell.unroll(3, m.nd.array(x), layout="NTC")
        return cell, [o.asnumpy() for o in outs], \
            [s.asnumpy() for s in states]

    jcell, jouts, jst = run(jmx)
    with CPU:
        _, touts, tst = run(tmx, jcell)
    assert len(touts) == 3 and touts[0].shape == (2, 12)
    for a, b in zip(touts + tst, jouts + jst):
        np.testing.assert_allclose(a, b, **FWD)


def test_modifier_cells_match_jax_outside_training():
    """DropoutCell, ResidualCell and ZoneoutCell around an LSTM stack,
    unrolled outside training (no randomness): the JAX package's."""
    x = np.random.RandomState(8).randn(2, 4, 6).astype(np.float32)

    def make(m, p):
        stack = m.gluon.rnn.SequentialRNNCell(prefix=p)
        with stack.name_scope():
            stack.add(m.gluon.rnn.ResidualCell(
                m.gluon.rnn.GRUCell(6, input_size=6)))
            stack.add(m.gluon.rnn.DropoutCell(0.5))
            stack.add(m.gluon.rnn.ZoneoutCell(
                m.gluon.rnn.RNNCell(5, input_size=6), 0.3, 0.3))
        return stack

    prefix = _pfx("mod")
    jnet = make(jmx, prefix)
    jnet.initialize()
    jo, js = jnet.unroll(4, jmx.nd.array(x), merge_outputs=True)
    with CPU:
        tnet = make(tmx, prefix)
        tnet.initialize()
        _carry(jnet, tnet)
        to, ts = tnet.unroll(4, tmx.nd.array(x), merge_outputs=True)
        assert len(tnet) == 3 and tnet[1]._rate == 0.5
    np.testing.assert_allclose(to.asnumpy(), jo.asnumpy(), **FWD)
    for a, b in zip(ts, js):
        np.testing.assert_allclose(a.asnumpy(), b.asnumpy(), **FWD)


def test_zoneout_and_dropout_cells_in_training():
    """In training a zoned-out unit keeps its previous value (0 before the
    first step) and DropoutCell scales the kept inputs by 1 / keep."""
    with CPU:
        tmx.random.seed(4)
        base = tmx.gluon.rnn.RNNCell(32, input_size=8)
        cell = tmx.gluon.rnn.ZoneoutCell(base, zoneout_outputs=0.5)
        cell.initialize()
        x = tmx.nd.array(np.random.RandomState(9).randn(16, 3, 8)
                         .astype(np.float32))
        plain, _ = base.unroll(3, x, merge_outputs=True)
        with tmx.autograd.record():
            outs, _ = cell.unroll(3, x, merge_outputs=True)
        o, p = outs.asnumpy(), plain.asnumpy()
        first = o[:, 0]
        assert np.all((first == p[:, 0]) | (first == 0))
        assert 0.3 < float((first == 0).mean()) < 0.7
        drop = tmx.gluon.rnn.DropoutCell(0.25)
        with tmx.autograd.record():
            d, st = drop(tmx.nd.ones((64, 64)), [])
        vals = np.unique(d.asnumpy())
        assert st == [] and set(vals) <= {0.0, np.float32(1 / 0.75)}


def test_begin_state_and_hybridize():
    """``begin_state`` gives NDArray zeros; a hybridized layer (a CachedOp,
    eager on the CPU) equals the plain one, with and without states."""
    x = np.random.RandomState(10).randn(4, 3, 5).astype(np.float32)
    with CPU:
        layer = tmx.gluon.rnn.GRU(6, num_layers=2, input_size=5)
        layer.initialize()
        st = layer.begin_state(batch_size=3)
        assert [s.shape for s in st] == [(2, 3, 6)]
        assert isinstance(st[0], tmx.nd.NDArray) and not st[0].asnumpy().any()
        want = layer(tmx.nd.array(x)).asnumpy()
        want2, wst = layer(tmx.nd.array(x), st)
        layer.hybridize()
        got = layer(tmx.nd.array(x)).asnumpy()
        got2, gst = layer(tmx.nd.array(x), st)
        assert layer._cached_op is not None
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got2.asnumpy(), want2.asnumpy())
    np.testing.assert_array_equal(gst[0].asnumpy(), wst[0].asnumpy())


# ---------------------------------------------------------------------------
# gluon.contrib.rnn: the cases of tests/test_gluon_contrib.py
# ---------------------------------------------------------------------------

def test_lstmp_cell():
    x = np.random.RandomState(12).rand(2, 3, 4).astype(np.float32)
    out, st = _cell_case(
        lambda m, p: (jcrnn if m is jmx else tcrnn).LSTMPCell(
            hidden_size=6, projection_size=5, input_size=4, prefix=p), x, 3)
    assert out.shape == (2, 3, 5)
    assert [s.shape for s in st] == [(2, 5), (2, 6)]


def test_variational_dropout_cell():
    """One mask per unroll, reused at every step (whole output columns
    zeroed in training); none outside training, where it is the JAX
    package's cell."""
    x = np.random.RandomState(13).rand(2, 5, 4).astype(np.float32)
    prefix = _pfx("vd")

    def make(m):
        base = m.gluon.rnn.LSTMCell(6, input_size=4, prefix=prefix + "b_")
        mod = jcrnn if m is jmx else tcrnn
        return mod.VariationalDropoutCell(base, drop_inputs=0.5,
                                          drop_states=0.5, drop_outputs=0.5,
                                          prefix=prefix)

    jcell = make(jmx)
    jcell.initialize()
    jouts, _ = jcell.unroll(5, jmx.nd.array(x), merge_outputs=True)
    with CPU:
        tmx.random.seed(1)
        cell = make(tmx)
        cell.initialize()
        _carry(jcell, cell)
        with tmx.autograd.record():
            outs, _ = cell.unroll(5, tmx.nd.array(x), merge_outputs=True)
        o = outs.asnumpy()
        assert outs.shape == (2, 5, 6)
        zero_cols = (o == 0).all(axis=1)
        assert zero_cols.any()
        assert ((o == 0).any(axis=1) == zero_cols).all()
        outs2, _ = cell.unroll(5, tmx.nd.array(x), merge_outputs=True)
    assert not (outs2.asnumpy() == 0).all(axis=1).any()
    np.testing.assert_allclose(outs2.asnumpy(), jouts.asnumpy(), **FWD)


@pytest.mark.parametrize("name", ["Conv2DLSTMCell", "Conv2DGRUCell"])
def test_conv_rnn_cells_2d(name):
    x = np.random.RandomState(14).rand(2, 3, 6, 6).astype(np.float32)
    out, st = _cell_case(
        lambda m, p: getattr(jcrnn if m is jmx else tcrnn, name)(
            input_shape=(3, 6, 6), hidden_channels=4, i2h_kernel=3,
            h2h_kernel=3, i2h_pad=1, prefix=p), x, grads=False)
    assert out.shape == (2, 4, 6, 6)
    assert all(s.shape == (2, 4, 6, 6) for s in st)
    assert len(st) == (2 if "LSTM" in name else 1)


@pytest.mark.parametrize("name", [f"Conv{d}D{k}Cell" for d in (1, 2, 3)
                                  for k in ("RNN", "LSTM", "GRU")])
def test_conv_rnn_cell_shapes(name):
    """Every conv cell: the state's extent is the i2h convolution's
    output (a kernel of 2 without padding shrinks it by 1) with a dilated
    h2h; a step keeps it."""
    spatial = {"1D": (7,), "2D": (5, 5), "3D": (4, 4, 4)}[name[4:6]]
    with CPU:
        cell = getattr(tcrnn, name)(input_shape=(2,) + spatial,
                                    hidden_channels=3, i2h_kernel=2,
                                    h2h_kernel=3, h2h_dilate=2)
        cell.initialize()
        x = tmx.nd.array(np.random.RandomState(15).rand(2, 2, *spatial)
                         .astype(np.float32))
        out, st = cell(x, cell.begin_state(batch_size=2))
        out2, _ = cell(x, st)
    want = (2, 3) + tuple(s - 1 for s in spatial)
    assert out.shape == out2.shape == want
    assert [s.shape for s in st] == [want] * (2 if "LSTM" in name else 1)
    with pytest.raises(tmx.MXNetError, match="odd"):
        getattr(tcrnn, name)(input_shape=(2,) + spatial, hidden_channels=3,
                             i2h_kernel=2, h2h_kernel=2)


def test_conv_lstm_1d_unroll():
    seq = [np.random.RandomState(20 + k).rand(2, 2, 10).astype(np.float32)
           for k in range(4)]
    prefix = _pfx("conv1d")

    def run(m, jnet=None):
        cell = (jcrnn if m is jmx else tcrnn).Conv1DLSTMCell(
            input_shape=(2, 10), hidden_channels=3, i2h_kernel=3,
            h2h_kernel=3, i2h_pad=1, prefix=prefix)
        cell.initialize()
        if jnet is not None:
            _carry(jnet, cell)
        outs, states = cell.unroll(4, [m.nd.array(s) for s in seq])
        return cell, [o.asnumpy() for o in outs + states]

    jcell, want = run(jmx)
    with CPU:
        _, got = run(tmx, jcell)
    assert len(got) == 6 and got[0].shape == (2, 3, 10)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **FWD)


# ---------------------------------------------------------------------------
# the whole slice: the word LM recipe's model, three SGD steps
# ---------------------------------------------------------------------------

def _lm_module(pkg, monkeypatch):
    """``examples/rnn/word_language_model.py`` run as a module under
    ``pkg`` (the port aliased as ``mxnet_tpu`` when it is the port)."""
    path = os.path.join(ROOT, "examples", "rnn", "word_language_model.py")
    if pkg is jmx:
        return runpy.run_path(path, run_name="lm")
    with monkeypatch.context() as mp:
        mp.setitem(sys.modules, "mxnet_tpu", tmx)
        mp.setitem(sys.modules, "mxnet_tpu.gluon", tmx.gluon)
        return runpy.run_path(path, run_name="lm")


def test_word_lm_three_sgd_steps_match_jax(monkeypatch):
    vocab, width, layers, batch, bptt, steps = 50, 16, 2, 4, 6, 3
    rs = np.random.RandomState(15)
    ids = rs.randint(0, vocab, batch * bptt * steps + 1).astype(np.int32)
    prefix = _pfx("wlm")

    def build(m, g, jnet=None):
        model = g["RNNModel"](vocab, width, width, layers, dropout=0.0,
                              prefix=prefix)
        model.initialize(m.init.Xavier())
        if jnet is not None:
            _carry(jnet, model)
        return model

    def train(m, g, model):
        trainer = m.gluon.Trainer(model.collect_params(), "sgd",
                                  {"learning_rate": 1.0}, kvstore=None)
        lossfn = m.gluon.loss.SoftmaxCrossEntropyLoss()
        hidden = model.begin_state(batch)
        losses, logits = [], []
        for x, y in g["batchify"](ids, batch, bptt):
            hidden = [h.detach() for h in hidden]
            with m.autograd.record():
                out, hidden = model._imperative_call(
                    m.nd.array(x, dtype="int32"), hidden)
                loss = lossfn(out.reshape((-1, vocab)),
                              m.nd.array(y.reshape(-1).astype(np.float32)))
            loss.backward()
            grads = [p.grad() for p in model.collect_params().values()
                     if p.grad_req != "null"]
            m.gluon.utils.clip_global_norm(grads, 0.25 * batch)
            trainer.step(batch)
            losses.append(float(loss.mean().asscalar()))
            logits.append(out.asnumpy())
        weights = {k[len(prefix):]: p.data().asnumpy()
                   for k, p in model.collect_params().items()}
        return losses, logits, weights

    jmod = _lm_module(jmx, monkeypatch)
    tmod = _lm_module(tmx, monkeypatch)
    assert tmod["rnn"] is tmx.gluon.rnn
    jnet = build(jmx, jmod)
    with CPU:
        tnet = build(tmx, tmod, jnet)
    jl, jlogits, jw = train(jmx, jmod, jnet)
    with CPU:
        tl, tlogits, tw = train(tmx, tmod, tnet)
    assert len(tl) == steps
    np.testing.assert_allclose(tl, jl, **FWD)
    # the first step's logits: the carried weights give the same model
    np.testing.assert_allclose(tlogits[0], jlogits[0], **FWD)
    np.testing.assert_allclose(tlogits[-1], jlogits[-1], rtol=1e-4,
                               atol=1e-4)
    assert sorted(tw) == sorted(jw)
    for k in jw:
        _near(tw[k], jw[k], 1e-5, k)


def test_fused_cell_parameters_carry_across():
    """``convert`` carries an ``mx.rnn.FusedRNNCell``'s flat
    ``parameters`` into a fused layer: the same outputs. (A word LM's
    per-layer parameters are carried in
    ``test_word_lm_three_sgd_steps_match_jax``.)"""
    data = np.random.RandomState(17).randn(5, 2, 4).astype(np.float32)
    cell = jmx.rnn.FusedRNNCell(6, num_layers=2, mode="gru",
                                bidirectional=True, prefix="fused_")
    sym_out, _ = cell.unroll(5, inputs=jmx.sym.var("data"), layout="TNC")
    ex = sym_out.simple_bind(jmx.cpu(), data=data.shape)
    flat = np.random.RandomState(18).randn(
        *ex.arg_dict["fused_parameters"].shape).astype(np.float32) * 0.3
    ex.arg_dict["fused_parameters"][:] = flat
    ex.arg_dict["data"][:] = data
    want = ex.forward()[0].asnumpy()
    with CPU:
        layer = tmx.gluon.rnn.GRU(6, num_layers=2, bidirectional=True,
                                  prefix="gru_carry_")
        layer.initialize()
        convert.from_mxnet_tpu_params(layer, {"fused_parameters": flat},
                                      prefix="fused_")
        got = layer(tmx.nd.array(data)).asnumpy()
    np.testing.assert_allclose(got, want, **FWD)
    with CPU, pytest.raises(tmx.MXNetError, match="do not pack"):
        convert.from_mxnet_tpu_params(
            tmx.gluon.rnn.GRU(6, prefix="bad_"), {"bad_parameters": flat[1:]})
