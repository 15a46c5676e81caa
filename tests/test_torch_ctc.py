"""The CTC op and ``gluon.loss.CTCLoss`` in the port against the JAX
package, and a small ``examples/ctc/lstm_ocr.py``.

The same numpy inputs, made from a seed, go to ``mx.nd.CTCLoss`` of both
packages (and, as ``tests/test_ctc.py`` does, to
``torch.nn.functional.ctc_loss``): the loss within 1e-5 and the gradient
of the activations within 1e-4 of its largest value. Cases: those of
``tests/test_ctc.py`` (blank first and last, data and label lengths, the
gradient, the Gluon layout, mid-row padding packed, a bad blank label);
an infeasible alignment (the finite log-zero gives a huge finite loss
where torch gives inf); alpha carried past a short data length; bf16
data (the loss in bf16, 2e-2); the aliases; and the OCR recipe's model
(bidirectional two-layer LSTM, Dense, CTCLoss with label lengths) over
two Adam steps from the same weights, losses and weights against the
JAX package's.
"""
import itertools
import os
import runpy

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.ops import registry as treg

CPU = tmx.cpu()
FWD = dict(rtol=1e-5, atol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ids = itertools.count()


def _near(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: {err} > {tol} x {scale}"


def _ctc(m, acts, labels, *lengths, dtype=None, **kw):
    """The loss and the activations' gradient of ``nd.CTCLoss``."""
    x = m.nd.array(acts)
    if dtype is not None:
        x = x.astype(dtype)
    x.attach_grad()
    with m.autograd.record():
        loss = m.nd.CTCLoss(x, m.nd.array(labels),
                            *[m.nd.array(a) for a in lengths], **kw)
        total = m.nd.sum(loss.astype("float32"))
    total.backward()
    return loss, np.asarray(x.grad.asnumpy(), np.float32)


def _both(acts, labels, *lengths, dtype=None, **kw):
    jl, jg = _ctc(jmx, acts, labels, *lengths, dtype=dtype, **kw)
    with CPU:
        tl, tg = _ctc(tmx, acts, labels, *lengths, dtype=dtype, **kw)
    return (np.asarray(tl.asnumpy(), np.float32), tg, tl.dtype), \
        (np.asarray(jl.asnumpy(), np.float32), jg, jl.dtype)


def _torch_ctc(acts, labels, data_len, label_len, blank):
    lp = torch.log_softmax(torch.tensor(acts), dim=-1)
    return torch.nn.functional.ctc_loss(
        lp, torch.tensor(labels, dtype=torch.long),
        torch.tensor(data_len, dtype=torch.long),
        torch.tensor(label_len, dtype=torch.long), blank=blank,
        reduction="none").numpy()


def test_blank_first_matches_jax_and_torch():
    rs = np.random.RandomState(0)
    t, b, a, n = 20, 4, 6, 5
    acts = rs.randn(t, b, a).astype(np.float32)
    label_len = np.array([5, 3, 4, 1], np.int32)
    labels = np.zeros((b, n), np.int32)
    for i in range(b):
        labels[i, :label_len[i]] = rs.randint(1, a, size=label_len[i])
    (tl, tg, _), (jl, jg, _) = _both(acts, labels)
    np.testing.assert_allclose(tl, jl, **FWD)
    _near(tg, jg, 1e-4, "grad")
    np.testing.assert_allclose(
        tl, _torch_ctc(acts, labels, [t] * b, label_len, 0), rtol=1e-4,
        atol=1e-4)


def test_variable_lengths_blank_last():
    rs = np.random.RandomState(1)
    t, b, a, n = 15, 3, 5, 4
    acts = rs.randn(t, b, a).astype(np.float32)
    data_len = np.array([15, 10, 8], np.int32)
    label_len = np.array([4, 2, 3], np.int32)
    labels = np.full((b, n), -1, np.int32)
    for i in range(b):
        labels[i, :label_len[i]] = rs.randint(0, a - 1, size=label_len[i])
    (tl, tg, _), (jl, jg, _) = _both(
        acts, labels, data_len, label_len, use_data_lengths=True,
        use_label_lengths=True, blank_label="last")
    np.testing.assert_allclose(tl, jl, **FWD)
    _near(tg, jg, 1e-4, "grad")
    np.testing.assert_allclose(
        tl, _torch_ctc(acts, np.where(labels < 0, 0, labels), data_len,
                       label_len, a - 1), rtol=1e-4, atol=1e-4)
    # past its data length an example's activations get no gradient
    assert not tg[10:, 1].any() and not tg[8:, 2].any()


def test_gradient_matches_torch():
    rs = np.random.RandomState(2)
    acts = rs.randn(12, 2, 5).astype(np.float32)
    labels = np.array([[1, 2, 1], [3, 1, 0]], np.int32)
    (tl, tg, _), (jl, jg, _) = _both(acts, labels)
    _near(tg, jg, 1e-4, "grad")
    x = torch.tensor(acts, requires_grad=True)
    torch.nn.functional.ctc_loss(
        torch.log_softmax(x, -1), torch.tensor(labels, dtype=torch.long),
        torch.tensor([12, 12]), torch.tensor([3, 2]), blank=0,
        reduction="sum").backward()
    np.testing.assert_allclose(tg, x.grad.numpy(), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("layout,label_layout", [("NTC", "NT"),
                                                 ("TNC", "TN")])
def test_gluon_ctc_loss_layouts(layout, label_layout):
    rs = np.random.RandomState(3)
    acts = rs.randn(2, 10, 5).astype(np.float32)
    labels = np.array([[0, 1, 2], [2, 3, -1]], np.float32)
    if layout == "TNC":
        acts = acts.swapaxes(0, 1).copy()
    if label_layout == "TN":
        labels = labels.T.copy()

    def run(m):
        x = m.nd.array(acts)
        x.attach_grad()
        with m.autograd.record():
            loss = m.gluon.loss.CTCLoss(layout, label_layout)(
                x, m.nd.array(labels))
        loss.backward()
        return loss.asnumpy(), x.grad.asnumpy()

    jl, jg = run(jmx)
    with CPU:
        tl, tg = run(tmx)
    np.testing.assert_allclose(tl, jl, **FWD)
    _near(tg, jg, 1e-4, "grad")
    with pytest.raises(tmx.MXNetError, match="layout"):
        tmx.gluon.loss.CTCLoss(layout="CTN")


def test_mid_row_padding_is_packed():
    rs = np.random.RandomState(4)
    acts = rs.randn(10, 1, 4).astype(np.float32)
    (tl, tg, _), (jl, jg, _) = _both(acts, np.array([[1, 0, 2]], np.int32))
    np.testing.assert_allclose(tl, jl, **FWD)
    _near(tg, jg, 1e-4, "grad")
    np.testing.assert_allclose(
        tl, _torch_ctc(acts, np.array([[1, 2]]), [10], [2], 0), rtol=1e-4,
        atol=1e-4)


def test_invalid_blank_label_raises():
    with CPU, pytest.raises(tmx.MXNetError, match="blank_label"):
        tmx.nd.CTCLoss(tmx.nd.zeros((4, 1, 3)),
                       tmx.nd.array(np.array([[1, 2]], np.float32)),
                       blank_label="First")


def test_infeasible_alignment_is_finite_as_in_jax():
    """Three labels with a repeat need five frames; three give no path:
    the JAX op's finite log-zero makes the loss huge and finite, and the
    gradient has no NaN."""
    acts = np.random.RandomState(5).randn(3, 1, 4).astype(np.float32)
    labels = np.array([[1, 1, 2]], np.int32)
    (tl, tg, _), (jl, jg, _) = _both(acts, labels)
    assert np.isfinite(tl).all() and tl[0] > 1e29
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert np.isfinite(tg).all()
    assert np.isinf(_torch_ctc(acts, labels, [3], [3], 0)).all()


def test_bf16_data_gives_a_bf16_loss():
    rs = np.random.RandomState(6)
    acts = rs.randn(8, 3, 5).astype(np.float32)
    labels = np.array([[1, 2, 0], [3, 3, 4], [2, 0, 0]], np.int32)
    (tl, tg, tdt), (jl, jg, jdt) = _both(acts, labels, dtype="bfloat16")
    assert str(jdt) == "bfloat16" and tdt == torch.bfloat16
    _near(tl, jl, 2e-2, "loss")
    _near(tg, jg, 2e-2, "grad")


def test_aliases_and_flags_match_jax():
    acts = np.random.RandomState(7).randn(6, 2, 4).astype(np.float32)
    labels = np.array([[1, 2], [3, 0]], np.float32)
    with CPU:
        want = tmx.nd.CTCLoss(tmx.nd.array(acts), tmx.nd.array(labels))
        for fn in (tmx.nd.ctc_loss, tmx.nd.contrib.CTCLoss,
                   tmx.nd.contrib.ctc_loss):
            np.testing.assert_array_equal(
                fn(tmx.nd.array(acts), tmx.nd.array(labels)).asnumpy(),
                want.asnumpy())
    for name in ("CTCLoss", "ctc_loss", "_contrib_CTCLoss",
                 "_contrib_ctc_loss"):
        t, j = treg.get_op(name), jmx.ops.registry.get_op(name)
        assert t.name == j.name == "CTCLoss"
        assert (t.differentiable, t.rng, t.variadic) == \
            (j.differentiable, j.rng, j.variadic)


def make_ocr(mx, hidden, classes, prefix):
    """``examples/ctc/lstm_ocr.py``'s OCRNet."""
    nn, rnn = mx.gluon.nn, mx.gluon.rnn

    class OCRNet(nn.HybridBlock):
        def __init__(self):
            super().__init__(prefix=prefix)
            with self.name_scope():
                self.lstm = rnn.LSTM(hidden, num_layers=2, layout="NTC",
                                     bidirectional=True)
                self.head = nn.Dense(classes + 1, flatten=False)

        def hybrid_forward(self, F, x):
            return self.head(self.lstm(x))

    return OCRNet()


def test_small_lstm_ocr_two_adam_steps():
    recipe = runpy.run_path(os.path.join(ROOT, "examples", "ctc",
                                         "lstm_ocr.py"), run_name="ocr")
    rs = np.random.RandomState(0)
    batches = [recipe["render_batch"](rs, 4, 1, 3, 12) for _ in range(2)]
    prefix = f"ocr{next(_ids)}_"

    def build(m, jnet=None):
        net = make_ocr(m, 8, recipe["NUM_CLASSES"], prefix)
        net.initialize(m.init.Xavier())
        net(m.nd.array(batches[0][0]))          # resolves deferred widths
        if jnet is not None:
            convert.from_mxnet_tpu_params(
                net, {k: v.data().asnumpy()
                      for k, v in jnet.collect_params().items()})
        return net

    def train(m, net):
        trainer = m.gluon.Trainer(net.collect_params(), "adam",
                                  {"learning_rate": 0.005})
        ctc = m.gluon.loss.CTCLoss(layout="NTC", label_layout="NT")
        losses = []
        for x, labels, lens in batches:
            with m.autograd.record():
                loss = ctc(net(m.nd.array(x)), m.nd.array(labels), None,
                           m.nd.array(lens))
            loss.backward()
            trainer.step(4)
            losses.append(loss.asnumpy())
        return losses, {k[len(prefix):]: p.data().asnumpy()
                        for k, p in net.collect_params().items()}

    jnet = build(jmx)
    with CPU:
        tnet = build(tmx, jnet)
    jl, jw = train(jmx, jnet)
    with CPU:
        tl, tw = train(tmx, tnet)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4)
    assert sorted(tw) == sorted(jw)
    for k in jw:
        _near(tw[k], jw[k], 1e-4, k)
