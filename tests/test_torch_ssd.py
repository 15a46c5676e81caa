"""The SSD detector of examples/ssd/train_ssd.py in both packages: a conv
backbone, class and box heads, ``MultiBoxPrior`` anchors,
``MultiBoxTarget`` under ``autograd.pause()``, softmax cross-entropy plus
L1 losses, ``gluon.Trainer`` SGD, then ``MultiBoxDetection``.

The net is written once as ``make(mx)`` and built in each package; the
JAX net's initial weights are carried to the port by structural name. Over
three steps on the example's synthetic batches: the loss and every weight
after each step within 2e-5 (f32), the same matches (box mask and class
targets identical, box targets within 1e-6), and after the steps the same
detection rows kept, with scores and boxes within 2e-5.
"""
import numpy as np

import mxnet_tpu as jmx

import mxnet_tpu_torch as tmx

CPU = tmx.cpu()
TOL = 2e-5
SIZES, RATIOS = (0.3, 0.45), (1.0, 2.0)
N_ANCHORS = len(SIZES) + len(RATIOS) - 1
N_CLASSES = 1
BATCH, LR, STEPS = 8, 0.05, 3


def synthetic_batch(rs, batch, size=32):
    """examples/ssd/train_ssd.py's data: images each with one bright
    square, labelled with its box."""
    data = rs.rand(batch, 3, size, size).astype(np.float32) * 0.1
    labels = np.zeros((batch, 1, 5), np.float32)
    for i in range(batch):
        w = rs.randint(8, 16)
        x0 = rs.randint(0, size - w)
        y0 = rs.randint(0, size - w)
        data[i, :, y0:y0 + w, x0:x0 + w] = 1.0
        labels[i, 0] = [0, x0 / size, y0 / size, (x0 + w) / size,
                        (y0 + w) / size]
    return data, labels


def make(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="ssd_")
    with net.name_scope():
        backbone = nn.HybridSequential()
        backbone.add(nn.Conv2D(16, 3, 2, 1, activation="relu"),
                     nn.Conv2D(32, 3, 2, 1, activation="relu"))
        net.add(backbone,
                nn.Conv2D(N_ANCHORS * (N_CLASSES + 1), 3, padding=1),
                nn.Conv2D(N_ANCHORS * 4, 3, padding=1))
    return net


def heads(mx, net, x):
    """(anchors, class predictions (B, C+1, N), box predictions (B, 4N))
    as the example computes them."""
    nd = mx.nd
    backbone, cls_head, box_head = net[0], net[1], net[2]
    feat = backbone(x)
    anchors = nd.contrib.MultiBoxPrior(feat, sizes=SIZES, ratios=RATIOS)
    b = x.shape[0]
    cp = cls_head(feat).reshape((b, N_ANCHORS * (N_CLASSES + 1), -1))
    cp = cp.reshape((b, N_CLASSES + 1, -1))
    bp = box_head(feat).reshape((b, -1))
    return anchors.reshape((1, -1, 4)), cp, bp


def train_step(mx, net, trainer, losses, data, labels):
    nd, autograd = mx.nd, mx.autograd
    cls_loss, l1_loss = losses
    with autograd.record():
        anchors, cp, bp = heads(mx, net, data)
        with autograd.pause():
            bt, bm, ct = nd.contrib.MultiBoxTarget(anchors, labels, cp)
        l_cls = cls_loss(nd.transpose(cp, axes=(0, 2, 1)), ct)
        l_box = l1_loss(bp * bm, bt)
        loss = l_cls.mean() + l_box.mean()
    loss.backward()
    trainer.step(data.shape[0])
    return float(loss.asscalar()), [t.asnumpy() for t in (bt, bm, ct)]


def detect(mx, net, data):
    nd = mx.nd
    anchors, cp, bp = heads(mx, net, data)
    return nd.contrib.MultiBoxDetection(nd.softmax(cp, axis=1), bp,
                                        anchors).asnumpy()


def _weights(net):
    return {k: p.data().asnumpy()
            for k, p in net._collect_params_with_prefix().items()}


def _setup(mx, x0, weights=None):
    net = make(mx)
    net.initialize(mx.init.Xavier())
    heads(mx, net, x0)                           # resolve deferred shapes
    if weights is not None:
        params = net._collect_params_with_prefix()
        assert params.keys() == weights.keys()
        for k, v in weights.items():
            params[k].set_data(v)
    gloss = mx.gluon.loss
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": LR})
    return net, trainer, (gloss.SoftmaxCrossEntropyLoss(), gloss.L1Loss())


def test_ssd_example_steps_targets_and_detections_match_jax():
    rs = np.random.RandomState(0)
    batches = [synthetic_batch(rs, BATCH) for _ in range(STEPS)]
    jmx.random.seed(0)
    jnet, jtr, jlosses = _setup(jmx, jmx.nd.array(batches[0][0]))
    weights = _weights(jnet)
    with CPU:
        tnet, ttr, tlosses = _setup(tmx, tmx.nd.array(batches[0][0]),
                                    weights)
    jl, tl = [], []
    for data, labels in batches:
        ljax, jt = train_step(jmx, jnet, jtr, jlosses, jmx.nd.array(data),
                              jmx.nd.array(labels))
        with CPU:
            lport, tt = train_step(tmx, tnet, ttr, tlosses,
                                   tmx.nd.array(data), tmx.nd.array(labels))
        # the matches (mask, classes) are identical; the encoded boxes are
        # within an f32 ulp or two (the anchors' and XLA's fused
        # multiply-adds)
        np.testing.assert_allclose(tt[0], jt[0], rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tt[1], jt[1])
        np.testing.assert_array_equal(tt[2], jt[2])
        np.testing.assert_allclose(lport, ljax, rtol=TOL, atol=TOL)
        jw, tw = _weights(jnet), _weights(tnet)
        for k in jw:
            np.testing.assert_allclose(tw[k], jw[k], rtol=TOL, atol=TOL,
                                       err_msg=k)
        jl.append(ljax)
        tl.append(lport)
    assert tl[-1] < tl[0] and jl[-1] < jl[0]
    want = detect(jmx, jnet, jmx.nd.array(batches[-1][0]))
    with CPU:
        got = detect(tmx, tnet, tmx.nd.array(batches[-1][0]))
    assert got.shape == want.shape == (BATCH, 8 * 8 * N_ANCHORS, 6)
    kept = want[..., 0] >= 0
    assert kept.any()
    np.testing.assert_array_equal(got[..., 0] >= 0, kept)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
