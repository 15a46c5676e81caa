"""``HybridBlock.export``, ``SymbolBlock`` and ``ModelServer.load`` across
the two packages, on the CPU.

A thin ResNet (v1 NHWC with the s2d stem and fused epilogues, v1 NCHW,
v2 NCHW) and its int8 twin (``quantize_net``) are exported by each
package; each package's files load in the other through
``SymbolBlock.imports``. The float outputs agree within 2e-5 of the
largest; the int8 ones are bit for bit (the int32 accumulators are exact
and the dequantize epilogue is the same f32 arithmetic). The port's
``SymbolBlock`` hybridized is its eager self bit for bit, a user block
exports through its ``hybrid_forward``, and ``ModelServer.load`` serves a
checkpoint the JAX package exported.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.serving import ModelServer
from mxnet_tpu_torch.symbol import symbol as tsym

CPU = mt.cpu()
NETS = {"v1_nhwc": ("ResNetV1", dict(layout="NHWC", stem_s2d=True)),
        "v1_nchw": ("ResNetV1", dict(layout="NCHW")),
        "v2_nchw": ("ResNetV2", dict(layout="NCHW"))}


def _x(kind, n=2, seed=0):
    shape = (n, 16, 16, 3) if kind == "v1_nhwc" else (n, 3, 16, 16)
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _build(pkg, kind):
    """A thin ResNet of basic blocks, one a stage."""
    name, kw = NETS[kind]
    kw = dict(kw, classes=10, prefix=f"ex{kind}_")
    if pkg is mt:
        kw["device"] = "cpu"
    vision = pkg.gluon.model_zoo.vision
    block = vision.BasicBlockV1 if name == "ResNetV1" else vision.BasicBlockV2
    return getattr(vision, name)(block, [1, 1, 1, 1], [16, 16, 32, 64, 128],
                                 **kw)


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """Both packages' nets of each kind with the same weights (trained
    running statistics), and a file of them."""
    d = tmp_path_factory.mktemp("ex")
    out = {}
    for kind in NETS:
        tnet = _build(mt, kind)
        tnet.initialize(mt.init.Xavier())
        with CPU, mt.autograd.record():
            tnet(mt.nd.array(_x(kind, 4, 9)))
        path = str(d / f"{kind}.params")
        tnet.save_parameters(path)
        jnet = _build(jmx, kind)
        jnet.load_parameters(path)       # sets every parameter
        jnet.hybridize()                 # one XLA program a forward
        out[kind] = (jnet, tnet)
    return out


def _imports(pkg, prefix):
    kw = {"ctx": CPU} if pkg is mt else {}
    return pkg.gluon.SymbolBlock.imports(f"{prefix}-symbol.json", ["data"],
                                         f"{prefix}-0000.params", **kw)


def _run(pkg, net, x):
    if pkg is mt:
        with CPU:
            return net(mt.nd.array(x)).asnumpy()
    return net(jmx.nd.array(x)).asnumpy()


@pytest.mark.parametrize("kind", list(NETS))
def test_float_export_loads_across(nets, kind, tmp_path):
    jnet, tnet = nets[kind]
    x = _x(kind)
    want = _run(jmx, jnet, x)
    _close(_run(mt, tnet, x), want)
    jsym._NAME_COUNTER.clear()
    tsym._NAME_COUNTER.clear()
    jnet.export(str(tmp_path / "j"))
    tnet.export(str(tmp_path / "t"))
    assert (tmp_path / "t-symbol.json").read_text() == \
        (tmp_path / "j-symbol.json").read_text()
    _close(_run(mt, _imports(mt, str(tmp_path / "j")), x), want)
    _close(_run(jmx, _imports(jmx, str(tmp_path / "t")), x), want)
    # the port's own round trip is bit for bit, eager and hybridized
    back = _imports(mt, str(tmp_path / "t"))
    own = _run(mt, tnet, x)
    np.testing.assert_array_equal(_run(mt, back, x), own)
    back.hybridize()
    np.testing.assert_array_equal(_run(mt, back, x), own)
    np.testing.assert_array_equal(_run(mt, back, x), own)


def test_int8_export_loads_across(nets, tmp_path):
    kind = "v1_nhwc"
    _, tsrc = nets[kind]
    tsrc.save_parameters(str(tmp_path / "w.params"))
    calib = [_x(kind, 4, s) for s in (1, 2)]
    jnet = _build(jmx, kind)
    jnet.load_parameters(str(tmp_path / "w.params"))
    jq.quantize_net(jnet, [jmx.nd.array(c) for c in calib])
    tnet = _build(mt, kind)
    tnet.initialize()
    tnet.load_parameters(str(tmp_path / "w.params"))
    tq.quantize_net(tnet, calib)
    x = _x(kind, 2, 3)
    jnet.export(str(tmp_path / "j"))
    tnet.export(str(tmp_path / "t"))
    jwant, twant = _run(jmx, jnet, x), _run(mt, tnet, x)
    np.testing.assert_array_equal(
        _run(mt, _imports(mt, str(tmp_path / "j")), x), jwant)
    np.testing.assert_array_equal(
        _run(jmx, _imports(jmx, str(tmp_path / "t")), x), twant)
    back = _imports(mt, str(tmp_path / "t"))
    assert all(str(p.data().dtype) == "int8"
               for n, p in back.params.items() if n.endswith("qweight"))
    back.hybridize()
    np.testing.assert_array_equal(_run(mt, back, x), twant)


def test_user_block_exports_through_hybrid_forward(tmp_path):
    class Scaled(mt.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = mt.gluon.nn.Dense(3, in_units=4, device="cpu")
            self.scale = self.params.get("scale", shape=(3,),
                                         init=mt.init.One())

        def hybrid_forward(self, F, x, scale):
            return F.broadcast_mul(F.relu(self.dense(x)), scale)

    net = Scaled(prefix="scaled_", device="cpu")
    net.initialize()
    x = np.random.RandomState(4).rand(2, 4).astype(np.float32)
    want = _run(mt, net, x)
    sym = net.export(str(tmp_path / "u"))
    assert sym.list_arguments() == ["data", "scaled_dense0_weight",
                                    "scaled_dense0_bias", "scaled_scale"]
    np.testing.assert_array_equal(_run(mt, _imports(mt, str(tmp_path / "u")),
                                       x), want)


def test_model_server_loads_a_jax_checkpoint(nets, tmp_path):
    kind = "v1_nchw"
    jnet, _ = nets[kind]
    jnet.export(str(tmp_path / "srv"), epoch=7)
    x = _x(kind, 3, 5)
    want = _run(jmx, jnet, x)
    with CPU:
        srv = ModelServer.load(str(tmp_path / "srv"), epoch=7,
                               bucket_shapes=[(3, 16, 16)],
                               max_batch_size=4)
    try:
        got = np.stack([np.asarray(srv.predict(x[i], timeout=60))
                        for i in range(3)])
    finally:
        srv.stop()
    _close(got, want)
