"""int8 quantization (``ops/quantization.py``, ``contrib/quantization.py``)
and the C14 repair, the port against the JAX package on the CPU.

Every one of the 22 registry names runs in both packages on the same
numpy inputs: int8 / uint8 / int32 results bit for bit, dequantized f32
within 1e-6 of each tensor's largest value. The exact int32 products
(``int_conv``, ``int_matmul``) are held to the JAX package's
``preferred_element_type=int32`` convolution in both layouts, with groups,
strides, padding and dilation. ``MXNET_CONV_COMPUTE=int8`` (C14) runs the
port's ``Convolution`` through the int8 training convolution as the JAX
package's does. The calibration statistics, ``fold_batchnorm`` and
``quantize_net`` (naive and entropy) run on a thin ResNet: scales within
1e-6 (they are maxima and histogram edges of activations that the two
packages compute to within a few ulps), outputs within 1e-5 once both
nets hold the same scales, and the exported int8 graph the same JSON.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.contrib import quantization as jq
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu.symbol import symbol as jsym

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.contrib import quantization as tq
from mxnet_tpu_torch.ops import quantization as tops
from mxnet_tpu_torch.ops import registry as treg
from mxnet_tpu_torch.symbol import symbol as tsym

A13 = ["_contrib_dequantize", "_contrib_quantize", "_contrib_quantize_v2",
       "_contrib_quantized_concat", "_contrib_quantized_conv",
       "_contrib_quantized_flatten", "_contrib_quantized_fully_connected",
       "_contrib_quantized_pooling", "_contrib_requantize",
       "_quantize_static", "_quantized_conv_v2", "_quantized_dense_v2",
       "_quantized_fc_static", "dequantize", "quantize", "quantize_v2",
       "quantized_concat", "quantized_conv", "quantized_flatten",
       "quantized_fully_connected", "quantized_pooling", "requantize"]


def _rs(seed=0):
    return np.random.RandomState(seed)


def _i8(rs, *shape):
    return rs.randint(-127, 128, shape).astype(np.int8)


def _jrun(name, arrays, params):
    import jax.numpy as jnp
    out = jreg.get_op(name).fn(*[jnp.asarray(a) for a in arrays], **params)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [np.asarray(o) for o in outs]


def _trun(name, arrays, params):
    out = treg.get_op(name).fn(*[torch.from_numpy(np.array(a))
                                 for a in arrays], **params)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [o.float().numpy().astype("bfloat16")
            if o.dtype == torch.bfloat16 else o.numpy() for o in outs]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert str(g.dtype) == str(w.dtype), (g.dtype, w.dtype)
        if w.dtype.kind not in "iub":
            g, w = g.astype(np.float64), w.astype(np.float64)
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= 1e-6 * scale
        else:
            np.testing.assert_array_equal(g, w)


def _f32(rs, *shape, scale=1.0):
    return ((rs.rand(*shape) - 0.5) * 2 * scale).astype(np.float32)


def _s(v):
    return np.asarray(v, np.float32)


def _cases():
    rs = _rs(3)
    x = _f32(rs, 4, 5, 6, scale=3)
    x[0, 0, 0] = 2.5 / 127 * 3     # ties of round-half-even
    acc = rs.randint(-40000, 40000, (6, 7)).astype(np.int32)
    d8, w8 = _i8(rs, 5, 12), _i8(rs, 6, 12)
    b8 = _i8(rs, 6)
    c8, k8 = _i8(rs, 2, 4, 7, 7), _i8(rs, 6, 4, 3, 3)
    r = [_s(-1.5), _s(2.0)]
    cases = [
        ("_contrib_quantize_v2", [x], {}),
        ("quantize_v2", [x], {"min_calib_range": -1.0,
                              "max_calib_range": 2.0}),
        ("_contrib_dequantize", [_i8(rs, 3, 4), _s(-0.7), _s(1.3)], {}),
        ("dequantize", [_i8(rs, 9), _s(-3.0), _s(3.0)], {}),
        ("_contrib_requantize", [acc, _s(-20.0), _s(20.0)], {}),
        ("requantize", [acc, _s(-20.0), _s(20.0)],
         {"min_calib_range": -0.5, "max_calib_range": 0.25}),
        ("_contrib_quantized_fully_connected",
         [d8, w8, b8] + r + [_s(-0.4), _s(0.5), _s(-0.1), _s(0.2)],
         {"num_hidden": 6}),
        ("quantized_fully_connected",
         [_i8(rs, 5, 3, 4), w8, b8] + r + [_s(-0.4), _s(0.5)],
         {"num_hidden": 6, "no_bias": True}),
        ("_contrib_quantized_conv",
         [c8, k8, b8] + r + [_s(-0.4), _s(0.5), _s(-0.1), _s(0.2)],
         {"kernel": (3, 3), "stride": (2, 1), "pad": (1, 0),
          "num_filter": 6}),
        ("quantized_conv",
         [c8, _i8(rs, 6, 2, 3, 3), b8] + r + [_s(-0.4), _s(0.5)],
         {"kernel": (3, 3), "dilate": (2, 2), "num_filter": 6,
          "num_group": 2, "no_bias": True}),
        ("_quantized_fc_static",
         [d8, _s(-1.0), _s(1.5), w8, _f32(rs, 6)],
         {"w_min": -0.3, "w_max": 0.7, "num_hidden": 6}),
        ("_contrib_quantized_pooling", [c8] + r,
         {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"}),
        ("quantized_pooling", [c8] + r,
         {"kernel": (3, 3), "pool_type": "avg", "pad": (1, 1),
          "pooling_convention": "full"}),
        ("_contrib_quantized_flatten", [c8] + r, {}),
        ("quantized_flatten", [_i8(rs, 3, 2, 2)] + r, {}),
        ("_contrib_quantize", [x, _s([-2.5]), _s([2.9])],
         {"out_type": "uint8"}),
        ("quantize", [x, _s([-2.5]), _s([2.9])], {"out_type": "int8"}),
        ("_quantize_static", [x], {"scale": 3.0 / 127}),
        ("_quantized_conv_v2",
         [_i8(rs, 2, 7, 7, 4), _i8(rs, 6, 3, 3, 2),
          np.abs(_f32(rs, 6)) + 1e-3, _f32(rs, 6)],
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
          "num_filter": 6, "num_group": 2, "in_scale": 0.02,
          "no_bias": False}),
        ("_quantized_conv_v2",
         [c8, k8, np.abs(_f32(rs, 6)) + 1e-3],
         {"kernel": (3, 3), "num_filter": 6, "layout": "NCHW",
          "in_scale": 1e-9, "out_dtype": "bfloat16"}),
        ("_quantized_dense_v2",
         [_i8(rs, 5, 3, 4), w8, np.abs(_f32(rs, 6)) + 1e-3, _f32(rs, 6)],
         {"num_hidden": 6, "in_scale": 0.05, "no_bias": False}),
        ("_contrib_quantized_concat",
         [_i8(rs, 2, 3), _i8(rs, 2, 5), _s(-1.0), _s(-0.5), _s(2.0),
          _s(0.25)], {"dim": 1, "num_args": 2}),
        ("quantized_concat",
         [_i8(rs, 2, 3), _i8(rs, 1, 3), _i8(rs, 3, 3), _s(-1.0), _s(-4.0),
          _s(0.0), _s(1.0), _s(0.1), _s(0.3)], {"dim": 0, "num_args": 3}),
    ]
    return cases


CASES = _cases()


def test_every_a13_name_has_a_case_and_the_jax_flags():
    names = {c[0] for c in CASES}
    assert names == set(A13) | {"_contrib_quantized_concat"} - set()
    assert sorted(set(A13)) == sorted(A13) and len(A13) == 22
    for n in A13:
        j, t = jreg.get_op(n), treg.get_op(n)
        assert t.num_outputs == j.num_outputs and \
            t.differentiable == j.differentiable is False and \
            t.variadic == j.variadic


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_op_matches_jax(case):
    name, arrays, params = CASES[case]
    _same(_trun(name, arrays, params), _jrun(name, arrays, params))


def test_ops_through_mx_nd_namespaces():
    x = _f32(_rs(1), 3, 4, scale=2)
    with mt.cpu():
        q, mn, mx_ = mt.nd.contrib.quantize_v2(mt.nd.array(x))
        back = mt.nd.contrib.dequantize(q, mn, mx_)
    jq_, jmn, jmx_ = jmx.nd.contrib.quantize_v2(jmx.nd.array(x))
    np.testing.assert_array_equal(q.asnumpy(), jq_.asnumpy())
    np.testing.assert_array_equal(
        back.asnumpy(), jmx.nd.contrib.dequantize(jq_, jmn, jmx_).asnumpy())
    assert q.dtype == np.int8


def _jconv(x, w, stride, pad, dilate, groups, layout):
    import jax
    import jax.numpy as jnp
    from mxnet_tpu.ops.nn import _CONV_DN
    dn = jax.lax.conv_dimension_numbers(x.shape, w.shape, _CONV_DN[layout])
    return np.asarray(jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), stride, [(p, p) for p in pad],
        rhs_dilation=dilate, dimension_numbers=dn, feature_group_count=groups,
        preferred_element_type=jnp.int32))


@pytest.mark.parametrize("layout,groups,stride,pad,dilate", [
    ("NHWC", 1, (1, 1), (1, 1), (1, 1)),
    ("NHWC", 2, (2, 2), (3, 3), (1, 1)),
    ("NCHW", 1, (2, 1), (0, 2), (2, 1)),
    ("NCHW", 4, (1, 1), (1, 1), (1, 1)),
])
def test_int_conv_is_exact(layout, groups, stride, pad, dilate):
    rs = _rs(7)
    x = _i8(rs, 2, 9, 9, 8) if layout == "NHWC" else _i8(rs, 2, 8, 9, 9)
    w = _i8(rs, 8, 3, 3, 8 // groups) if layout == "NHWC" \
        else _i8(rs, 8, 8 // groups, 3, 3)
    # the extremes: every product at 127 * 127 and -127 * 127
    x.reshape(-1)[:40] = 127
    got = tops.int_conv(torch.from_numpy(x), torch.from_numpy(w), stride,
                        pad, dilate, groups, channel_last=layout == "NHWC")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), _jconv(x, w, stride, pad, dilate, groups, layout))


def test_int_matmul_is_exact():
    rs = _rs(8)
    x, w = _i8(rs, 3, 5, 40), _i8(rs, 9, 40)
    got = tops.int_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(
        got.numpy(), x.astype(np.int32) @ w.astype(np.int32).T)


# ---------------------------------------------------------------------------
# C14: MXNET_CONV_COMPUTE=int8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_c14_convolution_under_conv_compute_int8(monkeypatch, dtype):
    """The issue's case: NHWC (2, 8, 8, 16) x (32, 3, 3, 16). Before the
    repair the port computed the float convolution (0.0719 away from the
    JAX package's at a largest output of 3.69)."""
    monkeypatch.setenv("MXNET_CONV_COMPUTE", "int8")
    rs = _rs(14)
    x = _f32(rs, 2, 8, 8, 16, scale=2)
    w = _f32(rs, 32, 3, 3, 16, scale=0.3)
    kw = dict(kernel=(3, 3), pad=(1, 1), num_filter=32, no_bias=True,
              layout="NHWC")
    want = jmx.nd.Convolution(jmx.nd.array(x).astype(dtype),
                              jmx.nd.array(w).astype(dtype), **kw)
    with mt.cpu():
        got = mt.nd.Convolution(mt.nd.array(x).astype(dtype),
                                mt.nd.array(w).astype(dtype), **kw)
    g = got.astype("float32").asnumpy()
    wv = want.astype("float32").asnumpy()
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(g, wv, rtol=tol, atol=tol * np.abs(wv).max())
    monkeypatch.delenv("MXNET_CONV_COMPUTE")
    with mt.cpu():
        plain = mt.nd.Convolution(mt.nd.array(x), mt.nd.array(w), **kw)
    assert np.abs(plain.asnumpy() - g).max() > 1e-3   # the flag switches


def test_c14_int32_accumulators_are_the_jax_ones(monkeypatch):
    """The int8 training conv's int32 accumulators, read back from its
    output through the per-channel scales, are the JAX package's."""
    from mxnet_tpu.ops import resid8 as jr8
    from mxnet_tpu_torch.ops import resid8 as tr8
    import jax.numpy as jnp
    monkeypatch.setenv("MXNET_CONV_INT8_RANGE", "4.0")
    rs = _rs(15)
    x, w = _f32(rs, 2, 6, 6, 8, scale=3), _f32(rs, 4, 3, 3, 8)
    want = np.asarray(jr8.conv_int8_train(
        jnp.asarray(x), jnp.asarray(w), (1, 1), (1, 1), (1, 1),
        ("NHWC", "OHWI", "NHWC"), 1))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    tw = torch.from_numpy(w).permute(0, 3, 1, 2)
    got = tr8.conv_int8_train(tx, tw, (1, 1), (1, 1), (1, 1), 1)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


# ---------------------------------------------------------------------------
# calibration, folding, quantize_net
# ---------------------------------------------------------------------------

def test_collectors_and_kl_threshold_match_jax():
    rs = _rs(21)
    acts = [np.maximum(rs.randn(4000).astype(np.float32), 0) * 3,
            rs.randn(300).astype(np.float32),
            np.concatenate([rs.randn(5000), [40.0]]).astype(np.float32)]
    for i, a in enumerate(acts):
        jc, tc = jq.HistogramCollector(), tq.HistogramCollector()
        jn, tn = jq.CalibrationCollector(), tq.CalibrationCollector()
        for part in np.array_split(a, 3):
            for c in (jc, tc, jn, tn):
                c.collect(str(i), part)
        (jh, jth), (th_, tth) = jc.hists[str(i)], tc.hists[str(i)]
        np.testing.assert_array_equal(jh, th_)
        assert jth == tth and jn.min_max == tn.min_max
        assert jq.get_optimal_threshold(jh, jth) == \
            tq.get_optimal_threshold(th_, tth)


def _thin(pkg, device=None):
    """A thin ResNet v1 of basic blocks, one a stage (NHWC, fused
    epilogues, the s2d stem, the three downsample branches)."""
    kw = dict(layout="NHWC", classes=10, stem_s2d=True, prefix="qres_")
    if device:
        kw["device"] = device
    vision = pkg.gluon.model_zoo.vision
    return vision.ResNetV1(vision.BasicBlockV1, [1, 1, 1, 1],
                           [16, 16, 32, 64, 128], **kw)


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("q") / "w.params")
    net = _thin(mt, device="cpu")
    net.initialize(mt.init.Xavier())
    x = _rs(30).rand(4, 16, 16, 3).astype(np.float32)
    with mt.cpu(), mt.autograd.record():   # running statistics off 0 / 1
        net(mt.nd.array(x))
    net.save_parameters(path)              # the JAX package's format
    return path


def _pair(weights):
    jnet = _thin(jmx)
    jnet.load_parameters(weights)          # sets every parameter
    tnet = _thin(mt, device="cpu")
    tnet.initialize()
    tnet.load_parameters(weights)
    return jnet, tnet


def test_fold_batchnorm_matches_jax(weights):
    jnet, tnet = _pair(weights)
    x = _rs(32).rand(2, 16, 16, 3).astype(np.float32)
    assert jq.fold_batchnorm(jnet) == tq.fold_batchnorm(tnet) == 12
    want = jnet(jmx.nd.array(x)).asnumpy()
    with mt.cpu():
        got = tnet(mt.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jw = {k: v.data().asnumpy() for k, v in
          jnet._collect_params_with_prefix().items()}
    for k, v in tnet._collect_params_with_prefix().items():
        np.testing.assert_array_equal(v.data().asnumpy(), jw[k], err_msg=k)


def _qblocks(mod, net):
    return [b for _, _, b in mod._walk_blocks(net)
            if isinstance(b, mod._QuantizedLayer)]


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_quantize_net_matches_jax(weights, mode, tmp_path):
    jnet, tnet = _pair(weights)
    rs = _rs(33)
    calib = [rs.rand(4, 16, 16, 3).astype(np.float32) for _ in range(2)]
    jq.quantize_net(jnet, [jmx.nd.array(c) for c in calib], calib_mode=mode)
    with mt.cpu():
        tq.quantize_net(tnet, [torch.from_numpy(c) for c in calib],
                        calib_mode=mode)
    jb, tb = _qblocks(jq, jnet), _qblocks(jq and tq, tnet)
    assert len(jb) == len(tb) == 13
    for a, b in zip(jb, tb):
        assert abs(a._in_scale - b._in_scale) <= 1e-6 * a._in_scale
        np.testing.assert_array_equal(b.params[b.prefix + "qweight"]
                                      .data().asnumpy(),
                                      a.qweight.data().asnumpy())
        b._in_scale = a._in_scale       # the same scales from here on
    x = _rs(34).rand(2, 16, 16, 3).astype(np.float32)
    want = jnet(jmx.nd.array(x)).asnumpy()
    with mt.cpu():
        got = tnet(mt.nd.array(x)).asnumpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    jsym._NAME_COUNTER.clear()
    tsym._NAME_COUNTER.clear()
    jnet.export(str(tmp_path / "j"))
    tnet.export(str(tmp_path / "t"))
    assert (tmp_path / "t-symbol.json").read_text() == \
        (tmp_path / "j-symbol.json").read_text()


def test_quantize_net_keeps_hybridize_state_and_calibrates_first(weights):
    _, tnet = _pair(weights)
    tnet.hybridize()
    x = _rs(35).rand(2, 16, 16, 3).astype(np.float32)
    with mt.cpu():
        ref = tnet(mt.nd.array(x)).asnumpy()
        with pytest.raises(mt.MXNetError, match="no calibration batches"):
            tq.quantize_net(tnet, [])
        # the failed call changed nothing and kept the state
        assert tnet._active and _qblocks(tq, tnet) == []
        np.testing.assert_array_equal(tnet(mt.nd.array(x)).asnumpy(), ref)
        tq.quantize_net(tnet, [x], exclude=("dense",))
        assert tnet._active and all(b._active for b in _qblocks(tq, tnet))
        assert len(_qblocks(tq, tnet)) == 12
        out = tnet(mt.nd.array(x)).asnumpy()
    assert np.abs(out - ref).max() < 0.1 * np.abs(ref).max()
