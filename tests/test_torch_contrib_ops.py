"""The port's contrib detection, ROI and sampler ops and its ordering ops
against the JAX package's on the CPU, on the same numpy inputs.

- ``box_nms``: tied scores, ``force_suppress``, ``topk``, ``id_index`` -1
  and 0, ``background_id`` (ignored by both), batch dims.
- ``MultiBoxTarget``: two ground-truth boxes sharing a best anchor (the
  force-match scatter keeps the later box, as XLA's CPU scatter does),
  padded labels, hard-negative mining with tied confidences.
- ``MultiBoxDetection``: decoding, ``nms_topk``, ``force_suppress``,
  ``background_id``.
- ``ROIPooling``, ``BilinearSampler``, ``SpatialTransformer`` and
  ``SyncBatchNorm``: forward and gradients (``op_cases.py`` lists these as
  covered elsewhere).
- ``topk`` / ``argsort`` / ``sort`` with tied values: the stable order of
  ``jax.lax.top_k`` and ``jnp.argsort``.

Detection outputs are compared exactly (the kept rows and their order);
other outputs at 1e-5, gradients at 1e-4.
"""
import numpy as np
import pytest

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd


def _first(out, idx):
    return out[idx] if isinstance(out, (tuple, list)) else out


def _run(nd, name, inputs, params, idx=0):
    arrs = tuple(nd.array(a, dtype=a.dtype) for a in inputs)
    return _first(nd.imperative_invoke(name, arrs, dict(params)),
                  idx).asnumpy()


def both(name, inputs, params, idx=0):
    want = _run(jnd, name, inputs, params, idx)
    with mt.cpu():
        got = _run(tnd, name, inputs, params, idx)
    return got, want


def _grads(nd, ag, name, inputs, params, diff, head):
    arrs = [nd.array(a, dtype=a.dtype) for a in inputs]
    for i in diff:
        arrs[i].attach_grad()
    with ag.record():
        out = _first(nd.imperative_invoke(name, tuple(arrs), dict(params)),
                     0)
    out.backward(nd.array(head))
    return out.asnumpy(), [arrs[i].grad.asnumpy() for i in diff]


def both_grads(name, inputs, params, diff, rtol=1e-4, atol=1e-5):
    shape = _run(jnd, name, inputs, params).shape
    head = np.random.RandomState(9).randn(*shape).astype(np.float32)
    wo, wg = _grads(jnd, jag, name, inputs, params, diff, head)
    with mt.cpu():
        to, tg = _grads(tnd, tag, name, inputs, params, diff, head)
    np.testing.assert_allclose(to, wo, rtol=1e-5, atol=1e-5)
    for k, (g, w) in enumerate(zip(tg, wg)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                   err_msg=f"gradient {k}")


# ----------------------------------------------------------------- box_nms

def _boxes(rs, shape, n_cls=3, tie=True):
    """(..., N, 6) rows [id, score, x1, y1, x2, y2] of boxes clustered so
    that many overlap, with tied scores when ``tie``."""
    n = shape[-1]
    lead = shape[:-1]
    xy = rs.uniform(0, 0.6, lead + (n, 2))
    wh = rs.uniform(0.1, 0.4, lead + (n, 2))
    score = rs.uniform(0, 1, lead + (n,))
    if tie:
        score = np.round(score * 4) / 4          # many exact ties
    cls = rs.randint(0, n_cls, lead + (n,))
    return np.concatenate([cls[..., None], score[..., None], xy, xy + wh],
                          -1).astype(np.float32)


NMS_PARAMS = [
    {"overlap_thresh": 0.5},
    {"overlap_thresh": 0.3, "id_index": 0},
    {"overlap_thresh": 0.3, "id_index": 0, "force_suppress": True},
    {"overlap_thresh": 0.4, "topk": 5},
    {"overlap_thresh": 0.4, "id_index": 0, "topk": 3, "valid_thresh": 0.3},
    {"overlap_thresh": 0.5, "id_index": 0, "background_id": 0},
]


@pytest.mark.parametrize("params", NMS_PARAMS,
                         ids=[str(i) for i in range(len(NMS_PARAMS))])
@pytest.mark.parametrize("shape", [(40,), (2, 3, 25)],
                         ids=["flat", "batched"])
def test_box_nms_matches_jax(params, shape):
    data = _boxes(np.random.RandomState(len(shape)), shape)
    got, want = both("_contrib_box_nms", (data,), params)
    np.testing.assert_array_equal(got, want)
    assert (got[..., 0] == -1).any() and (got[..., 0] >= 0).any()


def test_box_nms_with_all_scores_tied_keeps_index_order():
    data = _boxes(np.random.RandomState(3), (30,))
    data[:, 1] = 0.5
    got, want = both("_contrib_box_nms", (data,), {"overlap_thresh": 0.2})
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- MultiBoxTarget

def _anchors(h=4, w=4, sizes=(0.3, 0.5), ratios=(1.0, 2.0)):
    with mt.cpu():
        x = tnd.zeros((1, 3, h, w))
        return tnd.contrib.MultiBoxPrior(x, sizes=sizes,
                                         ratios=ratios).asnumpy()


def _labels(rs, b, m, pad=1):
    lab = np.full((b, m, 5), -1.0, np.float32)
    for i in range(b):
        for j in range(m - pad * (i % 2)):
            x0, y0 = rs.uniform(0, 0.6, 2)
            w, h = rs.uniform(0.15, 0.4, 2)
            lab[i, j] = [rs.randint(0, 3), x0, y0, x0 + w, y0 + h]
    return lab


def test_multibox_prior_matches_jax():
    data = np.zeros((1, 3, 5, 3), np.float32)
    for params in ({"sizes": (0.2, 0.4), "ratios": (1, 2, 0.5)},
                   {"sizes": (0.1,), "ratios": (1,), "steps": (0.2, 0.3),
                    "offsets": (0.4, 0.6), "clip": True}):
        got, want = both("_contrib_MultiBoxPrior", (data,), params)
        # one f32 ulp: XLA contracts (i + offset) * step - half-width into
        # a fused multiply-add
        np.testing.assert_allclose(got, want, rtol=0, atol=2.5e-7)


@pytest.mark.parametrize("params", [
    {},
    {"negative_mining_ratio": 3.0, "negative_mining_thresh": 0.5},
    {"overlap_threshold": 0.3, "negative_mining_ratio": 2.0,
     "minimum_negative_samples": 4, "ignore_label": -2.0,
     "variances": (0.1, 0.2, 0.3, 0.4)}], ids=["plain", "mining", "options"])
def test_multibox_target_matches_jax(params):
    rs = np.random.RandomState(4)
    anchors = _anchors()
    labels = _labels(rs, 3, 4)
    cls_preds = rs.randn(3, 4, anchors.shape[1]).astype(np.float32)
    cls_preds[:, 1:, ::3] = 0.5                  # tied confidences
    for k in range(3):
        got, want = both("_contrib_MultiBoxTarget",
                         (anchors, labels, cls_preds), params, k)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                   err_msg=f"output {k}")


def test_multibox_target_two_gts_sharing_a_best_anchor():
    """Two ground-truth boxes whose best anchor is the same: the later one
    claims it, in both packages."""
    anchors = _anchors(2, 2, sizes=(0.5,), ratios=(1.0,))
    labels = np.array([[[0, 0.0, 0.0, 0.5, 0.5],
                        [1, 0.05, 0.05, 0.45, 0.45],
                        [-1, -1, -1, -1, -1]]], np.float32)
    cls_preds = np.zeros((1, 3, anchors.shape[1]), np.float32)
    got, want = both("_contrib_MultiBoxTarget", (anchors, labels,
                                                 cls_preds), {}, 2)
    np.testing.assert_array_equal(got, want)
    assert got[0, 0] == 2.0      # class 1 + 1: the later box won anchor 0


# ------------------------------------------------------- MultiBoxDetection

@pytest.mark.parametrize("params", [
    {},
    {"nms_threshold": 0.3, "nms_topk": 6},
    {"force_suppress": True, "threshold": 0.2},
    {"background_id": 1, "clip": False},
], ids=["plain", "topk", "force", "background"])
def test_multibox_detection_matches_jax(params):
    rs = np.random.RandomState(5)
    anchors = _anchors()
    n = anchors.shape[1]
    logits = rs.randn(2, 4, n).astype(np.float32)
    cls_prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rs.randn(2, n * 4) * 0.5).astype(np.float32)
    got, want = both("_contrib_MultiBoxDetection", (cls_prob, loc, anchors),
                     params)
    keep = want[..., 0] >= 0
    np.testing.assert_array_equal(got[..., 0] >= 0, keep)
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert keep.any() and not keep.all()


# --------------------------------------------------- ROI / sampler / SyncBN

def test_roi_pooling_forward_and_no_gradient():
    rs = np.random.RandomState(6)
    data = rs.randn(2, 3, 8, 8).astype(np.float32)
    rois = np.array([[0, 0, 0, 7, 7], [1, 2.4, 1.6, 6.5, 5.2],
                     [0, 3, 3, 3, 3], [1, -2, 1, 20, 6]], np.float32)
    params = {"pooled_size": (2, 3), "spatial_scale": 0.9}
    got, want = both("ROIPooling", (data, rois), params)
    np.testing.assert_array_equal(got, want)
    assert not mt.ops.registry.get_op("ROIPooling").differentiable


def test_roi_align_gradients_match_jax():
    rs = np.random.RandomState(7)
    data = rs.randn(2, 2, 6, 6).astype(np.float32)
    rois = np.array([[0, 0.5, 0.5, 4.2, 3.9], [1, 1.1, 0.3, 5.0, 5.5]],
                    np.float32)
    both_grads("_contrib_ROIAlign", (data, rois),
               {"pooled_size": (2, 2), "sample_ratio": 2,
                "aligned": True}, diff=[0])


def test_bilinear_sampler_forward_and_gradients():
    rs = np.random.RandomState(8)
    data = rs.randn(2, 3, 5, 6).astype(np.float32)
    grid = rs.uniform(-0.98, 0.98, (2, 2, 4, 3)).astype(np.float32)
    both_grads("BilinearSampler", (data, grid), {}, diff=[0, 1])


def test_spatial_transformer_forward_and_gradients():
    rs = np.random.RandomState(10)
    data = rs.randn(2, 2, 6, 6).astype(np.float32)
    loc = (np.array([[0.8, 0.1, 0.05, -0.1, 0.7, 0.02]] * 2)
           + rs.randn(2, 6) * 0.05).astype(np.float32)
    both_grads("SpatialTransformer", (data, loc),
               {"target_shape": (4, 5)}, diff=[0, 1])


@pytest.mark.parametrize("training", [False, True], ids=["infer", "train"])
def test_sync_batch_norm_forward_and_gradients(training):
    rs = np.random.RandomState(11)
    data = rs.randn(4, 3, 2, 2).astype(np.float32)
    gamma = rs.uniform(0.5, 1.5, 3).astype(np.float32)
    beta = rs.randn(3).astype(np.float32)
    mm = rs.randn(3).astype(np.float32) * 0.1
    mv = rs.uniform(0.5, 2, 3).astype(np.float32)
    both_grads("_contrib_SyncBatchNorm", (data, gamma, beta, mm, mv),
               {"fix_gamma": False, "_training": training}, diff=[0, 1, 2])


# ---------------------------------------------------------------- ordering

TIES = np.array([[3, 1, 3, 2, 1, 3], [0, 0, 5, 0, 5, 1]], np.float32)


@pytest.mark.parametrize("params", [
    {"k": 3}, {"k": 3, "ret_typ": "value"}, {"k": 2, "ret_typ": "mask"},
    {"k": 4, "is_ascend": True}, {"k": 2, "ret_typ": "both"},
    {"k": 5, "axis": None}, {"k": 1, "axis": 0},
    {"k": 4, "axis": None, "ret_typ": "mask", "is_ascend": True}],
    ids=lambda p: "-".join(f"{k}={v}" for k, v in p.items()))
def test_topk_with_ties_matches_jax(params):
    n_out = 2 if params.get("ret_typ") == "both" else 1
    for k in range(n_out):
        got, want = both("topk", (TIES,), params, k)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("params", [
    {}, {"is_ascend": False}, {"axis": 0}, {"axis": None},
    {"axis": None, "is_ascend": False, "dtype": "int32"}],
    ids=["asc", "desc", "axis0", "flat", "flat_desc"])
def test_argsort_and_sort_with_ties_match_jax(params):
    got, want = both("argsort", (TIES,), params)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
    sparams = {k: v for k, v in params.items() if k != "dtype"}
    got, want = both("sort", (TIES,), sparams)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------- options op_cases.py does not reach

def _spd(n, seed):
    a = np.random.RandomState(seed).randn(n, n)
    return (a @ a.T + n * np.eye(n)).astype(np.float32)


TRI = np.tril(np.random.RandomState(20).randn(2, 3, 3) + 3 * np.eye(3)) \
    .astype(np.float32)
B34 = np.random.RandomState(21).randn(2, 3, 4).astype(np.float32)
B43 = np.random.RandomState(22).randn(2, 4, 3).astype(np.float32)
LINALG = [
    ("_linalg_gemm2", (B34, B34), {"transpose_b": True, "alpha": 0.5}),
    ("_linalg_gemm", (B34, B34, np.ones((2, 4, 4), np.float32)),
     {"transpose_a": True, "beta": 2.0}),
    ("_linalg_trsm", (TRI, B34), {"transpose": True, "alpha": 2.0}),
    ("_linalg_trsm", (TRI, B43), {"rightside": True}),
    ("_linalg_trsm", (TRI.transpose(0, 2, 1).copy(), B43),
     {"rightside": True, "lower": False, "transpose": True}),
    ("_linalg_trmm", (TRI, B43), {"rightside": True, "transpose": True}),
    ("_linalg_syrk", (B34,), {"transpose": True, "alpha": 3.0}),
    ("_linalg_potrf", (np.stack([_spd(3, 23), _spd(3, 24)]),),
     {"lower": False}),
    ("_linalg_makediag", (B34[0],), {"offset": -1}),
    ("_linalg_extractdiag", (B34,), {"offset": 1}),
    ("_linalg_extracttrian", (B34[:, :, :3],), {"offset": 1,
                                                "lower": False}),
    ("_linalg_maketrian", (np.arange(12, dtype=np.float32).reshape(2, 6),),
     {"lower": False}),
    ("_linalg_slogdet", (np.stack([_spd(3, 25), -_spd(3, 26)]),), {}),
    ("moments", (B34,), {"axes": (0, 2), "keepdims": True}),
]


@pytest.mark.parametrize("name,inputs,params", LINALG,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(LINALG)])
def test_linalg_options_match_jax(name, inputs, params):
    n_out = 2 if name in ("_linalg_slogdet", "moments") else 1
    for k in range(n_out):
        got, want = both(name, inputs, params, k)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("bins", [None, np.array([0.0, 1.5, 4.0, 10.0],
                                                 np.float32)],
                         ids=["bin_cnt", "edges"])
def test_histogram_forms_match_jax(bins):
    x = np.random.RandomState(27).uniform(-1, 11, (7, 9)).astype(np.float32)
    x[0, :3] = [0.0, 10.0, 4.0]                  # values on edges
    inputs = (x,) if bins is None else (x, bins)
    params = {"bin_cnt": 6, "range": (0, 10)} if bins is None else {}
    for k in range(2):
        got, want = both("histogram", inputs, params, k)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("name,params,shape", [
    ("_contrib_AdaptiveAvgPooling2D", {"output_size": (3, 2)}, (1, 2, 7, 5)),
    ("_contrib_AdaptiveAvgPooling2D", {"output_size": 2}, (2, 1, 6, 4)),
    ("_contrib_BilinearResize2D", {"height": 3, "width": 4}, (1, 2, 7, 9)),
    ("_contrib_BilinearResize2D", {"scale_height": 1.5, "scale_width": 0.5},
     (1, 1, 4, 6)),
], ids=["pool-resize", "pool-mean", "shrink", "scale"])
def test_resizes_match_jax(name, params, shape):
    x = np.random.RandomState(28).randn(*shape).astype(np.float32)
    got, want = both(name, (x,), params)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_index_ops_follow_getitem_and_setitem():
    a = np.arange(24, dtype=np.float32).reshape(4, 6)
    key = (slice(1, 3), slice(None, None, 2))
    with mt.cpu():
        x = tnd.array(a)
        got = tnd.imperative_invoke("_index", (x,), {"_idx": key})
        np.testing.assert_array_equal(got.asnumpy(), a[key])
        v = tnd.array(np.full((2, 3), -1.0, np.float32))
        out = tnd.imperative_invoke("_index_assign", (x, v), {"_idx": key})
        want = a.copy()
        want[key] = -1.0
        np.testing.assert_array_equal(out.asnumpy(), want)
        out = tnd.imperative_invoke("_index_assign_scalar", (x,),
                                    {"_idx": (2,), "_val": 7.0})
        want = a.copy()
        want[2] = 7.0
        np.testing.assert_array_equal(out.asnumpy(), want)
        np.testing.assert_array_equal(x.asnumpy(), a)    # not in place
