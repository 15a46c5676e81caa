"""Contrib operators: detection, ROI, resize and the small contrib ops
(ref: the JAX package's ``ops/contrib_ops.py``; MXNet src/operator/contrib/
bounding_box.cc, roi_align.cc, multibox_prior.cc, multibox_target.cc,
multibox_detection.cc, adaptive_avg_pooling.cc, bilinear_resize.cc,
boolean_mask.cc, index_copy.cc, quadratic_op.cc, sync_batch_norm.cc, and
src/operator/roi_pooling.cc, spatial_transformer.cc, bilinear_sampler.cc).

Every op computes what the JAX op computes, including where the JAX op
departs from the reference (``box_nms`` ignores ``in_format`` and
``background_id`` and applies ``topk`` after suppression; ``ROIPooling``
takes the max of a fixed 2x2 sample grid per bin).

``box_nms`` is greedy NMS over the boxes sorted by score (a stable sort,
as ``jnp.argsort``). The JAX package runs an N-step masked scan over an
(N, N) IoU matrix; here each step takes the next box that is still kept,
in every image of the batch at once, and suppresses the later boxes of its
class that overlap it. A box that is no longer kept suppresses nothing, so
the steps are as many as the most boxes kept in one image, and with
``topk`` at most ``topk``: a box's fate depends only on the boxes before
it, and every box after the ``topk``-th kept one is dropped anyway. No
(N, N) matrix is made, so SSD300's 8732 anchors at batch 32 take O(B N)
memory a step.

``MultiBoxTarget``'s three ordering rules are the JAX package's on the
host: ``argmax`` takes the first index among ties; when two ground-truth
boxes share a best anchor, the force-match scatter keeps the later box
(XLA's CPU scatter applies duplicate indices in order); the hard negatives
are ranked by a stable sort of their ``-inf``-padded confidences.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .nn import batch_norm, grid_generator
from .ordering import stable_argsort
from .registry import register

__all__ = ["box_iou_corner", "box_nms", "multibox_target",
           "multibox_detection"]


def _area(b):
    return torch.clamp(b[..., 2] - b[..., 0], min=0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0)


def box_iou_corner(a, b):
    """IoU of (..., N, 4) corner boxes against (..., M, 4): (..., N, M)."""
    tl = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    br = torch.minimum(a[..., :, None, 2:4], b[..., None, :, 2:4])
    wh = torch.clamp(br - tl, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = _area(a)[..., :, None] + _area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=1e-12)


def _iou_one(box, boxes):
    """IoU of one (B, 4) box per image against (B, N, 4): (B, N), the
    same arithmetic as a row of :func:`box_iou_corner`."""
    return box_iou_corner(box[:, None, :], boxes)[:, 0, :]


@register("_contrib_box_iou", aliases=("box_iou",), differentiable=False)
def _box_iou(lhs, rhs, format="corner"):
    if format == "center":
        def corner(x):
            cx, cy, w, h = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
            return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                cy + h / 2], dim=-1)
        lhs, rhs = corner(lhs), corner(rhs)
    return box_iou_corner(lhs, rhs)


def _greedy_keep(coords, cls, valid, overlap_thresh, force_suppress,
                 topk):
    """The keep mask of greedy NMS over score-sorted (B, N) boxes."""
    b, n = valid.shape
    keep = valid.clone()
    ar = torch.arange(n, device=valid.device)
    rows = torch.arange(b, device=valid.device)
    ptr = torch.full((b,), -1, dtype=torch.long, device=valid.device)
    steps = int(valid.sum(1).max()) if n else 0
    if topk > 0:
        steps = min(steps, int(topk))
    for step in range(steps):
        # the first box after the last one taken that is still kept
        i = torch.where(keep & (ar > ptr[:, None]), ar, n).amin(1)
        has = i < n
        if step % 32 == 31 and not bool(has.any()):
            break
        ic = torch.clamp(i, max=n - 1)
        sup = (_iou_one(coords[rows, ic], coords) > overlap_thresh) & \
            (ar > i[:, None]) & has[:, None]
        if not force_suppress:
            sup &= cls == cls[rows, ic][:, None]
        keep &= ~sup
        ptr = torch.where(has, i, n)
    return keep


@register("_contrib_box_nms", aliases=("box_nms",), differentiable=False)
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, force_suppress=False,
            in_format="corner", out_format="corner", background_id=-1):
    """Greedy NMS. data: (..., N, 5+) rows [id, score, x1, y1, x2, y2];
    returns the rows sorted by score, suppressed rows all -1. The formats
    and ``background_id`` are taken and ignored, as by the JAX op."""
    shape = data.shape
    flat = data.reshape((-1,) + tuple(shape[-2:]))
    order = stable_argsort(-flat[..., score_index], 1)
    sboxes = torch.gather(flat, 1, order[..., None].expand(flat.shape))
    coords = sboxes[..., coord_start:coord_start + 4]
    cls = sboxes[..., id_index] if id_index >= 0 \
        else torch.zeros_like(sboxes[..., 0])
    valid = sboxes[..., score_index] > valid_thresh
    keep = _greedy_keep(coords, cls, valid, overlap_thresh,
                        bool(force_suppress), int(topk))
    if topk > 0:
        keep &= torch.cumsum(keep.to(torch.int32), 1) - 1 < topk
    out = torch.where(keep[..., None], sboxes, -torch.ones_like(sboxes))
    return out.reshape(shape)


def _flat_gather(img, yi, xi):
    """img (R, C, H, W) at the integer positions (yi, xi), two (R, ...)
    tensors broadcast against each other: (R, C, ...)."""
    r, c, h, w = img.shape
    idx = (yi * w + xi)
    shape = idx.shape[1:]
    flat = idx.reshape(r, 1, -1).expand(r, c, -1)
    return torch.gather(img.reshape(r, c, h * w), 2, flat) \
        .reshape((r, c) + shape)


@register("ROIPooling", differentiable=False)
def _roi_pooling(data, rois, pooled_size=(1, 1), spatial_scale=1.0):
    """rois: (R, 5) [batch, x1, y1, x2, y2] -> (R, C, ph, pw): the max of
    a fixed 2x2 sample grid in each bin, as the JAX op takes it."""
    ph, pw = (int(s) for s in pooled_size)
    H, W = data.shape[2], data.shape[3]
    img = data[rois[:, 0].to(torch.int32).long()]
    x1, y1, x2, y2 = torch.round(rois[:, 1:5] * spatial_scale).unbind(1)
    bin_h = torch.clamp(y2 - y1 + 1, min=1.0) / ph
    bin_w = torch.clamp(x2 - x1 + 1, min=1.0) / pw
    q = torch.tensor([0.25, 0.75], dtype=data.dtype, device=data.device)
    ys = torch.arange(ph, device=data.device)
    xs = torch.arange(pw, device=data.device)
    sy = (y1[:, None] + ys * bin_h[:, None])[..., None] + \
        q * bin_h[:, None, None]                            # (R, ph, 2)
    sx = (x1[:, None] + xs * bin_w[:, None])[..., None] + \
        q * bin_w[:, None, None]                            # (R, pw, 2)
    syi = torch.clamp(sy.to(torch.int32), 0, H - 1).long()
    sxi = torch.clamp(sx.to(torch.int32), 0, W - 1).long()
    vals = _flat_gather(img, syi[:, :, None, :, None],
                        sxi[:, None, :, None, :])   # (R, C, ph, pw, 2, 2)
    return vals.amax(dim=(4, 5))


def _bilinear_at(img, y, x):
    """img (R, C, H, W) sampled at y (R, Y) x x (R, X), clamped to the
    map: (R, C, Y, X)."""
    H, W = img.shape[2], img.shape[3]
    y = torch.clamp(y, 0.0, H - 1.0)
    x = torch.clamp(x, 0.0, W - 1.0)
    y0 = torch.floor(y).to(torch.int32)
    x0 = torch.floor(x).to(torch.int32)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    wy = (y - y0)[:, None, :, None]
    wx = (x - x0)[:, None, None, :]
    Y0, Y1 = y0.long()[:, :, None], y1.long()[:, :, None]
    X0, X1 = x0.long()[:, None, :], x1.long()[:, None, :]
    v00 = _flat_gather(img, Y0, X0)
    v01 = _flat_gather(img, Y0, X1)
    v10 = _flat_gather(img, Y1, X0)
    v11 = _flat_gather(img, Y1, X1)
    return (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx +
            v10 * wy * (1 - wx) + v11 * wy * wx)


@register("_contrib_ROIAlign", aliases=("ROIAlign",))
def _roi_align(data, rois, pooled_size=(1, 1), spatial_scale=1.0,
               sample_ratio=2, position_sensitive=False, aligned=False):
    """Bilinear-sampled ROI pooling: the mean of ``sample_ratio``² samples
    per bin. rois: (R, 5) [batch, x1, y1, x2, y2] -> (R, C, ph, pw)."""
    ph, pw = (int(s) for s in pooled_size)
    sr = max(1, int(sample_ratio))
    img = data[rois[:, 0].to(torch.int32).long()]
    offset = 0.5 if aligned else 0.0
    x1, y1, x2, y2 = (rois[:, 1:5] * spatial_scale - offset).unbind(1)
    bin_h = torch.clamp(y2 - y1, min=1e-3) / ph
    bin_w = torch.clamp(x2 - x1, min=1e-3) / pw
    frac = (torch.arange(sr, device=data.device) + 0.5) / sr
    gy = (torch.arange(ph, device=data.device)[:, None] + frac[None, :])
    gx = (torch.arange(pw, device=data.device)[:, None] + frac[None, :])
    ys = y1[:, None] + gy.reshape(-1) * bin_h[:, None]       # (R, ph*sr)
    xs = x1[:, None] + gx.reshape(-1) * bin_w[:, None]       # (R, pw*sr)
    vals = _bilinear_at(img, ys, xs)
    r, c = vals.shape[:2]
    return vals.reshape(r, c, ph, sr, pw, sr).mean(dim=(3, 5))


@register("_contrib_MultiBoxPrior", aliases=("MultiBoxPrior",),
          differentiable=False)
def _multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                    steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes (1, h*w*A, 4), pixel-major, A = len(sizes) +
    len(ratios) - 1 per pixel: every size at the first ratio, then the
    first size at every other ratio."""
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    step_y = steps[1] if steps[1] > 0 else 1.0 / h
    step_x = steps[0] if steps[0] > 0 else 1.0 / w
    cy = (torch.arange(h, device=dev) + offsets[1]) * step_y
    cx = (torch.arange(w, device=dev) + offsets[0]) * step_x
    cy, cx = cy.float(), cx.float()
    boxes = []
    for i, s in enumerate(tuple(sizes)):
        for j, r in enumerate(tuple(ratios)):
            if i > 0 and j > 0:
                continue
            sr = math.sqrt(float(r))
            aw = torch.tensor(s * sr / 2, dtype=torch.float32)
            ah = torch.tensor(s / sr / 2, dtype=torch.float32)
            aw, ah = aw.to(dev), ah.to(dev)
            x1 = (cx[None, :] - aw).expand(h, w)
            y1 = (cy[:, None] - ah).expand(h, w)
            x2 = (cx[None, :] + aw).expand(h, w)
            y2 = (cy[:, None] + ah).expand(h, w)
            boxes.append(torch.stack([x1, y1, x2, y2], -1).reshape(-1, 4))
    out = torch.stack(boxes, dim=1).reshape(1, -1, 4)
    return torch.clamp(out, 0, 1) if clip else out


def _resize(data, oh, ow):
    """jax.image.resize(..., "linear") on NCHW: half-pixel bilinear, with
    the triangle kernel widened when shrinking (antialiased)."""
    return F.interpolate(data, size=(oh, ow), mode="bilinear",
                         align_corners=False, antialias=True)


@register("_contrib_AdaptiveAvgPooling2D", aliases=("AdaptiveAvgPooling2D",))
def _adaptive_avg_pooling(data, output_size=(1, 1)):
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = (int(s) for s in output_size)
    n, c, h, w = data.shape
    if h % oh == 0 and w % ow == 0:
        return data.reshape(n, c, oh, h // oh, ow, w // ow).mean(dim=(3, 5))
    return _resize(data, oh, ow)


@register("_contrib_BilinearResize2D", aliases=("BilinearResize2D",))
def _bilinear_resize(data, height=1, width=1, scale_height=None,
                     scale_width=None, mode="size"):
    n, c, h, w = data.shape
    if scale_height is not None:
        height, width = int(h * scale_height), int(w * scale_width)
    return _resize(data, int(height), int(width))


@register("_contrib_boolean_mask", aliases=("boolean_mask",),
          differentiable=False)
def _boolean_mask(data, index, axis=0):
    """The slices of ``data`` along ``axis`` where ``index`` is nonzero
    (a data-dependent length: one host sync)."""
    idx = torch.nonzero(index.reshape(-1)).reshape(-1)
    return torch.index_select(data, int(axis), idx)


@register("_contrib_index_copy", aliases=("index_copy",))
def _index_copy(old, idx, new):
    out = old.clone()
    out[idx.to(torch.int32).long()] = new.to(old.dtype)
    return out


@register("_contrib_index_array", aliases=("index_array",),
          differentiable=False)
def _index_array(data, axes=None):
    shape = data.shape
    ax = tuple(axes) if axes is not None else tuple(range(len(shape)))
    grids = torch.meshgrid(*[torch.arange(shape[a], device=data.device)
                             for a in ax], indexing="ij")
    return torch.stack(grids, dim=-1).to(torch.int64)


class _GradientMultiplier(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scalar):
        ctx.scalar = scalar
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scalar, None


@register("_contrib_gradientmultiplier", aliases=("gradientmultiplier",))
def _gradient_multiplier(data, scalar=1.0):
    """The identity forward; the backward scales the gradient."""
    return _GradientMultiplier.apply(data, float(scalar))


@register("_contrib_quadratic", aliases=("quadratic",))
def _quadratic(data, a=0.0, b=0.0, c=0.0):
    """The tutorial op (ref: src/operator/contrib/quadratic_op.cc)."""
    return a * data * data + b * data + c


@register("_contrib_arange_like", aliases=("arange_like",),
          differentiable=False)
def _arange_like(data, start=0.0, step=1.0, repeat=1, axis=None):
    n = data.numel() if axis is None else data.shape[axis]
    out = start + torch.arange(n, device=data.device).float() * step
    return out.reshape(data.shape) if axis is None else out


@register("_contrib_SyncBatchNorm", aliases=("SyncBatchNorm",),
          num_outputs=3)
def _sync_batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                     momentum=0.9, fix_gamma=True, use_global_stats=False,
                     output_mean_var=False, ndev=1, key="", _training=False):
    """Cross-device BatchNorm (ref: src/operator/contrib/
    sync_batch_norm.cc). On one device it is BatchNorm over axis 1."""
    return batch_norm(data, gamma, beta, moving_mean, moving_var, eps=eps,
                      momentum=momentum, fix_gamma=fix_gamma,
                      use_global_stats=use_global_stats, axis=1,
                      _training=_training)


@register("BilinearSampler")
def _bilinear_sampler(data, grid):
    """data (N, C, H, W) sampled at grid (N, 2, Ho, Wo) in [-1, 1]:
    (N, C, Ho, Wo)."""
    n, c, h, w = data.shape
    gx = (grid[:, 0] + 1) * (w - 1) / 2
    gy = (grid[:, 1] + 1) * (h - 1) / 2
    y0 = torch.clamp(torch.floor(gy).to(torch.int32), 0, h - 1)
    x0 = torch.clamp(torch.floor(gx).to(torch.int32), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = torch.clamp(gy - y0, 0, 1)[:, None]
    wx = torch.clamp(gx - x0, 0, 1)[:, None]
    y0, y1, x0, x1 = (t.long() for t in (y0, y1, x0, x1))
    return _flat_gather(data, y0, x0) * (1 - wy) * (1 - wx) + \
        _flat_gather(data, y0, x1) * (1 - wy) * wx + \
        _flat_gather(data, y1, x0) * wy * (1 - wx) + \
        _flat_gather(data, y1, x1) * wy * wx


@register("SpatialTransformer")
def _spatial_transformer(data, loc, target_shape=(0, 0),
                         transform_type="affine", sampler_type="bilinear",
                         cudnn_off=False):
    """(ref: src/operator/spatial_transformer.cc) the affine grid of
    ``loc`` sampled bilinearly."""
    grid = grid_generator(loc, transform_type="affine",
                          target_shape=target_shape)
    return _bilinear_sampler(data, grid)


# ---------------------------------------------------------------------------
# SSD training and inference ops (ref: multibox_target.cc,
# multibox_detection.cc)
# ---------------------------------------------------------------------------

def _corner_to_center(boxes):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    x = (boxes[..., 0] + boxes[..., 2]) * 0.5
    y = (boxes[..., 1] + boxes[..., 3]) * 0.5
    return x, y, w, h


@register("_contrib_MultiBoxTarget", aliases=("MultiBoxTarget",),
          num_outputs=3, differentiable=False)
def multibox_target(anchors, labels, cls_preds, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD target assignment. anchors (1, N, 4) corner; labels (B, M, 5)
    [cls, xmin, ymin, xmax, ymax], padded rows cls < 0; cls_preds
    (B, num_classes + 1, N). Returns box_target (B, N*4), box_mask
    (B, N*4), cls_target (B, N): each anchor matches the ground truth of
    its best IoU when that is at least ``overlap_threshold``, each valid
    ground truth claims its best anchor, the matched boxes are encoded
    with the variances, classes are gt + 1 (0 background), and with
    hard-negative mining the unmined negatives get ``ignore_label``."""
    v = tuple(float(x) for x in variances)
    A = anchors.reshape(-1, 4)
    n = A.shape[0]
    b, m = labels.shape[0], labels.shape[1]
    dev = A.device
    ax, ay, aw, ah = _corner_to_center(A)
    valid = labels[..., 0] >= 0                               # (B, M)
    gt = labels[..., 1:5]
    ious = box_iou_corner(A.expand(b, n, 4), gt)              # (B, N, M)
    ious = torch.where(valid[:, None, :], ious, -1.0)
    best_iou = ious.amax(dim=2)                               # (B, N)
    best_gt = torch.argmax(ious, dim=2)
    matched = best_iou >= overlap_threshold
    # force-match: each valid gt claims its best anchor; padded rows go to
    # slot n and are dropped; of two gts sharing an anchor the later wins
    best_anchor = torch.where(valid, torch.argmax(ious, dim=1), n)
    claim = torch.full((b, n + 1), -1, dtype=torch.long, device=dev)
    claim.scatter_reduce_(1, best_anchor,
                          torch.arange(m, device=dev).expand(b, m),
                          reduce="amax")
    forced = claim[:, :n] >= 0
    matched = matched | forced
    assigned = torch.where(forced, claim[:, :n], best_gt)
    g = torch.gather(gt, 1, assigned[..., None].expand(b, n, 4))
    gx, gy, gw, gh = _corner_to_center(g)
    eps = 1e-8
    t0 = (gx - ax) / torch.clamp(aw, min=eps) / v[0]
    t1 = (gy - ay) / torch.clamp(ah, min=eps) / v[1]
    t2 = torch.log(torch.clamp(gw, min=eps) / torch.clamp(aw, min=eps)) / v[2]
    t3 = torch.log(torch.clamp(gh, min=eps) / torch.clamp(ah, min=eps)) / v[3]
    box_t = torch.stack([t0, t1, t2, t3], dim=2) * matched[..., None]
    box_m = matched[..., None].to(A.dtype).expand(b, n, 4)
    cls_gt = torch.gather(labels[..., 0], 1, assigned)
    cls_t = torch.where(matched, cls_gt + 1.0, 0.0)
    if negative_mining_ratio > 0:
        eligible = (~matched) & (best_iou < negative_mining_thresh)
        neg_conf = cls_preds[:, 1:, :].amax(dim=1)            # (B, N)
        n_pos = matched.sum(dim=1)
        n_neg = torch.clamp((negative_mining_ratio * n_pos).to(torch.int32),
                            min=int(minimum_negative_samples))
        conf = torch.where(eligible, neg_conf, -torch.inf)
        order = stable_argsort(-conf, 1)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(n, device=dev).expand(b, n))
        keep_neg = eligible & (rank < n_neg[:, None])
        cls_t = torch.where(matched | keep_neg, cls_t, float(ignore_label))
    return box_t.reshape(b, -1), box_m.reshape(b, -1), cls_t


@register("_contrib_MultiBoxDetection", aliases=("MultiBoxDetection",),
          differentiable=False)
def multibox_detection(cls_prob, loc_pred, anchors, clip=True,
                       threshold=0.01, background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """SSD decoding + NMS: cls_prob (B, C+1, N), loc_pred (B, N*4),
    anchors (1, N, 4) -> (B, N, 6) rows [class_id, score, xmin, ymin,
    xmax, ymax] sorted by score, suppressed rows -1."""
    v = tuple(float(x) for x in variances)
    A = anchors.reshape(-1, 4)
    n = A.shape[0]
    ax, ay, aw, ah = _corner_to_center(A)
    loc = loc_pred.reshape(loc_pred.shape[0], n, 4)
    cx = loc[..., 0] * v[0] * aw + ax
    cy = loc[..., 1] * v[1] * ah + ay
    w = torch.exp(loc[..., 2] * v[2]) * aw * 0.5
    h = torch.exp(loc[..., 3] * v[3]) * ah * 0.5
    boxes = torch.stack([cx - w, cy - h, cx + w, cy + h], dim=2)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    bg = int(background_id)
    fg = torch.cat([cls_prob[:, :bg], cls_prob[:, bg + 1:]], dim=1)
    score = fg.amax(dim=1)
    cls_id = torch.argmax(fg, dim=1).to(boxes.dtype)
    keep = score > threshold
    rows = torch.cat([torch.where(keep, cls_id, -1.0)[..., None],
                      torch.where(keep, score, -1.0)[..., None], boxes],
                     dim=2)
    return box_nms(rows, overlap_thresh=nms_threshold, valid_thresh=0.0,
                   topk=nms_topk, coord_start=2, score_index=1, id_index=0,
                   force_suppress=force_suppress)
