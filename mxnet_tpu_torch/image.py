"""mx.image: decoding, resizing, cropping, the augmenters and ``ImageIter``
(ref: python/mxnet/image/{image.py,detection.py}; the JAX package's
``image.py``).

The functions take and give NDArrays; the augmenters are the JAX
package's, with its sources of randomness: crops, flips and the jitter
factors draw from Python's ``random``; lighting, the jitter order and the
detection crops and flips from ``numpy.random``. Decoding is npy bytes, or
JPEG / PNG through cv2 where cv2 is importable; ``imresize`` is
``cv2.resize`` there and ``_image_resize``'s antialiased bilinear (then a
plain cast) without it, as in the JAX package.

Where the work runs: the per-image work of the record iterators
(:func:`decode_and_augment`) is host work by construction, because it
hands back numpy. ``ImageIter`` (and ``io.ImageRecordIter``'s decode
threads) therefore run the augmenters under ``mx.cpu()``, an explicit
placement that spares a round trip to the card per image per op, and put
the assembled batch on the current context (the card unless the caller
says ``with mx.cpu():``). Called directly, the functions and augmenters
run where their input lives.
"""
from __future__ import annotations

import io as _io
import logging
import random as _pyrandom
from typing import List

import numpy as _np
import torch

from .base import check
from .context import cpu, current_context
from .io.io import DataBatch, DataDesc, DataIter
from .ndarray import ndarray as _nd
from .ops import image_ops as _image_ops

__all__ = ["imresize", "imdecode", "imread", "fixed_crop", "center_crop",
           "random_crop", "color_normalize", "resize_short",
           "HorizontalFlipAug", "CastAug", "ColorNormalizeAug",
           "RandomCropAug", "CenterCropAug", "ResizeAug", "ForceResizeAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "LightingAug", "ColorJitterAug", "CreateAugmenter", "ImageIter",
           "DetAugmenter", "DetBorrowAug", "DetHorizontalFlipAug",
           "DetRandomCropAug", "DetForceResizeAug", "CreateDetAugmenter",
           "to_chw", "decode_and_augment"]


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode an npy or (through cv2) JPEG / PNG buffer to an HWC
    NDArray."""
    raw = bytes(buf)
    if raw[:6] == b"\x93NUMPY":
        return _nd.array(_np.load(_io.BytesIO(raw), allow_pickle=False))
    import cv2
    img = cv2.imdecode(_np.frombuffer(raw, _np.uint8), flag)
    check(img is not None, "imdecode failed")
    if to_rgb and img.ndim == 3 and img.shape[2] == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    return _nd.array(img)


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=1):
    """Resize an HWC image to (h, w): ``cv2.resize`` where cv2 is
    importable, else ``_image_resize``'s antialiased bilinear."""
    try:
        import cv2
    except ImportError:
        data = src._data if isinstance(src, _nd.NDArray) else \
            torch.as_tensor(_np.asarray(src))
        out = _image_ops.resize(data.to(torch.float32), int(h), int(w),
                                "bilinear")
        return _nd.NDArray(out.to(data.dtype))
    data = src.asnumpy() if isinstance(src, _nd.NDArray) else \
        _np.asarray(src)
    interp_map = {0: cv2.INTER_NEAREST, 1: cv2.INTER_LINEAR,
                  2: cv2.INTER_CUBIC, 3: cv2.INTER_AREA,
                  4: cv2.INTER_LANCZOS4}
    out = cv2.resize(data, (w, h),
                     interpolation=interp_map.get(interp, cv2.INTER_LINEAR))
    ctx = src.context if isinstance(src, _nd.NDArray) else None
    return _nd.array(out, ctx=ctx)


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = _pyrandom.randint(0, w - new_w)
    y0 = _pyrandom.randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def color_normalize(src, mean, std=None):
    src = src - mean
    if std is not None:
        src = src / std
    return src


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return resize_short(src, self.size)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1])


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return random_crop(src, self.size)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size)
        self.size = size

    def __call__(self, src):
        return center_crop(src, self.size)[0]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if _pyrandom.random() < self.p:
            return src.flip(axis=1)
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(typ=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


class ColorNormalizeAug(Augmenter):
    """(src - mean) / std, with mean and std on the image's device."""

    def __init__(self, mean, std):
        super().__init__()
        self.mean = None if mean is None else _np.asarray(mean, _np.float32)
        self.std = None if std is None else _np.asarray(std, _np.float32)
        self._on = {}

    def _arrays(self, ctx):
        if ctx not in self._on:
            self._on[ctx] = tuple(None if a is None else _nd.array(a, ctx=ctx)
                                  for a in (self.mean, self.std))
        return self._on[ctx]

    def __call__(self, src):
        mean, std = self._arrays(src.context)
        return color_normalize(src, mean, std)


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__()
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__()
        self.contrast = contrast
        self.coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.contrast, self.contrast)
        gray = (src * _nd.array(self.coef, ctx=src.context)).sum()
        gray = (3.0 * (1.0 - alpha) / src.size) * gray
        return src * alpha + gray


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__()
        self.saturation = saturation
        self.coef = _np.array([[[0.299, 0.587, 0.114]]], _np.float32)

    def __call__(self, src):
        alpha = 1.0 + _pyrandom.uniform(-self.saturation, self.saturation)
        gray = (src * _nd.array(self.coef, ctx=src.context)).sum(
            axis=2, keepdims=True)
        return src * alpha + gray * (1.0 - alpha)


class LightingAug(Augmenter):
    def __init__(self, alphastd, eigval, eigvec):
        super().__init__()
        self.alphastd = alphastd
        self.eigval = _np.asarray(eigval, _np.float32)
        self.eigvec = _np.asarray(eigvec, _np.float32)

    def __call__(self, src):
        alpha = _np.random.normal(0, self.alphastd, size=(3,))
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return src + _nd.array(rgb.astype(_np.float32), ctx=src.context)


class ColorJitterAug(Augmenter):
    def __init__(self, brightness, contrast, saturation):
        super().__init__()
        self.augs = []
        if brightness:
            self.augs.append(BrightnessJitterAug(brightness))
        if contrast:
            self.augs.append(ContrastJitterAug(contrast))
        if saturation:
            self.augs.append(SaturationJitterAug(saturation))

    def __call__(self, src):
        for a in _np.random.permutation(len(self.augs)):
            src = self.augs[a](src)
        return src


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """The classification augmenter list (ref: image.py CreateAugmenter);
    ``rand_resize``, ``hue`` and ``rand_gray`` are logged and ignored, as
    in the JAX package."""
    unimpl = [n for n, v in (("rand_resize", rand_resize), ("hue", hue),
                             ("rand_gray", rand_gray)) if v]
    if unimpl:
        logging.getLogger("mxnet_tpu_torch").warning(
            "CreateAugmenter: %s not implemented and IGNORED", unimpl)
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.extend(_color_stages(brightness, contrast, saturation,
                                 pca_noise, mean, std))
    return auglist


def _color_stages(brightness, contrast, saturation, pca_noise, mean, std):
    """Cast, color jitter, PCA lighting, normalization: shared by
    CreateAugmenter and (through DetBorrowAug) CreateDetAugmenter."""
    stages: List[Augmenter] = [CastAug()]
    if brightness or contrast or saturation:
        stages.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        eigval = [55.46, 4.794, 1.148]
        eigvec = [[-0.5675, 0.7192, 0.4009],
                  [-0.5808, -0.0045, -0.8140],
                  [-0.5836, -0.6948, 0.4203]]
        stages.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = _np.array([123.68, 116.28, 103.53])
    if std is True:
        std = _np.array([58.395, 57.12, 57.375])
    if mean is not None and len(_np.atleast_1d(mean)) > 0:
        stages.append(ColorNormalizeAug(mean, std))
    return stages


def to_chw(x) -> _np.ndarray:
    """HWC NDArray / array -> CHW numpy (unchanged unless 1 or 3
    channels)."""
    arr = x.asnumpy() if hasattr(x, "asnumpy") else _np.asarray(x)
    if arr.ndim == 3 and arr.shape[2] in (1, 3):
        arr = arr.transpose(2, 0, 1)
    return arr


def decode_and_augment(rec, auglist):
    """One record: unpack, augment, CHW. Returns (chw numpy array, label
    array). Runs where the current context says (``ImageIter`` and
    ``ImageRecordIter`` call it under ``mx.cpu()``)."""
    from .recordio import unpack_img
    header, img = unpack_img(rec)
    x = _nd.array(img.astype(_np.float32))
    for aug in auglist:
        x = aug(x)
    return to_chw(x), _np.asarray(header.label, _np.float32)


class ImageIter(DataIter):
    """Batches from a ``.rec`` file (ref: image.py ImageIter): records
    through ``io.record_io.RecordPipeline``, augmented on the host (see
    the module docstring), the batch on the current context."""

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 shuffle=False, aug_list=None, part_index=0, num_parts=1,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        check(path_imgrec is not None, "ImageIter requires path_imgrec")
        check(len(data_shape) == 3, "data_shape must be (C, H, W)")
        self.data_shape = tuple(data_shape)
        from .io.record_io import RecordPipeline
        self._pipe = RecordPipeline(path_imgrec, num_threads=4,
                                    part_index=part_index,
                                    num_parts=num_parts, shuffle=shuffle)
        self.auglist = aug_list if aug_list is not None else \
            CreateAugmenter(data_shape)
        self._data_name = data_name
        self._label_name = label_name

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        return [DataDesc(self._label_name, (self.batch_size,))]

    def reset(self):
        self._pipe.reset()

    def next(self):
        ctx = current_context()
        c, h, w = self.data_shape
        batch = _np.zeros((self.batch_size, c, h, w), _np.float32)
        labels = _np.zeros((self.batch_size,), _np.float32)
        i = 0
        with cpu():
            while i < self.batch_size:
                rec = self._pipe.next()
                if rec is None:
                    if i == 0:
                        raise StopIteration
                    break
                arr, label = decode_and_augment(rec, self.auglist)
                batch[i] = arr
                labels[i] = float(label) if label.size == 1 \
                    else float(label.reshape(-1)[0])
                i += 1
        return DataBatch([_nd.array(batch, ctx=ctx)],
                         [_nd.array(labels, ctx=ctx)],
                         pad=self.batch_size - i)


# ---------------------------------------------------------------------------
# Detection augmenters: image and boxes transformed together (ref:
# python/mxnet/image/detection.py). Labels are (N, 5+) rows [id, xmin,
# ymin, xmax, ymax, ...] with coordinates in [0, 1].
# ---------------------------------------------------------------------------

class DetAugmenter:
    """``__call__(src, label) -> (src, label)``."""

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """A plain augmenter that leaves boxes where they are (color, cast,
    normalize, exact resize)."""

    def __init__(self, augmenter):
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


def _check_det_label(label, who):
    check(label.ndim == 2 and label.shape[1] >= 5,
          f"{who} needs detection labels with obj_width >= 5 "
          f"[id, xmin, ymin, xmax, ymax, ...]; got shape "
          f"{tuple(label.shape)}")


class DetHorizontalFlipAug(DetAugmenter):
    """Flip image and boxes together with probability p."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, src, label):
        _check_det_label(label, "DetHorizontalFlipAug")
        if _np.random.random() < self.p:
            src = src.flip(axis=1)
            label = label.copy()
            xmin = label[:, 1].copy()
            label[:, 1] = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - xmin
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random crop keeping the boxes that stay covered by at least
    ``min_object_covered`` of their area, clipped to the crop."""

    def __init__(self, min_object_covered=0.3, min_crop_size=0.5,
                 max_attempts=10):
        self.min_object_covered = min_object_covered
        self.min_crop_size = min_crop_size
        self.max_attempts = max_attempts

    def __call__(self, src, label):
        _check_det_label(label, "DetRandomCropAug")
        h, w = src.shape[0], src.shape[1]
        for _ in range(self.max_attempts):
            s = _np.random.uniform(self.min_crop_size, 1.0)
            # whole pixels first, so boxes renormalize against the pixels
            # that were kept
            wi = max(int(round(s * w)), 1)
            hi = max(int(round(s * h)), 1)
            xi = _np.random.randint(0, w - wi + 1)
            yi = _np.random.randint(0, h - hi + 1)
            x0, y0 = xi / w, yi / h
            cw, ch = wi / w, hi / h
            new = self._crop_boxes(label, x0, y0, cw, ch)
            if new.shape[0] > 0:
                src = fixed_crop(src, xi, yi, wi, hi)
                return src, new
        return src, label

    def _crop_boxes(self, label, x0, y0, cw, ch):
        out = []
        for row in _np.asarray(label, _np.float32):
            bx0, by0, bx1, by1 = row[1:5]
            ix0, iy0 = max(bx0, x0), max(by0, y0)
            ix1, iy1 = min(bx1, x0 + cw), min(by1, y0 + ch)
            iw, ih = max(ix1 - ix0, 0.0), max(iy1 - iy0, 0.0)
            area = (bx1 - bx0) * (by1 - by0)
            if area <= 0 or iw * ih / area < self.min_object_covered:
                continue
            new = row.copy()
            new[1] = (ix0 - x0) / cw
            new[2] = (iy0 - y0) / ch
            new[3] = (ix1 - x0) / cw
            new[4] = (iy1 - y0) / ch
            out.append(new)
        return _np.asarray(out, _np.float32).reshape(-1, label.shape[1])


class DetForceResizeAug(DetAugmenter):
    """Exact resize to (w, h); normalized boxes do not move."""

    def __init__(self, size, interp=2):
        self.aug = ForceResizeAug(size, interp)

    def __call__(self, src, label):
        return self.aug(src), label


def CreateDetAugmenter(data_shape, rand_crop=0, rand_mirror=False,
                       mean=None, std=None, brightness=0, contrast=0,
                       saturation=0, pca_noise=0,
                       min_object_covered=0.3, min_crop_size=0.5,
                       inter_method=2):
    """The detection augmenter list: geometric stages move the boxes, the
    color stages are the classification ones."""
    auglist: List[DetAugmenter] = []
    if rand_crop:
        auglist.append(DetRandomCropAug(min_object_covered=min_object_covered,
                                        min_crop_size=min_crop_size))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    auglist.append(DetForceResizeAug((data_shape[2], data_shape[1]),
                                     inter_method))
    auglist.extend(DetBorrowAug(a) for a in
                   _color_stages(brightness, contrast, saturation,
                                 pca_noise, mean, std))
    return auglist
