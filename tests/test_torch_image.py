"""``mx.image``, the record iterators and ``MNISTIter`` of the port against
the JAX package's, on the CPU.

- ``imresize``: with cv2 visible both packages call ``cv2.resize`` (equal);
  with cv2 hidden in both (``sys.modules["cv2"] = None``) both fall back
  to ``jax.image.resize``'s bilinear and its PyTorch counterpart (1 in
  uint8, 1e-3 of 255 in f32); ``imdecode`` of npy and PNG bytes.
- Every augmenter, after ``random.seed`` and ``np.random.seed`` in both
  packages: equal where it is elementwise, within 1e-5 of the largest
  value where it reduces (contrast, saturation, lighting's sum).
- ``ImageRecordIter`` (``preprocess_threads=1``), ``ImageIter`` and
  ``ImageDetRecordIter`` over one ``.rec`` after the same seeds: data,
  labels (``label_width`` 1 and 2), ``pad`` with and without
  ``round_batch``, detection labels padded with -1, two epochs.
- ``MNISTIter`` over idx files written here, plain and gzipped, flat and
  not, shuffled by its seed.
"""
import gzip
import io
import random
import struct
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import image as jimage
from mxnet_tpu import recordio as jrec

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import image as timage


@pytest.fixture(autouse=True)
def _host():
    with mt.cpu():
        yield


def _seed(s):
    random.seed(s)
    np.random.seed(s)


def _img(h, w, dtype=np.uint8, seed=0):
    x = np.random.RandomState(seed).randint(0, 256, (h, w, 3))
    return x.astype(dtype)


def _npy(img):
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


# --- imresize / imdecode ----------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
@pytest.mark.parametrize("wh", [(30, 22), (9, 7), (16, 40)])
def test_imresize_without_cv2(monkeypatch, dtype, wh):
    monkeypatch.setitem(sys.modules, "cv2", None)
    x = _img(17, 23, dtype)
    got = timage.imresize(mt.nd.array(x, dtype=x.dtype), *wh).asnumpy()
    want = jimage.imresize(jmx.nd.array(x, dtype=x.dtype), *wh).asnumpy()
    assert got.shape == want.shape == (wh[1], wh[0], 3)
    assert got.dtype == want.dtype
    tol = 1.0 if dtype == np.uint8 else 1e-3 * 255
    np.testing.assert_allclose(got.astype(np.float64), want, atol=tol,
                               rtol=0)


@pytest.mark.parametrize("interp", [0, 1, 2, 3, 4])
def test_imresize_with_cv2_is_equal(interp):
    pytest.importorskip("cv2")
    x = _img(17, 23)
    got = timage.imresize(mt.nd.array(x, dtype="uint8"), 12, 9, interp)
    want = jimage.imresize(jmx.nd.array(x, dtype="uint8"), 12, 9, interp)
    np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


def test_imdecode_npy_and_png(tmp_path):
    x = _img(6, 5)
    np.testing.assert_array_equal(timage.imdecode(_npy(x)).asnumpy(), x)
    cv2 = pytest.importorskip("cv2")
    ok, png = cv2.imencode(".png", x)
    assert ok
    np.testing.assert_array_equal(timage.imdecode(png.tobytes()).asnumpy(),
                                  jimage.imdecode(png.tobytes()).asnumpy())
    path = tmp_path / "x.png"
    path.write_bytes(png.tobytes())
    np.testing.assert_array_equal(timage.imread(str(path)).asnumpy(),
                                  jimage.imread(str(path)).asnumpy())


# --- augmenters -------------------------------------------------------------

EIG = ([55.46, 4.794, 1.148], [[-0.5675, 0.7192, 0.4009],
                               [-0.5808, -0.0045, -0.8140],
                               [-0.5836, -0.6948, 0.4203]])
AUGS = {  # name -> (make(module), reduces)
    "resize": (lambda m: m.ResizeAug(14), False),
    "force_resize": (lambda m: m.ForceResizeAug((13, 11)), False),
    "random_crop": (lambda m: m.RandomCropAug((9, 7)), False),
    "center_crop": (lambda m: m.CenterCropAug((9, 7)), False),
    "flip": (lambda m: m.HorizontalFlipAug(0.5), False),
    "cast": (lambda m: m.CastAug(), False),
    "normalize": (lambda m: m.ColorNormalizeAug([10.0, 20.0, 30.0],
                                                [2.0, 3.0, 4.0]), False),
    "brightness": (lambda m: m.BrightnessJitterAug(0.4), False),
    "contrast": (lambda m: m.ContrastJitterAug(0.4), True),
    "saturation": (lambda m: m.SaturationJitterAug(0.4), True),
    "lighting": (lambda m: m.LightingAug(0.1, *EIG), True),
    "color_jitter": (lambda m: m.ColorJitterAug(0.3, 0.3, 0.3), True),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmenters_match_jax(name):
    make, reduces = AUGS[name]
    x = _img(16, 20, np.float32)
    taug, jaug = make(timage), make(jimage)
    outs = []
    for mod, aug, nd in ((timage, taug, mt.nd), (jimage, jaug, jmx.nd)):
        _seed(4)
        outs.append([aug(nd.array(x)).asnumpy() for _ in range(6)])
    for got, want in zip(*outs):
        assert got.shape == want.shape
        if reduces:
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-5 * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(), dict(resize=20, rand_crop=True, rand_mirror=True),
    dict(mean=True, std=True, brightness=0.2, contrast=0.2, saturation=0.2,
         pca_noise=0.1),
    dict(rand_resize=True, hue=0.1, rand_gray=0.1)])
def test_create_augmenter_lists_match(kw):
    got = [type(a).__name__ for a in timage.CreateAugmenter((3, 8, 8), **kw)]
    want = [type(a).__name__ for a in jimage.CreateAugmenter((3, 8, 8), **kw)]
    assert got == want
    got = [type(a).__name__ for a in timage.CreateDetAugmenter(
        (3, 8, 8), rand_crop=1, rand_mirror=True, mean=True)]
    assert got == [type(a).__name__ for a in jimage.CreateDetAugmenter(
        (3, 8, 8), rand_crop=1, rand_mirror=True, mean=True)]


# --- record iterators -------------------------------------------------------

def _rec(tmp_path, n=13, det=False, multi=False):
    rs = np.random.RandomState(1)
    path = str(tmp_path / ("det.rec" if det else "img.rec"))
    w = jrec.MXRecordIO(path, "w")
    for i in range(n):
        img = rs.randint(0, 256, (18 + i % 3, 22, 3)).astype(np.uint8)
        if det:
            k = 1 + i % 3
            boxes = []
            for _ in range(k):
                x0, y0 = rs.uniform(0, 0.5, 2)
                boxes += [float(rs.randint(0, 4)), x0, y0,
                          x0 + rs.uniform(0.2, 0.5), y0 + rs.uniform(0.2, 0.5)]
            label = np.asarray([2, 5] + boxes, np.float32)
        elif multi:
            label = np.asarray([i % 5, i % 3], np.float32)
        else:
            label = float(i % 5)
        w.write(jrec.pack(jrec.IRHeader(0, label, i, 0), _npy(img)))
    w.close()
    return path


def _drain(it, epochs=2):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        it.reset()
    return out


def _same_batches(got, want, atol=0.0):
    assert len(got) == len(want)
    for (d, l, p), (jd, jl, jp) in zip(got, want):
        assert d.shape == jd.shape and l.shape == jl.shape and p == jp
        np.testing.assert_allclose(d, jd, rtol=0, atol=atol)
        np.testing.assert_array_equal(l, jl)


MEAN_STD = dict(mean_r=123.68, mean_g=116.779, mean_b=103.939,
                std_r=58.393, std_g=57.12, std_b=57.375)


@pytest.mark.parametrize("kw,reduces", [
    (dict(shuffle=True, rand_crop=True, rand_mirror=True, **MEAN_STD),
     False),
    (dict(resize=16, round_batch=False), False),
    (dict(shuffle=True, seed=3, brightness=0.3, contrast=0.3,
          saturation=0.3, pca_noise=0.1, rand_mirror=True), True),
    (dict(label_width=2), False)])
def test_image_record_iter_matches_jax(tmp_path, kw, reduces):
    path = _rec(tmp_path, multi=kw.get("label_width") == 2)
    args = dict(path_imgrec=path, data_shape=(3, 14, 12), batch_size=4,
                preprocess_threads=1, **kw)
    _seed(7)
    got = _drain(mt.io.ImageRecordIter(**args))
    _seed(7)
    want = _drain(jmx.io.ImageRecordIter(**args))
    atol = 1e-5 * max(np.abs(w[0]).max() for w in want) if reduces else 0.0
    _same_batches(got, want, atol)
    assert [b[2] for b in got] == [0, 0, 0, 3] * 2
    it = mt.io.ImageRecordIter(**args)
    assert it.provide_data == jmx.io.ImageRecordIter(**args).provide_data
    assert it.provide_label[0].shape == \
        jmx.io.ImageRecordIter(**args).provide_label[0].shape


def test_image_iter_matches_jax(tmp_path):
    path = _rec(tmp_path)
    args = dict(batch_size=5, data_shape=(3, 12, 12), path_imgrec=path,
                shuffle=True)
    _seed(2)
    got = _drain(timage.ImageIter(**args))
    _seed(2)
    want = _drain(jimage.ImageIter(**args))
    _same_batches(got, want)
    assert got[-1][2] == 2


@pytest.mark.parametrize("kw", [dict(), dict(rand_crop=1, rand_mirror=True,
                                             mean_r=10.0, std_b=2.0)])
def test_image_det_record_iter_matches_jax(tmp_path, kw):
    path = _rec(tmp_path, det=True)
    args = dict(path_imgrec=path, data_shape=(3, 16, 16), batch_size=4,
                preprocess_threads=1, label_pad_width=2, **kw)
    _seed(5)
    got = _drain(mt.io.ImageDetRecordIter(**args))
    _seed(5)
    want = _drain(jmx.io.ImageDetRecordIter(**args))
    _same_batches(got, want)
    labels = got[-1][1]
    assert labels.shape[1:] == (3, 5) and (labels[1:] == -1).all()


# --- MNISTIter --------------------------------------------------------------

def _idx_files(tmp_path, n=37, gz=False):
    rs = np.random.RandomState(0)
    imgs = rs.randint(0, 256, (n, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, n).astype(np.uint8)
    opener = gzip.open if gz else open
    suffix = ".gz" if gz else ""
    img_path = tmp_path / "images-idx3-ubyte"
    lbl_path = tmp_path / "labels-idx1-ubyte"
    with opener(str(img_path) + suffix, "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28) + imgs.tobytes())
    with opener(str(lbl_path) + suffix, "wb") as f:
        f.write(struct.pack(">II", 2049, n) + labels.tobytes())
    return str(img_path), str(lbl_path)


@pytest.mark.parametrize("gz,flat,shuffle", [(False, False, True),
                                             (True, True, False),
                                             (False, True, True)])
def test_mnist_iter_matches_jax(tmp_path, gz, flat, shuffle):
    img, lbl = _idx_files(tmp_path, gz=gz)
    args = dict(image=img, label=lbl, batch_size=8, flat=flat,
                shuffle=shuffle, seed=4)
    got = _drain(mt.io.MNISTIter(**args))
    want = _drain(jmx.io.MNISTIter(**args))
    _same_batches(got, want)
    assert len(got) == 2 * (37 // 8)
    assert got[0][0].shape == ((8, 784) if flat else (8, 1, 28, 28))
    with pytest.raises(mt.MXNetError, match="not found"):
        mt.io.MNISTIter(image=str(tmp_path / "none"), label=lbl)
