"""ImageRecordIter and ImageDetRecordIter (ref:
src/io/iter_image_recordio_2.cc, src/io/iter_image_det_recordio.cc; the
JAX package's ``io/image_record.py``).

Records come through ``record_io.RecordPipeline`` (sharded by
``part_index`` / ``num_parts``, shuffled by ``seed``), are decoded and
augmented by ``image.decode_and_augment`` on a pool of
``preprocess_threads`` threads, and are assembled into static-shape
batches. Each decode thread runs the augmenters under ``mx.cpu()``: the
per-image work is host work by construction (it hands back numpy), so it
does not take a round trip to the card per image per op. This is an
explicit placement, not a fallback. The assembled batch goes to the
current context of the thread that calls ``next()`` (the card unless it
says ``with mx.cpu():``).

The JAX iterator prefetches the next batch through its native engine;
here the next batch's decodes are submitted to the same pool when a batch
is handed out, so they run while the caller trains. Batches and their
order are the same either way; ``reset()`` waits for a prefetched batch
to finish before it drops it, as the JAX iterator does, so the augmenters
draw the same random numbers in both.

``LibSVMIter`` parses libsvm text into flat CSR arrays on the host and
yields ``CSRNDArray`` data batches (values on the current context, the
coordinates cached on the host), as the JAX iterator does.
"""
from __future__ import annotations

import concurrent.futures as _futures
import inspect
import logging
from typing import List

import numpy as _np

from ..base import MXNetError, check
from ..context import cpu, current_context
from ..ndarray import ndarray as _nd
from .io import DataBatch, DataDesc, DataIter

__all__ = ["ImageRecordIter", "ImageDetRecordIter", "LibSVMIter"]

_LOG = logging.getLogger("mxnet_tpu_torch")
# IO / speed knobs of the reference that change no data
_INERT = {"shuffle_chunk_size", "shuffle_chunk_seed", "verbose",
          "num_decode_threads", "prefetch_buffer"}


def _channel_stats(kwargs):
    """Pop mean_r/g/b and std_r/g/b (and the alpha channel's); the arrays
    when any differs from 0 / 1, else None."""
    mean = [kwargs.pop(k, 0.0) for k in ("mean_r", "mean_g", "mean_b")]
    std = [kwargs.pop(k, 1.0) for k in ("std_r", "std_g", "std_b")]
    kwargs.pop("mean_a", None)
    kwargs.pop("std_a", None)
    if any(m != 0.0 for m in mean) or any(v != 1.0 for v in std):
        return _np.asarray(mean, _np.float32), _np.asarray(std, _np.float32)
    return None


class ImageRecordIter(DataIter):
    """Classification batches from a RecordIO file (ref: ImageRecordIter).

    Augmentation kwargs go to ``image.CreateAugmenter`` (``resize``,
    ``rand_crop``, ``rand_mirror``, ``mean_*`` / ``std_*`` ...); others
    the reference accepts are logged and ignored, as in the JAX package.
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 preprocess_threads=4, label_width=1, round_batch=True,
                 data_name="data", label_name="softmax_label",
                 seed=0, **aug_kwargs):
        super().__init__(batch_size)
        check(len(data_shape) == 3, "data_shape must be (C, H, W)")
        self.data_shape = tuple(int(d) for d in data_shape)
        self.label_width = int(label_width)
        self._data_name = data_name
        self._label_name = label_name
        from ..image import CreateAugmenter
        aug = dict(aug_kwargs)
        stats = _channel_stats(aug)
        if stats is not None:
            aug["mean"], aug["std"] = stats
        known = set(inspect.signature(CreateAugmenter).parameters)
        dropped = sorted(k for k in aug if k not in known and k not in _INERT)
        if dropped:
            _LOG.warning("ImageRecordIter: ignoring unimplemented "
                         "augmentation kwargs %s", dropped)
        self.auglist = CreateAugmenter(
            self.data_shape, **{k: v for k, v in aug.items() if k in known})
        from .record_io import RecordPipeline
        self._pipe = RecordPipeline(path_imgrec,
                                    num_threads=int(preprocess_threads),
                                    part_index=int(part_index),
                                    num_parts=int(num_parts),
                                    shuffle=bool(shuffle), seed=int(seed))
        self._pool = _futures.ThreadPoolExecutor(
            max_workers=int(preprocess_threads), thread_name_prefix="decode")
        self._round_batch = round_batch
        self._pending = None     # the prefetched batch: (recs, futures)

    def close(self):
        self._drop_pending()
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        if self._pipe is not None:
            self._pipe.close()
            self._pipe = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self.label_width == 1 \
            else (self.batch_size, self.label_width)
        return [DataDesc(self._label_name, shape)]

    def _drop_pending(self):
        """Let a prefetched batch finish (its augmenters' draws are
        part of the stream), then drop it."""
        if self._pending is not None:
            _futures.wait(self._pending[1])
            self._pending = None

    def reset(self):
        self._drop_pending()
        self._pipe.reset()

    def _decode_one(self, rec):
        from ..image import decode_and_augment
        with cpu():
            arr, label = decode_and_augment(rec, self.auglist)
        return arr, _np.atleast_1d(label)

    def _read_records(self) -> List[bytes]:
        recs = []
        while len(recs) < self.batch_size:
            rec = self._pipe.next()
            if rec is None:
                break
            recs.append(rec)
        return recs

    def _schedule(self):
        recs = self._read_records()
        self._pending = (recs, [self._pool.submit(self._decode_one, r)
                                for r in recs])

    def _take(self):
        """The prefetched batch's (records, decoded items); the next
        batch's decodes are submitted before it is returned."""
        if self._pending is None:
            self._schedule()
        recs, futs = self._pending
        self._pending = None
        if not recs:
            raise StopIteration
        decoded = [f.result() for f in futs]
        self._schedule()
        return recs, decoded

    def _assemble(self, recs, decoded):
        c, h, w = self.data_shape
        batch = _np.zeros((self.batch_size, c, h, w), _np.float32)
        labels = _np.zeros((self.batch_size, self.label_width), _np.float32)
        for i, (arr, label) in enumerate(decoded):
            batch[i] = arr
            labels[i, :] = label[:self.label_width]
        pad = self.batch_size - len(recs)
        if pad and self._round_batch:
            for i in range(len(recs), self.batch_size):
                batch[i] = batch[i % len(recs)]
                labels[i] = labels[i % len(recs)]
        lab = labels[:, 0] if self.label_width == 1 else labels
        ctx = current_context()
        return DataBatch([_nd.array(batch, ctx=ctx)],
                         [_nd.array(lab, ctx=ctx)], pad=pad)

    def next(self):
        return self._assemble(*self._take())


class ImageDetRecordIter(ImageRecordIter):
    """Detection batches (ref: iter_image_det_recordio.cc). A record's
    label is ``[header_width, obj_width, <header>, obj0..., obj1...]``;
    the batch's label is (batch, max_objs, obj_width), padded with
    ``label_pad_value``; ``max_objs`` only grows. It decodes on demand
    (no prefetch), as the JAX iterator does. Geometric augmentation
    moves the boxes with the image (``image.CreateDetAugmenter``)."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 label_pad_width=0, label_pad_value=-1.0, **kwargs):
        kwargs.setdefault("label_name", "label")
        kwargs.pop("label_width", None)
        from ..image import CreateDetAugmenter
        det_known = set(inspect.signature(CreateDetAugmenter).parameters)
        det_kwargs = {k: kwargs.pop(k) for k in list(kwargs)
                      if k in det_known and k != "data_shape"}
        stats = _channel_stats(kwargs)
        if stats is not None:
            det_kwargs["mean"], det_kwargs["std"] = stats
        unimpl = [k for k in ("rand_resize", "max_rotate_angle",
                              "max_aspect_ratio", "max_shear_ratio",
                              "rand_pad") if kwargs.pop(k, None)]
        if unimpl:
            _LOG.warning("ImageDetRecordIter: geometric augmenters %s are "
                         "not implemented for detection and are IGNORED",
                         unimpl)
        super().__init__(path_imgrec, data_shape, batch_size,
                         label_width=1, **kwargs)
        self.auglist = []
        self.det_auglist = CreateDetAugmenter(self.data_shape, **det_kwargs)
        self._label_pad_width = int(label_pad_width)
        self._label_pad_value = float(label_pad_value)
        self._max_objs = max(self._label_pad_width, 1)

    @property
    def provide_label(self):
        return None     # known once the first batch is read

    @staticmethod
    def _parse_det_label(flat):
        flat = _np.asarray(flat, _np.float32).reshape(-1)
        check(flat.size >= 2, "detection label must start with "
              "[header_width, obj_width]")
        header_width = int(flat[0])
        obj_width = int(flat[1])
        check(obj_width > 0, "detection obj_width must be > 0")
        body = flat[header_width:]
        n_obj = body.size // obj_width
        return body[:n_obj * obj_width].reshape(n_obj, obj_width), obj_width

    def _decode_one_det(self, rec):
        from ..image import to_chw
        from ..recordio import unpack_img
        header, img = unpack_img(rec)
        boxes, obj_width = self._parse_det_label(header.label)
        with cpu():
            src = _nd.array(img.astype(_np.float32))
            for aug in self.det_auglist:
                src, boxes = aug(src, boxes)
            return to_chw(src), boxes, obj_width

    def next(self):
        # no prefetch here: the JAX detection iterator decodes on demand
        recs = self._read_records()
        if not recs:
            raise StopIteration
        decoded = self._pool.map(self._decode_one_det, recs)
        c, h, w = self.data_shape
        batch = _np.zeros((self.batch_size, c, h, w), _np.float32)
        det_labels = []
        widths = set()
        for i, (arr, parsed, ow) in enumerate(decoded):
            batch[i] = arr
            det_labels.append(parsed)
            widths.add(ow)
        check(len(widths) == 1,
              f"inconsistent detection obj_width across records: {widths}")
        obj_width = widths.pop()
        self._max_objs = max(self._max_objs,
                             max((l.shape[0] for l in det_labels),
                                 default=1))
        out = _np.full((self.batch_size, self._max_objs, obj_width),
                       self._label_pad_value, _np.float32)
        for i, l in enumerate(det_labels):
            if l.size:
                out[i, :l.shape[0], :] = l
        ctx = current_context()
        return DataBatch([_nd.array(batch, ctx=ctx)],
                         [_nd.array(out, ctx=ctx)],
                         pad=self.batch_size - len(recs))


class LibSVMIter(DataIter):
    """Sparse batches from libsvm text (ref: iter_libsvm.cc; the JAX
    package's ``io/image_record.py`` LibSVMIter):
    ``label idx:val idx:val ...`` per line -> CSRNDArray data batches.

    `data_shape` is the feature-vector length; indices beyond it raise.
    Labels may come from a separate `label_libsvm` file (multi-label rows
    supported via `label_shape`).
    """

    def __init__(self, data_libsvm, data_shape, batch_size,
                 label_libsvm=None, label_shape=None, part_index=0,
                 num_parts=1, data_name="data", label_name="softmax_label"):
        super().__init__(batch_size)
        if isinstance(data_shape, (tuple, list)):
            check(len(data_shape) == 1, "LibSVMIter data_shape must be 1-d")
            data_shape = data_shape[0]
        self._dim = int(data_shape)
        self._data_name = data_name
        self._label_name = label_name
        values, indices, indptr, labels = self._parse(data_libsvm)
        if label_libsvm is not None:
            labels = self._parse_label_file(label_libsvm)
            check(len(labels) == len(indptr) - 1,
                  f"label_libsvm has {len(labels)} rows, data has "
                  f"{len(indptr) - 1}")
        self._label_width = 1
        if label_shape is not None:
            self._label_width = int(label_shape[0] if
                                    isinstance(label_shape, (tuple, list))
                                    else label_shape)
        check(int(num_parts) >= 1 and 0 <= int(part_index) < int(num_parts),
              "bad part_index/num_parts")
        if int(num_parts) == 1:
            self._values = values
            self._indices = indices
            self._indptr = _np.asarray(indptr, _np.int64)
            self._labels = labels
        else:
            # keep only this part's rows (compact flat-CSR storage)
            keep = list(range(int(part_index), len(indptr) - 1,
                              int(num_parts)))
            vs, ins, ptr = [], [], [0]
            for r in keep:
                lo, hi = indptr[r], indptr[r + 1]
                vs.append(values[lo:hi])
                ins.append(indices[lo:hi])
                ptr.append(ptr[-1] + (hi - lo))
            self._values = _np.concatenate(vs) if vs else \
                _np.zeros((0,), _np.float32)
            self._indices = _np.concatenate(ins) if ins else \
                _np.zeros((0,), _np.int64)
            self._indptr = _np.asarray(ptr, _np.int64)
            self._labels = [labels[r] for r in keep]
        self._cursor = 0

    @staticmethod
    def _parse_label_file(path):
        """Each line is one row of (possibly multiple) label floats."""
        labels = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if parts:
                    labels.append([float(p) for p in parts])
        return labels

    def _parse(self, path):
        """Stream the file into flat CSR arrays (compact: one numpy
        value/index per nonzero, not per-row Python objects)."""
        values, indices, indptr, labels = [], [], [0], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append([float(parts[0])])
                feats = []
                for tok in parts[1:]:
                    idx_s, _, val_s = tok.partition(":")
                    idx = int(idx_s)
                    if idx >= self._dim:
                        raise MXNetError(
                            f"libsvm feature index {idx} >= data_shape "
                            f"{self._dim}")
                    feats.append((idx, float(val_s)))
                feats.sort()
                indices.extend(i for i, _ in feats)
                values.extend(v for _, v in feats)
                indptr.append(len(indices))
        return (_np.asarray(values, _np.float32),
                _np.asarray(indices, _np.int64), indptr, labels)

    @property
    def provide_data(self):
        return [DataDesc(self._data_name, (self.batch_size, self._dim))]

    @property
    def provide_label(self):
        shape = (self.batch_size,) if self._label_width == 1 \
            else (self.batch_size, self._label_width)
        return [DataDesc(self._label_name, shape)]

    def reset(self):
        self._cursor = 0

    def __len__(self):
        return len(self._indptr) - 1

    def next(self):
        n_rows = len(self._indptr) - 1
        if self._cursor >= n_rows:
            raise StopIteration
        lo_row = self._cursor
        hi_row = min(lo_row + self.batch_size, n_rows)
        labs = self._labels[lo_row:hi_row]
        self._cursor = hi_row
        pad = self.batch_size - (hi_row - lo_row)
        lo, hi = self._indptr[lo_row], self._indptr[hi_row]
        indptr = self._indptr[lo_row:hi_row + 1] - lo
        if pad:
            indptr = _np.concatenate(
                [indptr, _np.full((pad,), indptr[-1], _np.int64)])
        from ..ndarray import sparse as _sp
        ctx = current_context()
        data = _sp.csr_matrix(
            (self._values[lo:hi], self._indices[lo:hi], indptr),
            shape=(self.batch_size, self._dim), ctx=ctx)
        labels = _np.zeros((self.batch_size, self._label_width),
                           _np.float32)
        for i, row in enumerate(labs):
            labels[i, :min(len(row), self._label_width)] = \
                row[:self._label_width]
        lab = labels[:, 0] if self._label_width == 1 else labels
        return DataBatch([data], [_nd.array(lab, ctx=ctx)], pad=pad)
