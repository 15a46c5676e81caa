"""Vision datasets (ref: python/mxnet/gluon/data/vision/datasets.py; the
JAX package's ``gluon/data/vision/datasets.py``).

Local files only: MNIST and FashionMNIST read the idx files (plain or
``.gz``), CIFAR10 / CIFAR100 the binary batches, from ``root`` (default
under ``$MXNET_HOME`` or ``~/.mxnet``); a missing file raises, nothing is
downloaded. Items are made on the current context, as in the JAX
package (a forked DataLoader worker's context is the host).
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from ....base import MXNetError, data_dir
from ....ndarray import array
from ..dataset import Dataset, RecordFileDataset

__all__ = ["MNIST", "FashionMNIST", "CIFAR10", "CIFAR100",
           "ImageRecordDataset", "SyntheticImageDataset"]


class _DownloadedDataset(Dataset):
    def __init__(self, root, transform):
        marker = os.path.join("~", ".mxnet")
        if root.startswith(marker):
            # default roots re-anchor onto $MXNET_HOME when it is set
            root = os.path.join(data_dir(), os.path.relpath(root, marker))
        self._root = os.path.expanduser(root)
        self._transform = transform
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        x = array(self._data[idx])
        y = self._label[idx]
        if self._transform is not None:
            return self._transform(x, y)
        return x, y

    def __len__(self):
        return len(self._label)


class MNIST(_DownloadedDataset):
    """The idx files ``{train,t10k}-{images-idx3,labels-idx1}-ubyte``:
    (28, 28, 1) uint8 images, int32 labels."""

    def __init__(self, root="~/.mxnet/datasets/mnist", train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _get_data(self):
        prefix = "train" if self._train else "t10k"
        img_path = os.path.join(self._root, f"{prefix}-images-idx3-ubyte")
        lbl_path = os.path.join(self._root, f"{prefix}-labels-idx1-ubyte")

        def _open(p):
            if os.path.exists(p):
                return open(p, "rb")
            if os.path.exists(p + ".gz"):
                return gzip.open(p + ".gz", "rb")
            raise MXNetError(
                f"MNIST file {p} not found (downloads disabled; place idx "
                "files locally or use SyntheticImageDataset)")

        with _open(lbl_path) as f:
            struct.unpack(">II", f.read(8))
            self._label = np.frombuffer(f.read(), dtype=np.uint8) \
                .astype(np.int32)
        with _open(img_path) as f:
            _, n, rows, cols = struct.unpack(">IIII", f.read(16))
            self._data = np.frombuffer(f.read(), dtype=np.uint8) \
                .reshape(n, rows, cols, 1)


class FashionMNIST(MNIST):
    def __init__(self, root="~/.mxnet/datasets/fashion-mnist", train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """The binary batches ``data_batch_{1..5}.bin`` / ``test_batch.bin``:
    (32, 32, 3) uint8 images, int32 labels."""

    def __init__(self, root="~/.mxnet/datasets/cifar10", train=True,
                 transform=None):
        self._train = train
        super().__init__(root, transform)

    def _file_list(self):
        if self._train:
            return [f"data_batch_{i}.bin" for i in range(1, 6)]
        return ["test_batch.bin"]

    def _read_batch(self, filename):
        if not os.path.exists(filename):
            raise MXNetError(f"CIFAR file {filename} not found "
                             "(downloads disabled)")
        with open(filename, "rb") as f:
            raw = np.frombuffer(f.read(), dtype=np.uint8)
        rec = raw.reshape(-1, 3073)
        return rec[:, 1:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            rec[:, 0].astype(np.int32)

    def _get_data(self):
        data, label = [], []
        for name in self._file_list():
            d, l = self._read_batch(os.path.join(self._root, name))
            data.append(d)
            label.append(l)
        self._data = np.concatenate(data)
        self._label = np.concatenate(label)


class CIFAR100(CIFAR10):
    """``train.bin`` / ``test.bin``; coarse labels unless
    ``fine_label``."""

    def __init__(self, root="~/.mxnet/datasets/cifar100", fine_label=False,
                 train=True, transform=None):
        self._fine = fine_label
        super().__init__(root, train, transform)

    def _file_list(self):
        return ["train.bin"] if self._train else ["test.bin"]

    def _read_batch(self, filename):
        if not os.path.exists(filename):
            raise MXNetError(f"CIFAR file {filename} not found")
        with open(filename, "rb") as f:
            raw = np.frombuffer(f.read(), dtype=np.uint8)
        rec = raw.reshape(-1, 3074)
        lbl_col = 1 if self._fine else 0
        return rec[:, 2:].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1), \
            rec[:, lbl_col].astype(np.int32)


class ImageRecordDataset(Dataset):
    """The images of a packed ``.rec`` (with its ``.idx``): (image, label)
    items, the label a float or, for a multi-value header, its array."""

    def __init__(self, filename, flag=1, transform=None):
        self._record = RecordFileDataset(filename)
        self._transform = transform

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        from ....recordio import unpack_img
        header, img = unpack_img(self._record[idx])
        x = array(img)
        label = header.label if header.flag else float(header.label)
        if self._transform is not None:
            return self._transform(x, label)
        return x, label


class SyntheticImageDataset(Dataset):
    """Deterministic synthetic images from ``seed`` (no reference
    analog): class centres plus noise, uint8."""

    def __init__(self, num_samples=1024, shape=(32, 32, 3), classes=10,
                 seed=0, transform=None):
        rs = np.random.RandomState(seed)
        self._label = rs.randint(0, classes, num_samples).astype(np.int32)
        centers = rs.rand(classes, *shape) * 255
        noise = rs.rand(num_samples, *shape) * 64
        self._data = np.clip(centers[self._label] + noise, 0,
                             255).astype(np.uint8)
        self._transform = transform

    def __len__(self):
        return len(self._label)

    def __getitem__(self, idx):
        x = array(self._data[idx])
        if self._transform is not None:
            return self._transform(x, self._label[idx])
        return x, self._label[idx]
