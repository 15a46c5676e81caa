"""Gluon vision data (ref: python/mxnet/gluon/data/vision/__init__.py)."""
from .datasets import (MNIST, FashionMNIST, CIFAR10, CIFAR100,  # noqa
                       ImageRecordDataset, SyntheticImageDataset)
from . import transforms  # noqa: F401
