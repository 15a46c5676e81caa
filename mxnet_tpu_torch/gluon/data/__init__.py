"""Gluon data API (ref: python/mxnet/gluon/data/__init__.py; the JAX
package's ``gluon/data/``)."""
from .dataset import (Dataset, SimpleDataset, ArrayDataset,  # noqa
                      RecordFileDataset)
from .sampler import (Sampler, SequentialSampler, RandomSampler,  # noqa
                      BatchSampler)
from .dataloader import DataLoader  # noqa: F401
from . import vision  # noqa: F401
