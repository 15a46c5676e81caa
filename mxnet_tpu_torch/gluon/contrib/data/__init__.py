"""Contrib data utilities (ref: python/mxnet/gluon/contrib/data)."""
from .sampler import IntervalSampler

__all__ = ["IntervalSampler"]
