"""Contrib samplers (ref: python/mxnet/gluon/contrib/data/sampler.py)."""
from __future__ import annotations

from ...data.sampler import Sampler

__all__ = ["IntervalSampler"]


class IntervalSampler(Sampler):
    """Indices at a fixed interval: 0, k, 2k, ..., then (with
    ``rollover``) 1, k + 1, ... until every index is taken once."""

    def __init__(self, length, interval, rollover=True):
        assert interval <= length, \
            f"interval {interval} must be smaller than length {length}"
        self._length = length
        self._interval = interval
        self._rollover = rollover

    def __iter__(self):
        for i in range(self._interval if self._rollover else 1):
            for j in range(i, self._length, self._interval):
                yield j

    def __len__(self):
        if self._rollover:
            return self._length
        return len(range(0, self._length, self._interval))
