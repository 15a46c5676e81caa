"""Samplers (ref: python/mxnet/gluon/data/sampler.py; the JAX package's
``gluon/data/sampler.py``). ``RandomSampler`` draws its permutation from
``numpy.random``, as the JAX one does, so both packages shuffle alike
under one numpy seed."""
from __future__ import annotations

import numpy as np

from ...base import check

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class SequentialSampler(Sampler):
    def __init__(self, length, start=0):
        self._length = length
        self._start = start

    def __iter__(self):
        return iter(range(self._start, self._start + self._length))

    def __len__(self):
        return self._length


class RandomSampler(Sampler):
    def __init__(self, length):
        self._length = length

    def __iter__(self):
        return iter(np.random.permutation(self._length).tolist())

    def __len__(self):
        return self._length


class BatchSampler(Sampler):
    """Batches of indices; ``last_batch`` is keep, discard or rollover (the
    remainder opens the next epoch)."""

    def __init__(self, sampler, batch_size, last_batch="keep"):
        check(last_batch in ("keep", "discard", "rollover"),
              f"invalid last_batch {last_batch}")
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._prev = []

    def __iter__(self):
        batch, self._prev = self._prev, []
        for i in self._sampler:
            batch.append(i)
            if len(batch) == self._batch_size:
                yield batch
                batch = []
        if batch:
            if self._last_batch == "keep":
                yield batch
            elif self._last_batch == "rollover":
                self._prev = batch

    def __len__(self):
        n = len(self._sampler) + len(self._prev)
        if self._last_batch == "discard":
            return n // self._batch_size
        return (n + self._batch_size - 1) // self._batch_size
