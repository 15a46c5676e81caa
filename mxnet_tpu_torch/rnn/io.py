"""Bucketed sequence iterators (ref: the JAX package's ``rnn/io.py``;
python/mxnet/rnn/io.py BucketSentenceIter and encode_sentences). The
batches are NDArrays on the current context; ``reset`` shuffles with
Python's and numpy's global generators, as the JAX package does."""
from __future__ import annotations

import random as _pyrandom

import numpy as _np

from ..base import check
from ..io.io import DataIter, DataBatch, DataDesc
from ..ndarray import ndarray as _nd

__all__ = ["BucketSentenceIter", "encode_sentences"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Map token sequences to int ids, building a vocab
    (ref: rnn/io.py encode_sentences)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    check(unknown_token is not None,
                          f"unknown token {word!r} with fixed vocab")
                    word = unknown_token
                    if word not in vocab:
                        vocab[word] = idx
                        idx += 1
                else:
                    if idx == invalid_label:
                        idx += 1
                    vocab[word] = idx
                    idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Length-bucketed sentence iterator (ref: rnn/io.py BucketSentenceIter
    — the workhorse of example/rnn/bucketing)."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32",
                 layout="NT"):
        super().__init__(batch_size)
        if not buckets:
            lengths = [len(s) for s in sentences]
            maxlen = max(lengths)
            buckets = [b for b in [10, 20, 30, 40, 50, 60, maxlen]
                       if b <= maxlen]
            buckets = sorted(set(buckets))
        buckets = sorted(buckets)
        self.data = [[] for _ in buckets]
        ndiscard = 0
        for sent in sentences:
            buck = next((i for i, b in enumerate(buckets)
                         if b >= len(sent)), None)
            if buck is None:
                ndiscard += 1
                continue
            buf = _np.full((buckets[buck],), invalid_label, _np.float32)
            buf[:len(sent)] = sent
            self.data[buck].append(buf)
        self.data = [_np.asarray(x) for x in self.data]
        self.buckets = buckets
        self.invalid_label = invalid_label
        self.data_name = data_name
        self.label_name = label_name
        self.layout = layout
        self.default_bucket_key = max(buckets)
        self.idx = []
        for i, buck in enumerate(self.data):
            for j in range(0, len(buck) - batch_size + 1, batch_size):
                self.idx.append((i, j))
        self.curr_idx = 0
        self.reset()

    @property
    def provide_data(self):
        shape = (self.batch_size, self.default_bucket_key) \
            if self.layout == "NT" else (self.default_bucket_key,
                                         self.batch_size)
        return [DataDesc(self.data_name, shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size, self.default_bucket_key) \
            if self.layout == "NT" else (self.default_bucket_key,
                                         self.batch_size)
        return [DataDesc(self.label_name, shape)]

    def reset(self):
        self.curr_idx = 0
        _pyrandom.shuffle(self.idx)
        for buck in self.data:
            _np.random.shuffle(buck)

    def next(self) -> DataBatch:
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        buck = self.data[i]
        data = buck[j:j + self.batch_size]
        label = _np.full_like(data, self.invalid_label)
        label[:, :-1] = data[:, 1:]
        if self.layout == "TN":
            data = data.T
            label = label.T
        return DataBatch([_nd.array(data)], [_nd.array(label)],
                         bucket_key=self.buckets[i],
                         provide_data=[DataDesc(self.data_name, data.shape)],
                         provide_label=[DataDesc(self.label_name,
                                                 label.shape)])
