"""``mx.rnn``, the symbol-era RNN cells and ``BucketSentenceIter`` (ref:
the JAX package's ``rnn/``; python/mxnet/rnn/). The modern API is
``gluon.rnn``; ``BucketSentenceIter`` feeds ``mx.mod.BucketingModule``."""
from .rnn_cell import (BaseRNNCell, RNNCell, LSTMCell, GRUCell,  # noqa
                       FusedRNNCell, SequentialRNNCell, BidirectionalCell,
                       DropoutCell, ZoneoutCell, ResidualCell)
from .io import BucketSentenceIter, encode_sentences  # noqa: F401
