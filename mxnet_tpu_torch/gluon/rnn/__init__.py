"""Gluon recurrent layers and cells (ref: the JAX package's
``gluon/rnn/``; python/mxnet/gluon/rnn/)."""
from .rnn_cell import (BidirectionalCell, DropoutCell, GRUCell, LSTMCell,
                       RecurrentCell, ResidualCell, RNNCell,
                       SequentialRNNCell, ZoneoutCell)
from .rnn_layer import GRU, LSTM, RNN

__all__ = ["RecurrentCell", "RNNCell", "LSTMCell", "GRUCell",
           "SequentialRNNCell", "DropoutCell", "BidirectionalCell",
           "ResidualCell", "ZoneoutCell", "RNN", "LSTM", "GRU"]
