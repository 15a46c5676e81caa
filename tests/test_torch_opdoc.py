"""The generated ``mx.nd`` op functions' signatures and docstrings
(``ops/opdoc.py``, ROADMAP A22) against the JAX package's: for every
registry name the port has, ``mx.nd.op.<name>.__signature__`` equals the
JAX function's (array inputs positional, op parameters keyword-only with
their defaults, ``ctx`` for creation ops, ``out`` and ``name``), and the
numpydoc sections built from it (Parameters, Returns) are the same text.
"""
import inspect

import pytest

import mxnet_tpu as mx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg

# the graph-only ops (symbolic control flow, partitioned regions) are
# registered after the namespaces are filled in both packages: no mx.nd
# function has them
GRAPH_ONLY = {"_foreach", "_while_loop", "_cond", "_subgraph"}
NAMES = sorted(set(treg.list_ops()) & set(jreg.list_ops()) - GRAPH_ONLY)


def _sections(doc):
    return doc[doc.index("Parameters\n----------"):]


def test_every_ported_name_is_covered():
    assert NAMES == sorted(set(treg.list_ops()) - GRAPH_ONLY)
    assert GRAPH_ONLY <= set(treg.list_ops()) & set(jreg.list_ops())
    for name in GRAPH_ONLY:
        assert not hasattr(mx.nd.op, name) and not hasattr(mt.nd.op, name)


@pytest.mark.parametrize("name", NAMES)
def test_signature_and_doc_match_jax(name):
    t, j = getattr(mt.nd.op, name), getattr(mx.nd.op, name)
    assert t.__signature__ == j.__signature__
    assert str(inspect.signature(t)) == str(inspect.signature(j))
    assert _sections(t.__doc__) == _sections(j.__doc__)
