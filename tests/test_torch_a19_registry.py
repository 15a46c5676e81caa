"""The port's op registry and ``mx.nd`` namespaces against the JAX
package's, after the dense op families (ordering, random, linalg, the
contrib detection ops, the flash registry op and the misc / parity / index
names).

Every JAX registry name is in the port with the same ``num_outputs``,
``differentiable``, ``rng``, ``creation`` and ``variadic`` flags, except
exactly the names that later queues own (listed below by queue; the
13 sparse names of A11 came with the sparse slice, the 22 quantization
names of A13 with the int8 slice, the RNN op's three and the CTC op's
four with the recurrent stack, ``Custom`` and the four graph ops ``_foreach``,
``_while_loop``, ``_cond`` and ``_subgraph`` with the symbolic training
surface), and
``mx.nd.random`` / ``mx.nd.linalg`` / ``mx.nd.contrib`` / ``mx.nd.image``
hold the JAX package's names less those (the 14 ``_image_*`` names came
with the input pipeline).
"""
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg

# the registry names still to port, by the ROADMAP queue that owns each
NOT_YET = {
    "A14": ["Correlation", "DeformableConvolution",
            "_contrib_DeformableConvolution", "_contrib_count_sketch",
            "_contrib_fft", "_contrib_ifft", "count_sketch", "fft", "ifft",
            "DeformablePSROIPooling", "_contrib_DeformablePSROIPooling",
            "MultiProposal", "_contrib_MultiProposal", "PSROIPooling",
            "_contrib_PSROIPooling", "Proposal", "_contrib_Proposal",
            "_contrib_bipartite_matching", "bipartite_matching"],
}
MISSING = {n for names in NOT_YET.values() for n in names}
# the JAX modules of the dense op families and the aliases this slice ports
A19_MODULES = ("mxnet_tpu.ops.contrib_ops", "mxnet_tpu.ops.linalg",
               "mxnet_tpu.ops.random_ops", "mxnet_tpu.ops.ordering",
               "mxnet_tpu.ops.parity_ops", "mxnet_tpu.ops.misc_ops")
A19_EXTRA = {"_contrib_flash_attention", "flash_attention",
             "_contrib_interleaved_matmul_selfatt_qk",
             "_contrib_interleaved_matmul_selfatt_valatt", "_index",
             "_index_assign", "_index_assign_scalar", "BatchNorm_v1",
             "Convolution_v1", "Pooling_v1", "_contrib_SparseEmbedding"}
FLAGS = ("differentiable", "rng", "creation", "variadic")


def _a19_names():
    out = set(A19_EXTRA)
    for n in jreg.list_ops():
        if jreg.get_op(n).fn.__module__ in A19_MODULES:
            out.add(n)
    # _split_v2 (misc_ops.py) came with the port's ops/matrix.py
    return out - MISSING - {"_split_v2"}


def test_the_missing_names_are_exactly_the_later_queues():
    assert len(MISSING) == 19
    assert set(jreg.list_ops()) - set(treg.list_ops()) == MISSING
    assert not set(treg.list_ops()) - set(jreg.list_ops())
    assert len(treg.list_ops()) == 477


def test_the_a19_names_are_ported():
    names = _a19_names()
    assert len(names) == 163
    assert names <= set(treg.list_ops())


def _nout(opdef, params):
    n = opdef.num_outputs
    return n(1, params) if callable(n) else n


@pytest.mark.parametrize("name", sorted(set(jreg.list_ops()) - MISSING))
def test_flags_match_jax(name):
    j, t = jreg.get_op(name), treg.get_op(name)
    for flag in FLAGS:
        assert getattr(t, flag) == getattr(j, flag), flag
    assert callable(t.num_outputs) == callable(j.num_outputs)
    for params in ({}, {"ret_typ": "both"}, {"sections": 3},
                   {"num_outputs": 2}):
        try:
            want = _nout(j, params)
        except Exception as e:  # noqa: BLE001 - the port must fail alike
            # Custom needs an op_type, _subgraph its sub-Symbol
            with pytest.raises(Exception) as got:
                _nout(t, params)
            assert type(got.value).__name__ == type(e).__name__
            continue
        assert _nout(t, params) == want, params


def _names(mod):
    return {n for n in vars(mod) if not n.startswith("__")}


def _stripped(prefix):
    return {n[len(prefix):] for n in MISSING if n.startswith(prefix)}


@pytest.mark.parametrize("ns,missing", [
    ("random", set()), ("linalg", set()), ("image", set()),
    ("contrib", _stripped("_contrib_"))])
def test_namespaces_match_jax_less_the_later_queues(ns, missing):
    jnames = _names(getattr(jmx.nd, ns))
    tnames = _names(getattr(mt.nd, ns)) - {"__getattr__"}
    assert missing <= jnames
    assert tnames == jnames - missing


def test_namespace_functions_reach_the_same_ops_as_jax():
    """Where a ``_random_`` and a ``_sample_`` op strip to one name, the
    ``_sample_`` op holds it in both packages (the registry's sorted
    order)."""
    for ns in ("random", "linalg", "contrib", "image"):
        jmod, tmod = getattr(jmx.nd, ns), getattr(mt.nd, ns)
        for name in _names(tmod) - {"__getattr__"}:
            assert getattr(tmod, name).__name__ == \
                getattr(jmod, name).__name__, (ns, name)
    assert mt.nd.contrib.flash_attention.__name__ == \
        "_contrib_flash_attention"
    # the quantization names came with the int8 slice, the control flow
    # with the symbolic training surface; the rest of contrib is still to
    # port
    assert mt.nd.contrib.quantize.__name__ == "_contrib_quantize"
    assert mt.nd.contrib.foreach.__module__ == \
        "mxnet_tpu_torch.contrib.control_flow"
    with pytest.raises(treg.NotPortedError, match="not ported yet"):
        mt.nd.contrib.fft
