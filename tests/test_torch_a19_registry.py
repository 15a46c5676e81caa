"""The port's op registry and ``mx.nd`` namespaces against the JAX
package's, after the dense op families (ordering, random, linalg, the
contrib detection ops, the flash registry op and the misc / parity / index
names).

Every JAX registry name is in the port with the same ``num_outputs``,
``differentiable``, ``rng``, ``creation`` and ``variadic`` flags, except
exactly the names that later queues own (listed below by queue), and
``mx.nd.random`` / ``mx.nd.linalg`` / ``mx.nd.contrib`` hold the JAX
package's names less those.
"""
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import registry as treg

# the registry names still to port, by the ROADMAP queue that owns each
NOT_YET = {
    "A11": ["cast_storage", "sparse_retain", "_sparse_retain",
            "_contrib_getnnz", "_contrib_edge_id", "_contrib_dgl_adjacency",
            "_contrib_dgl_subgraph",
            "_contrib_dgl_csr_neighbor_uniform_sample",
            "_contrib_dgl_csr_neighbor_non_uniform_sample",
            "_contrib_dgl_graph_compact", "_sparse_adam_update",
            "_sparse_sgd_mom_update", "_sparse_sgd_update"],
    "A13": ["_contrib_dequantize", "_contrib_quantize",
            "_contrib_quantize_v2", "_contrib_quantized_concat",
            "_contrib_quantized_conv", "_contrib_quantized_flatten",
            "_contrib_quantized_fully_connected",
            "_contrib_quantized_pooling", "_contrib_requantize",
            "_quantize_static", "_quantized_conv_v2", "_quantized_dense_v2",
            "_quantized_fc_static", "dequantize", "quantize", "quantize_v2",
            "quantized_concat", "quantized_conv", "quantized_flatten",
            "quantized_fully_connected", "quantized_pooling", "requantize"],
    "A14": ["CTCLoss", "_contrib_CTCLoss", "_contrib_ctc_loss", "ctc_loss",
            "RNN", "_rnn_state_zeros", "_state_zeros",
            "Correlation", "DeformableConvolution",
            "_contrib_DeformableConvolution", "_contrib_count_sketch",
            "_contrib_fft", "_contrib_ifft", "count_sketch", "fft", "ifft",
            "DeformablePSROIPooling", "_contrib_DeformablePSROIPooling",
            "MultiProposal", "_contrib_MultiProposal", "PSROIPooling",
            "_contrib_PSROIPooling", "Proposal", "_contrib_Proposal",
            "_contrib_bipartite_matching", "bipartite_matching",
            "Custom", "_subgraph", "_cond", "_foreach", "_while_loop"],
    "A20": ["_image_adjust_lighting", "_image_flip_left_right",
            "_image_flip_top_bottom", "_image_normalize",
            "_image_random_brightness", "_image_random_color_jitter",
            "_image_random_contrast", "_image_random_flip_left_right",
            "_image_random_flip_top_bottom", "_image_random_hue",
            "_image_random_lighting", "_image_random_saturation",
            "_image_resize", "_image_to_tensor"],
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
    assert len(MISSING) == 80
    assert set(jreg.list_ops()) - set(treg.list_ops()) == MISSING
    assert not set(treg.list_ops()) - set(jreg.list_ops())
    assert len(treg.list_ops()) == 416


def test_the_a19_names_are_ported():
    names = _a19_names()
    assert len(names) == 153
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
        assert _nout(t, params) == _nout(j, params), params


def _names(mod):
    return {n for n in vars(mod) if not n.startswith("__")}


def _stripped(prefix):
    return {n[len(prefix):] for n in MISSING if n.startswith(prefix)}


@pytest.mark.parametrize("ns,missing", [
    ("random", set()), ("linalg", set()),
    ("contrib", _stripped("_contrib_") | {"cond", "foreach", "while_loop"})])
def test_namespaces_match_jax_less_the_later_queues(ns, missing):
    jnames = _names(getattr(jmx.nd, ns))
    tnames = _names(getattr(mt.nd, ns)) - {"__getattr__"}
    assert missing <= jnames
    assert tnames == jnames - missing


def test_namespace_functions_reach_the_same_ops_as_jax():
    """Where a ``_random_`` and a ``_sample_`` op strip to one name, the
    ``_sample_`` op holds it in both packages (the registry's sorted
    order)."""
    for ns in ("random", "linalg", "contrib"):
        jmod, tmod = getattr(jmx.nd, ns), getattr(mt.nd, ns)
        for name in _names(tmod) - {"__getattr__"}:
            assert getattr(tmod, name).__name__ == \
                getattr(jmod, name).__name__, (ns, name)
    assert mt.nd.contrib.flash_attention.__name__ == \
        "_contrib_flash_attention"
    with pytest.raises(treg.NotPortedError, match="not ported yet"):
        mt.nd.contrib.quantize
