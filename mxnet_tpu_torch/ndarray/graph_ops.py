"""DGL graph-sampling operators over CSR adjacency matrices (ref: the JAX
package's ``ndarray/graph_ops.py``).

Reference: src/operator/contrib/dgl_graph.cc (_contrib_dgl_adjacency:1391,
_contrib_edge_id:1315, _contrib_dgl_subgraph:1130,
_contrib_dgl_csr_neighbor_uniform_sample:759 /
_non_uniform_sample:853, _contrib_dgl_graph_compact:1565).

These are host-side graph algorithms in the reference too (CPU-only
FComputeEx over csr storage); here they run on numpy views of the
CSRNDArray containers (the csr's coordinates are on the host already, its
values are read back once), and their results are arrays on the input's
device. The samplers draw from ``mx.random.np_rng()``, so
``mx.random.seed()`` repeats a sample.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as _np

from ..base import MXNetError, check
from . import ndarray as _nd
from .sparse import CSRNDArray, csr_matrix


def _csr_np(csr: CSRNDArray):
    check(isinstance(csr, CSRNDArray), "expected a csr NDArray")
    return (csr.data.asnumpy(), csr._indices_np.astype(_np.int64),
            csr._indptr_np.astype(_np.int64), csr.shape)


def _ctx(x):
    return getattr(x, "context", None)


def edge_id(data, u, v):
    """out[i] = data[u[i], v[i]], or -1 when the edge is absent
    (ref: dgl_graph.cc:1315 _contrib_edge_id). Keeps the csr value dtype
    (edge ids are int64 — a float32 result would corrupt ids > 2^24)."""
    vals, indices, indptr, _ = _csr_np(data)
    uu = u.asnumpy().astype(_np.int64).reshape(-1)
    vv = v.asnumpy().astype(_np.int64).reshape(-1)
    out = _np.full(uu.shape, -1, vals.dtype)
    for i, (r, c) in enumerate(zip(uu, vv)):
        row = indices[indptr[r]:indptr[r + 1]]
        hit = _np.where(row == c)[0]
        if hit.size:
            out[i] = vals[indptr[r] + hit[0]]
    return _nd.array(out, ctx=_ctx(data), dtype=vals.dtype)


def dgl_adjacency(data):
    """CSR of edge ids -> adjacency with float32 ones
    (ref: dgl_graph.cc:1391 _contrib_dgl_adjacency)."""
    vals, indices, indptr, shape = _csr_np(data)
    return csr_matrix((_np.ones(vals.shape, _np.float32), indices, indptr),
                      shape=shape, ctx=_ctx(data))


def dgl_subgraph(graph, *vertex_arrays, return_mapping=False, **_):
    """Induced subgraph per vertex set; new edge ids are 1-based in
    row-major order, mapping output carries parent edge ids
    (ref: dgl_graph.cc:1130 _contrib_dgl_subgraph).

    Deviation note: the reference is internally inconsistent here — its
    docstring example shows 1-based new edge ids while the executed kernel
    GetSubgraph writes 0-based ids (dgl_graph.cc:1099-1100
    ``sub_eids[i] = i``). We follow the documented 1-based convention; code
    indexing edge-feature arrays by these ids must subtract 1 to match the
    reference kernel's actual output."""
    vals, indices, indptr, _ = _csr_np(graph)
    outs: List = []
    mappings: List = []
    for varr in vertex_arrays:
        vids = varr.asnumpy().astype(_np.int64).reshape(-1)
        n = len(vids)
        pos = {int(v): i for i, v in enumerate(vids)}
        sub_indptr = [0]
        sub_indices: List[int] = []
        sub_parent: List[float] = []
        for v in vids:
            row_cols = indices[indptr[v]:indptr[v + 1]]
            row_vals = vals[indptr[v]:indptr[v + 1]]
            cols = [(pos[int(c)], val) for c, val in zip(row_cols, row_vals)
                    if int(c) in pos]
            cols.sort()
            sub_indices.extend(c for c, _v in cols)
            sub_parent.extend(_v for _c, _v in cols)
            sub_indptr.append(len(sub_indices))
        new_ids = _np.arange(1, len(sub_indices) + 1, dtype=vals.dtype)
        ii = _np.asarray(sub_indices, _np.int64)
        pp = _np.asarray(sub_indptr, _np.int64)
        outs.append(csr_matrix((new_ids, ii, pp), shape=(n, n),
                               dtype=vals.dtype, ctx=_ctx(graph)))
        mappings.append(csr_matrix(
            (_np.asarray(sub_parent, vals.dtype), ii, pp), shape=(n, n),
            dtype=vals.dtype, ctx=_ctx(graph)))
    result = outs + mappings if return_mapping else outs
    return result[0] if len(result) == 1 else tuple(result)


def _neighbor_sample(graph, seed_arrays, num_hops, num_neighbor,
                     max_num_vertices, probability=None):
    """Shared BFS sampler (ref: dgl_graph.cc SampleSubgraph)."""
    vals, indices, indptr, shape = _csr_np(graph)
    ctx = _ctx(graph)
    check(max_num_vertices >= 1, "max_num_vertices must be positive")
    prob = None if probability is None else \
        probability.asnumpy().reshape(-1).astype(_np.float64)
    from .. import random as _mxrandom
    rng = _mxrandom.np_rng()  # mx.random.seed() governs sampling
    results = []
    for seeds_arr in seed_arrays:
        seeds = seeds_arr.asnumpy().astype(_np.int64).reshape(-1)
        layer = {int(s): 0 for s in seeds}
        order = [int(s) for s in seeds][:max_num_vertices]
        sampled_edges = {}  # vertex -> [(col, edge_val)]
        frontier = list(order)
        for hop in range(1, num_hops + 1):
            nxt = []
            for v in frontier:
                row_cols = indices[indptr[v]:indptr[v + 1]]
                row_vals = vals[indptr[v]:indptr[v + 1]]
                deg = len(row_cols)
                if deg == 0:
                    continue
                k = min(num_neighbor, deg)
                if prob is None:
                    pick = rng.choice(deg, size=k, replace=False)
                else:
                    p = prob[row_cols]
                    s = p.sum()
                    if s <= 0:
                        continue
                    # without replacement: can draw at most the number of
                    # nonzero-probability neighbors
                    k = min(k, int((p > 0).sum()))
                    pick = rng.choice(deg, size=k, replace=False, p=p / s)
                pick.sort()
                chosen = [(int(row_cols[i]), row_vals[i]) for i in pick]
                sampled_edges.setdefault(v, []).extend(chosen)
                for c, _e in chosen:
                    if c not in layer and len(order) < max_num_vertices:
                        layer[c] = hop
                        order.append(c)
                        nxt.append(c)
            frontier = nxt
        # vertices output: max_num_vertices+1, last = actual count
        verts = _np.zeros(max_num_vertices + 1, _np.int64)
        verts[:len(order)] = order
        verts[-1] = len(order)
        # layers output
        layers = _np.full(max_num_vertices, -1, _np.int64)
        for i, v in enumerate(order):
            layers[i] = layer[v]
        # sub csr, shape (max_num_vertices, parent_n): row i holds the
        # sampled out-edges of the i-th vertex in `order`, columns are
        # ORIGINAL vertex ids, values original edge ids (ref: dgl_graph.cc
        # CSRNeighborUniformSampleShape:272-281 — out_csr_shape =
        # [max_num_vertices, in_shape[1]])
        m = max_num_vertices
        parent_n = shape[1]
        vset = set(order)
        sub_indptr = [0]
        sub_indices: List[int] = []
        sub_vals: List = []
        for v in order:
            row = sorted((c, e) for c, e in sampled_edges.get(v, ())
                         if c in vset)
            sub_indices.extend(c for c, _e in row)
            sub_vals.extend(e for _c, e in row)
            sub_indptr.append(len(sub_indices))
        sub_indptr.extend([len(sub_indices)] * (m - len(order)))
        sub = csr_matrix((_np.asarray(sub_vals, vals.dtype),
                          _np.asarray(sub_indices, _np.int64),
                          _np.asarray(sub_indptr, _np.int64)),
                         shape=(m, parent_n), dtype=vals.dtype, ctx=ctx)
        if prob is not None:
            # non-uniform adds a sub_probability output (ref:
            # CSRNeighborNonUniformSampleShape:340-347)
            sub_prob = _np.zeros(m, _np.float32)
            sub_prob[:len(order)] = prob[order]
            results.append((_nd.array(verts, ctx=ctx), sub,
                            _nd.array(sub_prob, ctx=ctx),
                            _nd.array(layers, ctx=ctx)))
        else:
            results.append((_nd.array(verts, ctx=ctx), sub,
                            _nd.array(layers, ctx=ctx)))
    out = []
    for i in range(len(results[0])):
        out.extend(r[i] for r in results)
    return tuple(out)


def dgl_csr_neighbor_uniform_sample(csr_mat, *seed_arrays, num_args=None,
                                    num_hops=1, num_neighbor=2,
                                    max_num_vertices=100, **_):
    """Uniform neighborhood sampling (ref: dgl_graph.cc:759)."""
    return _neighbor_sample(csr_mat, seed_arrays, int(num_hops),
                            int(num_neighbor), int(max_num_vertices))


def dgl_csr_neighbor_non_uniform_sample(csr_mat, probability, *seed_arrays,
                                        num_args=None, num_hops=1,
                                        num_neighbor=2,
                                        max_num_vertices=100, **_):
    """Probability-weighted neighborhood sampling
    (ref: dgl_graph.cc:853)."""
    return _neighbor_sample(csr_mat, seed_arrays, int(num_hops),
                            int(num_neighbor), int(max_num_vertices),
                            probability=probability)


def dgl_graph_compact(*graph_data, graph_sizes=(), return_mapping=False,
                      num_args=None, **_):
    """Drop the empty tail rows/cols of sampled subgraphs by relabeling
    with the sampled vertex list (ref: dgl_graph.cc:1565).
    Inputs: N subgraph csrs followed by N vertex arrays."""
    if isinstance(graph_sizes, (int, _np.integer)):
        graph_sizes = (int(graph_sizes),)
    graph_sizes = tuple(int(g) for g in graph_sizes)
    n_graphs = len(graph_data) // 2
    check(len(graph_sizes) == n_graphs,
          "graph_sizes must have one entry per graph")
    outs, maps = [], []
    for i in range(n_graphs):
        g = graph_data[i]
        varr = graph_data[n_graphs + i]
        size = graph_sizes[i]
        vids = varr.asnumpy().astype(_np.int64).reshape(-1)[:size]
        vals, indices, indptr, _shape = _csr_np(g)
        # sampler csr rows are SAMPLE POSITIONS (row j = j-th vertex in
        # the vertex list) with original-id columns (ref: dgl_graph.cc
        # CompactSubgraph:1443-1484 copies row pointers 0..size and
        # remaps columns via the id map)
        pos = {int(v): j for j, v in enumerate(vids)}
        sub_indptr = [0]
        sub_indices: List[int] = []
        sub_vals: List = []
        for r in range(size):
            row_cols = indices[indptr[r]:indptr[r + 1]]
            row_vals = vals[indptr[r]:indptr[r + 1]]
            row = sorted((pos[int(c)], e)
                         for c, e in zip(row_cols, row_vals) if int(c) in pos)
            sub_indices.extend(c for c, _e in row)
            sub_vals.extend(e for _c, e in row)
            sub_indptr.append(len(sub_indices))
        ii = _np.asarray(sub_indices, _np.int64)
        pp = _np.asarray(sub_indptr, _np.int64)
        outs.append(csr_matrix((_np.asarray(sub_vals, vals.dtype), ii, pp),
                               shape=(size, size), dtype=vals.dtype,
                               ctx=_ctx(g)))
        if return_mapping:
            # like dgl_subgraph: first output gets fresh 1-based edge ids,
            # mapping carries the parent edge ids
            new_ids = _np.arange(1, len(sub_vals) + 1, dtype=vals.dtype)
            maps.append(outs[-1])
            outs[-1] = csr_matrix((new_ids, ii, pp), shape=(size, size),
                                  dtype=vals.dtype, ctx=_ctx(g))
    result = outs + maps if return_mapping else outs
    return result[0] if len(result) == 1 else tuple(result)
