"""The port's ``io.LibSVMIter`` against the JAX package's, exactly, on the
CPU (the cases of ``tests/test_image_record_iter.py``): CSR batches from
libsvm text, padding, labels (one column, a label file with several),
parts, the out-of-range index refusal, and the batches feeding the csr
dot kernel.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import io as jio
from mxnet_tpu.base import MXNetError as JMXNetError

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import io as tio

CPU = mt.cpu()
TEXT = ("1 0:1.5 3:2.0\n"
        "0 1:0.5\n"
        "1 2:1.0 3:0.25\n"
        "0 3:-1.0 0:0.75 1:2.0\n"
        "1\n")


@pytest.fixture(autouse=True)
def _on_cpu():
    with CPU:
        yield


def _batches(mod, **kw):
    it = mod.LibSVMIter(**kw)
    out = []
    for _ in range(2):               # two epochs: reset works
        for b in it:
            d = b.data[0]
            out.append((d.stype, tuple(d.shape),
                        np.asarray(d.data.asnumpy()),
                        np.asarray(d.indices.asnumpy()),
                        np.asarray(d.indptr.asnumpy()),
                        np.asarray(d.asnumpy()),
                        np.asarray(b.label[0].asnumpy()), b.pad))
        it.reset()
    return it, out


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x[0] == y[0] == "csr" and x[1] == y[1] and x[7] == y[7]
        for u, v in zip(x[2:7], y[2:7]):
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("batch", [1, 2, 3, 5])
def test_libsvm_batches_match_jax(tmp_path, batch):
    f = tmp_path / "d.libsvm"
    f.write_text(TEXT)
    kw = dict(data_libsvm=str(f), data_shape=(4,), batch_size=batch)
    jit, jb = _batches(jio, **kw)
    tit, tb = _batches(tio, **kw)
    _same(tb, jb)
    assert tit.provide_data[0].shape == jit.provide_data[0].shape
    assert tit.provide_label[0].shape == jit.provide_label[0].shape
    assert len(tit) == len(jit) == 5


def test_libsvm_parts_and_label_file_match_jax(tmp_path):
    d = tmp_path / "d.libsvm"
    d.write_text(TEXT)
    lab = tmp_path / "l.libsvm"
    lab.write_text("1 0 1\n0 1 0\n1 1 1\n0 0 0\n1 0 0\n")
    for kw in (dict(label_libsvm=str(lab), label_shape=(3,)),
               dict(part_index=1, num_parts=2)):
        kw.update(data_libsvm=str(d), data_shape=(4,), batch_size=2)
        _same(_batches(tio, **kw)[1], _batches(jio, **kw)[1])


def test_libsvm_out_of_range_index_raises_like_jax(tmp_path):
    f = tmp_path / "bad.libsvm"
    f.write_text("1 7:1.0\n")
    with pytest.raises(JMXNetError, match="data_shape"):
        jio.LibSVMIter(data_libsvm=str(f), data_shape=(4,), batch_size=1)
    with pytest.raises(mt.MXNetError, match="data_shape"):
        tio.LibSVMIter(data_libsvm=str(f), data_shape=(4,), batch_size=1)


def test_libsvm_batches_feed_the_csr_dot(tmp_path):
    f = tmp_path / "d.libsvm"
    f.write_text(TEXT)
    w = np.random.RandomState(0).randn(4, 2).astype(np.float32)
    it = tio.LibSVMIter(data_libsvm=str(f), data_shape=(4,), batch_size=2)
    jit = jio.LibSVMIter(data_libsvm=str(f), data_shape=(4,), batch_size=2)
    for b, jb in zip(it, jit):
        got = mt.nd.sparse.dot(b.data[0], mt.nd.array(w)).asnumpy()
        want = jmx.nd.sparse.dot(jb.data[0], jmx.nd.array(w)).asnumpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
