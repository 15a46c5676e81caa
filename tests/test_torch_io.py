"""``mx.io`` of the port against the JAX package's, on the CPU.

- ``NDArrayIter`` serves the same batches in the same order (data, label,
  pad, count) as the JAX iterator: shuffled with a seed or not, every
  ``last_batch_handle``, ``num_parts`` / ``part_index`` shards, after
  ``reset()``, ``set_epoch`` and ``set_position``; the same
  ``provide_data`` / ``provide_label``.
- ``CSVIter``, ``ResizeIter`` and ``PrefetchingIter`` against the JAX
  ones.
- ``DeviceStagingIter`` (on the host here; the card is ``chip_smoke.py``'s
  ``fit_train``): the base iterator's batches on its device, ``depth`` /
  ``set_depth``, the memory ledger's ``staging`` bytes rising and
  falling as in the JAX package, the ``h2d`` segment.
- ``LibSVMIter`` is held to the JAX one in ``test_torch_libsvm.py``, the
  RecordIO iterators and ``MNISTIter`` in ``test_torch_image.py``.
"""
import gc

import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import io as jio

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch.ops.registry import NotPortedError
from mxnet_tpu_torch.telemetry import memory as tmem
from mxnet_tpu_torch.telemetry.step_breakdown import StepBreakdown


@pytest.fixture(autouse=True)
def _host():
    with mt.cpu():
        yield


def _arrays(n=23, d=3):
    rs = np.random.RandomState(2)
    return (rs.randn(n, d).astype(np.float32),
            np.arange(n, dtype=np.float32))


def _stream(it, n_batches=None):
    out = []
    for i, b in enumerate(it):
        if n_batches is not None and i == n_batches:
            break
        out.append(([d.asnumpy() for d in b.data],
                    [l.asnumpy() for l in (b.label or [])], b.pad))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (ad, al, ap), (bd, bl, bp) in zip(a, b):
        assert ap == bp
        for x, y in zip(ad + al, bd + bl):
            np.testing.assert_array_equal(x, y)


def _pair(**kw):
    X, Y = _arrays(kw.pop("n", 23))
    if kw.pop("unseeded", False):
        np.random.seed(4)
        j = jio.NDArrayIter(X, Y, **kw)
        np.random.seed(4)
        t = tio.NDArrayIter(X, Y, **kw)
        return j, t
    return jio.NDArrayIter(X, Y, **kw), tio.NDArrayIter(X, Y, **kw)


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
@pytest.mark.parametrize("shuffle,seed", [(False, None), (True, 13),
                                          (True, None)])
def test_ndarrayiter_order_matches_jax(handle, shuffle, seed):
    j, t = _pair(batch_size=5, shuffle=shuffle, seed=seed,
                 last_batch_handle=handle, unseeded=seed is None)
    assert t.num_batches == j.num_batches
    assert t.provide_data == j.provide_data
    assert t.provide_label == j.provide_label
    for epoch in range(3):                    # reset() moves the epoch
        _same(_stream(t), _stream(j))
        if shuffle and seed is None:
            np.random.seed(10 + epoch)
            j.reset()
            np.random.seed(10 + epoch)
            t.reset()
        else:
            j.reset()
            t.reset()


@pytest.mark.parametrize("handle", ["pad", "discard"])
def test_set_epoch_and_set_position_match_jax(handle):
    j, t = _pair(n=48, batch_size=4, shuffle=True, seed=7,
                 last_batch_handle=handle)
    for epoch in (3, 0, 5):
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        _same(_stream(t, 4), _stream(j, 4))
    for epoch, pos in ((2, 8), (0, 40), (1, 0)):
        j.set_position(epoch, pos)
        t.set_position(epoch, pos)
        _same(_stream(t), _stream(j))
    unseeded = tio.NDArrayIter(*_arrays(), batch_size=4, shuffle=True)
    with pytest.raises(mt.MXNetError, match="seed"):
        unseeded.set_epoch(1)


@pytest.mark.parametrize("parts", [2, 3])
def test_shards_match_jax(parts):
    for r in range(parts):
        j, t = _pair(n=48, batch_size=4, shuffle=True, seed=9,
                     num_parts=parts, part_index=r)
        assert t.num_batches == j.num_batches
        _same(_stream(t), _stream(j))
        j.set_position(1, 4 * parts * 2)
        t.set_position(1, 4 * parts * 2)
        _same(_stream(t), _stream(j))
        with pytest.raises(mt.MXNetError, match="set_position"):
            t.set_position(0, 4 * parts + 1)
    with pytest.raises(mt.MXNetError):
        tio.NDArrayIter(*_arrays(), batch_size=2, num_parts=2, part_index=2)


def test_batches_live_on_the_current_context():
    X, Y = _arrays()
    b = next(iter(tio.NDArrayIter(X, Y, batch_size=4)))
    assert b.data[0].context == mt.cpu() and b.data[0].shape == (4, 3)
    host = tio.NDArrayIter(X, Y, batch_size=4)._next_host()
    assert isinstance(host.data[0], np.ndarray)
    assert "DataBatch" in str(b)
    j = jio.NDArrayIter({"a": X, "b": X}, {"y": Y}, batch_size=4)
    t = tio.NDArrayIter({"a": X, "b": X}, {"y": Y}, batch_size=4)
    assert t.provide_data == j.provide_data
    _same(_stream(t), _stream(j))


def test_csv_resize_prefetch_match_jax(tmp_path):
    X, Y = _arrays(n=10, d=6)
    np.savetxt(tmp_path / "d.csv", X, delimiter=",")
    np.savetxt(tmp_path / "l.csv", Y, delimiter=",")
    kw = dict(data_csv=str(tmp_path / "d.csv"), data_shape=(2, 3),
              label_csv=str(tmp_path / "l.csv"), batch_size=4)
    _same(_stream(tio.CSVIter(**kw)), _stream(jio.CSVIter(**kw)))
    kw.pop("label_csv")
    _same(_stream(tio.CSVIter(**kw)), _stream(jio.CSVIter(**kw)))
    j, t = _pair(batch_size=4)
    _same(_stream(tio.ResizeIter(t, 9)), _stream(jio.ResizeIter(j, 9)))
    j2, t2 = _pair(batch_size=4, shuffle=True, seed=1)
    j3, t3 = _pair(batch_size=4, shuffle=True, seed=2)
    tp = tio.PrefetchingIter([t2, t3], rename_data=[{"data": "a"},
                                                    {"data": "b"}])
    jp = jio.PrefetchingIter([j2, j3], rename_data=[{"data": "a"},
                                                    {"data": "b"}])
    assert tp.provide_data == jp.provide_data
    for _ in range(2):
        _same(_stream(tp), _stream(jp))
        tp.reset()
        jp.reset()


def test_device_staging_on_the_host():
    X, Y = _arrays(n=24, d=8)
    base = tio.NDArrayIter(X, Y, batch_size=4, shuffle=True, seed=3)
    it = tio.DeviceStagingIter(tio.NDArrayIter(X, Y, batch_size=4,
                                               shuffle=True, seed=3),
                               device=mt.cpu())
    assert it.depth == 1 and it.device.type == "cpu"
    it.set_depth(3)
    assert it.depth == 3
    with pytest.raises(mt.MXNetError):
        it.set_depth(0)
    _same(_stream(it), _stream(base))
    it.reset()
    base.reset()
    _same(_stream(it), _stream(base))
    # a base iterator whose batches are already NDArrays
    wrapped = tio.DeviceStagingIter(tio.ResizeIter(
        tio.NDArrayIter(X, Y, batch_size=4), 3))
    _same(_stream(wrapped), _stream(tio.NDArrayIter(X, Y, batch_size=4), 3))


def test_staging_passes_positioning_through():
    X, Y = _arrays(n=48)
    base = tio.NDArrayIter(X, Y, batch_size=4, shuffle=True, seed=5)
    it = tio.DeviceStagingIter(tio.NDArrayIter(X, Y, batch_size=4,
                                               shuffle=True, seed=5))
    next(it)
    for epoch, pos in ((2, 8), (0, 0), (1, 44)):
        it.set_position(epoch, pos)
        base.set_position(epoch, pos)
        _same(_stream(it), _stream(base))
    it.set_epoch(3)
    base.set_epoch(3)
    _same(_stream(it, 2), _stream(base, 2))
    assert (it.num_parts, it.part_index) == (1, 0)
    unseekable = tio.DeviceStagingIter(tio.ResizeIter(base, 2))
    assert not hasattr(unseekable, "set_position")
    assert not hasattr(unseekable, "set_epoch")


def test_staging_bytes_rise_and_fall():
    gc.collect()
    led = tmem.ledger()
    before = led.live_bytes("staging")
    rs = np.random.RandomState(4)
    data = rs.randn(6 * 4, 8).astype(np.float32)
    label = rs.randint(0, 2, (6 * 4,)).astype(np.float32)
    it = tio.DeviceStagingIter(tio.NDArrayIter(data, label, batch_size=4),
                               depth=2)
    batch_bytes = 4 * 8 * 4 + 4 * 4
    first = it.next()
    # depth=2: after serving one batch, 3 are staged ahead (depth+1)
    assert led.live_bytes("staging") - before == 3 * batch_bytes
    for _ in range(5):
        it.next()
    with pytest.raises(StopIteration):
        it.next()
    assert led.live_bytes("staging") == before
    it.reset()
    it.next()
    assert led.live_bytes("staging") > before
    del it, first
    gc.collect()
    assert led.live_bytes("staging") == before


def test_staging_charges_the_h2d_segment():
    X, Y = _arrays(n=16)
    it = tio.DeviceStagingIter(tio.NDArrayIter(X, Y, batch_size=4))
    bd = StepBreakdown().install()
    try:
        for step, _ in enumerate(it):
            bd.begin_step(step)
            bd.end_step()
        bd.begin_step(9)
        it.reset()
        with __import__("mxnet_tpu_torch").telemetry.segment("data_wait"):
            next(it)
        rec = bd.end_step()
    finally:
        bd.uninstall()
    assert rec["h2d"] > 0 and "data_wait" in rec


def test_not_ported_iterators_raise():
    """Every iterator is ported now: the record iterators and
    ``MNISTIter`` (``test_torch_image.py``) and ``LibSVMIter``
    (``test_torch_libsvm.py``); a missing file raises as in the JAX
    package."""
    with pytest.raises(FileNotFoundError):
        tio.LibSVMIter(data_libsvm="no-such.libsvm", data_shape=(4,),
                       batch_size=2)
    for name in ("ImageRecordIter", "ImageDetRecordIter", "MNISTIter",
                 "LibSVMIter"):
        assert not issubclass(getattr(tio, name), NotPortedError)
        assert getattr(tio, name).__module__.startswith("mxnet_tpu_torch.io")
    with pytest.raises(mt.MXNetError, match="not found"):
        tio.MNISTIter(image="no-such-images", label="no-such-labels")
    assert mx.io.DataDesc.get_batch_axis("NHWC") == \
        tio.DataDesc.get_batch_axis("NHWC") == 0
