"""``gluon.data`` of the port against the JAX package's, on the CPU.

- ``DataLoader``: the same batches as the JAX loader in serial, thread
  and process modes, unshuffled and shuffled under one numpy seed, for
  ``last_batch`` keep / discard / rollover; a custom batchify through the
  pickled path and an unpicklable one (a warning, then threads); a
  worker's error carrying its traceback; a killed worker reported; a
  stuck one timed out (the reference's ``timeout``); no
  shared-memory segment left after an early ``break``; ``pin_memory`` a
  plain copy under ``mx.cpu()`` and an error for a card context without
  a card.
- Two forked workers and a random draw: in both packages each worker
  starts from the parent's generator state, so the two workers' first
  samples draw the same numbers, the ones the parent draws next (the
  JAX side reads its key counter: a process forked from a multithreaded
  JAX must not run JAX).
- Datasets (``transform`` / ``transform_first`` / ``filter`` / ``take``,
  ``ArrayDataset``, ``RecordFileDataset``, the vision datasets from files
  written here, ``$MXNET_HOME``), samplers and ``IntervalSampler``.
- The 15 vision transforms against the JAX blocks, the random ones on
  degenerate ranges, the random flips held to {x, flip(x)}.
"""
import glob
import io
import multiprocessing
import os
import pickle
import struct
import time

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.contrib.data import IntervalSampler as JInterval
from mxnet_tpu.gluon.data.vision import transforms as jtf

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.contrib.data import IntervalSampler as TInterval
from mxnet_tpu_torch.gluon.data.vision import transforms as ttf


@pytest.fixture(autouse=True)
def _host():
    with mt.cpu():
        yield


def _arrays(n=23):
    rs = np.random.RandomState(0)
    return rs.rand(n, 4, 3).astype(np.float32), rs.randint(0, 9, n)


def _np(batch):
    if isinstance(batch, (tuple, list)):
        return [b.asnumpy() for b in batch]
    return [batch.asnumpy()]


def _loader_batches(data, seed, **kw):
    x, y = _arrays()
    np.random.seed(seed)
    return [_np(b) for b in data.DataLoader(data.ArrayDataset(x, y), **kw)]


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


MODES = {"serial": dict(num_workers=0),
         "thread": dict(num_workers=2, thread_pool=True),
         "process": dict(num_workers=2)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_dataloader_matches_jax(mode, shuffle, last_batch):
    kw = dict(batch_size=5, shuffle=shuffle, last_batch=last_batch,
              **MODES[mode])
    got = _loader_batches(tdata, 11, **kw)
    want = _loader_batches(jdata, 11, **kw)
    _same(got, want)
    assert len(got) == (4 if last_batch != "keep" else 5)


def test_rollover_carries_the_remainder():
    x, _ = _arrays(7)
    for data in (tdata, jdata):
        loader = data.DataLoader(data.ArrayDataset(x), batch_size=3,
                                 last_batch="rollover")
        epochs = [[b.shape[0] for b in loader] for _ in range(3)]
        # 7 items: a remainder of 1, then 2, then 9 items in three batches
        assert epochs == [[3, 3], [3, 3], [3, 3, 3]]


def pad_batchify(samples):
    """A custom (picklable) batchify: stacks and adds one."""
    return np.stack([np.asarray(s) for s in samples]) + 1.0


@pytest.mark.parametrize("thread_pool", [None, False])
def test_custom_batchify_runs_in_processes(thread_pool):
    x, _ = _arrays(12)
    got, want = [], []
    for data, out in ((tdata, got), (jdata, want)):
        loader = data.DataLoader(data.ArrayDataset(x), batch_size=4,
                                 num_workers=2, batchify_fn=pad_batchify,
                                 thread_pool=thread_pool)
        out.extend(_np(b) for b in loader)
        assert loader._worker_mode() == "process"
    _same(got, want)


def test_unpicklable_batchify_warns_and_threads():
    x, _ = _arrays(12)
    loader = tdata.DataLoader(tdata.ArrayDataset(x), batch_size=4,
                              num_workers=2,
                              batchify_fn=lambda s: mt.nd.array(np.stack(
                                  [np.asarray(v) for v in s])))
    with pytest.warns(UserWarning, match="not picklable"):
        batches = [b.asnumpy() for b in loader]
    assert loader._worker_mode() == "thread"
    np.testing.assert_array_equal(np.concatenate(batches), x)


class _Poisoned(tdata.Dataset):
    def __len__(self):
        return 8

    def __getitem__(self, i):
        if i == 5:
            raise ValueError("poisoned sample 5")
        return np.float32(i)


@pytest.mark.parametrize("mode", ["thread", "process"])
def test_worker_error_carries_its_traceback(mode):
    loader = tdata.DataLoader(_Poisoned(), batch_size=2, **MODES[mode])
    err = ValueError if mode == "thread" else mt.MXNetError
    with pytest.raises(err, match="poisoned sample 5") as info:
        list(loader)
    if mode == "process":
        assert "Traceback" in str(info.value)
        assert "__getitem__" in str(info.value)
    # the next epoch starts clean
    assert len(list(tdata.DataLoader(tdata.ArrayDataset(np.arange(6.0)),
                                     batch_size=2, num_workers=2))) == 3


class _Exiting(tdata.Dataset):
    def __len__(self):
        return 4

    def __getitem__(self, i):
        os._exit(3)


def test_killed_worker_is_reported():
    loader = tdata.DataLoader(_Exiting(), batch_size=2, num_workers=1)
    t0 = time.perf_counter()
    with pytest.raises(mt.MXNetError, match=r"died \(exitcode \[3\]\)"):
        list(loader)
    assert time.perf_counter() - t0 < 30


class _Stuck(tdata.Dataset):
    def __len__(self):
        return 2

    def __getitem__(self, i):
        time.sleep(60)


def test_a_stuck_worker_times_out():
    loader = tdata.DataLoader(_Stuck(), batch_size=1, num_workers=1,
                              timeout=1)
    t0 = time.perf_counter()
    with pytest.raises(mt.MXNetError, match="no batch from the workers"):
        list(loader)
    assert time.perf_counter() - t0 < 30


ODD = 1237      # an item length no other test's segments share


def _our_segments():
    nbytes = 2 * ODD * 4
    return {p for p in glob.glob("/dev/shm/psm_*")
            if os.path.exists(p) and os.path.getsize(p) == nbytes}


def test_no_segment_left_after_early_break():
    x = np.arange(40 * ODD, dtype=np.float32).reshape(40, ODD)
    before = _our_segments()
    loader = tdata.DataLoader(tdata.ArrayDataset(x), batch_size=2,
                              num_workers=2, prefetch=6)
    for i, batch in enumerate(loader):
        np.testing.assert_array_equal(batch.asnumpy(), x[2 * i:2 * i + 2])
        if i == 1:
            break
    del loader, batch
    deadline = time.time() + 10
    while _our_segments() - before and time.time() < deadline:
        time.sleep(0.1)
    assert not _our_segments() - before


def test_pin_memory_on_the_host_is_a_copy():
    x, y = _arrays(10)
    got = [_np(b) for b in tdata.DataLoader(
        tdata.ArrayDataset(x, y), batch_size=4, num_workers=2,
        pin_memory=True)]
    want = [_np(b) for b in tdata.DataLoader(
        tdata.ArrayDataset(x, y), batch_size=4)]
    _same(got, want)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_pin_memory_on_a_card_context_without_a_card_raises():
    loader = tdata.DataLoader(tdata.ArrayDataset(np.arange(4.0)),
                              batch_size=2, num_workers=1, pin_memory=True)
    with mt.gpu(0):
        with pytest.raises(mt.MXNetError, match="no CUDA device"):
            iter(loader)


class _TwoAtOnce(tdata.Dataset):
    """``draw()`` of each item. In a worker, an item waits at a barrier
    for the other worker's item, so each of two workers takes one of the
    two batches."""

    def __init__(self, draw):
        self._draw = draw
        self._parent = os.getpid()
        self._barrier = multiprocessing.get_context("fork").Barrier(2)

    def __len__(self):
        return 2

    def __getitem__(self, i):
        if os.getpid() != self._parent:
            self._barrier.wait(timeout=60)
        return self._draw()


def _port_brightness():
    x = mt.nd.array(np.full((4, 4, 3), 100.0, np.float32))
    return ttf.RandomBrightness(0.5)(x).asnumpy()


def _jax_next_key_index():
    """The fold-in index of the JAX package's next key: plain Python
    state (a worker must not run JAX: a process forked from a
    multithreaded JAX can deadlock in it)."""
    from mxnet_tpu import random as jrandom
    return np.int64(jrandom._counter + 1)


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_two_workers_share_the_parents_random_stream(pkg):
    """Both packages: a forked worker inherits the parent's generator
    state (torch's default generator in the port, the key counter of
    ``mx.random`` in the JAX package), so two workers draw the same
    numbers for their first sample, the numbers the parent draws next.
    Neither package reseeds its workers."""
    if pkg == "torch":
        data, draw = tdata, _port_brightness
    else:
        data, draw = jdata, _jax_next_key_index
    ds = _TwoAtOnce(draw)
    batches = [np.asarray(b.asnumpy()) for b in
               data.DataLoader(ds, batch_size=1, num_workers=2)]
    assert len(batches) == 2
    np.testing.assert_array_equal(batches[0], batches[1])
    parent = ds[0]
    np.testing.assert_array_equal(batches[0][0], parent)
    if pkg == "torch":      # the parent's own draws move its stream on
        assert not np.array_equal(parent, ds[1])


# --- datasets and samplers --------------------------------------------------

def test_dataset_methods_match_jax():
    x, y = _arrays(9)
    for lazy in (True, False):
        got = tdata.ArrayDataset(x, y).transform(
            lambda a, b: (a * 2, b + 1), lazy=lazy)
        want = jdata.ArrayDataset(x, y).transform(
            lambda a, b: (a * 2, b + 1), lazy=lazy)
        for i in range(9):
            np.testing.assert_array_equal(got[i][0], want[i][0])
            assert got[i][1] == want[i][1]
    got = tdata.ArrayDataset(x, y).transform_first(lambda a: a - 1)
    want = jdata.ArrayDataset(x, y).transform_first(lambda a: a - 1)
    np.testing.assert_array_equal(got[3][0], want[3][0])
    assert got[3][1] == want[3][1]
    f = tdata.SimpleDataset(list(range(10))).filter(lambda v: v % 3 == 0)
    assert [f[i] for i in range(len(f))] == [0, 3, 6, 9]
    t = tdata.SimpleDataset(list(range(10))).take(4)
    assert len(t) == 4 and t[3] == 3
    with pytest.raises(mt.MXNetError):
        tdata.ArrayDataset(x, y[:3])


def test_samplers_match_jax():
    np.random.seed(3)
    got = list(tdata.RandomSampler(17))
    np.random.seed(3)
    assert got == list(jdata.RandomSampler(17))
    assert list(tdata.SequentialSampler(5, start=2)) == [2, 3, 4, 5, 6]
    for lb in ("keep", "discard", "rollover"):
        t = tdata.BatchSampler(tdata.SequentialSampler(7), 3, lb)
        j = jdata.BatchSampler(jdata.SequentialSampler(7), 3, lb)
        assert [list(t), list(t), len(t)] == [list(j), list(j), len(j)]
    for rollover in (True, False):
        assert list(TInterval(10, 3, rollover)) == \
            list(JInterval(10, 3, rollover))
        assert len(TInterval(10, 3, rollover)) == \
            len(JInterval(10, 3, rollover))


def _write_images(tmp_path, n=10):
    rs = np.random.RandomState(4)
    path = str(tmp_path / "imgs.rec")
    w = jrec.MXIndexedRecordIO(str(tmp_path / "imgs.idx"), path, "w")
    for i in range(n):
        buf = io.BytesIO()
        np.save(buf, rs.randint(0, 256, (12, 10, 3)).astype(np.uint8))
        label = float(i % 4) if i % 2 else [1.0, float(i)]
        w.write_idx(i, jrec.pack(jrec.IRHeader(0, label, i, 0),
                                 buf.getvalue()))
    w.close()
    return path


def test_record_datasets_match_jax(tmp_path):
    path = _write_images(tmp_path)
    trd, jrd = tdata.RecordFileDataset(path), jdata.RecordFileDataset(path)
    assert len(trd) == len(jrd) == 10
    assert [trd[i] for i in range(10)] == [jrd[i] for i in range(10)]
    tds = tdata.vision.ImageRecordDataset(path)
    jds = jdata.vision.ImageRecordDataset(path)
    for i in range(10):
        (tx, tl), (jx, jl) = tds[i], jds[i]
        np.testing.assert_array_equal(tx.asnumpy(), jx.asnumpy())
        np.testing.assert_array_equal(np.asarray(tl), np.asarray(jl))
    # forked workers read the file through handles of their own
    ds = tdata.vision.ImageRecordDataset(path).transform_first(
        ttf.ToTensor())
    loader = tdata.DataLoader(ds.transform(lambda x, y: (x, np.float32(
        np.asarray(y).reshape(-1)[0]))), batch_size=2, num_workers=2)
    got = np.concatenate([b[0].asnumpy() for b in loader])
    want = np.stack([ds[i][0].asnumpy() for i in range(10)])
    np.testing.assert_array_equal(got, want)


def _mnist_files(root, prefix, n=6):
    rs = np.random.RandomState(5)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, f"{prefix}-images-idx3-ubyte"), "wb") as f:
        f.write(struct.pack(">IIII", 2051, n, 28, 28))
        f.write(rs.randint(0, 256, (n, 28, 28)).astype(np.uint8).tobytes())
    with open(os.path.join(root, f"{prefix}-labels-idx1-ubyte"), "wb") as f:
        f.write(struct.pack(">II", 2049, n))
        f.write(rs.randint(0, 10, n).astype(np.uint8).tobytes())


def _cifar_files(root, names, width, n=4):
    rs = np.random.RandomState(6)
    os.makedirs(root, exist_ok=True)
    for name in names:
        with open(os.path.join(root, name), "wb") as f:
            f.write(rs.randint(0, 100, (n, width)).astype(np.uint8)
                    .tobytes())


def _same_items(tds, jds):
    assert len(tds) == len(jds)
    for i in range(len(tds)):
        (tx, tl), (jx, jl) = tds[i], jds[i]
        assert tx.asnumpy().dtype == jx.asnumpy().dtype
        np.testing.assert_array_equal(tx.asnumpy(), jx.asnumpy())
        assert int(tl) == int(jl)


def test_vision_datasets_from_local_files(tmp_path, monkeypatch):
    root = str(tmp_path / "mnist")
    _mnist_files(root, "train")
    _mnist_files(root, "t10k", 3)
    for train in (True, False):
        _same_items(tdata.vision.MNIST(root, train=train),
                    jdata.vision.MNIST(root, train=train))
        _same_items(tdata.vision.FashionMNIST(root, train=train),
                    jdata.vision.FashionMNIST(root, train=train))
    c10 = str(tmp_path / "c10")
    _cifar_files(c10, [f"data_batch_{i}.bin" for i in range(1, 6)] +
                 ["test_batch.bin"], 3073)
    for train in (True, False):
        _same_items(tdata.vision.CIFAR10(c10, train=train),
                    jdata.vision.CIFAR10(c10, train=train))
    c100 = str(tmp_path / "c100")
    _cifar_files(c100, ["train.bin", "test.bin"], 3074)
    for fine in (True, False):
        _same_items(tdata.vision.CIFAR100(c100, fine_label=fine),
                    jdata.vision.CIFAR100(c100, fine_label=fine))
    _same_items(tdata.vision.SyntheticImageDataset(8, seed=2),
                jdata.vision.SyntheticImageDataset(8, seed=2))
    # the default root re-anchors on $MXNET_HOME; a missing file raises
    monkeypatch.setenv("MXNET_HOME", str(tmp_path / "home"))
    _mnist_files(str(tmp_path / "home" / "datasets" / "mnist"), "train")
    assert mt.base.data_dir() == jmx.base.data_dir()
    _same_items(tdata.vision.MNIST(), jdata.vision.MNIST())
    with pytest.raises(mt.MXNetError, match="not found"):
        tdata.vision.CIFAR10(str(tmp_path / "none"))
    # a transform gets (image, label)
    ds = tdata.vision.MNIST(root, transform=lambda x, y: (x.shape, y + 1))
    assert ds[0][0] == (28, 28, 1)


# --- transforms -------------------------------------------------------------

def _tf_pair(make):
    return make(ttf), make(jtf)


DETERMINISTIC = {
    "to_tensor": lambda m: m.ToTensor(),
    "cast": lambda m: m.Cast("float16"),
    "normalize": lambda m: m.Compose([m.ToTensor(),
                                      m.Normalize((0.4, 0.5, 0.6),
                                                  (0.2, 0.25, 0.3))]),
    "resize": lambda m: m.Resize((9, 7)),
    "resize_keep": lambda m: m.Resize(8, keep_ratio=True, interpolation=2),
    "center_crop": lambda m: m.CenterCrop((6, 5)),
    "random_resized_crop": lambda m: m.RandomResizedCrop(8),
    "brightness_0": lambda m: m.RandomBrightness(0.0),
    "contrast_0": lambda m: m.RandomContrast(0.0),
    "saturation_0": lambda m: m.RandomSaturation(0.0),
    "hue_0": lambda m: m.RandomHue(0.0),
    "lighting_0": lambda m: m.RandomLighting(0.0),
    "color_jitter_0": lambda m: m.RandomColorJitter(),
}


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
@pytest.mark.parametrize("batched", [False, True])
def test_transforms_match_jax(name, batched):
    if batched and name in ("to_tensor", "normalize"):
        shape = (2, 12, 10, 3)
    else:
        shape = (2, 12, 10, 3) if batched else (12, 10, 3)
    x = np.random.RandomState(8).randint(0, 256, shape).astype(np.uint8)
    t, j = _tf_pair(DETERMINISTIC[name])
    np.random.seed(1)
    got = t(mt.nd.array(x, dtype="uint8")).asnumpy()
    np.random.seed(1)
    want = j(jmx.nd.array(x, dtype="uint8")).asnumpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    tol = 1.0 if "resize" in name and got.dtype == np.uint8 else 0.0
    np.testing.assert_allclose(got.astype(np.float64), want, rtol=1e-6,
                               atol=tol)


@pytest.mark.parametrize("name,axis", [("RandomFlipLeftRight", -2),
                                       ("RandomFlipTopBottom", -3)])
def test_random_flip_transforms(name, axis):
    x = np.random.RandomState(9).randint(0, 256, (12, 10, 3)) \
        .astype(np.uint8)
    flips = set()
    for _ in range(12):
        y = getattr(ttf, name)()(mt.nd.array(x, dtype="uint8")).asnumpy()
        assert np.array_equal(y, x) or np.array_equal(y, np.flip(x, axis))
        flips.add(np.array_equal(y, np.flip(x, axis)))
    assert flips == {True, False}


def test_transforms_are_the_jax_set():
    assert set(ttf.__all__) == set(jtf.__all__)
    assert len(ttf.__all__) == 15
    pickle.dumps(ttf.ToTensor)
