"""RecordIO of the port against the JAX package's, on the CPU.

- ``.rec`` / ``.idx`` files written by one package read in the other,
  both ways, byte for byte (npy payloads, JPEG / PNG through cv2, and with
  cv2 hidden in both packages); ``pack`` / ``unpack`` headers with scalar
  and array labels; split records reassembled by the reader; a pickled
  indexed reader.
- ``RecordPipeline``'s record order equal to the JAX package's native
  pipeline (``src/recordio.cc``) and to a splitmix64 Fisher-Yates written
  here in numpy: unshuffled and shuffled with seeds 0 and 1, three epochs,
  every shard of ``num_parts=3``, with several reader threads; an
  unreadable record skipped in place, as the native pipeline skips it.
"""
import io
import pickle
import struct
import sys

import numpy as np
import pytest

from mxnet_tpu import recordio as jrec
from mxnet_tpu.io import record_io as jrio

from mxnet_tpu_torch import recordio as trec
from mxnet_tpu_torch.io import record_io as trio

PKG = {"jax": jrec, "torch": trec}


def _npy(img):
    buf = io.BytesIO()
    np.save(buf, img)
    return buf.getvalue()


def _records(n=23, seed=0):
    rs = np.random.RandomState(seed)
    out = []
    for i in range(n):
        img = rs.randint(0, 256, (5 + i % 4, 7, 3)).astype(np.uint8)
        label = float(i % 7) if i % 3 else \
            rs.rand(1 + i % 4).astype(np.float32)
        out.append((i, label, img))
    return out


def _write(mod, path, idx, recs, payload=_npy):
    w = mod.MXIndexedRecordIO(str(idx), str(path), "w")
    for i, label, img in recs:
        w.write_idx(i, mod.pack(mod.IRHeader(0, label, i, 0), payload(img)))
    w.close()


def _read_all(mod, path, idx):
    r = mod.MXIndexedRecordIO(str(idx), str(path), "r")
    out = [(k, r.read_idx(k)) for k in r.keys]
    r.close()
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                           ("torch", "jax")])
def test_rec_and_idx_cross_read(tmp_path, writer, reader):
    recs = _records()
    _write(PKG[writer], tmp_path / "a.rec", tmp_path / "a.idx", recs)
    _write(PKG[reader], tmp_path / "b.rec", tmp_path / "b.idx", recs)
    assert (tmp_path / "a.rec").read_bytes() == \
        (tmp_path / "b.rec").read_bytes()
    assert (tmp_path / "a.idx").read_text() == \
        (tmp_path / "b.idx").read_text()
    got = _read_all(PKG[reader], tmp_path / "a.rec", tmp_path / "a.idx")
    want = _read_all(PKG[writer], tmp_path / "a.rec", tmp_path / "a.idx")
    assert got == want
    mod = PKG[reader]
    for (i, label, img), (_, rec) in zip(recs, got):
        header, arr = mod.unpack_img(rec)
        np.testing.assert_array_equal(arr, img)
        np.testing.assert_array_equal(np.asarray(header.label, np.float32),
                                      np.asarray(label, np.float32))
        assert header.id == i
    # sequential reads see the same records
    seq = [PKG[reader].MXRecordIO(str(tmp_path / "a.rec"), "r")]
    records = []
    while True:
        rec = seq[0].read()
        if rec is None:
            break
        records.append(rec)
    assert records == [rec for _, rec in want]


@pytest.mark.parametrize("label", [3.0, 7, [1.0, 2.5, -3.0], np.arange(5.0)])
def test_pack_unpack_match_jax(label):
    hdr = (0, label, 11, 2)
    blob = trec.pack(trec.IRHeader(*hdr), b"payload")
    assert blob == jrec.pack(jrec.IRHeader(*hdr), b"payload")
    th, tp = trec.unpack(blob)
    jh, jp = jrec.unpack(blob)
    assert tp == jp == b"payload"
    assert th.flag == jh.flag and th.id == jh.id and th.id2 == jh.id2
    np.testing.assert_array_equal(np.asarray(th.label), np.asarray(jh.label))


@pytest.mark.parametrize("fmt", [".png", ".jpg"])
def test_pack_img_with_cv2_matches_jax(fmt):
    pytest.importorskip("cv2")
    img = (np.random.RandomState(1).rand(9, 11, 3) * 255).astype(np.uint8)
    hdr = (0, 4.0, 3, 0)
    blob = trec.pack_img(trec.IRHeader(*hdr), img, img_fmt=fmt)
    assert blob == jrec.pack_img(jrec.IRHeader(*hdr), img, img_fmt=fmt)
    _, timg = trec.unpack_img(blob)
    _, jimg = jrec.unpack_img(blob)
    np.testing.assert_array_equal(timg, jimg)


def test_pack_img_without_cv2_writes_npy(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    img = (np.random.RandomState(2).rand(6, 4, 3) * 255).astype(np.uint8)
    blob = trec.pack_img(trec.IRHeader(0, 1.0, 0, 0), img)
    assert blob == jrec.pack_img(jrec.IRHeader(0, 1.0, 0, 0), img)
    np.testing.assert_array_equal(trec.unpack_img(blob)[1], img)
    jpeg = trec.pack(trec.IRHeader(0, 1.0, 0, 0), b"\xff\xd8\xff\xe0xx")
    for mod in (trec, jrec):
        with pytest.raises(Exception, match="cv2"):
            mod.unpack_img(jpeg)


def test_reader_reassembles_split_records(tmp_path):
    """A record split in parts (flags 1, 2, 3) reads back whole in both
    packages; the pipeline indexes whole records only (flag 0)."""
    path = tmp_path / "split.rec"
    parts = [b"abcde", b"fg", b"hijklm"]
    with open(path, "wb") as f:
        def put(flag, data):
            f.write(struct.pack("<II", 0xCED7230A, (flag << 29) | len(data)))
            f.write(data + b"\x00" * ((4 - len(data) % 4) % 4))
        put(0, b"first")
        for flag, p in zip((1, 2, 3), parts):
            put(flag, p)
        put(0, b"last!")
    for mod in (trec, jrec):
        r = mod.MXRecordIO(str(path), "r")
        assert [r.read(), r.read(), r.read(), r.read()] == \
            [b"first", b"".join(parts), b"last!", None]
        r.close()
    tp = trio.RecordPipeline(str(path), num_threads=2)
    jp = jrio.RecordPipeline(str(path), num_threads=2)
    assert len(tp) == len(jp) == 2
    assert [tp.next(), tp.next(), tp.next()] == \
        [jp.next(), jp.next(), jp.next()] == [b"first", b"last!", None]


def test_indexed_reader_pickles(tmp_path):
    recs = _records(5)
    _write(trec, tmp_path / "p.rec", tmp_path / "p.idx", recs)
    r = trec.MXIndexedRecordIO(str(tmp_path / "p.idx"),
                               str(tmp_path / "p.rec"), "r")
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.keys == r.keys == [0, 1, 2, 3, 4]
    assert r2.read_idx(3) == r.read_idx(3)


# --- the pipeline's order ----------------------------------------------------

def _splitmix_order(n, seed, epochs):
    """Each epoch's permutation of range(n), in numpy uint64 (wrapping)."""
    golden = np.uint64(0x9E3779B97F4A7C15)
    order = list(range(n))
    out = []
    with np.errstate(over="ignore"):
        for epoch in range(epochs):
            x = np.uint64(seed) + golden * np.uint64(epoch + 1)
            for i in range(n, 1, -1):
                x = x + golden
                z = x
                z = (z ^ (z >> np.uint64(30))) * \
                    np.uint64(0xBF58476D1CE4E5B9)
                z = (z ^ (z >> np.uint64(27))) * \
                    np.uint64(0x94D049BB133111EB)
                z = z ^ (z >> np.uint64(31))
                j = int(z % np.uint64(i))
                order[i - 1], order[j] = order[j], order[i - 1]
            out.append(list(order))
    return out


def _numbered(tmp_path, n):
    path = tmp_path / "n.rec"
    w = trio.RecordWriter(str(path))
    for i in range(n):
        w.write(struct.pack("<I", i) + b"x" * (i % 5))
    w.close()
    return str(path)


def _epoch(pipe):
    out = []
    while True:
        rec = pipe.next()
        if rec is None:
            return out
        out.append(struct.unpack("<I", rec[:4])[0])


@pytest.mark.parametrize("shuffle,seed", [(False, 0), (True, 0), (True, 1)])
@pytest.mark.parametrize("part", [0, 1, 2])
def test_pipeline_order_matches_native(tmp_path, shuffle, seed, part):
    n = 64
    path = _numbered(tmp_path, n)
    kw = dict(part_index=part, num_parts=3, shuffle=shuffle, seed=seed)
    tp = trio.RecordPipeline(path, num_threads=3, **kw)
    jp = jrio.RecordPipeline(path, num_threads=3, **kw)
    per = -(-n // 3)
    shard = list(range(per * part, min(per * (part + 1), n)))
    want = _splitmix_order(len(shard), seed, 3) if shuffle else [
        list(range(len(shard)))] * 3
    assert len(tp) == len(jp) == len(shard)
    for epoch in range(3):
        got = _epoch(tp)
        assert got == _epoch(jp)
        assert got == [shard[k] for k in want[epoch]]
        tp.reset()
        jp.reset()
    tp.close()
    jp.close()


def test_shuffle_order_is_splitmix64():
    items = list(range(40))
    trio.shuffle_order(items, 7, 0)
    assert items == _splitmix_order(40, 7, 1)[0]


def test_pipeline_skips_an_unreadable_record(tmp_path):
    """A record whose data runs past the end of the file is skipped in
    place, in both packages."""
    path = _numbered(tmp_path, 9)
    with open(path, "r+b") as f:
        data = f.read()
        f.truncate(len(data) - 6)           # cut the last record short
    for shuffle in (False, True):
        tp = trio.RecordPipeline(path, num_threads=2, shuffle=shuffle)
        jp = jrio.RecordPipeline(path, num_threads=2, shuffle=shuffle)
        got = _epoch(tp)
        assert got == _epoch(jp)
        assert sorted(got) == list(range(8))
