"""RecordIO reader, writer and the sharded, shuffled record pipeline (ref:
dmlc-core RecordIO, src/io/iter_image_recordio_2.cc; the JAX package's
``io/record_io.py`` over its native ``src/recordio.cc``).

Plain Python, no host library. The byte format is the reference's:

    [u32 magic 0xCED7230A][u32 lrec][payload][zero pad to 4 bytes]

where ``lrec``'s upper 3 bits are the continuation flag (0: a whole
record; 1, 2, 3: first, middle, last part of a split one) and its lower
29 bits the payload length. :class:`RecordReader` reassembles split
records; :class:`RecordWriter` writes whole ones.

:class:`RecordPipeline` gives the native pipeline's records in the native
pipeline's order, bit for bit, because a shuffled epoch is part of the
result:

- its index holds the offsets of whole-record heads only (flag 0);
- ``part_index`` / ``num_parts`` take a contiguous shard of
  ``ceil(n / num_parts)`` of them;
- ``shuffle`` permutes the shard in place by Fisher-Yates over a
  splitmix64 stream seeded with ``seed + 0x9e3779b97f4a7c15 * (epoch + 1)``
  at construction (epoch 0) and again on every ``reset()`` (epoch + 1),
  starting from the previous epoch's order;
- records arrive in that order whatever thread read them; a record that
  cannot be read (a bad magic, a short read) is skipped in place.

Reads run on a thread pool, each thread with its own file handle, at most
256 records ahead of the consumer (the native pipeline's window).
"""
from __future__ import annotations

import collections
import concurrent.futures as _futures
import struct
import threading
from typing import List, Optional

from ..base import check

__all__ = ["RecordReader", "RecordWriter", "RecordPipeline",
           "shuffle_order"]

_MAGIC = 0xCED7230A
_LEN_MASK = (1 << 29) - 1
_U64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_CAPACITY = 256     # records read ahead of the consumer (the native window)


def _pad(length: int) -> int:
    return (4 - (length & 3)) & 3


class RecordWriter:
    """Sequential writer of whole records."""

    def __init__(self, path: str):
        self._fp = open(path, "wb")

    def write(self, data: bytes) -> None:
        self._fp.write(struct.pack("<II", _MAGIC, len(data) & _LEN_MASK))
        self._fp.write(data)
        self._fp.write(b"\x00" * _pad(len(data)))

    def tell(self) -> int:
        return self._fp.tell()

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None


class RecordReader:
    """Sequential reader; split records come back reassembled. ``read()``
    is None at the end of the file or at a bad magic."""

    def __init__(self, path: str):
        self._fp = open(path, "rb")

    def read(self) -> Optional[bytes]:
        parts = []
        while True:
            head = self._fp.read(8)
            if len(head) < 8:
                return None
            magic, lrec = struct.unpack("<II", head)
            if magic != _MAGIC:
                return None
            length = lrec & _LEN_MASK
            data = self._fp.read(length)
            if len(data) < length:
                return None
            parts.append(data)
            self._fp.seek(_pad(length), 1)
            if (lrec >> 29) in (0, 3):
                return b"".join(parts)

    def seek(self, pos: int) -> None:
        self._fp.seek(pos)

    def tell(self) -> int:
        return self._fp.tell()

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None


def _heads(path: str) -> List[int]:
    """Offsets of the whole-record heads (flag 0), in file order."""
    out = []
    with open(path, "rb") as fp:
        pos = 0
        while True:
            head = fp.read(8)
            if len(head) < 8:
                break
            magic, lrec = struct.unpack("<II", head)
            if magic != _MAGIC:
                break
            length = lrec & _LEN_MASK
            if lrec >> 29 == 0:
                out.append(pos)
            pos += 8 + length + _pad(length)
            fp.seek(pos)
    return out


def shuffle_order(items: list, seed: int, epoch: int) -> None:
    """Permute ``items`` in place as the native pipeline does: Fisher-Yates
    from the last slot down, over splitmix64 seeded by
    ``seed + 0x9e3779b97f4a7c15 * (epoch + 1)`` (all mod 2^64)."""
    x = (int(seed) + _GOLDEN * (int(epoch) + 1)) & _U64
    for i in range(len(items), 1, -1):
        x = (x + _GOLDEN) & _U64
        z = x
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
        z ^= z >> 31
        j = z % i
        items[i - 1], items[j] = items[j], items[i - 1]


class RecordPipeline:
    """Threaded, ordered prefetch of a shard of a ``.rec`` file (ref:
    iter_image_recordio_2.cc part_index / num_parts; see the module
    docstring for the order)."""

    def __init__(self, path: str, num_threads: int = 4, part_index: int = 0,
                 num_parts: int = 1, shuffle: bool = False, seed: int = 0,
                 max_record: int = 1 << 24):
        check(int(num_parts) >= 1 and 0 <= int(part_index) < int(num_parts),
              "bad part_index / num_parts")
        self._path = path
        heads = _heads(path)
        per = -(-len(heads) // int(num_parts))
        lo = per * int(part_index)
        self._offsets = heads[lo:lo + per]
        self._shuffle = bool(shuffle)
        self._seed = int(seed)
        self._epoch = 0
        if self._shuffle:
            shuffle_order(self._offsets, self._seed, self._epoch)
        self._max_record = int(max_record)
        self._local = threading.local()
        self._files: list = []
        self._files_lock = threading.Lock()
        self._pool = _futures.ThreadPoolExecutor(
            max_workers=max(1, int(num_threads)),
            thread_name_prefix="recordio")
        self._start()

    def __len__(self) -> int:
        return len(self._offsets)

    def _file(self):
        fp = getattr(self._local, "fp", None)
        if fp is None:
            fp = self._local.fp = open(self._path, "rb")
            with self._files_lock:
                self._files.append(fp)
        return fp

    def _read_at(self, offset: int) -> Optional[bytes]:
        """The record at ``offset``; None where it cannot be read."""
        try:
            fp = self._file()
            fp.seek(offset)
            head = fp.read(8)
            if len(head) < 8:
                return None
            magic, lrec = struct.unpack("<II", head)
            if magic != _MAGIC:
                return None
            length = lrec & _LEN_MASK
            data = fp.read(length)
            return data if len(data) == length else None
        except OSError:
            return None

    def _start(self) -> None:
        self._next_submit = 0
        self._window: collections.deque = collections.deque()
        self._fill()

    def _fill(self) -> None:
        while (len(self._window) < _CAPACITY
               and self._next_submit < len(self._offsets)):
            self._window.append(self._pool.submit(
                self._read_at, self._offsets[self._next_submit]))
            self._next_submit += 1

    def next(self) -> Optional[bytes]:
        """The next readable record in order, or None at the epoch's end."""
        while self._window:
            rec = self._window.popleft().result()
            self._fill()
            if rec is not None:
                check(len(rec) <= self._max_record,
                      "record larger than pipeline buffer")
                return rec
        return None

    def _drain(self) -> None:
        for fut in self._window:
            fut.cancel()
        _futures.wait(list(self._window))
        self._window.clear()

    def reset(self) -> None:
        """Start the next epoch (reshuffled from this epoch's order)."""
        self._drain()
        self._epoch += 1
        if self._shuffle:
            shuffle_order(self._offsets, self._seed, self._epoch)
        self._start()

    def close(self) -> None:
        if self._pool is None:
            return
        self._drain()
        self._pool.shutdown(wait=True)
        self._pool = None
        with self._files_lock:
            for fp in self._files:
                fp.close()
            self._files.clear()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
