"""mx.recordio: the RecordIO surface (ref: python/mxnet/recordio.py; the
JAX package's ``recordio.py``): ``MXRecordIO``, ``MXIndexedRecordIO``
(the ``.idx`` sidecar of ``key\\toffset`` lines), ``IRHeader``, ``pack``,
``unpack``, ``pack_img`` and ``unpack_img``.

The wire format is the reference's, so ``.rec`` / ``.idx`` files written
by either package (or by im2rec) read in the other. Images are JPEG or
PNG through cv2 where cv2 is importable; without it ``pack_img`` writes
``np.save`` bytes and ``unpack_img`` reads those and raises on any other
payload, as the JAX package does.
"""
from __future__ import annotations

import collections
import io as _io
import os
import struct
from typing import Optional

import numpy as np

from .base import MXNetError, check
from .io.record_io import RecordReader, RecordWriter

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

IRHeader = collections.namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)
_NPY_MAGIC = b"\x93NUMPY"


class MXRecordIO:
    """Sequential ``.rec`` access; ``flag`` is "r" or "w". Pickles
    without its file handle and reopens on unpickling."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self._impl = None
        self.is_open = False
        self.open()

    def open(self):
        if self.flag == "w":
            self._impl = RecordWriter(self.uri)
            self.writable = True
        elif self.flag == "r":
            self._impl = RecordReader(self.uri)
            self.writable = False
        else:
            raise MXNetError(f"invalid flag {self.flag}")
        self.is_open = True

    def close(self):
        if self.is_open:
            self._impl.close()
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def write(self, buf: bytes):
        check(self.writable, "not opened for writing")
        self._impl.write(buf)

    def read(self) -> Optional[bytes]:
        check(not self.writable, "not opened for reading")
        return self._impl.read()

    def tell(self) -> int:
        return self._impl.tell()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_impl"] = None
        d["is_open"] = False
        if "fidx" in d:
            d["fidx"] = None
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self.open()


class MXIndexedRecordIO(MXRecordIO):
    """Random access by key through the ``.idx`` sidecar."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.exists(self.idx_path):
            with open(self.idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) >= 2:
                        key = self.key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)
        elif self.writable:
            self.fidx = open(self.idx_path, "w")

    def close(self):
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None
        super().close()

    def seek(self, idx):
        check(not self.writable, "seek on writer")
        self._impl.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf: bytes):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write(f"{key}\t{pos}\n")
        self.idx[key] = pos
        self.keys.append(key)


def pack(header: IRHeader, s: bytes) -> bytes:
    """A record: the header, then the label array when ``flag`` > 0, then
    ``s``."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        hdr = struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                          header.id2)
        return hdr + s
    label = np.asarray(header.label, dtype=np.float32)
    hdr = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
    return hdr + label.tobytes() + s


def unpack(s: bytes):
    """(header, payload) of a record."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = np.frombuffer(s[:flag * 4], dtype=np.float32)
        s = s[flag * 4:]
    return IRHeader(flag, label, id_, id2), s


def pack_img(header: IRHeader, img, quality: int = 95,
             img_fmt: str = ".jpg") -> bytes:
    """A record holding ``img`` encoded by cv2 (JPEG or PNG), or as npy
    bytes where cv2 is not importable."""
    try:
        import cv2
    except ImportError:
        buf = _io.BytesIO()
        np.save(buf, np.asarray(img), allow_pickle=False)
        return pack(header, buf.getvalue())
    fmt = img_fmt.lower()
    params = [cv2.IMWRITE_JPEG_QUALITY, quality] \
        if fmt in (".jpg", ".jpeg") else \
        ([cv2.IMWRITE_PNG_COMPRESSION, 3] if fmt == ".png" else [])
    ok, buf = cv2.imencode(fmt, np.asarray(img), params)
    check(ok, "image encode failed")
    return pack(header, buf.tobytes())


def unpack_img(s: bytes, iscolor: int = -1):
    """(header, image as a numpy array) of a record: npy payloads always,
    JPEG / PNG through cv2."""
    header, payload = unpack(s)
    if payload[:6] == _NPY_MAGIC:
        return header, np.load(_io.BytesIO(payload), allow_pickle=False)
    try:
        import cv2
    except ImportError:
        raise MXNetError("record payload needs cv2 to decode") from None
    img = cv2.imdecode(np.frombuffer(payload, np.uint8), iscolor)
    check(img is not None, "image decode failed")
    return header, img
