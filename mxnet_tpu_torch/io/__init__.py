"""mx.io — data iterators (ref: python/mxnet/io/__init__.py; the JAX
package's ``io/``)."""
from ..ops.registry import NotPortedError
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, CSVIter,  # noqa
                 MNISTIter, ResizeIter, PrefetchingIter)
from .staging import DeviceStagingIter  # noqa


def _record_iter(name):
    class _NotPorted:
        def __init__(self, *args, **kwargs):
            raise NotPortedError(f"io.{name} (RecordIO) is not ported yet "
                                 "(ROADMAP.md, queue A14)")
    _NotPorted.__name__ = _NotPorted.__qualname__ = name
    return _NotPorted


ImageRecordIter = _record_iter("ImageRecordIter")
ImageDetRecordIter = _record_iter("ImageDetRecordIter")
LibSVMIter = _record_iter("LibSVMIter")

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "MNISTIter", "ResizeIter", "PrefetchingIter", "DeviceStagingIter",
           "ImageRecordIter", "ImageDetRecordIter", "LibSVMIter"]
