"""mx.io — data iterators (ref: python/mxnet/io/__init__.py; the JAX
package's ``io/``)."""
from .io import (DataDesc, DataBatch, DataIter, NDArrayIter, CSVIter,  # noqa
                 MNISTIter, ResizeIter, PrefetchingIter)
from .image_record import (ImageRecordIter, ImageDetRecordIter,  # noqa
                           LibSVMIter)
from .staging import DeviceStagingIter  # noqa

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "MNISTIter", "ResizeIter", "PrefetchingIter", "DeviceStagingIter",
           "ImageRecordIter", "ImageDetRecordIter", "LibSVMIter"]
