"""``mx.mod``: the Module API (ref: the JAX package's ``module/``;
python/mxnet/module/). A Module binds a Symbol to data shapes through one
Executor and trains it (``fit``, ``score``, ``predict``); a
BucketingModule keeps one Module a bucket over the same parameter
tensors; a SequentialModule chains Modules."""
from .base_module import BaseModule  # noqa: F401
from .module import Module  # noqa: F401
from .bucketing_module import BucketingModule  # noqa: F401
from .sequential_module import SequentialModule  # noqa: F401
