"""Optimizers (ref: python/mxnet/optimizer/__init__.py)."""
from .optimizer import *  # noqa: F401,F403
from .optimizer import (Optimizer, Updater, create, get_updater,  # noqa: F401
                        register)
from . import contrib  # noqa: F401
from . import grouped  # noqa: F401  (aggregated multi-tensor updates)
from .contrib import GroupAdaGrad  # noqa: F401
