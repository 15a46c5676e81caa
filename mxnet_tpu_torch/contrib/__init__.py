"""Contrib namespace of the port (ref: python/mxnet/contrib/): the chaos
plans, int8 quantization and the imperative control flow (``foreach``,
``while_loop``, ``cond``, also ``mx.nd.contrib.*``; ``mx.sym.contrib``
has the symbolic ones). The JAX package's other contrib modules (text,
SVRG, ONNX) are not ported yet (ROADMAP A14)."""
import sys

from . import chaos  # noqa: F401
from . import control_flow  # noqa: F401
from . import quantization  # noqa: F401
from .control_flow import cond, foreach, while_loop  # noqa: F401

__all__ = ["chaos", "control_flow", "cond", "foreach", "quantization",
           "while_loop"]

# mx.nd.contrib carries the imperative control flow, as in the reference
_nd_contrib = sys.modules["mxnet_tpu_torch.ndarray.contrib"]
_nd_contrib.foreach = foreach
_nd_contrib.while_loop = while_loop
_nd_contrib.cond = cond
