"""Contrib namespace of the port (ref: python/mxnet/contrib/): the chaos
plans and int8 quantization. The JAX package's other contrib modules
(control flow, text, SVRG, ONNX) are not ported yet (ROADMAP A14)."""
from . import chaos  # noqa: F401
from . import quantization  # noqa: F401

__all__ = ["chaos", "quantization"]
