"""Contrib namespace of the port (ref: python/mxnet/contrib/): the chaos
plans. The JAX package's other contrib modules (control flow,
quantization, text, SVRG, ONNX) are not ported yet (ROADMAP A13, A14)."""
from . import chaos  # noqa: F401

__all__ = ["chaos"]
