"""Model families of the port (ref: the JAX package's models/): the
transformer LM on one device."""
from . import transformer  # noqa: F401

__all__ = ["transformer"]
