"""Training-step drivers of the port (ref: the JAX package's parallel/)."""
from .spmd import SPMDTrainer

__all__ = ["SPMDTrainer"]
