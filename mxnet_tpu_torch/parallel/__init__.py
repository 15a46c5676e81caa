"""Training-step drivers and attention of the port (ref: the JAX package's
parallel/)."""
from .ring_attention import attention
from .spmd import SPMDTrainer

__all__ = ["SPMDTrainer", "attention"]
