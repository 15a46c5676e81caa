"""2-bit gradient compression with error feedback (ref: the JAX package's
``gradient_compression.py``; src/kvstore/gradient_compression.{h,cc} and
``mx.kv.set_gradient_compression({'type': '2bit', 'threshold': t})``).

Each push quantizes ``g + residual`` to {-1, 0, +1} at ``threshold``
(``q = +1`` where ``g + r >= t``, ``-1`` where ``<= -t``) and keeps the
error ``g + r - q * t`` as the key's residual for the next push. On the
wire the codes travel packed four to a byte (codes {-1, 0, 1} -> {2, 0,
1}, the first element in the low bits): ``n / 4`` bytes instead of
``4 n``. Plain torch on the gradient's device; the packed bytes and the
residuals are the JAX package's, bit for bit.
"""
from __future__ import annotations

from typing import Dict

import torch

from .base import check

__all__ = ["GradientCompression"]

_SHIFTS = (0, 2, 4, 6)


class GradientCompression:
    def __init__(self, type: str = "2bit", threshold: float = 0.5):
        check(type == "2bit", f"unsupported compression type {type}")
        check(threshold > 0, "threshold must be positive")
        self.type = type
        self.threshold = float(threshold)
        self._residuals: Dict = {}

    def compress(self, key, grad: torch.Tensor) -> torch.Tensor:
        """The int8 {-1, 0, 1} codes of ``grad`` plus the key's residual;
        the new residual is kept."""
        thr = self.threshold
        res = self._residuals.get(key)
        if res is None or res.shape != grad.shape or \
                res.device != grad.device:
            res = torch.zeros_like(grad)
        with torch.no_grad():
            g = grad + res
            q = torch.where(g >= thr, 1, torch.where(g <= -thr, -1, 0)) \
                .to(torch.int8)
            self._residuals[key] = g - q.to(grad.dtype) * thr
        return q

    def decompress(self, q: torch.Tensor, dtype) -> torch.Tensor:
        return q.to(dtype) * self.threshold

    def roundtrip(self, key, grad: torch.Tensor) -> torch.Tensor:
        return self.decompress(self.compress(key, grad), grad.dtype)

    # -- wire format ----------------------------------------------------
    @staticmethod
    def pack(q: torch.Tensor) -> torch.Tensor:
        """int8 {-1, 0, 1} -> uint8, four codes a byte, zero-padded."""
        flat = q.reshape(-1)
        pad = (-flat.numel()) % 4
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        codes = torch.where(flat < 0, 2, flat).to(torch.uint8).view(-1, 4)
        return codes[:, 0] | (codes[:, 1] << 2) | (codes[:, 2] << 4) | \
            (codes[:, 3] << 6)

    @staticmethod
    def unpack(packed: torch.Tensor, nelem: int) -> torch.Tensor:
        """uint8 -> int8 codes {-1, 0, 1}, the first ``nelem``."""
        shifts = torch.tensor(_SHIFTS, dtype=torch.uint8,
                              device=packed.device)
        codes = ((packed[:, None] >> shifts[None, :]) & 3) \
            .to(torch.int8).reshape(-1)
        return torch.where(codes == 2, -1, codes).to(torch.int8)[
            :int(nelem)]

    def compress_packed(self, key, grad: torch.Tensor):
        """Compress with error feedback and pack for the wire: returns
        ``(packed uint8, nelem)``."""
        q = self.compress(key, grad)
        return self.pack(q), q.numel()

    def decode_packed(self, packed, nelem, shape, dtype) -> torch.Tensor:
        """Wire payload -> the dequantized gradient."""
        return self.decompress(self.unpack(packed, nelem), dtype) \
            .reshape(shape)
