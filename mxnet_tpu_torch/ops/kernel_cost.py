"""The work of the hand-written kernels, as formulas of their shapes.

One source for two readers: ``chip_smoke.py``'s kernel table divides
these bytes and operations by the card's rates for each kernel's bound,
and the efficiency plane (``telemetry/efficiency.py``) takes a launched
kernel's bytes from here (:func:`bn_report`, :func:`flash_report`), so
the table and the plane count the same traffic.

Bytes are what a kernel must move: each input read once, each output
written once. Operations are the arithmetic the kernel does, per element
for the BatchNorm kernels (:data:`BN_OPS_PER_ELEMENT`) and the two
products for attention. The plane counts FLOPs in ``FlopCounterMode``'s
convention (matmuls, convolutions, attention; elementwise work is 0), so
it reports 0 FLOPs for the BatchNorm kernels and the full ``Q Kᵀ`` and
``P V`` products for flash, causal or not, as the formula for
``scaled_dot_product_attention`` does.
"""
from __future__ import annotations

__all__ = ["BN_OPS_PER_ELEMENT", "site_bytes_flops", "flash_flops",
           "flash_bytes", "bn_report", "flash_report"]

#: arithmetic per element of each BatchNorm kernel (the residual add of
#: bn_apply adds one more)
BN_OPS_PER_ELEMENT = {"bn_stats": 3, "bn_apply": 4, "bn_bwd_stats": 6,
                      "bn_bwd_apply": 7}


def site_bytes_flops(name, r, c, itemsize, has_res):
    """``(bytes, operations)`` of one BatchNorm kernel launch over an
    ``(r, c)`` site of ``itemsize``-byte elements: the rows read and
    written once, the f32 coefficient vectors and (2, C) sums."""
    n = r * c
    coef = {"bn_stats": 0, "bn_apply": 2, "bn_bwd_stats": 2,
            "bn_bwd_apply": 5}[name] * c * 4
    if name == "bn_stats":
        moved = n * itemsize + 2 * c * 4
    elif name == "bn_apply":
        moved = (3 if has_res else 2) * n * itemsize
    elif name == "bn_bwd_stats":
        moved = 3 * n * itemsize + 2 * c * 4
    else:
        moved = (5 if has_res else 4) * n * itemsize
    flops = BN_OPS_PER_ELEMENT[name] * n + (
        n if has_res and name == "bn_apply" else 0)
    return moved + coef, flops


def flash_flops(b, t, h, d, causal):
    """The attention forward's operations: 4*B*H*T^2*D, halved when
    causal (the kernel skips the masked tiles)."""
    return 4 * b * h * t * t * d / (2 if causal else 1)


def flash_bytes(b, t, h, d, itemsize):
    """q, k and v read once, o written once."""
    return 4 * b * t * h * d * itemsize


def bn_report(name, r, c, itemsize, has_res):
    """``(flops, bytes)`` a BatchNorm launch reports to the efficiency
    plane: no FLOPs (elementwise work), the formula's bytes."""
    return 0.0, float(site_bytes_flops(name, r, c, itemsize, has_res)[0])


def flash_report(b, t, h, d, itemsize):
    """``(flops, bytes)`` a flash launch reports to the efficiency plane:
    both products in full (the plain version's count, causal or not) and
    the formula's bytes."""
    return float(flash_flops(b, t, h, d, False)), \
        float(flash_bytes(b, t, h, d, itemsize))
