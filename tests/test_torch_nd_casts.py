"""Float to integer casts and ``_split_v2`` with boundary indices that do
not start at 0, the port against the JAX package on the CPU.

The JAX package's ``astype`` is XLA's convert: a float cast to an integer
type truncates toward zero and saturates at the type's limits, and NaN
gives 0. Every cast path of the port (``NDArray.astype``, ``Cast``,
``cast``, ``amp_cast``) goes through one saturating cast. ``int64`` is
left out: the JAX package runs with x64 off and gives int32 there.

``_split_v2`` drops ``indices[0]`` (the leading 0 of MXNet's serialised
attributes) and splits at the rest, as the JAX op does.
"""
import numpy as np
import pytest

from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd as tnd

VALUES = np.array([300.7, -1.5, -200.2, np.nan, np.inf, -np.inf, 127.9,
                   255.5, -0.5, 3e9, -3e9, 2147483647.0, -2147483648.0],
                  np.float32)
EXPECTED = {
    "uint8": [255, 0, 0, 0, 255, 0, 127, 255, 0, 255, 0, 255, 0],
    "int8": [127, -1, -128, 0, 127, -128, 127, 127, 0, 127, -128, 127,
             -128],
    "int32": [300, -1, -200, 0, 2147483647, -2147483648, 127, 255, 0,
              2147483647, -2147483648, 2147483647, -2147483648],
}


def _port(path, x, dtype):
    with mt.cpu():
        a = tnd.array(x, dtype=x.dtype)
        if path == "astype":
            out = a.astype(dtype)
        elif path == "Cast":
            out = tnd.Cast(a, dtype=dtype)
        elif path == "cast":
            out = tnd.cast(a, dtype=dtype)
        else:
            out = tnd.amp_cast(a, dtype=dtype)
        return out.asnumpy()


@pytest.mark.parametrize("src", ["float32", "float16", "float64"])
@pytest.mark.parametrize("path", ["astype", "Cast", "cast", "amp_cast"])
@pytest.mark.parametrize("dtype", sorted(EXPECTED))
def test_float_to_int_saturates_as_the_jax_package(dtype, path, src):
    with np.errstate(over="ignore"):      # 3e9 is inf in float16
        x = VALUES.astype(src)
    want = jnd.array(x, dtype=x.dtype).astype(dtype).asnumpy()
    got = _port(path, x, dtype)
    assert got.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got, want)
    if src == "float32":
        np.testing.assert_array_equal(got, np.array(EXPECTED[dtype], dtype))


def test_integer_casts_still_wrap_as_xla_does():
    x = np.array([300, -1, 70000, -129], np.int32)
    for dtype in ("uint8", "int8", "int16"):
        want = jnd.array(x, dtype=x.dtype).astype(dtype).asnumpy()
        np.testing.assert_array_equal(_port("astype", x, dtype), want)


@pytest.mark.parametrize("indices,axis", [((1, 3), 1), ((0, 3), 1),
                                          ((2,), 0), ((1, 2, 2), 1),
                                          ((3, 1), 1)])
def test_split_v2_drops_the_first_index(indices, axis):
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    jout = jnd.op._split_v2(jnd.array(x), indices=indices, axis=axis)
    with mt.cpu():
        tout = tnd.op._split_v2(tnd.array(x), indices=indices, axis=axis)
    jout = jout if isinstance(jout, (list, tuple)) else [jout]
    tout = tout if isinstance(tout, (list, tuple)) else [tout]
    assert len(tout) == len(jout) == len(indices)
    for t, j in zip(tout, jout):
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    if indices == (1, 3):
        assert [t.shape for t in tout] == [(3, 3), (3, 1)]
