"""The 14 ``_image_*`` ops of the port against the JAX package's, on the
CPU, on the same seeded numpy images (HWC and NHWC, uint8 and float32).

Tolerances:
- elementwise ops (to_tensor, normalize, the flips, brightness, lighting)
  bit for bit, 1e-6 relative in f32 where the JAX op divides;
- contrast, saturation and hue 1e-4 of 255 in f32 and 1 in uint8 (a
  mean or a 3-term dot in another order);
- ``_image_resize`` 1e-3 of 255 in f32 and 1 in uint8, every interp code,
  enlarging and shrinking, ``keep_ratio``, HWC and NHWC.

The random ops draw other numbers than the JAX ops (a torch generator
against a JAX key), so they run on degenerate ranges (``min_factor ==
max_factor``), or the factors the port drew are handed to the JAX
package's adjust functions; random flips are held to {x, flip(x)}.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import mxnet_tpu as jmx
from mxnet_tpu.ops import image_ops as jops

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.ops import image_ops as tops


@pytest.fixture(autouse=True)
def _host():
    with mt.cpu():
        yield


def _img(shape, dtype, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randint(0, 256, shape)
    if dtype == np.float32:
        x = x + rs.rand(*shape)
    return x.astype(dtype)


def _tol(dtype):
    return 1.0 if dtype == np.uint8 else 1e-4 * 255


def _close(got, want, atol):
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=0, atol=atol)


def _both(name, x, **params):
    got = getattr(mt.nd.image, name)(mt.nd.array(x, dtype=x.dtype), **params)
    want = getattr(jmx.nd.image, name)(jmx.nd.array(x, dtype=x.dtype),
                                       **params)
    return got.asnumpy(), want.asnumpy()


SHAPES = [(12, 10, 3), (2, 12, 10, 3)]
DTYPES = [np.uint8, np.float32]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["to_tensor", "flip_left_right",
                                  "flip_top_bottom"])
def test_elementwise_ops_bit_for_bit(name, shape, dtype):
    got, want = _both(name, _img(shape, dtype))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(3, 12, 10), (2, 3, 12, 10)])
def test_normalize(shape):
    x = _img(shape, np.float32) / 255.0
    got, want = _both("normalize", x.astype(np.float32),
                      mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_adjust_lighting_bit_for_bit(shape, dtype):
    got, want = _both("adjust_lighting", _img(shape, dtype),
                      alpha=(0.3, -0.8, 1.2))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_random_brightness_degenerate_bit_for_bit(shape, dtype):
    got, want = _both("random_brightness", _img(shape, dtype),
                      min_factor=1.37, max_factor=1.37)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name,factor", [
    ("random_contrast", 0.55), ("random_saturation", 1.8),
    ("random_hue", 0.21), ("random_hue", -0.4)])
def test_color_ops_degenerate(name, factor, shape, dtype):
    got, want = _both(name, _img(shape, dtype), min_factor=factor,
                      max_factor=factor)
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_single_channel_color_ops(dtype):
    x = _img((2, 9, 7, 1), dtype)
    for name in ("random_contrast", "random_saturation", "random_hue"):
        got, want = _both(name, x, min_factor=0.6, max_factor=0.6)
        _close(got, want, _tol(dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_random_flips_give_x_or_its_flip(dtype):
    x = _img((2, 8, 6, 3), dtype)
    seen = {"lr": set(), "tb": set()}
    for i in range(16):
        for key, name, axis in (("lr", "random_flip_left_right", 2),
                                ("tb", "random_flip_top_bottom", 1)):
            y = getattr(mt.nd.image, name)(mt.nd.array(x, dtype=x.dtype))
            y = y.asnumpy()
            flipped = np.flip(x, axis)
            assert np.array_equal(y, x) or np.array_equal(y, flipped)
            seen[key].add(np.array_equal(y, flipped))
    assert seen == {"lr": {True, False}, "tb": {True, False}}


@pytest.mark.parametrize("dtype", DTYPES)
def test_random_lighting_is_adjust_lighting_of_its_draw(dtype):
    x = _img((10, 8, 3), dtype)
    gen = torch.Generator().manual_seed(3)
    alpha = (torch.randn((3,), generator=gen) * 0.1).numpy()
    got = tops._image_random_lighting(
        torch.from_numpy(x), alpha_std=0.1,
        generator=torch.Generator().manual_seed(3)).numpy()
    want = np.asarray(jops._image_adjust_lighting(jnp.asarray(x),
                                                  alpha=tuple(alpha)))
    _close(got, want, 1e-4 if dtype == np.float32 else 1.0)
    # alpha_std 0 leaves the image as it is
    got, want = _both("random_lighting", x, alpha_std=0.0)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)


ALL4 = dict(brightness=0.4, contrast=0.4, saturation=0.4, hue=0.1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("jitter,shape", [
    (ALL4, SHAPES[0]), (ALL4, SHAPES[1]), (dict(contrast=0.5), SHAPES[1]),
    (dict(saturation=0.6), SHAPES[0]), (dict(hue=0.3), SHAPES[0])])
def test_color_jitter_is_the_jax_order_on_its_factors(jitter, shape, dtype):
    """The port draws the factors; the JAX package's adjust functions,
    applied in the JAX op's fixed order to those factors, give the
    port's output."""
    x = _img(shape, dtype)
    got = tops._image_random_color_jitter(
        torch.from_numpy(x), generator=torch.Generator().manual_seed(9),
        **jitter).numpy()
    factors = tops.jitter_factors(
        jitter.get("brightness", 0), jitter.get("contrast", 0),
        jitter.get("saturation", 0), jitter.get("hue", 0),
        torch.Generator().manual_seed(9), torch.device("cpu"))
    y = jnp.asarray(x).astype(jnp.float32)
    for name, fn in (("brightness", jops._adjust_brightness),
                     ("contrast", jops._adjust_contrast),
                     ("saturation", jops._adjust_saturation),
                     ("hue", jops._adjust_hue)):
        if name in factors:
            y = fn(y, jnp.float32(float(factors[name])), jnp.float32)
    want = np.asarray(jops._saturate(y, x.dtype))
    _close(got, want, _tol(dtype))
    # and through mx.nd, a draw inside each factor's range
    out = mt.nd.image.random_color_jitter(mt.nd.array(x, dtype=x.dtype),
                                          **jitter)
    assert out.shape == x.shape and out.asnumpy().dtype == x.dtype


RESIZES = [((24, 19), False), ((7, 5), False), (6, True)]
# every interp code; 3 and 4 are bicubic too, as in the JAX op
RESIZE_CASES = [(i, d, b) for i in (0, 1, 2) for d in DTYPES
                for b in (False, True)] + \
    [(3, np.float32, True), (4, np.uint8, False)]


@pytest.mark.parametrize("interp,dtype,batched", RESIZE_CASES)
def test_resize_matches_jax_image_resize(interp, dtype, batched):
    x = _img((2, 13, 17, 3) if batched else (13, 17, 3), dtype)
    for size, keep in RESIZES:
        got, want = _both("resize", x, size=size, keep_ratio=keep,
                          interp=interp)
        _close(got, want, 1.0 if dtype == np.uint8 else 1e-3 * 255)


def test_resize_keep_ratio_shapes():
    x = _img((10, 8, 3), np.uint8)
    got, want = _both("resize", x, size=())
    np.testing.assert_array_equal(got, want)
    assert mt.nd.image.resize(mt.nd.array(x, dtype="uint8"), size=(4, 5)) \
        .shape == (5, 4, 3)
    assert mt.nd.image.resize(mt.nd.array(x, dtype="uint8"), size=4,
                              keep_ratio=True).shape == (5, 4, 3)


def test_image_namespace_is_the_registry_ops():
    names = {n for n in vars(mt.nd.image) if not n.startswith("__")}
    assert names == {n for n in vars(jmx.nd.image)
                     if not n.startswith("__")}
    assert mt.nd.image.resize.__name__ == "_image_resize"
    assert mt.nd._internal._image_to_tensor is mt.nd.image.to_tensor
