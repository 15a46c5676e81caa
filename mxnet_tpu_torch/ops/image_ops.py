"""``mx.nd.image`` operators (ref: src/operator/image/image_random.cc,
src/operator/image/resize.cc; the JAX package's ``ops/image_ops.py``).

The 14 ``_image_*`` registry names with the JAX flags. Every op takes an
HWC image or an NHWC batch (``to_tensor`` / ``normalize`` give and take
CHW / NCHW), computes in float32 and casts back to the input's dtype
through :func:`saturate` (integer outputs: round half to even, then clip
to the type's range, as the reference's ``saturate_cast``).

- ``_image_resize`` is ``jax.image.resize``: it antialiases when it
  shrinks. Bilinear and bicubic are ``F.interpolate(..., antialias=True)``
  (bicubic with antialias is Keys' a = -0.5, the kernel JAX uses, also
  when enlarging; without antialias PyTorch's bicubic is a = -0.75), and
  nearest is ``"nearest-exact"`` (half-pixel centres, as JAX's).
- The contrast mean is per image, over H and W only.
- Hue goes through the reference's HLS round trip; its sector arithmetic
  is a floor modulo (``torch.remainder``, as ``jnp.mod``).
- ``_image_random_color_jitter`` applies brightness, contrast, saturation
  and hue in that fixed order, as the JAX op does.
- The random ops draw from ``generator`` or the device's default
  generator (see :mod:`mxnet_tpu_torch.random`), where the JAX ops take a
  key; a random flip flips the whole batch on one coin, as the JAX op.
"""
from __future__ import annotations

import numpy as _np
import torch
import torch.nn.functional as F

from .random_ops import stream as _stream
from .registry import register

__all__ = ["saturate", "resize", "adjust_brightness", "adjust_contrast",
           "adjust_saturation", "adjust_hue", "adjust_lighting",
           "jitter_factors", "color_jitter"]

# ITU-R BT.601 luma coefficients (ref: image_random-inl.h)
_GRAY_COEF = (0.299, 0.587, 0.114)
# AlexNet PCA lighting basis (ref: image_random-inl.h AdjustLightingImpl)
_EIGVAL = _np.array([55.46, 4.794, 1.148], _np.float32)
_EIGVEC = _np.array([[-0.5675, 0.7192, 0.4009],
                     [-0.5808, -0.0045, -0.8140],
                     [-0.5836, -0.6948, 0.4203]], _np.float32)
_EPS = float(_np.finfo(_np.float32).eps)
_INV255 = float(_np.float32(1.0 / 255.0))


def saturate(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``saturate_cast``: for integer dtypes round half to even and clip
    to the range; then cast."""
    if not dtype.is_floating_point and dtype != torch.bool:
        info = torch.iinfo(dtype)
        x = torch.clamp(torch.round(x), info.min, info.max)
    return x.to(dtype)


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32)


def _uniform(gen, device, lo, hi) -> torch.Tensor:
    """One f32 draw in [lo, hi) on ``device`` (exactly ``lo`` when
    ``lo == hi``)."""
    u = torch.rand((), generator=gen, device=device, dtype=torch.float32)
    return u * (float(hi) - float(lo)) + float(lo)


@register("_image_to_tensor", differentiable=False)
def _image_to_tensor(data, **_):
    """HWC [0, 255] -> CHW float32 [0, 1] (NHWC -> NCHW). The scaling is
    a product with f32(1 / 255), the rounding XLA gives the JAX op's
    division by the constant."""
    x = _f32(data) * _INV255
    perm = (2, 0, 1) if x.dim() == 3 else (0, 3, 1, 2)
    return x.permute(perm).contiguous()


@register("_image_normalize")
def _image_normalize(data, mean=(0.0,), std=(1.0,), **_):
    """(x - mean) / std per channel on CHW / NCHW float input."""
    mean = torch.as_tensor(_np.asarray(mean, _np.float32).reshape(-1, 1, 1),
                           device=data.device)
    std = torch.as_tensor(_np.asarray(std, _np.float32).reshape(-1, 1, 1),
                          device=data.device)
    return (data - mean) / std


def _target_hw(h, w, size, keep_ratio):
    if isinstance(size, (int, _np.integer)):
        size = (size,)
    size = tuple(int(s) for s in size)
    if len(size) == 0:
        return h, w
    if len(size) == 1:
        if keep_ratio:              # the short edge goes to size
            if h < w:
                return size[0], max(1, round(w * size[0] / h))
            return max(1, round(h * size[0] / w)), size[0]
        return size[0], size[0]
    return size[1], size[0]         # size is (w, h)


_METHODS = {0: "nearest", 1: "bilinear", 2: "bicubic", 3: "bicubic",
            4: "bicubic"}


def resize(x: torch.Tensor, h: int, w: int, method: str) -> torch.Tensor:
    """``jax.image.resize`` of the first two axes of an (H, W, ...) f32
    tensor to (h, w)."""
    lead = x.shape[:2]
    rest = x.shape[2:]
    nchw = x.reshape(lead[0], lead[1], -1).permute(2, 0, 1).unsqueeze(0)
    if method == "nearest":
        out = F.interpolate(nchw, size=(h, w), mode="nearest-exact")
    else:
        out = F.interpolate(nchw, size=(h, w), mode=method,
                            align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).reshape((h, w) + tuple(rest))


@register("_image_resize", differentiable=False)
def _image_resize(data, size=(), keep_ratio=False, interp=1, **_):
    """HWC / NHWC resize; ``size`` is (), an int or (w, h)."""
    method = _METHODS.get(int(interp), "bilinear")
    batched = data.dim() == 4
    h, w = (data.shape[1], data.shape[2]) if batched else \
        (data.shape[0], data.shape[1])
    new_h, new_w = _target_hw(h, w, size, keep_ratio)
    x = _f32(data)
    if batched:     # (N, H, W, C) -> (H, W, N, C)
        out = resize(x.permute(1, 2, 0, 3), new_h, new_w, method)
        out = out.permute(2, 0, 1, 3)
    else:
        out = resize(x, new_h, new_w, method)
    return saturate(out.contiguous(), data.dtype)


def _flip(data, axis_from_last):
    return torch.flip(data, (data.dim() + axis_from_last,))


@register("_image_flip_left_right", differentiable=False)
def _image_flip_left_right(data, **_):
    return _flip(data, -2)


@register("_image_flip_top_bottom", differentiable=False)
def _image_flip_top_bottom(data, **_):
    return _flip(data, -3)


def _random_flip(data, generator, axis_from_last):
    coin = torch.rand((), generator=_stream(generator, data.device),
                      device=data.device) < 0.5
    return torch.where(coin, _flip(data, axis_from_last), data)


@register("_image_random_flip_left_right", rng=True, differentiable=False)
def _image_random_flip_left_right(data, generator=None, **_):
    return _random_flip(data, generator, -2)


@register("_image_random_flip_top_bottom", rng=True, differentiable=False)
def _image_random_flip_top_bottom(data, generator=None, **_):
    return _random_flip(data, generator, -3)


def _gray(x):
    """BT.601 luma of the last (RGB) axis, f32."""
    c0, c1, c2 = _GRAY_COEF
    return x[..., 0] * c0 + x[..., 1] * c1 + x[..., 2] * c2


def adjust_brightness(x, alpha, dtype):
    return saturate(x * alpha, dtype)


def adjust_contrast(x, alpha, dtype):
    """Blend with each image's gray mean (over H and W, never across the
    batch)."""
    spatial = (x.dim() - 3, x.dim() - 2)
    if x.shape[-1] == 3:
        mean = _gray(x).mean(dim=spatial, keepdim=True)[..., None]
    else:
        mean = x.mean(dim=spatial + (x.dim() - 1,), keepdim=True)
    return saturate(x * alpha + (1.0 - alpha) * mean, dtype)


def adjust_saturation(x, alpha, dtype):
    if x.shape[-1] != 3:
        return saturate(x, dtype)
    gray = _gray(x)[..., None]
    return saturate(x * alpha + (1.0 - alpha) * gray, dtype)


def _rgb_to_hls(rgb):
    """RGB2HLSConvert (ref: image_random-inl.h:783-822), vectorised."""
    x = rgb / 255.0
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    vmax = torch.maximum(torch.maximum(r, g), b)
    vmin = torch.minimum(torch.minimum(r, g), b)
    diff = vmax - vmin
    l = (vmax + vmin) * 0.5
    safe = diff > _EPS
    denom = torch.where(l < 0.5, vmax + vmin, 2.0 - vmax - vmin)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    s = torch.where(safe, diff / torch.clamp(denom, min=_EPS), zero)
    d = 60.0 / torch.clamp(diff, min=_EPS)
    h = torch.where(vmax == r, (g - b) * d,
                    torch.where(vmax == g, (b - r) * d + 120.0,
                                (r - g) * d + 240.0))
    h = torch.where(h < 0, h + 360.0, h)
    h = torch.where(safe, h, zero)
    return h, l, s


def _hls_to_rgb(h, l, s):
    """HLS2RGBConvert (ref: image_random-inl.h:824-879), vectorised."""
    p2 = torch.where(l <= 0.5, l * (1 + s), l + s - l * s)
    p1 = 2 * l - p2
    hh = torch.remainder(h / 60.0, 6.0)
    sector = torch.floor(hh).to(torch.int32)
    frac = hh - sector
    t_up = p1 + (p2 - p1) * frac
    t_down = p1 + (p2 - p1) * (1 - frac)

    def sel(table):
        out = table[0]
        for i in range(1, 6):
            out = torch.where(sector == i, table[i], out)
        return out

    r = sel([p2, t_down, p1, p1, t_up, p2])
    g = sel([t_up, p2, p2, t_down, p1, p1])
    b = sel([p1, p1, t_up, p2, p2, t_down])
    gray = torch.broadcast_to(l, r.shape)
    mask = s != 0
    r = torch.where(mask, r, gray)
    g = torch.where(mask, g, gray)
    b = torch.where(mask, b, gray)
    return torch.stack([r * 255.0, g * 255.0, b * 255.0], dim=-1)


def adjust_hue(x, alpha, dtype):
    if x.shape[-1] != 3:
        return saturate(x, dtype)
    h, l, s = _rgb_to_hls(_f32(x))
    return saturate(_hls_to_rgb(h + alpha * 360.0, l, s), dtype)


def _lighting_rgb(alpha: torch.Tensor) -> torch.Tensor:
    eigvec = torch.as_tensor(_EIGVEC, device=alpha.device)
    eigval = torch.as_tensor(_EIGVAL, device=alpha.device)
    return eigvec @ (alpha * eigval)


def adjust_lighting(x, alpha, dtype):
    """Add the PCA lighting offset ``EIGVEC @ (alpha * EIGVAL)``."""
    return saturate(_f32(x) + _lighting_rgb(alpha), dtype)


@register("_image_random_brightness", rng=True, differentiable=False)
def _image_random_brightness(data, min_factor=0.0, max_factor=0.0,
                             generator=None, **_):
    alpha = _uniform(_stream(generator, data.device), data.device,
                     min_factor, max_factor)
    return adjust_brightness(_f32(data), alpha, data.dtype)


@register("_image_random_contrast", rng=True, differentiable=False)
def _image_random_contrast(data, min_factor=0.0, max_factor=0.0,
                           generator=None, **_):
    alpha = _uniform(_stream(generator, data.device), data.device,
                     min_factor, max_factor)
    return adjust_contrast(_f32(data), alpha, data.dtype)


@register("_image_random_saturation", rng=True, differentiable=False)
def _image_random_saturation(data, min_factor=0.0, max_factor=0.0,
                             generator=None, **_):
    alpha = _uniform(_stream(generator, data.device), data.device,
                     min_factor, max_factor)
    return adjust_saturation(_f32(data), alpha, data.dtype)


@register("_image_random_hue", rng=True, differentiable=False)
def _image_random_hue(data, min_factor=0.0, max_factor=0.0, generator=None,
                      **_):
    alpha = _uniform(_stream(generator, data.device), data.device,
                     min_factor, max_factor)
    return adjust_hue(data, alpha, data.dtype)


def jitter_factors(brightness, contrast, saturation, hue, generator,
                   device):
    """The factors ``_image_random_color_jitter`` draws, in its order:
    ``{"brightness": alpha, ...}`` for each stage that is on."""
    gen = _stream(generator, device)
    out = {}
    if brightness > 0:
        out["brightness"] = _uniform(gen, device, max(0.0, 1 - brightness),
                                     1 + brightness)
    if contrast > 0:
        out["contrast"] = _uniform(gen, device, max(0.0, 1 - contrast),
                                   1 + contrast)
    if saturation > 0:
        out["saturation"] = _uniform(gen, device, max(0.0, 1 - saturation),
                                     1 + saturation)
    if hue > 0:
        out["hue"] = _uniform(gen, device, -hue, hue)
    return out


_JITTER = (("brightness", adjust_brightness), ("contrast", adjust_contrast),
           ("saturation", adjust_saturation), ("hue", adjust_hue))


def color_jitter(data, factors):
    """The jitter stages of ``factors`` in the fixed order brightness,
    contrast, saturation, hue, in f32, then one cast back."""
    x = _f32(data)
    for name, fn in _JITTER:
        if name in factors:
            x = fn(x, factors[name], torch.float32)
    return saturate(x, data.dtype)


@register("_image_random_color_jitter", rng=True, differentiable=False)
def _image_random_color_jitter(data, brightness=0.0, contrast=0.0,
                               saturation=0.0, hue=0.0, generator=None, **_):
    """Brightness, contrast, saturation and hue with random factors, in
    that fixed order (the JAX op's)."""
    return color_jitter(data, jitter_factors(brightness, contrast,
                                             saturation, hue, generator,
                                             data.device))


@register("_image_adjust_lighting", differentiable=False)
def _image_adjust_lighting(data, alpha=(0.0, 0.0, 0.0), **_):
    """PCA lighting with fixed alphas."""
    rgb = _EIGVEC @ (_np.asarray(alpha, _np.float32) * _EIGVAL)
    return saturate(_f32(data) + torch.as_tensor(rgb, device=data.device),
                    data.dtype)


@register("_image_random_lighting", rng=True, differentiable=False)
def _image_random_lighting(data, alpha_std=0.05, generator=None, **_):
    """PCA lighting with alpha ~ N(0, alpha_std)."""
    alpha = torch.randn((3,), generator=_stream(generator, data.device),
                        device=data.device, dtype=torch.float32) \
        * float(alpha_std)
    return adjust_lighting(data, alpha, data.dtype)
