"""Vision transforms (ref: python/mxnet/gluon/data/vision/transforms.py;
the JAX package's ``gluon/data/vision/transforms.py``).

Gluon blocks over the ``mx.nd.image`` operators, as the JAX ones are: the
same ops serve the transform pipeline and direct calls. The random blocks
draw from the device's default generator through the ops, except
``RandomResizedCrop``'s window, which draws from ``numpy.random`` as in
the JAX package. A block runs where its input lives.
"""
from __future__ import annotations

import numpy as np

from ...block import Block, HybridBlock
from ...nn import Sequential

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "Resize",
           "CenterCrop", "RandomResizedCrop", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomLighting",
           "RandomColorJitter"]


def _image():
    from .... import ndarray as nd
    return nd.image


class Compose(Sequential):
    """The transforms in order."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(HybridBlock):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def hybrid_forward(self, F, x):
        return F.cast(x, dtype=self._dtype)


class ToTensor(HybridBlock):
    """HWC uint8 [0, 255] -> CHW float32 [0, 1]."""

    def hybrid_forward(self, F, x):
        return F._internal._image_to_tensor(x)


class Normalize(HybridBlock):
    def __init__(self, mean=0.0, std=1.0):
        super().__init__()
        self._mean = mean if isinstance(mean, (tuple, list)) else (mean,)
        self._std = std if isinstance(std, (tuple, list)) else (std,)

    def hybrid_forward(self, F, x):
        return F._internal._image_normalize(x, mean=tuple(self._mean),
                                            std=tuple(self._std))


class Resize(Block):
    """Resize through ``_image_resize``."""

    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interp = interpolation

    def forward(self, x):
        return _image().resize(x, size=self._size, keep_ratio=self._keep,
                               interp=self._interp)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)

    def forward(self, x):
        w, h = self._size
        H, W = x.shape[-3], x.shape[-2]
        y0 = max(0, (H - h) // 2)
        x0 = max(0, (W - w) // 2)
        return x[..., y0:y0 + h, x0:x0 + w, :]


class RandomResizedCrop(Block):
    """A window of random area and aspect (``numpy.random``; ten tries,
    else the whole image), resized to ``size``."""

    def __init__(self, size, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else tuple(size)
        self._scale = scale
        self._ratio = ratio
        self._interp = interpolation

    def forward(self, x):
        H, W = x.shape[-3], x.shape[-2]
        area = H * W
        crop = x
        for _ in range(10):
            target = np.random.uniform(*self._scale) * area
            ratio = np.random.uniform(*self._ratio)
            w = int(round(np.sqrt(target * ratio)))
            h = int(round(np.sqrt(target / ratio)))
            if w <= W and h <= H:
                x0 = np.random.randint(0, W - w + 1)
                y0 = np.random.randint(0, H - h + 1)
                crop = x[..., y0:y0 + h, x0:x0 + w, :]
                break
        return _image().resize(crop, size=(self._size[0], self._size[1]),
                               interp=self._interp)


class RandomFlipLeftRight(Block):
    def forward(self, x):
        return _image().random_flip_left_right(x)


class RandomFlipTopBottom(Block):
    def forward(self, x):
        return _image().random_flip_top_bottom(x)


class _RandomEnhance(Block):
    """Magnitude m -> a factor uniform in [max(0, 1 - m), 1 + m]."""

    def __init__(self, magnitude):
        super().__init__()
        self._lo = max(0.0, 1.0 - magnitude)
        self._hi = 1.0 + magnitude


class RandomBrightness(_RandomEnhance):
    def forward(self, x):
        return _image().random_brightness(x, min_factor=self._lo,
                                          max_factor=self._hi)


class RandomContrast(_RandomEnhance):
    def forward(self, x):
        return _image().random_contrast(x, min_factor=self._lo,
                                        max_factor=self._hi)


class RandomSaturation(_RandomEnhance):
    def forward(self, x):
        return _image().random_saturation(x, min_factor=self._lo,
                                          max_factor=self._hi)


class RandomHue(Block):
    def __init__(self, hue):
        super().__init__()
        self._hue = hue

    def forward(self, x):
        return _image().random_hue(x, min_factor=-self._hue,
                                   max_factor=self._hue)


class RandomLighting(Block):
    """AlexNet-style PCA noise with alpha ~ N(0, ``alpha``)."""

    def __init__(self, alpha):
        super().__init__()
        self._std = alpha

    def forward(self, x):
        return _image().random_lighting(x, alpha_std=self._std)


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._args = dict(brightness=brightness, contrast=contrast,
                          saturation=saturation, hue=hue)

    def forward(self, x):
        return _image().random_color_jitter(x, **self._args)
