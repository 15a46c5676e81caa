"""ResNet v1 and v2 (ref: the JAX package's
gluon/model_zoo/vision/resnet.py; He et al. 1512.03385, 1603.05027).

Built in the same order, with the same blocks and names, as the JAX model,
so weights carry across by name (:mod:`mxnet_tpu_torch.convert`).
Channel-last blocks use the fused BN(+add)+ReLU epilogues: in v1 each
block's tail, in v2 every pre-activation BN+ReLU (``_bn_relu``). V1 is
built with every input width given; v2, as in the JAX package, leaves the
image's channels and each bottleneck's ``conv1`` / ``conv3`` input
(``in_channels=0``) to deferred initialisation, resolved by the first
forward. Called with ``NDArray``s (the imperative loop) the model returns
``NDArray``s (``HybridBlock.__call__``).
"""
from __future__ import annotations

import torch.nn.functional as F

from ....ops import nn as ops
from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "SpaceToDepthStem", "resnet18_v1",
           "resnet34_v1", "resnet50_v1", "resnet101_v1", "resnet152_v1",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2", "get_resnet"]

_IMAGE_CHANNELS = 3


def _conv3x3(channels, stride, in_channels, layout, device):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout,
                     device=device)


def _bn_axis(layout):
    return -1 if layout.endswith("C") else 1


def _fuse_epilogue(layout):
    """Channel-last blocks use the fused BN(+add)+ReLU epilogue kernels;
    channel-first keeps the composed lowering."""
    return bool(layout) and layout.endswith("C")


def _downsample(channels, stride, in_channels, layout, ax, device):
    ds = nn.HybridSequential(prefix="", device=device)
    ds.add(nn.Conv2D(channels, kernel_size=1, strides=stride, use_bias=False,
                     in_channels=in_channels, layout=layout, device=device))
    ds.add(nn.BatchNorm(axis=ax, in_channels=channels, device=device))
    return ds


class _ResidualV1(HybridBlock):
    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        if self._fused:
            kids = list(self.body)
            for child in kids[:-1]:
                x = child(x)
            return kids[-1](x, residual)
        return ops.relu(self.body(x) + residual)


class BasicBlockV1(_ResidualV1):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        ax = _bn_axis(layout)
        self._fused = _fuse_epilogue(layout)
        self.body = nn.HybridSequential(prefix="", device=device)
        self.body.add(_conv3x3(channels, stride, in_channels, layout, device))
        if self._fused:
            self.body.add(nn.FusedBatchNormReLU(axis=ax, in_channels=channels,
                                                device=device))
            self.body.add(_conv3x3(channels, 1, channels, layout, device))
            self.body.add(nn.FusedBatchNormAddReLU(
                axis=ax, in_channels=channels, device=device))
        else:
            self.body.add(nn.BatchNorm(axis=ax, in_channels=channels,
                                       device=device))
            self.body.add(nn.Activation("relu", device=device))
            self.body.add(_conv3x3(channels, 1, channels, layout, device))
            self.body.add(nn.BatchNorm(axis=ax, in_channels=channels,
                                       device=device))
        self.downsample = _downsample(channels, stride, in_channels, layout,
                                      ax, device) if downsample else None


class BottleneckV1(_ResidualV1):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        ax = _bn_axis(layout)
        mid = channels // 4
        self._fused = _fuse_epilogue(layout)

        def bn(c, tail):
            if not self._fused:
                return nn.BatchNorm(axis=ax, in_channels=c, device=device)
            cls = nn.FusedBatchNormAddReLU if tail else nn.FusedBatchNormReLU
            return cls(axis=ax, in_channels=c, device=device)

        self.body = nn.HybridSequential(prefix="", device=device)
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                use_bias=False, in_channels=in_channels,
                                layout=layout, device=device))
        self.body.add(bn(mid, False))
        if not self._fused:
            self.body.add(nn.Activation("relu", device=device))
        self.body.add(_conv3x3(mid, 1, mid, layout, device))
        self.body.add(bn(mid, False))
        if not self._fused:
            self.body.add(nn.Activation("relu", device=device))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                use_bias=False, in_channels=mid,
                                layout=layout, device=device))
        self.body.add(bn(channels, True))
        self.downsample = _downsample(channels, stride, in_channels, layout,
                                      ax, device) if downsample else None


class SpaceToDepthStem(HybridBlock):
    """The 7x7/2 stem as space-to-depth + a 4x4/1 convolution (ref: the JAX
    package's SpaceToDepthStem): 2x2 spatial blocks become channels
    (H, W, 3 -> H/2, W/2, 12), padded (2, 1) on each spatial axis."""

    def __init__(self, channels, layout="NCHW", prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        self._layout = layout
        self.conv = nn.Conv2D(channels, 4, 1, 0, use_bias=False,
                              in_channels=4 * _IMAGE_CHANNELS, layout=layout,
                              device=device)

    def forward(self, x):
        if self._layout == "NHWC":
            b, h, w, c = x.shape
            # (B,H,W,C) -> (B,H/2,2,W/2,2,C) -> (B,H/2,W/2,2,2,C) -> 4C
            x = x.reshape(b, h // 2, 2, w // 2, 2, c)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
            x = F.pad(x, (0, 0, 2, 1, 2, 1))
        else:
            b, c, h, w = x.shape
            # (B,C,H,W) -> (B,C,H/2,2,W/2,2) -> (B,C,2,2,H/2,W/2) -> 4C
            x = x.reshape(b, c, h // 2, 2, w // 2, 2)
            x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, 4 * c, h // 2, w // 2)
            x = F.pad(x, (2, 1, 2, 1))
        return self.conv(x)


class ResNetV1(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", stem_s2d=False, prefix=None,
                 device=None):
        super().__init__(prefix=prefix, device=device)
        assert len(layers) == len(channels) - 1
        ax = _bn_axis(layout)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="", device=device)
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, _IMAGE_CHANNELS,
                                           layout, device))
            else:
                if stem_s2d:
                    self.features.add(SpaceToDepthStem(
                        channels[0], layout=layout, device=device))
                else:
                    self.features.add(nn.Conv2D(
                        channels[0], 7, 2, 3, use_bias=False,
                        in_channels=_IMAGE_CHANNELS, layout=layout,
                        device=device))
                self.features.add(nn.BatchNorm(axis=ax,
                                               in_channels=channels[0],
                                               device=device))
                self.features.add(nn.Activation("relu", device=device))
                self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout,
                                               device=device))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride,
                    in_channels=channels[i], layout=layout, device=device))
            self.features.add(nn.GlobalAvgPool2D(layout=layout,
                                                 device=device))
            self.output = nn.Dense(classes, in_units=channels[-1],
                                   device=device)

    @staticmethod
    def _make_layer(block, layers, channels, stride, in_channels, layout,
                    device):
        layer = nn.HybridSequential(prefix="", device=device)
        layer.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, layout=layout,
                        device=device))
        for _ in range(layers - 1):
            layer.add(block(channels, 1, False, in_channels=channels,
                            layout=layout, device=device))
        return layer

    def forward(self, x):
        return self.output(self.features(x))


def _bn_relu(ax, fused, device):
    """Pre-activation BN+ReLU: one fused block channel-last, a plain
    BatchNorm otherwise (the caller applies the relu itself)."""
    return nn.FusedBatchNormReLU(axis=ax, device=device) if fused \
        else nn.BatchNorm(axis=ax, device=device)


class _ResidualV2(HybridBlock):
    def _pre(self, bn, x):
        x = bn(x)
        return x if self._fused else ops.relu(x)


class BasicBlockV2(_ResidualV2):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        ax = _bn_axis(layout)
        self._fused = _fuse_epilogue(layout)
        self.bn1 = _bn_relu(ax, self._fused, device)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout, device)
        self.bn2 = _bn_relu(ax, self._fused, device)
        self.conv2 = _conv3x3(channels, 1, channels, layout, device)
        self.downsample = nn.Conv2D(
            channels, 1, stride, use_bias=False, in_channels=in_channels,
            layout=layout, device=device) if downsample else None

    def forward(self, x):
        residual = x
        x = self._pre(self.bn1, x)
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv2(self._pre(self.bn2, self.conv1(x)))
        return x + residual


class BottleneckV2(_ResidualV2):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        ax = _bn_axis(layout)
        self._fused = _fuse_epilogue(layout)
        self.bn1 = _bn_relu(ax, self._fused, device)
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False, layout=layout, device=device)
        self.bn2 = _bn_relu(ax, self._fused, device)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, layout,
                              device)
        self.bn3 = _bn_relu(ax, self._fused, device)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, layout=layout, device=device)
        self.downsample = nn.Conv2D(
            channels, 1, stride, use_bias=False, in_channels=in_channels,
            layout=layout, device=device) if downsample else None

    def forward(self, x):
        residual = x
        x = self._pre(self.bn1, x)
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv2(self._pre(self.bn2, self.conv1(x)))
        x = self.conv3(self._pre(self.bn3, x))
        return x + residual


class ResNetV2(HybridBlock):
    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", prefix=None, device=None):
        super().__init__(prefix=prefix, device=device)
        assert len(layers) == len(channels) - 1
        ax = _bn_axis(layout)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="", device=device)
            self.features.add(nn.BatchNorm(scale=False, center=False,
                                           axis=ax, device=device))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout,
                                           device))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, layout=layout,
                                            device=device))
                self.features.add(nn.BatchNorm(axis=ax, device=device))
                self.features.add(nn.Activation("relu", device=device))
                self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout,
                                               device=device))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(ResNetV1._make_layer(
                    block, num_layer, channels[i + 1], stride,
                    in_channels=in_channels, layout=layout, device=device))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm(axis=ax, device=device))
            self.features.add(nn.Activation("relu", device=device))
            self.features.add(nn.GlobalAvgPool2D(layout=layout,
                                                 device=device))
            self.features.add(nn.Flatten(device=device))
            self.output = nn.Dense(classes, in_units=in_channels,
                                   device=device)

    def forward(self, x):
        return self.output(self.features(x))


_RESNET_SPEC = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}

_BLOCKS = {1: (ResNetV1, {"basic_block": BasicBlockV1,
                          "bottle_neck": BottleneckV1}),
           2: (ResNetV2, {"basic_block": BasicBlockV2,
                          "bottle_neck": BottleneckV2})}


def get_resnet(version, num_layers, device=None, **kwargs):
    """ResNet ``num_layers`` of ``version`` 1 or 2 on ``device`` (default:
    the card)."""
    block_type, layers, channels = _RESNET_SPEC[num_layers]
    net, blocks = _BLOCKS[version]
    return net(blocks[block_type], layers, channels, device=device, **kwargs)


def resnet18_v1(**kw): return get_resnet(1, 18, **kw)
def resnet34_v1(**kw): return get_resnet(1, 34, **kw)
def resnet50_v1(**kw): return get_resnet(1, 50, **kw)
def resnet101_v1(**kw): return get_resnet(1, 101, **kw)
def resnet152_v1(**kw): return get_resnet(1, 152, **kw)
def resnet18_v2(**kw): return get_resnet(2, 18, **kw)
def resnet34_v2(**kw): return get_resnet(2, 34, **kw)
def resnet50_v2(**kw): return get_resnet(2, 50, **kw)
def resnet101_v2(**kw): return get_resnet(2, 101, **kw)
def resnet152_v2(**kw): return get_resnet(2, 152, **kw)
