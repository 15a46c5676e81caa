"""Vision models of the port (ref: the JAX package's
gluon/model_zoo/vision/__init__.py)."""
from ....base import MXNetError
from ....ops.registry import NotPortedError
from .resnet import (BasicBlockV1, BasicBlockV2, BottleneckV1, BottleneckV2,
                     ResNetV1, ResNetV2, SpaceToDepthStem, get_resnet,
                     resnet18_v1, resnet18_v2, resnet34_v1, resnet34_v2,
                     resnet50_v1, resnet50_v2, resnet101_v1, resnet101_v2,
                     resnet152_v1, resnet152_v2)

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "ResNetV1", "ResNetV2", "SpaceToDepthStem", "get_model",
           "get_resnet", "resnet18_v1", "resnet34_v1", "resnet50_v1",
           "resnet101_v1", "resnet152_v1", "resnet18_v2", "resnet34_v2",
           "resnet50_v2", "resnet101_v2", "resnet152_v2"]

_MODELS = {f"resnet{n}_v{v}": globals()[f"resnet{n}_v{v}"]
           for n in (18, 34, 50, 101, 152) for v in (1, 2)}
# the JAX package's other zoo names, not ported yet
_NOT_PORTED = ("alexnet", "vgg11", "vgg13", "vgg16", "vgg19", "vgg11_bn",
               "vgg13_bn", "vgg16_bn", "vgg19_bn", "squeezenet1.0",
               "squeezenet1.1", "mobilenet1.0", "mobilenet0.75",
               "mobilenet0.5", "mobilenet0.25", "mobilenetv2_1.0",
               "mobilenetv2_0.75", "mobilenetv2_0.5", "mobilenetv2_0.25",
               "densenet121", "densenet161", "densenet169", "densenet201",
               "inceptionv3")


def get_model(name, **kwargs):
    """A zoo model by name (ref: model_zoo get_model); ``kwargs`` go to
    its constructor (``layout``, ``classes``, ``device`` ...)."""
    name = name.lower()
    if name in _MODELS:
        return _MODELS[name](**kwargs)
    if name in _NOT_PORTED:
        raise NotPortedError(f"model {name!r} is not ported yet (see "
                             "ROADMAP.md, queue A14); the ResNets are")
    raise MXNetError(f"model {name!r} not in zoo: {sorted(_MODELS)}")
