"""Weight initializers (ref: the JAX package's ``initializer.py``;
python/mxnet/initializer.py).

The JAX package's registry and name rules are kept: ``create`` takes an
instance or a registered name (``"xavier"``, ``"zeros"``, ``"msra"`` ...;
``None`` is ``Uniform(0.07)``), and an initializer called on a parameter
dispatches on its name: ``*bias``, ``*beta`` and ``*running_mean`` /
``*moving_mean`` start at zero, ``*gamma`` and ``*running_var`` /
``*moving_var`` at one, everything else goes to ``_init_weight``. An
:class:`InitDesc` whose ``attrs["__init__"]`` holds a dumped initializer
sends the parameter to that one's ``_init_weight`` instead.

Arrays are filled in place. Random draws come from the
``torch.Generator`` the caller passes (the JAX package threads PRNG keys),
so the two packages draw different numbers from one seed; the rules
(bounds, scales, the deterministic patterns) are the same.
"""
from __future__ import annotations

import json
import math
import re

import torch

from .base import MXNetError

__all__ = ["Initializer", "Zero", "One", "Constant", "Uniform", "Normal",
           "Orthogonal", "Xavier", "MSRAPrelu", "Bilinear", "LSTMBias",
           "Mixed", "InitDesc", "register", "create"]

_INIT_REGISTRY = {}
_ALIASES = {"zeros": "zero", "ones": "one", "gaussian": "normal",
            "xavier_uniform": "xavier", "msra": "msraprelu"}


def register(klass):
    """Register an initializer class under its lower-cased name."""
    _INIT_REGISTRY[klass.__name__.lower()] = klass
    return klass


def create(init, **kwargs) -> "Initializer":
    """An initializer from an instance, a registered name (with
    ``kwargs``) or ``None`` (``Uniform(0.07)``, MXNet's default)."""
    if init is None:
        return Uniform(0.07)
    if isinstance(init, (Initializer, Mixed)):
        return init
    if isinstance(init, str):
        name = _ALIASES.get(init.lower(), init.lower())
        if name not in _INIT_REGISTRY:
            raise MXNetError(f"unknown initializer {init!r}")
        return _INIT_REGISTRY[name](**kwargs)
    raise MXNetError(f"cannot create initializer from {init!r}")


class InitDesc(str):
    """A parameter's name with attributes for the initializer (ref:
    initializer.py InitDesc)."""

    def __new__(cls, name, attrs=None, global_init=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.global_init = global_init
        return ret


class Initializer:
    """Base initializer: fills a tensor in place by its parameter's name."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self) -> str:
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, desc, arr: torch.Tensor,
                 generator: torch.Generator = None) -> None:
        if not isinstance(desc, str):
            desc = InitDesc("weight")
        with torch.no_grad():
            init = getattr(desc, "attrs", {}).get("__init__", "")
            if init:
                klass, kwargs = json.loads(init)
                create(klass, **kwargs)._init_weight(desc, arr, generator)
            elif desc.endswith("bias"):
                self._init_bias(desc, arr, generator)
            elif desc.endswith("gamma"):
                self._init_one(desc, arr, generator)
            elif desc.endswith(("beta", "running_mean", "moving_mean")):
                self._init_zero(desc, arr, generator)
            elif desc.endswith(("running_var", "moving_var")):
                self._init_one(desc, arr, generator)
            else:
                self._init_weight(desc, arr, generator)

    def _init_zero(self, desc, arr, generator):
        arr.zero_()

    def _init_one(self, desc, arr, generator):
        arr.fill_(1.0)

    def _init_bias(self, desc, arr, generator):
        self._init_zero(desc, arr, generator)

    def _init_weight(self, desc, arr, generator):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self._kwargs})"


@register
class Zero(Initializer):
    def _init_weight(self, desc, arr, generator):
        self._init_zero(desc, arr, generator)


@register
class One(Initializer):
    def _init_weight(self, desc, arr, generator):
        self._init_one(desc, arr, generator)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, desc, arr, generator):
        arr.fill_(self.value)


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, desc, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, desc, arr, generator):
        arr.normal_(0.0, self.sigma, generator=generator)


@register
class Orthogonal(Initializer):
    """``scale`` times an orthonormal factor of a random (out, in) matrix
    drawn from U(-1, 1) or N(0, 1) (ref: initializer.py Orthogonal)."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, desc, arr, generator):
        nout = arr.shape[0]
        nin = math.prod(arr.shape[1:])
        tmp = torch.empty((nout, nin), dtype=torch.float32, device=arr.device)
        if self.rand_type == "normal":
            tmp.normal_(0.0, 1.0, generator=generator)
        else:
            tmp.uniform_(-1.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if tuple(u.shape) == (nout, nin) else v
        arr.copy_((self.scale * q).reshape(arr.shape))


@register
class Xavier(Initializer):
    """(ref: initializer.py Xavier; MXNet defaults uniform / avg / 3). The
    fans follow the reference's formula on the stored shape."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        if rnd_type not in ("uniform", "gaussian"):
            raise MXNetError(f"invalid rnd_type {rnd_type}")
        if factor_type not in ("avg", "in", "out"):
            raise MXNetError(f"invalid factor_type {factor_type}")
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, desc, arr, generator):
        shape = arr.shape
        hw_scale = float(math.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale if len(shape) > 1 else shape[0]
        fan_out = shape[0] * hw_scale
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}[self.factor_type]
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            arr.uniform_(-scale, scale, generator=generator)
        else:
            arr.normal_(0.0, scale, generator=generator)

    def __repr__(self):
        return (f"Xavier(rnd_type={self.rnd_type!r}, "
                f"factor_type={self.factor_type!r}, "
                f"magnitude={self.magnitude})")


@register
class MSRAPrelu(Xavier):
    """Gaussian Xavier with magnitude ``2 / (1 + slope^2)`` (He et al.)."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel, for a Deconvolution weight."""

    def _init_weight(self, desc, arr, generator):
        shape = arr.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = torch.arange(math.prod(shape), dtype=torch.float64)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        w = (1 - (x / f - c).abs()) * (1 - (y / f - c).abs())
        arr.copy_(w.float().reshape(shape))


@register
class LSTMBias(Initializer):
    """Zeros with the forget gate's quarter at ``forget_bias`` (ref:
    initializer.py LSTMBias)."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, desc, arr, generator):
        arr.zero_()
        num_hidden = arr.shape[0] // 4
        arr[num_hidden:2 * num_hidden] = self.forget_bias


class Mixed:
    """The first initializer whose pattern matches the parameter's name
    (ref: initializer.py Mixed)."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must pair up")
        self.map = [(re.compile(p), create(i))
                    for p, i in zip(patterns, initializers)]

    def __call__(self, name, arr, generator=None):
        for regex, init in self.map:
            if regex.search(str(name)):
                init(name, arr, generator)
                return
        raise MXNetError(f"no initializer pattern matches {name!r}; "
                         "add a '.*' catch-all")
