"""AttrScope: scoped symbol attributes (ref: the JAX package's
``attribute.py``; python/mxnet/attribute.py).

``with AttrScope(ctx_group="dev1"):`` gives every variable and op node
that ``mx.sym`` creates inside it those attributes (``Symbol.attr``,
``attr_dict``); an explicit ``attr=`` of ``var`` replaces them. Scopes
nest, the inner one winning on a shared key, and each thread has its own
stack. The port runs a graph on one card: ``ctx_group`` is kept as an
attribute and places nothing.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional

__all__ = ["AttrScope", "current", "attr_scope"]


class _TLS(threading.local):
    def __init__(self):
        self.stack = []


_tls = _TLS()


class AttrScope:
    def __init__(self, **kwargs):
        self._attr = {k: str(v) for k, v in kwargs.items()}

    def get(self, attr: Optional[Dict] = None) -> Dict:
        """The attributes of every open scope, outermost first, then
        ``attr``."""
        merged = {}
        for scope in _tls.stack:
            merged.update(scope._attr)
        if attr:
            merged.update(attr)
        return merged

    def __enter__(self):
        _tls.stack.append(self)
        return self

    def __exit__(self, *a):
        _tls.stack.pop()


def current() -> AttrScope:
    return _tls.stack[-1] if _tls.stack else AttrScope()


attr_scope = AttrScope
