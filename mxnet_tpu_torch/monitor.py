"""Monitor: per-parameter inspection for NaN hunting (ref: the JAX
package's ``monitor.py``; python/mxnet/monitor.py and
MXExecutorSetMonitorCallback in the reference).

``tic`` / ``toc`` / ``toc_print`` keep the reference's semantics. Two
feeds fill the queue while the Monitor is activated and a name matches
``pattern``:

- the numerics plane (:meth:`Monitor.install_numerics`,
  ``MXTPU_NUMERICS``): each sampled step's per-parameter statistics
  (grad L2 / abs-max / mean / non-finite count / update-weight ratio),
  computed inside the grouped update, as ``(step, "<param>:<stat>",
  value)`` entries;
- eager dispatch: :meth:`Monitor.wrap` wraps a callable (an ``mx.nd``
  op, a block) so each call's output goes through ``stat_func``
  (:meth:`_stat_helper`, the executor callback's surface).

``install(executor)`` needs the symbolic executor (ROADMAP A14) and
raises ``NotPortedError``.
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional, Tuple

import numpy as _np

from .ops.registry import NotPortedError

__all__ = ["Monitor"]


def _default_stat(x) -> "object":
    from .ndarray import array
    v = x.asnumpy() if hasattr(x, "asnumpy") else _np.asarray(x)
    return array(_np.asarray([float(_np.abs(v).mean())], dtype=_np.float32),
                 ctx=x.context if hasattr(x, "context") else None)


class Monitor:
    def __init__(self, interval: int, stat_func: Optional[Callable] = None,
                 pattern: str = ".*", sort: bool = False,
                 monitor_all: bool = False):
        self.interval = interval
        self.stat_func = stat_func or (lambda x: _default_stat(x))
        self.re_prog = re.compile(pattern)
        self.sort = sort
        self.monitor_all = monitor_all
        self.step = 0
        self.activated = False
        self.queue: List[Tuple[int, str, object]] = []

    def install(self, exe) -> None:
        """(ref: monitor.py install_to_executor) The executor is ROADMAP
        A14."""
        raise NotPortedError("Monitor.install: the symbolic executor is "
                             "not ported yet (ROADMAP.md, queue A14)")

    def wrap(self, fn: Callable, name: Optional[str] = None) -> Callable:
        """``fn`` with each call's output (an NDArray, a tensor, or a
        tuple of them) fed to :meth:`_stat_helper` under ``name``
        (default ``fn.__name__``), as the eager-dispatch feed."""
        label = name or getattr(fn, "__name__", "op")

        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            outs = out if isinstance(out, (list, tuple)) else (out,)
            for i, o in enumerate(outs):
                self._stat_helper(label if len(outs) == 1
                                  else f"{label}_output{i}", o)
            return out
        return wrapped

    def install_numerics(self) -> "Monitor":
        """Feed this Monitor from the in-graph numerics plane
        (``MXTPU_NUMERICS``): each sampled step's per-parameter stats are
        appended to the ``tic``/``toc`` queue as ``(step,
        "<param>:<stat>", value)`` entries while the Monitor is activated
        and the name matches ``pattern`` (the reference Monitor
        contract, fed from the grouped update). Returns self for
        chaining."""
        from .telemetry import numerics as _numerics
        _numerics.attach_monitor(self)
        return self

    def _stat_helper(self, name, value) -> None:
        if not self.activated or not self.re_prog.match(str(name)):
            return
        from .ndarray.ndarray import NDArray
        if not isinstance(value, NDArray):
            value = NDArray(value)
        self.queue.append((self.step, str(name), self.stat_func(value)))

    def tic(self) -> None:
        if self.step % self.interval == 0:
            self.queue = []
            self.activated = True

    def toc(self) -> List:
        if not self.activated:
            self.step += 1
            return []
        self.activated = False
        res = []
        if self.sort:
            self.queue.sort(key=lambda x: x[1])
        for n, k, v_list in self.queue:
            if not isinstance(v_list, (list, tuple)):
                v_list = [v_list]
            for v in v_list:
                res.append((n, k, str(v.asnumpy() if hasattr(v, "asnumpy")
                                      else v)))
        self.step += 1
        self.queue = []
        return res

    def toc_print(self) -> None:
        for n, k, v in self.toc():
            print(f"Batch: {n:7d} {k:30s} {v}")
