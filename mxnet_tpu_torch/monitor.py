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
  (:meth:`_stat_helper`, the executor callback's surface);
- executors: :meth:`Monitor.install` sets an ``Executor``'s monitor
  callback (its outputs after every forward), and ``toc`` evaluates the
  installed executors' internal outputs.
"""
from __future__ import annotations

import re
from typing import Callable, List, Optional, Tuple

import numpy as _np

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
        self._exes: List = []

    def install(self, exe) -> None:
        """(ref: monitor.py install_to_executor)"""
        self._exes.append(exe)
        exe.set_monitor_callback(self._stat_helper, self.monitor_all)

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
        from .ndarray.ndarray import NDArray
        from .symbol.executor import _walk
        # the internal outputs of each installed executor
        for exe in self._exes:
            internals = exe._symbol.get_internals()
            args = {n: a._data for n, a in exe.arg_dict.items()}
            aux = {n: a._data for n, a in exe.aux_dict.items()}
            try:
                import torch
                with torch.no_grad():
                    outs = _walk(internals, args, aux, False)
            except Exception as e:          # noqa: BLE001 - logged
                import logging
                logging.getLogger("mxnet_tpu_torch").warning(
                    "Monitor: could not evaluate internals of executor "
                    "%r: %s", exe, e)
                continue
            for name, val in zip(internals.list_outputs(), outs):
                if self.re_prog.match(name):
                    self.queue.append((self.step, name,
                                       self.stat_func(NDArray(val))))
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
