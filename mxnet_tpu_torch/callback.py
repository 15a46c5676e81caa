"""Training callbacks (ref: python/mxnet/callback.py; a copy of the JAX
package's ``callback.py``)."""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric",
           "module_checkpoint", "ProgressBar"]


def do_checkpoint(prefix, period=1):
    """An epoch-end callback ``(iter_no, sym, arg, aux)`` that writes
    ``model.save_checkpoint(prefix, iter_no + 1, ...)`` every ``period``
    epochs (ref: callback.py do_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym, arg, aux):
        if (iter_no + 1) % period == 0:
            from .model import save_checkpoint
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """An epoch-end callback that writes ``mod.save_checkpoint(prefix,
    iter_no + 1, save_optimizer_states)`` every ``period`` epochs (ref:
    callback.py module_checkpoint)."""
    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            for name, value in param.eval_metric.get_name_value():
                logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                             param.epoch, param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset_local()
    return _callback


class Speedometer:
    """Samples/sec logger.

    Original implementation; the LOG LINE FORMAT deliberately matches the
    reference's Speedometer output
    (``Epoch[N] Batch [M]\\tSpeed: X samples/sec\\tmetric=value...``) so
    tools/parse_log.py and existing reference log parsers keep working
    (ref: python/mxnet/callback.py Speedometer — behavior re-derived from
    its docstring/format, not its code).
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = max(1, int(frequent))
        self.auto_reset = auto_reset
        self._window_open = None   # perf-counter at window start, or None
        self._prev_nbatch = -1

    def _emit(self, param, speed):
        parts = [f"Epoch[{param.epoch}] Batch [{param.nbatch}]",
                 f"Speed: {speed:.2f} samples/sec"]
        metric = param.eval_metric
        if metric is not None:
            pairs = metric.get_name_value()
            if self.auto_reset:
                metric.reset_local()
            parts.extend(f"{k}={v:f}" for k, v in pairs)
        logging.info("\t".join(parts))

    def __call__(self, param):
        if param.nbatch < self._prev_nbatch:
            self._window_open = None  # new epoch: restart the window
        self._prev_nbatch = param.nbatch
        if self._window_open is None:
            self._window_open = time.perf_counter()
            return
        if param.nbatch % self.frequent:
            return
        elapsed = time.perf_counter() - self._window_open
        n_samples = self.frequent * self.batch_size
        speed = n_samples / elapsed if elapsed > 0 else float("inf")
        self._emit(param, speed)
        self._window_open = time.perf_counter()


class ProgressBar:
    """Text progress bar over total batches. Frame format matches the
    reference's (``[===--] NN%``) for log compatibility; rendering is
    original."""

    def __init__(self, total, length=80):
        self.bar_len = int(length)
        self.total = total

    def __call__(self, param):
        frac = min(max(param.nbatch / float(self.total), 0.0), 1.0)
        ticks = int(round(frac * self.bar_len))
        bar = "".join("=" if i < ticks else "-"
                      for i in range(self.bar_len))
        logging.info("[%s] %d%%\r", bar, int(round(frac * 100)))
