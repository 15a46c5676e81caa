"""Checkpoints of symbolic models (ref: the JAX package's ``model.py``;
python/mxnet/model.py): ``prefix-symbol.json`` and
``prefix-NNNN.params`` with ``arg:`` / ``aux:`` keys, the layout that
``HybridBlock.export`` writes and ``SymbolBlock.imports`` reads. The rest
of ``model.py`` (``FeedForward``) waits for ``module/`` (ROADMAP A14)."""
from __future__ import annotations

import logging

from .ndarray import utils as nd_utils

__all__ = ["save_checkpoint", "load_checkpoint"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """(ref: model.py save_checkpoint)"""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    payload = {f"arg:{k}": v for k, v in arg_params.items()}
    payload.update({f"aux:{k}": v for k, v in aux_params.items()})
    nd_utils.save(f"{prefix}-{epoch:04d}.params", payload)
    logging.info("Saved checkpoint to \"%s-%04d.params\"", prefix, epoch)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` (ref: model.py
    load_checkpoint)."""
    from .symbol import load as sym_load
    symbol = sym_load(f"{prefix}-symbol.json")
    arg_params, aux_params = {}, {}
    for k, v in nd_utils.load(f"{prefix}-{epoch:04d}.params").items():
        if k.startswith("arg:"):
            arg_params[k[4:]] = v
        elif k.startswith("aux:"):
            aux_params[k[4:]] = v
    return symbol, arg_params, aux_params
