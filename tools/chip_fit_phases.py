#!/usr/bin/env python3
"""Run only the FitLoop phases of ``chip_smoke.py`` on one card.

    python3 tools/chip_fit_phases.py     # from the repository root

Builds the port's kernels, runs ``gluon_train`` (whose step time
``fit_train`` reports beside its own) and then ``fit_reference``,
``fit_train`` and ``megastep_train``, printing their JSON lines as
``chip_smoke.py`` does: a quick card check of the FitLoop path and its
megastep (about two minutes) without the other phases. Any failure
exits non-zero.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import _build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    walls = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        cs.emit({"phase": "wall", "of": name, "seconds": walls[name]})
        return out

    t = time.perf_counter()
    _build.build()
    walls["build"] = time.perf_counter() - t
    _, gluon_row = timed("gluon_train", cs.gluon_train, torch, mt, card)
    launches, mega = cs.fit_phases(torch, mt, card, gluon_row, timed)
    cs.emit({"phase": "walls", "seconds": walls, "fit_launches": launches,
             "megastep_launches": mega})


if __name__ == "__main__":
    main()
