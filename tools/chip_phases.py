#!/usr/bin/env python3
"""Run some phases of ``chip_smoke.py`` on one card.

    python3 tools/chip_phases.py PHASE [PHASE ...]     # from the root

PHASE is one of:

- ``gluon_train``: the hybridized ResNet-50 v1 f32 b32 Gluon step;
- ``fit``: ``gluon_train`` (whose step time ``fit_train`` reports beside
  its own), then ``fit_reference``, ``fit_train``, ``megastep_train`` and
  ``telemetry_planes`` (about three minutes);
- ``cached_op``: a hybridized small ResNetV1 and a flash-attention user
  block against the same blocks un-hybridized;
- ``serving``: ResNet-50 v1 behind ``ModelServer``;
- ``dist_train``: data-parallel training over ``torch.distributed``
  (NCCL at one rank, two ranks sharing the card over gloo, the megastep
  under a simulated ZeRO world, the distributed example).

Builds the port's kernels, then runs the phases in the order given,
printing their JSON lines as ``chip_smoke.py`` does, each phase's wall,
and a last ``walls`` line. Any failure exits non-zero.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fit(cs, torch, mt, card, timed):
    _, row = timed("gluon_train", cs.gluon_train, torch, mt, card)
    launches, mega, planes = cs.fit_phases(torch, mt, card, row, timed)
    return {"fit_launches": launches, "megastep_launches": mega,
            "planes_launches": planes}


def _one(name, fn):
    def run(cs, torch, mt, card, timed):
        timed(name, getattr(cs, fn), torch, mt, card)
    return run


PHASES = {"gluon_train": _one("gluon_train", "gluon_train"),
          "fit": _fit,
          "cached_op": _one("cached_op", "cached_op_phase"),
          "serving": _one("serving", "serving_phase"),
          "dist_train": _one("dist_train", "dist_train")}


def main():
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    names = sys.argv[1:]
    unknown = sorted(set(names) - set(PHASES))
    if not names or unknown:
        cs.fail(f"name phases from {', '.join(PHASES)} (unknown: "
                f"{unknown})")
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import _build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs.card_line()
    print(card, flush=True)
    walls, extra = {}, {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        cs.emit({"phase": "wall", "of": name, "seconds": walls[name]})
        torch.cuda.empty_cache()
        return out

    t = time.perf_counter()
    _build.build()
    walls["build"] = time.perf_counter() - t
    for name in names:
        extra.update(PHASES[name](cs, torch, mt, card, timed) or {})
    cs.emit({"phase": "walls", "seconds": walls, **extra})


if __name__ == "__main__":
    main()
