#!/usr/bin/env python3
"""FitLoop step time of full-width ResNet-50 v1 on one card.

    python3 tools/fit_step_time.py [--tree DIR] [--epochs N] [--env K=V]...

Trains ``get_model("resnet50_v1", layout="NHWC")`` (224x224, f32, batch
32, TF32 off, Xavier weights from seed 0) through ``fit.FitLoop`` with
``gluon.Trainer`` (sgd, lr 0.05, momentum 0.9, ``MXTPU_OPTIMIZER_
AGGREGATION=4``) over ``DeviceStagingIter(NDArrayIter(256 random images,
seed 13))``, composed (no megastep) and with every telemetry plane off
unless ``--env`` turns one on (e.g. ``--env MXTPU_EFFICIENCY=on``): the
configuration ``resnet50-fitloop-f32-b32`` of PERF.md. ``--tree`` is
the root of the checkout whose ``mxnet_tpu_torch`` is imported (default:
this one), so two commits are compared in one call on one card by
running parent, change, change, parent. Builds that checkout's kernels
first.

Prints the card's name and power limit, then one JSON line: the tree,
every step's wall and its segments (ms, from
``FitResult.step_breakdown``), and the medians over the steps after the
first two (the cold steps build, capture and count), also over the even
and the odd ones apart (``MXTPU_NUMERICS=on,every=2`` samples the even
steps). Exits non-zero without a card.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=HERE)
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--env", action="append", default=[],
                    help="KEY=VALUE set for the run (repeatable)")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        sys.exit("fit_step_time: no CUDA device")
    for k in list(os.environ):
        if k.startswith("MXTPU_"):
            del os.environ[k]
    os.environ["MXTPU_OPTIMIZER_AGGREGATION"] = "4"
    env = dict(kv.split("=", 1) for kv in args.env)
    os.environ.update(env)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.ops import _build
    assert os.path.dirname(os.path.dirname(
        os.path.abspath(mt.__file__))) == tree, mt.__file__
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t
    rng = np.random.default_rng(1)
    x = rng.random((256, 224, 224, 3), dtype=np.float32)
    y = rng.integers(0, 1000, 256).astype(np.float32)
    net = get_model("resnet50_v1", layout="NHWC")
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
    net.hybridize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.05, "momentum": 0.9},
                               kvstore="device")
    itr = mt.io.DeviceStagingIter(mt.io.NDArrayIter(
        x, y, batch_size=32, shuffle=True, seed=13))
    loop = mt.fit.FitLoop(net, trainer,
                          mt.gluon.loss.SoftmaxCrossEntropyLoss(), itr)
    torch.cuda.synchronize()
    res = loop.fit(epochs=args.epochs)
    torch.cuda.synchronize()
    steps = [{k: 1e3 * v for k, v in r.items() if isinstance(v, float)}
             for r in res.step_breakdown["per_step"]]
    warm = steps[2:]
    keys = sorted({k for s in warm for k in s})
    print(json.dumps({
        "tool": "fit_step_time", "card": card, "tree": tree,
        "config": "resnet50-fitloop-f32-b32", "env": env,
        "build_s": build_s, "steps": len(steps),
        "loss_last": float(res.losses[-1]),
        "median_ms": {k: float(np.median([s.get(k, 0.0) for s in warm]))
                      for k in keys},
        "median_even_odd_ms": [float(np.median([
            s["wall"] for i, s in enumerate(steps) if i >= 2 and i % 2 == k]))
            for k in (0, 1)],
        "step_ms": [s.get("wall") for s in steps]}), flush=True)


if __name__ == "__main__":
    main()
