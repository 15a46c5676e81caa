"""Whether ``torch.export`` traces the port's served models on the card.

Exports ``chip_smoke.py``'s causal self-attention block (f16, its
forward reaches the flash kernel through ctypes) and ResNet-50 v1 NHWC
(no kernel at inference), each through ``SymbolBlock.imports`` as a
fleet replica loads it, strict and non-strict, and prints one line per
attempt. Run from the repository root on a machine with a card::

    python3 tools/torch_export_probe.py
"""
import os
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.getcwd())
import mxnet_tpu_torch as mt  # noqa: E402
from chip_smoke import IMG, _sf_attention_block  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo.vision import get_model  # noqa: E402


def probe(name, net, x):
    d = tempfile.mkdtemp()
    net.export(os.path.join(d, "m"))
    sb = mt.gluon.SymbolBlock.imports(os.path.join(d, "m-symbol.json"),
                                      ["data"], os.path.join(d, "m-0000.params"))
    for strict in (False, True):
        t = time.perf_counter()
        try:
            ep = torch.export.export(sb, (x,), strict=strict)
            y = ep.module()(x)
            ref = sb(x)
            print(f"EXPORT {name} strict={strict}: ok, {len(ep.graph.nodes)} "
                  f"nodes, {time.perf_counter() - t:.1f} s, max diff "
                  f"{float((y - ref).abs().max())}", flush=True)
        except Exception as e:
            print(f"EXPORT {name} strict={strict}: {type(e).__name__}: "
                  f"{str(e)[:700]}", flush=True)


with torch.no_grad():
    att = _sf_attention_block(mt)
    att.initialize(mt.init.Xavier())
    att.cast("float16")
    probe("attention (flash, ctypes)", att,
          torch.randn(1, 2048, 512, device="cuda", dtype=torch.float16))
    net = get_model("resnet50_v1", layout="NHWC")
    net.initialize(mt.init.Xavier())
    net(mt.nd.from_torch(torch.zeros((1, IMG, IMG, 3), device="cuda")))
    probe("resnet50_v1", net, torch.rand(2, IMG, IMG, 3, device="cuda"))
