#!/usr/bin/env python3
"""What bounds the port's flash general route and ``bn_apply`` on one card.

    python3 tools/kernel_variants_probe.py [--parent OLD_flash_attention.cu]

Builds ``mxnet_tpu_torch/csrc/flash_attention.cu`` as it is and with two
of its build switches changed, and times ``mxt_flash_fwd`` (the general
route) at the transformer LM's f32 shape (B 8, T 2048, H 8, D 64, causal,
q/k/v views of one qkv projection):

- ``one_pass`` (``-DMXT_TF32_PASSES=1``): one TF32 product where 3xTF32
  takes three, the split arithmetic kept: what the extra passes cost;
- ``no_split`` (``-DMXT_TF32_SPLIT=0``): the three passes with no split
  arithmetic (hi = the f32 bits, lo = 0): what the split costs.

Both variants give wrong numbers on purpose; only their times are read.
``--parent`` takes ``flash_attention.cu`` as of commit 8f23ee8 (the
bf16-only tensor-core kernel: its ``mxt_flash_fwd_tc`` has no dtype code,
its ``mxt_flash_fwd`` a 0/1 vector flag where this one has a copy width)
and times its general and tensor-core entries against the current ones on
the same inputs (bf16 at D 64 and 128 for the tensor-core route). Every
build is timed twice per shape, in turns: each build once, then again in
the reverse order. It also prints the registers and spills that
``cuobjdump -res-usage`` reports for each tensor-core kernel of both
builds.

Then ``bn_apply`` as it is and with 8 rows of loads in flight
(``-DMXT_APPLY_UNROLL=8``) instead of 4, each at 8 and 16 blocks per SM,
summed over the 48 ResNet-50 v1 sites (bf16 batch 128, f32 batch 32),
every result bit for bit against the plain version. Times are CUDA-event
means (flash: 20 launches back to back; BN: ``chip_smoke.time_ms``, L2
dirtied before each launch). Prints the card line and one JSON line per
measurement. Builds go to ``build/kernel_variants/``.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mxnet_tpu_torch.ops import _build  # noqa: E402
from mxnet_tpu_torch.ops import fused_bn_act as tk  # noqa: E402

OUT = os.path.join(HERE, "build", "kernel_variants")


def build(variants, extra):
    """{name: (CDLL, path)} of ``variants`` = {name: (source, defines)},
    one nvcc each, all started together."""
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, (src, defines) in variants.items():
        so = os.path.join(OUT, f"{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS,
             *[f"-D{d}" for d in defines], "-o", so, src, *extra],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            sys.exit(f"kernel_variants_probe: {name} did not build:\n{log}")
        libs[name] = (ctypes.CDLL(so), so)
    return libs


def res_usage(so):
    """{kernel: 'REG:n STACK:n ...'} of the tensor-core kernels in ``so``."""
    try:
        out = subprocess.run(
            [os.path.join(_build.cuda_home(), "bin", "cuobjdump"),
             "-res-usage", so], capture_output=True, text=True,
            check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        return {"error": str(e)}
    usage, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function (\S*flash_fwd_tc_kernel\S*):", line)
        if m:
            name = m.group(1)
        elif name and "REG:" in line:
            usage[name] = line.strip()
            name = None
    return usage


def events_ms(fn, n=20):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / n


def flash(parent):
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    src = os.path.join(_build._CSRC, "flash_attention.cu")
    variants = {"current": (src, ()),
                "one_pass": (src, ("MXT_TF32_PASSES=1",)),
                "no_split": (src, ("MXT_TF32_SPLIT=0",))}
    if parent:
        variants["parent"] = (os.path.abspath(parent), ())
    libs = build(variants, ("-lcuda",))
    for name, (lib, _) in libs.items():
        lib.mxt_flash_fwd.argtypes = [p, p, p, p, p, i, i, i, i, f, i, i, i,
                                      p]
        lib.mxt_flash_fwd_tc.argtypes = (
            [p, p, p, p, p, i, i, i, i, f, i, p] if name == "parent"
            else [p, p, p, p, p, i, i, i, i, f, i, i, p])
    for name in ("current", "parent"):
        if name in libs:
            print(json.dumps({"probe": "res_usage", "build": name,
                              "kernels": res_usage(libs[name][1])}),
                  flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for b, t, h, d, dtype in ((8, 2048, 8, 64, torch.float32),
                              (8, 2048, 8, 64, torch.bfloat16),
                              (8, 2048, 4, 128, torch.bfloat16)):
        x = torch.randn((b, t, 3 * h * d), generator=gen,
                        device="cuda").to(dtype)
        q, k, v = (z.reshape(b, t, h, d) for z in x.split(h * d, dim=-1))
        o = torch.empty_like(q)
        strides = (ctypes.c_longlong * 12)(
            *[s for y in (q, k, v, o) for s in y.stride()[:3]])
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                strides, b, t, h, d, d ** -0.5, 1)
        code = 0 if dtype == torch.float32 else 1

        def run(name, tc):
            lib = libs[name][0]
            stream = torch.cuda.current_stream().cuda_stream
            old = name == "parent"
            if not tc:   # the parent's last flag: 1 = 16-byte vectors
                return lambda: lib.mxt_flash_fwd(*args, code,
                                                 1 if old else 16, stream)
            if old:
                return lambda: lib.mxt_flash_fwd_tc(*args, stream)
            return lambda: lib.mxt_flash_fwd_tc(*args, code, stream)

        routes = [False] if dtype == torch.float32 else [False, True]
        for tc in routes:
            names = ["current"] + (["parent"] if "parent" in libs else [])
            if not tc and dtype == torch.float32:
                names += ["one_pass", "no_split"]
            order = names + names[::-1]
            times = {n: [] for n in names}
            for n in order:
                times[n].append(events_ms(run(n, tc)))
            print(json.dumps({"probe": "flash", "route": "tc" if tc
                              else "general", "shape": [b, t, h, d],
                              "dtype": str(dtype)[6:], "ms": times}),
                  flush=True)


def bn_apply():
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    src = os.path.join(_build._CSRC, "fused_bn_act.cu")
    libs = build({"bn_current": (src, ()),
                  "bn_unroll8": (src, ("MXT_APPLY_UNROLL=8",))}, ())
    for lib, _ in libs.values():
        lib.mxt_bn_apply.argtypes = [p, p, p, p, ll, i, i, i, i, i, i, ll, p]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    tot = {}
    for dtype, batch in ((torch.bfloat16, cs.B), (torch.float32,
                                                  cs.GT_BATCH)):
        for r, c, res, mult in cs.path_sites(batch):
            case = cs.make_case(torch, tk, r, c, res, dtype, gen)
            x, rr, coef = case["x"], case["res"], case["coef_f"]
            out = torch.empty_like(x)
            want = tk._bn_apply_plain(x, rr, coef)
            for name, (lib, _) in libs.items():
                for per_sm in (8, 16):
                    tx, ty, chunks, rpc = tk._reduce_config(
                        r, c, 1, dtype, blocks_per_sm=per_sm)

                    def fn():
                        lib.mxt_bn_apply(
                            x.data_ptr(), None if rr is None
                            else rr.data_ptr(), coef.data_ptr(),
                            out.data_ptr(), r, c, tk._DTYPE_CODE[dtype], 1,
                            tx, ty, chunks, rpc,
                            torch.cuda.current_stream().cuda_stream)
                    ms = cs.time_ms(torch, fn, flush)
                    torch.cuda.synchronize()
                    if not torch.equal(out, want):
                        sys.exit(f"bn_apply {name} differs at {(r, c)}")
                    key = f"{str(dtype)[6:]}/{name}/{per_sm}_blocks_per_sm"
                    tot[key] = tot.get(key, 0.0) + mult * ms
    print(json.dumps({"probe": "bn_apply", "per": "one ResNet-50 v1 step, "
                      "48 sites", "ms": tot}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="flash_attention.cu as of 8f23ee8")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_variants_probe: no CUDA device")
    print(cs.card_line(), flush=True)
    flash(opts.parent)
    bn_apply()


if __name__ == "__main__":
    main()
