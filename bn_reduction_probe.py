#!/usr/bin/env python3
"""Where the time of the port's two BN reductions goes, on one NVIDIA card.

    python3 bn_reduction_probe.py [--parent OLD_fused_bn_act.cu]

from the repository root. It builds three copies of
``mxnet_tpu_torch/csrc/fused_bn_act.cu`` (one nvcc each, all at once):

* the source as it is;
* ``walk``: each block walks its rows and stops (no block sum, no
  cluster step, no ticket, no finishing sum; its results are wrong), so
  its time is that of the row walk and the launch;
* ``stamped``: the source with ``%globaltimer`` stamps, taken by the first
  thread of each block and kept as the minimum or maximum over blocks, at
  the start of each block, after each block's sum of its rows, after the
  cluster barrier, after the cluster leader's partial, after the last
  ticket and at the end of the last block.

With ``--parent`` it also builds an older source with the two-launch C
interface (partial kernel plus ``sum_partials``) and times it on the grid
of ``_reduce_config``, as that tree's wrapper did.

At each of the 48 ResNet-50 sites (batch 128, bf16) it times each copy
with ``chip_smoke.time_ms`` (64 MB memset into L2, sleep, one launch
between two events) and reads the stamps of the stamped copy (mean of 5
launches, microseconds from the first block's start). It prints one JSON
line per site and kernel, the sums over a training step, the time the
same method gives an empty kernel, and the card's name and power limit.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "mxnet_tpu_torch", "csrc", "fused_bn_act.cu")
OUT = os.path.join(HERE, "build", "bn_reduction_probe")
STAMPS = ("walk_end", "cluster_barrier", "cluster_partial", "last_ticket",
          "done")


def _sub(s, old, new, count=-1):
    if old not in s:
        raise SystemExit(f"bn_reduction_probe: anchor not in the source: "
                         f"{old!r}")
    return s.replace(old, new, count)


def walk_only(src):
    for call in ("finish_reduction<VEC>(smem, s, q, partial, sums, "
                 "tickets, C);",
                 "finish_reduction<VEC>(smem, sg, sgx, partial, sums, "
                 "tickets, C);"):
        acc = call.split(", ")[1:3]
        src = _sub(src, "  " + call,
                   f"  if ({acc[0]}[0] == 1234.5f) sums[0] = {acc[1]}[0];")
    return src


def stamped(src):
    src = _sub(src, "namespace {\n", """__device__ unsigned long long probe_t[8];
__device__ __forceinline__ unsigned long long probe_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROBE_FIRST (threadIdx.x == 0 && threadIdx.y == 0)
#define PROBE_MIN(i) if (PROBE_FIRST) atomicMin(&probe_t[i], probe_now())
#define PROBE_MAX(i) if (PROBE_FIRST) atomicMax(&probe_t[i], probe_now())
namespace {
""", 1)
    src = _sub(src, "  extern __shared__ float smem[];\n  constexpr int U",
               "  extern __shared__ float smem[];\n  PROBE_MIN(0);\n"
               "  constexpr int U")
    src = _sub(src, "  block_sum<VEC>(smem, a, b, red);\n  cluster.sync();\n",
               "  block_sum<VEC>(smem, a, b, red);\n  PROBE_MAX(1);\n"
               "  cluster.sync();\n  PROBE_MAX(2);\n")
    src = _sub(src, "  cluster.sync();\n  if (!leader || clusters == 1) "
               "return;\n", "  cluster.sync();\n  PROBE_MAX(3);\n"
               "  if (!leader || clusters == 1) return;\n")
    src = _sub(src, "  if (!last_arrival(tickets + blockIdx.x, clusters)) "
               "return;\n", "  if (!last_arrival(tickets + blockIdx.x, "
               "clusters)) return;\n  PROBE_MAX(4);\n")
    src = _sub(src, "  sum_partials_block<VEC>(smem, red, partial, clusters, "
               "C, sums);\n}", "  sum_partials_block<VEC>(smem, red, partial,"
               " clusters, C, sums);\n  __syncthreads();\n  PROBE_MAX(5);\n}")
    return src + """
extern "C" int probe_reset() {
  unsigned long long h[8] = {~0ull, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(probe_t, h, sizeof(h));
}
extern "C" int probe_read(unsigned long long* h) {
  return (int)cudaMemcpyFromSymbol(h, probe_t, sizeof(probe_t));
}
"""


def build(parent):
    from mxnet_tpu_torch.ops import _build
    src = open(SRC).read()
    srcs = {"kernel": src, "walk": walk_only(src), "stamped": stamped(src)}
    if parent:
        srcs["parent"] = open(parent).read()
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, text in srcs.items():
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(text)
        so = os.path.join(OUT, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        lib = libs[name] = ctypes.CDLL(so)
        if name == "parent":
            lib.mxt_bn_stats.argtypes = [p, p, p, ll, i, i, i, i, i, i, ll, p]
            lib.mxt_bn_bwd_stats.argtypes = [p, p, p, p, p, p, ll, i, i, i,
                                             i, i, i, ll, p]
        else:
            lib.mxt_bn_stats.argtypes = [p, p, p, p, ll, i, i, i, i, i, i,
                                         ll, p]
            lib.mxt_bn_bwd_stats.argtypes = [p, p, p, p, p, p, p, ll, i, i,
                                             i, i, i, i, ll, p]
    libs["stamped"].probe_read.argtypes = [p]
    return libs


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an older fused_bn_act.cu with the "
                    "two-launch reductions, timed beside this one")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bn_reduction_probe: no CUDA device")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import fused_bn_act as tk

    print(cs.card_line(), flush=True)
    t0 = time.perf_counter()
    libs = build(args.parent)
    tk._bound = True          # every library's argtypes are set above
    print(json.dumps({"build_s": time.perf_counter() - t0}), flush=True)

    def ours(lib, kname, cs_):
        _build._loaded["fused_bn_act"] = lib
        if kname == "bn_stats":
            return tk.bn_stats(cs_["x"])
        return tk.bn_bwd_stats(cs_["dy"], cs_["out"], cs_["x"],
                               cs_["coef_b"])

    def parent(lib, kname, cs_):
        x = cs_["x"]
        r, c = x.shape
        ins = (x,) if kname == "bn_stats" else (cs_["dy"], cs_["out"], x)
        wide = tk._wide(*ins)
        tx, ty, chunks, rpc = tk._reduce_config(r, c, wide, x.dtype, 132)
        partial = torch.empty((chunks, 2, c), dtype=torch.float32,
                              device="cuda")
        sums = torch.empty((2, c), dtype=torch.float32, device="cuda")
        head = [p.data_ptr() for p in ins]
        if kname == "bn_bwd_stats":
            head.append(cs_["coef_b"].data_ptr())
        fn = lib.mxt_bn_stats if kname == "bn_stats" else \
            lib.mxt_bn_bwd_stats
        if fn(*head, partial.data_ptr(), sums.data_ptr(), r, c,
              tk._DTYPE_CODE[x.dtype], wide, tx, ty, chunks, rpc,
              tk._stream(x)):
            raise SystemExit("parent kernel did not launch")
        return sums

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    floor = cs.time_ms(torch, lambda: torch.cuda._sleep(0), flush, iters=20)
    print(json.dumps({"empty_kernel_ms": floor}), flush=True)
    st = libs["stamped"]
    buf = (ctypes.c_ulonglong * 8)()
    totals = {}
    for r, c, has_res, mult in cs.path_sites():
        case = cs.make_case(torch, tk, r, c, has_res, torch.bfloat16, gen)
        for kname in ("bn_stats", "bn_bwd_stats"):
            row = {"kernel": kname, "R": r, "C": c, "sites_per_step": mult,
                   "bound_ms": cs.bound_ms(kname, r, c, 2, False)[0]}
            for name, lib in libs.items():
                call = parent if name == "parent" else ours
                row[f"{name}_ms"] = cs.time_ms(
                    torch, lambda: call(lib, kname, case), flush)
            stamps = [0.0] * len(STAMPS)
            for _ in range(5):
                ours(st, kname, case)
                torch.cuda.synchronize()
                if st.probe_reset():
                    raise SystemExit("probe_reset failed")
                ours(st, kname, case)
                torch.cuda.synchronize()
                if st.probe_read(ctypes.cast(buf, ctypes.c_void_p)):
                    raise SystemExit("probe_read failed")
                for k in range(len(STAMPS)):
                    stamps[k] += (buf[k + 1] - buf[0]) / 5e3
            row["stamps_us"] = dict(zip(STAMPS, stamps))
            print(json.dumps(row), flush=True)
            t = totals.setdefault(kname, {})
            for key, v in row.items():
                if key.endswith("_ms"):
                    t[key] = t.get(key, 0.0) + mult * v
        del case
        torch.cuda.empty_cache()
    print(json.dumps({"per_step_ms": totals,
                      "empty_kernel_ms_times_48": 48 * floor}), flush=True)
    print(cs.card_line(), flush=True)


if __name__ == "__main__":
    main()
