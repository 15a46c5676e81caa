#!/usr/bin/env python3
"""Drive mxnet_tpu_torch on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            # from the repository root; one card

Phases, each printing JSON lines:

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel of the port from ``mxnet_tpu_torch/csrc`` (nvcc, sm_90a);
2. each kernel of the training path against its plain PyTorch version on
   the card, at every shape the ResNet-50 step gives it (plus a ragged R, a
   C that takes the scalar path, and an f32 case): maximum error, the
   kernel's time, the plain version's time, a one-call PyTorch yardstick
   (``library_ms``, never used by the port) and the bound (the larger of
   bytes / 3.35 TB/s and flops / 67 TFLOP/s, H100 SXM peaks) with its
   share of the kernel's time (``bound_share``), and the time the same
   method gives an empty kernel (the floor under every row); then the
   reductions' ticket counters: each reduction twice back to back, at
   shapes with other grids without a sync, and on two streams at once,
   every result against the plain version and the repeats bit for bit;
3. correctness of the path: a small channel-last ResNetV1 trained one step
   on the card (kernels) and on the host (plain versions) from the same
   weights, f32, TF32 off; logits (training mode, from
   ``autograd.train_mode()``), loss and every updated tensor compared;
   then ``graph``: the same small model from one start state through
   ``SPMDTrainer.run_steps`` twice (the first call runs its K steps
   eagerly and captures them as one CUDA graph, the second replays it)
   and through 2 K eager ``step()`` calls, for SGD momentum and for Adam:
   losses, weights, optimizer state and running statistics bit for bit,
   or within 1e-3 of each tensor's largest value where cuDNN picked
   other algorithms under capture (the row says which); a third call on
   new data whose replayed losses must follow the eager ones (a stale
   input buffer would not); no wrapper called during a replay, and every
   BN ticket counter back at 0;
4. the main path: full-width ResNet-50 v1, NHWC, space-to-depth stem,
   224x224, bf16 compute with f32 masters, SGD momentum 0.9 lr 0.05,
   ``SPMDTrainer.run_steps`` of K steps. The first call runs K eager steps
   (48 wrapper launches of every kernel per step) and captures the
   graph; the timed call is one replay, which calls no wrapper. Step
   time, img/s and peak memory (the graph's private pool included);
5. ``profile``: one eager ``step()`` and one ``run_steps`` replay under
   ``torch.profiler``: wall ms, device busy ms and the device's idle share
   of each, device time by kernel family, and PyTorch's own kernels split
   into bf16 casts, copies, the ``_foreach`` update, the plain stem and
   downsample BatchNorm and the rest. The device counts of the four BN
   kernels are the path's launches: 48 in the eager step and 48 x K in
   the replay, which the summary line reports;
6. the flash-attention forward against its plain PyTorch version on both
   of its routes (``flash_route``: the tensor-core kernel for bf16 with D
   64 or 128 and aligned views, the SIMT kernel for the rest), each case at
   its route's tolerance and with the route it took read from the launch
   counters: the transformer path's shape (B 8, T 2048, H 8, D 64, causal,
   bf16, q/k/v as views of the qkv projection; timed, with TFLOP/s, the
   SIMT kernel on the same inputs, SDPA as the yardstick and the bound the
   larger of bytes / 3.35 TB/s and flops / 989 TFLOP/s), the same work at
   D 128 (timed), and edge cases (ragged T, T under one tile, D 8 to 256,
   non-causal, f32, unaligned views);
7. a small transformer LM card against host, f32, TF32 off: logits, loss
   and every parameter after one ``make_train_step`` step, with exactly
   n_layers ``flash_fwd`` launches per forward on the card and none on the
   host;
8. the transformer main path at full width: ``TransformerConfig()`` in
   bf16, batch 8 x T 2048; one timed ``forward`` (tokens/s), then K timed
   ``make_train_step`` steps (step ms, tokens/s, peak memory), counters
   zeroed just before each and read just after: 4 launches per forward
   and per step, every one on the tensor-core route;
9. one more train step under ``torch.profiler``: device time of
   ``flash_fwd``, of the attention backward (the plain recompute), of
   matmuls and of the rest, and the device's idle share;
10. ``nd_ops``: every op of the imperative front end (``mx.nd``) that has
    a case in ``tests/op_cases.py``, card against host at the case's
    rtol/atol, and its gradients through ``autograd.record()`` /
    ``backward()`` where the case has them (f32, TF32 off);
11. ``rtc``: user kernels compiled at run time by ``mx.rtc.CudaModule``
    (NVRTC; the shim ``csrc/rtc.cu`` is built with the other sources):
    ``axpy`` and ``scale2`` over 2^26 f32 elements, ``rowscale`` over an
    (8192, 8192) f32 array with one block per row, ``axpy`` over 2^26
    bf16 elements, and the three ``tests/test_rtc.py`` shapes, each driven
    once through ``CudaKernel.launch`` with the counts zeroed before and
    read after, then held bit for bit against its plain PyTorch version
    and timed (kernel, plain, a one-call yardstick, the bytes bound);
    NVRTC compile ms and the first launch's module-load ms;
12. ``imperative_reference``: an MLP written with ``mx.nd`` only (batch
    64, 256 -> 256 -> 10, f32, TF32 off) takes one step on the card and
    on the host from the same numpy weights: ``autograd.record()``,
    ``backward()``, then the ``sgd_mom`` rtc kernel in place on the card
    and its plain version on the host; loss, gradients and every updated
    tensor within 1e-3 of the tensor's largest value; exactly 4 ``sgd_mom``
    launches on the card, none on the host;
13. ``imperative_train``: the same loop at batch 4096, 4096 -> 4096 ->
    1000, f32, 4 timed steps (step ms, samples/s, peak memory; 16
    ``sgd_mom`` launches, counts zeroed just before and read just after),
    and one more step under ``torch.profiler``;
14. ``imperative_example``: the same loop at the shape of
    ``examples/svm/svm_mnist.py`` (batch 64 of its 10x10 digits, 100 ->
    128 -> 10, 200 steps, each uploading its batch with ``nd.array`` as
    the example does), where the front end's host time, not the card,
    sets the step: step ms, samples/s, host ms of upload / forward /
    backward / update, ``mx.nd`` ops per step and the front end's host
    microseconds per op against the same forward in plain torch; 800
    ``sgd_mom`` launches, counts zeroed just before and read just after;
    then 20 steps under ``torch.profiler`` for the device's idle share;
15. the ``{"kernels": [...]}`` summary (the BN kernels' times are per
    ResNet training step, the sum over the 48 call sites; flash_fwd's per
    launch at the path's shape; the rtc kernels' per launch at the sizes
    above, sgd_mom's per imperative step, the sum over its 4 launches)
    and, last, the device line.

Any failure exits non-zero. Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.
"""
import importlib.util
import json
import os
import subprocess
import sys
import time

B, K_STEPS, IMG = 128, 4, 224
HBM_BYTES_PER_S = 3.35e12       # H100 SXM
F32_FLOPS_PER_S = 67e12         # H100 SXM, outside the tensor cores
BF16_FLOPS_PER_S = 989e12       # H100 SXM, dense bf16 tensor cores
TF_BATCH, TF_T, TF_K_STEPS = 8, 2048, 4
FLASH_SOURCE = "mxnet_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "mxnet_tpu/ops/pallas_kernels.py:85"   # _build_flash
# ResNet-50 v1 stages: (H = W, bottleneck width, output width, blocks)
STAGES = ((56, 64, 256, 3), (28, 128, 512, 4), (14, 256, 1024, 6),
          (7, 512, 2048, 3))
SOURCE = "mxnet_tpu_torch/csrc/fused_bn_act.cu"
KERNELS = {  # name -> (replaced TPU kernel, flops per element)
    "bn_stats": ("mxnet_tpu/ops/pallas_kernels.py:231 _bn_stats_call", 3),
    "bn_apply": ("mxnet_tpu/ops/pallas_kernels.py:261 _bn_apply_call", 4),
    "bn_bwd_stats": ("mxnet_tpu/ops/pallas_kernels.py:298 "
                     "_bn_bwd_stats_call", 6),
    "bn_bwd_apply": ("mxnet_tpu/ops/pallas_kernels.py:340 "
                     "_bn_bwd_apply_call", 7),
}
RTC_VIA = "mxnet_tpu_torch/rtc.py + mxnet_tpu_torch/csrc/rtc.cu (NVRTC)"
RTC_REPLACES = "mxnet_tpu/rtc.py:78"      # PallasKernel._compiled
RTC_N, RTC_ROWS = 1 << 26, 8192
MLP_SMALL = (64, 256, 256, 10)            # batch, in, hidden, classes
MLP_FULL = (4096, 4096, 4096, 1000)
# examples/svm/svm_mnist.py: batch 64 of 10x10 digits, Dense 128 (ReLU),
# Dense 10, SGD lr 0.05 momentum 0.9, 200 iterations by default
MLP_EXAMPLE, MLP_EXAMPLE_ITERS = (64, 100, 128, 10), 200
MLP_K_STEPS, MLP_LR, MLP_MU = 4, 0.05, 0.9
MLP_PARAMS = ("W1", "b1", "W2", "b2")
LIBRARY = {
    "bn_stats": "torch.batch_norm_stats",
    "bn_apply": "torch.batch_norm_elemt (no ReLU / residual)",
    "bn_bwd_stats": "torch.batch_norm_backward_reduce (no ReLU mask)",
    "bn_bwd_apply": "torch.batch_norm_backward_elemt (no ReLU mask)",
}


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(torch, fn, flush, iters=10):
    """Mean device time of ``fn`` in ms over ``iters`` launches, each one
    timed alone with CUDA events after the 50 MB L2 was overwritten (the
    epilogue reads activations a convolution wrote long before). Host
    launch overhead is excluded; the training step's time includes it."""
    fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        flush.zero_()
        # keep the card busy while the host enqueues fn, so the events
        # measure device time and not the wrapper's Python
        torch.cuda._sleep(1_000_000)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def path_sites():
    """Distinct (R, C, residual) epilogue sites of one ResNet-50 step at
    batch B with their multiplicity (48 sites in all)."""
    sites = []
    for hw, mid, out, blocks in STAGES:
        r = B * hw * hw
        sites.append((r, mid, False, 2 * blocks))
        sites.append((r, out, True, blocks))
    assert sum(s[3] for s in sites) == 48
    return sites


def make_case(torch, tk, r, c, has_res, dtype, gen):
    dev = gen.device
    x = (torch.randn((r, c), generator=gen, device=dev) + 0.5).to(dtype)
    res = torch.randn((r, c), generator=gen, device=dev).to(dtype) \
        if has_res else None
    g = torch.rand((c,), generator=gen, device=dev) + 0.5
    b = torch.randn((c,), generator=gen, device=dev)
    sums = tk._bn_stats_plain(x)
    mean = sums[0] / r
    var = torch.clamp_min(sums[1] / r - mean * mean, 0.0)
    inv = torch.rsqrt(var + 1e-5)
    coef_f = torch.stack([inv * g, b - mean * inv * g]).contiguous()
    out = tk._bn_apply_plain(x, res, coef_f)
    dy = torch.randn((r, c), generator=gen, device=dev).to(dtype)
    coef_b = torch.stack([mean, inv]).contiguous()
    bsums = tk._bn_bwd_stats_plain(dy, out, x, coef_b)
    coef_5 = torch.stack([mean, inv, g * inv, bsums[0] / r,
                          bsums[1] / r]).contiguous()
    return dict(x=x, res=res, g=g, b=b, mean=mean, var=var, inv=inv,
                coef_f=coef_f, out=out, dy=dy, coef_b=coef_b,
                coef_5=coef_5, bsums=bsums, has_res=has_res)


def calls(torch, tk, cs):
    """name -> (kernel call, plain call, library call)."""
    x, res, dy, out = cs["x"], cs["res"], cs["dy"], cs["out"]
    r, c = x.shape
    x4 = x.view(r, 1, 1, c).permute(0, 3, 1, 2)   # (R, C, 1, 1) NHWC
    dy4 = dy.view(r, 1, 1, c).permute(0, 3, 1, 2)
    mean, inv, g, b = cs["mean"], cs["inv"], cs["g"], cs["b"]
    count = torch.tensor([r], dtype=torch.int32, device=x.device)
    has_res = cs["has_res"]
    return {
        "bn_stats": (lambda: tk.bn_stats(x),
                     lambda: tk._bn_stats_plain(x),
                     lambda: torch.batch_norm_stats(x4, 1e-5)),
        "bn_apply": (lambda: tk.bn_apply(x, res, cs["coef_f"]),
                     lambda: tk._bn_apply_plain(x, res, cs["coef_f"]),
                     lambda: torch.batch_norm_elemt(x4, g, b, mean, inv,
                                                    1e-5)),
        "bn_bwd_stats": (
            lambda: tk.bn_bwd_stats(dy, out, x, cs["coef_b"]),
            lambda: tk._bn_bwd_stats_plain(dy, out, x, cs["coef_b"]),
            lambda: torch.batch_norm_backward_reduce(dy4, x4, mean, inv, g,
                                                     True, True, True)),
        "bn_bwd_apply": (
            lambda: tk.bn_bwd_apply(dy, out, x, cs["coef_5"], has_res),
            lambda: tk._bn_bwd_apply_plain(dy, out, x, cs["coef_5"],
                                           has_res),
            lambda: torch.batch_norm_backward_elemt(
                dy4, x4, mean, inv, g, cs["bsums"][0], cs["bsums"][1],
                count)),
    }


def reduction_scale(torch, tk, name, cs):
    """Per-entry magnitude a reduction's rounding is measured against: the
    same sums over absolute values."""
    if name == "bn_stats":
        return tk._bn_stats_plain(cs["x"].abs())
    g, xhat = tk._masked_g_xhat(cs["dy"], cs["out"], cs["x"], cs["coef_b"])
    return torch.stack([g.abs().sum(0), (g * xhat).abs().sum(0)])


def max_err(torch, tk, name, cs, got, want):
    """(max |kernel - plain|, whether it is within tolerance).
    Reductions: 1e-5 of the sum of magnitudes (f32 accumulation in another
    order). bn_bwd_apply: bit-identical (it rounds operation by operation
    as the plain version does). bn_apply: within one unit in the last
    place of the output type."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst, ok = 0.0, True
    for a, w in zip(got, want):
        d = (a.float() - w.float()).abs()
        worst = max(worst, float(d.max()))
        if name in ("bn_stats", "bn_bwd_stats"):
            tol = 1e-5 * reduction_scale(torch, tk, name, cs) + 1e-6
        elif name == "bn_bwd_apply":
            tol = 0.0
        else:
            ulp = 2.0 ** -7 if a.dtype == torch.bfloat16 else 2.0 ** -23
            tol = ulp * w.float().abs() + 1e-6
        ok = ok and bool((d <= tol).all())
    return worst, ok


def site_bytes_flops(name, r, c, itemsize, has_res):
    n = r * c
    coef = {"bn_stats": 0, "bn_apply": 2, "bn_bwd_stats": 2,
            "bn_bwd_apply": 5}[name] * c * 4
    if name == "bn_stats":
        moved = n * itemsize + 2 * c * 4
    elif name == "bn_apply":
        moved = (3 if has_res else 2) * n * itemsize
    elif name == "bn_bwd_stats":
        moved = 3 * n * itemsize + 2 * c * 4
    else:
        moved = (5 if has_res else 4) * n * itemsize
    flops = KERNELS[name][1] * n + (n if has_res and name == "bn_apply"
                                    else 0)
    return moved + coef, flops


def bound_ms(name, r, c, itemsize, has_res):
    moved, flops = site_bytes_flops(name, r, c, itemsize, has_res)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def kernel_phase(torch, tk):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    totals = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                      max_abs_err=0.0, bound_by=set()) for n in KERNELS}
    bad = []
    # what time_ms gives an empty kernel: the floor under every row below
    emit({"phase": "kernel", "kernel": "empty (torch.cuda._sleep(0))",
          "timing_floor_ms": time_ms(torch, lambda: torch.cuda._sleep(0),
                                     flush, iters=20)})
    # the path's own shapes (timed), then edge cases (checked only)
    cases = [(r, c, res, mult, torch.bfloat16, True)
             for r, c, res, mult in path_sites()]
    cases += [(100003, 512, True, 0, torch.bfloat16, False),
              (1001, 9, True, 0, torch.bfloat16, False),
              (25088, 256, True, 0, torch.float32, False)]
    for r, c, has_res, mult, dtype, timed in cases:
        cs = make_case(torch, tk, r, c, has_res, dtype, gen)
        for name, (kern, plain, lib) in calls(torch, tk, cs).items():
            got = kern()
            want = plain()
            torch.cuda.synchronize()
            err, ok = max_err(torch, tk, name, cs, got, want)
            row = {"phase": "kernel", "kernel": name, "R": r, "C": c,
                   "residual": has_res, "dtype": str(dtype)[6:],
                   "max_abs_err": err, "ok": ok}
            if not ok:
                bad.append(row)
            t = totals[name]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            if timed:
                row["ms"] = time_ms(torch, kern, flush)
                row["plain_ms"] = time_ms(torch, plain, flush)
                row["library_ms"] = time_ms(torch, lib, flush)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    name, r, c, cs["x"].element_size(), has_res)
                row["bound_share"] = row["bound_ms"] / row["ms"]
                row["sites_per_step"] = mult
                for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                    t[key] += mult * row[key]
                t["bound_by"].add(row["bound_by"])
            emit(row)
        del cs
    torch.cuda.empty_cache()
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    return totals


def reduction_counter_check(torch, tk):
    """The one-launch reductions leave their ticket counters at 0: each
    reduction called twice back to back at one shape, then at two shapes
    with other grids without a sync between them, then on two side streams
    at once (each stream has counters of its own). Every result is held
    against the plain version, and the repeated calls against each other
    bit for bit (the finishing order does not depend on which block
    arrives last)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    shapes = ((25088, 256), (401408, 64), (6272, 2048))
    cases = [make_case(torch, tk, r, c, False, torch.bfloat16, gen)
             for r, c in shapes]
    run = {"bn_stats": lambda cs: tk.bn_stats(cs["x"]),
           "bn_bwd_stats": lambda cs: tk.bn_bwd_stats(
               cs["dy"], cs["out"], cs["x"], cs["coef_b"])}
    plain = {"bn_stats": lambda cs: tk._bn_stats_plain(cs["x"]),
             "bn_bwd_stats": lambda cs: cs["bsums"]}
    torch.cuda.synchronize()
    got = []
    for name, fn in run.items():
        got += [(name, 0, fn(cases[0])), (name, 0, fn(cases[0]))]
        got += [(name, i, fn(cases[i])) for i in (1, 2)]
    side = (torch.cuda.Stream(), torch.cuda.Stream())
    for s in side:
        s.wait_stream(torch.cuda.current_stream())
    for s, name in zip(side, run):
        with torch.cuda.stream(s):
            got += [(name, i, run[name](cases[i])) for i in (0, 1, 2, 0)]
    torch.cuda.synchronize()
    bad, worst, first = [], 0.0, {}
    for name, i, out in got:
        err, ok = max_err(torch, tk, name, cases[i], out,
                          plain[name](cases[i]))
        worst = max(worst, err)
        ref = first.setdefault((name, i), out)
        if not (ok and torch.equal(out, ref)):
            bad.append((name, shapes[i], err))
    left = {str(k): int(v.abs().sum()) for k, v in tk._tickets.items()}
    row = {"phase": "reduction_counters", "calls": len(got),
           "max_abs_err": worst, "tickets_left": left, "ok": not bad}
    emit(row)
    if bad or any(left.values()):
        fail(f"reductions after repeated or concurrent calls: {row} {bad}")


# ---------------------------------------------------------------------------
# phase 3: the path on a small model, card against host
# ---------------------------------------------------------------------------

SMALL_SPEC = ([1, 1, 1, 1], [8, 16, 32, 64, 128])


def small_net(mt, device):
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        BottleneckV1, ResNetV1)
    return ResNetV1(BottleneckV1, *SMALL_SPEC, classes=10, layout="NHWC",
                    stem_s2d=True, device=device)


def small_reference(torch, mt):
    from mxnet_tpu_torch.convert import from_mxnet_tpu_params
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    nets = {dev: small_net(mt, dev) for dev in ("cpu", "cuda")}
    nets["cpu"].initialize(generator=torch.Generator().manual_seed(0))
    from_mxnet_tpu_params(nets["cuda"], {
        k: p.data().asnumpy()
        for k, p in nets["cpu"].collect_params().items()},
        prefix=nets["cpu"].prefix)
    gen = torch.Generator().manual_seed(1)
    data = torch.rand((1, 4, 64, 64, 3), generator=gen)
    label = torch.randint(0, 10, (1, 4), generator=gen).float()
    res = {}
    tk.reset_launches()
    for dev, net in nets.items():
        # training-mode logits: the mode comes from autograd
        with mt.autograd.train_mode():
            logits = net(data[0].to(dev)).detach().cpu()
        tr = mt.parallel.SPMDTrainer(
            net, gloss.SoftmaxCrossEntropyLoss(),
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
        loss = tr.run_steps(data.to(dev), label.to(dev)).cpu()
        params = {k: p.tensor.detach().cpu()
                  for k, p in net.collect_params().items()}
        res[dev] = (logits, loss, params)
    launched = dict(tk.launches)
    (l_c, loss_c, p_c), (l_g, loss_g, p_g) = res["cpu"], res["cuda"]
    p_g = {k[len(nets["cuda"].prefix):]: v for k, v in p_g.items()}
    p_c = {k[len(nets["cpu"].prefix):]: v for k, v in p_c.items()}
    worst = max(float((p_g[k] - p_c[k]).abs().max())
                / max(float(p_c[k].abs().max()), 1e-6) for k in p_c)
    row = {"phase": "reference", "model": "ResNetV1 [1,1,1,1] "
           "[8,16,32,64,128] NHWC s2d 64x64 batch 4, f32, TF32 off",
           "logits_max_abs_err": float((l_g - l_c).abs().max()),
           "loss_card": float(loss_g[0]), "loss_host": float(loss_c[0]),
           "worst_state_err_of_max": worst, "launches": launched}
    emit(row)
    if not (torch.allclose(l_g, l_c, rtol=1e-3, atol=1e-3)
            and torch.allclose(loss_g, loss_c, rtol=1e-4, atol=1e-5)
            and worst <= 1e-3):
        fail(f"card and host disagree on the small model: {row}")
    if min(launched.values()) < 12:
        fail(f"small model did not go through the kernels: {launched}")


# ---------------------------------------------------------------------------
# phase 3b: the K-step CUDA graph against eager steps
# ---------------------------------------------------------------------------

GRAPH_K = 2
GRAPH_OPTS = (("sgd", {"learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4}),
              ("adam", {"learning_rate": 1e-3, "wd": 1e-4}))


def _trainer_state(tr, net):
    """Every weight, running statistic and optimizer buffer, by name."""
    strip = len(net.prefix)
    out = {f"param/{k[strip:]}": p.tensor.detach().clone()
           for k, p in net.collect_params().items()}
    for k, s in tr.optimizer_state.items():
        for i, t in enumerate(s if isinstance(s, tuple) else (s,)):
            out[f"opt{i}/{k[strip:]}"] = t.detach().clone()
    if tr._t is not None:
        out["t"] = tr._t.detach().clone()
    return out


def _agreement(torch, got, want):
    """('bit for bit' | 'within 1e-3', worst error as a fraction of each
    tensor's largest value) or None when they disagree."""
    if all(torch.equal(got[k], want[k]) for k in want):
        return "bit for bit", 0.0
    worst = max(float((got[k].float() - want[k].float()).abs().max())
                / max(float(want[k].float().abs().max()), 1e-6)
                for k in want)
    return ("within 1e-3", worst) if worst <= 1e-3 else (None, worst)


def graph_phase(torch, mt):
    """One start state of the small ResNet through (a) ``run_steps`` twice
    (the first call eager, then a replay of its graph) and (b) 2 K eager
    ``step()`` calls, for SGD and Adam: losses, weights, optimizer state,
    ``t`` and running statistics must agree. Then new data: the replay's
    losses must follow it (a stale input buffer would not). A replay
    calls no wrapper (their counts stay put), and every ticket counter
    reads 0 after the replays."""
    from mxnet_tpu_torch.convert import from_mxnet_tpu_params
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    src = small_net(mt, "cpu")
    src.initialize(generator=torch.Generator().manual_seed(3))
    weights = {k: p.data().asnumpy()
               for k, p in src.collect_params().items()}
    # deterministic cuDNN algorithms, so graph and eager can agree to the
    # bit; restored after the phase
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    gen = torch.Generator().manual_seed(4)
    batches = [(torch.rand((GRAPH_K, 4, 64, 64, 3), generator=gen).cuda(),
                torch.randint(0, 10, (GRAPH_K, 4), generator=gen).float()
                .cuda()) for _ in range(3)]
    for opt, params in GRAPH_OPTS:
        runs = {}
        for how in ("graph", "eager"):
            net = small_net(mt, "cuda")
            from_mxnet_tpu_params(net, weights, prefix=src.prefix)
            tr = mt.parallel.SPMDTrainer(
                net, gloss.SoftmaxCrossEntropyLoss(), optimizer=opt,
                optimizer_params=params)
            losses, replay_launches = [], []
            for i, (d, lab) in enumerate(batches):
                before = dict(tk.launches)
                if how == "graph":
                    losses.append(tr.run_steps(d, lab))
                else:
                    losses.append(torch.stack(
                        [tr.step(d[k], lab[k]) for k in range(GRAPH_K)]))
                torch.cuda.synchronize()
                if how == "graph" and i > 0:
                    replay_launches.append(
                        sum(tk.launches[k] - before[k] for k in before))
                if i == 1:
                    state = _trainer_state(tr, net)
            runs[how] = (torch.stack(losses).cpu(), state, replay_launches,
                         len(tr._graphs))
        (lg, sg, rl, n_graphs), (le, se, _, _) = runs["graph"], runs["eager"]
        agree, worst = _agreement(torch, {**sg, "losses": lg[:2]},
                                  {**se, "losses": le[:2]})
        new_agree, new_worst = _agreement(torch, {"l": lg[2]}, {"l": le[2]})
        left = {str(k): int(v.abs().sum()) for k, v in tk._tickets.items()}
        left.update({f"retired{i}": int(v.abs().sum())
                     for i, v in enumerate(tk._retired)})
        row = {"phase": "graph", "optimizer": opt, "k_steps": GRAPH_K,
               "model": "ResNetV1 [1,1,1,1] [8,16,32,64,128] NHWC s2d "
                        "64x64 batch 4, f32, TF32 off",
               "agreement": agree, "worst_err_of_max": worst,
               "new_data_agreement": new_agree,
               "new_data_worst_err_of_max": new_worst,
               "losses_graph": lg.tolist(), "losses_eager": le.tolist(),
               "graphs": n_graphs, "wrapper_launches_in_replays": rl,
               "tickets_left": left}
        emit(row)
        if agree is None:
            fail(f"graph replay and eager steps disagree: {row}")
        if new_agree is None:
            fail(f"the replay's losses did not follow new data: {row}")
        if n_graphs != 1 or any(rl):
            fail(f"the replays did not run as one graph: {row}")
        if any(left.values()):
            fail(f"ticket counters left non-zero after replays: {row}")
    torch.backends.cudnn.deterministic = prev_det


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------

def main_path(torch, mt, card):
    """The timed ``run_steps`` is one replay of the K-step graph, captured
    by the first call (which runs its K steps eagerly first). A replay
    calls no wrapper, so its launches are read on the device by the
    profile phase that follows."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    t0 = time.perf_counter()
    net = resnet50_v1(layout="NHWC", stem_s2d=True)
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
    trainer = mt.parallel.SPMDTrainer(
        net, gloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
        dtype=torch.bfloat16)
    gen = mt.random.seed(1)
    data = torch.rand((K_STEPS, B, IMG, IMG, 3), generator=gen,
                      device="cuda")
    label = torch.randint(0, 1000, (K_STEPS, B), generator=gen,
                          device="cuda").float()
    gib = 2.0 ** 30
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    warm = trainer.run_steps(data, label).cpu()
    warm_launches = dict(tk.launches)
    setup_s = time.perf_counter() - t0
    first_peak = torch.cuda.max_memory_allocated() / gib
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    t1 = time.perf_counter()
    losses = trainer.run_steps(data, label)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    wrapper = dict(tk.launches)
    losses = losses.cpu()
    # the graph's private pool is reserved, not allocated, between replays
    replay_mem = {"peak_allocated_gib": torch.cuda.max_memory_allocated()
                  / gib, "reserved_gib": torch.cuda.memory_reserved() / gib}
    # the eager step in the same call: one untimed, then K timed
    trainer.step(data[0], label[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t2 = time.perf_counter()
    eager = [trainer.step(data[k], label[k]) for k in range(K_STEPS)]
    torch.cuda.synchronize()
    eager_dt = time.perf_counter() - t2
    row = {"phase": "train", "model": "resnet50_v1 NHWC stem_s2d",
           "batch": B, "image": IMG, "k_steps": K_STEPS,
           "dtype": "bfloat16 compute, f32 masters",
           "how": "one replay of the K-step CUDA graph",
           "warmup_losses": warm.tolist(), "losses": losses.tolist(),
           "step_ms": 1e3 * dt / K_STEPS, "img_per_s": B * K_STEPS / dt,
           "peak_mem_gib": replay_mem["reserved_gib"],
           "replay_memory": replay_mem,
           "first_call_peak_allocated_gib": first_peak,
           "eager_step_ms": 1e3 * eager_dt / K_STEPS,
           "eager_img_per_s": B * K_STEPS / eager_dt,
           "eager_peak_allocated_gib": torch.cuda.max_memory_allocated()
           / gib,
           "eager_losses": [float(v) for v in eager],
           "setup_and_first_call_s": setup_s,
           "first_call_wrapper_launches": warm_launches,
           "replay_wrapper_launches": wrapper, "card": card}
    emit(row)
    if not (torch.isfinite(losses).all() and torch.isfinite(warm).all()
            and all(torch.isfinite(v) for v in eager)):
        fail("non-finite loss")
    if not 0.0 < float(warm[0]) < 20.0:
        fail(f"first loss {float(warm[0])} is not that of a fresh "
             "1000-class model")
    if any(v != 48 * K_STEPS for v in warm_launches.values()):
        fail(f"the first (eager) call should launch every kernel "
             f"{48 * K_STEPS} times: {warm_launches}")
    if any(wrapper.values()):
        fail(f"the timed call ran wrappers, not a graph replay: {wrapper}")
    if len(trainer._graphs) != 1:
        fail(f"expected one captured graph, got {len(trainer._graphs)}")
    return trainer, data, label


# device kernels of the four BN epilogue kernels: one per launch
_KERNEL_NAMES = {"bn_stats": "bn_stats_reduce<", "bn_apply": "bn_apply<",
                 "bn_bwd_stats": "bn_bwd_stats_reduce<",
                 "bn_bwd_apply": "bn_bwd_apply<"}
_EPILOGUE_KERNELS = tuple(_KERNEL_NAMES.values())
_CONV_KERNELS = ("conv", "cudnn", "xmma", "implicit", "gemm", "sm90_",
                 "wgrad", "dgrad", "fprop")
_GLUE = ("bf16_casts", "copies", "foreach_update", "plain_batchnorm",
         "rest")


def _glue_category(e):
    """Where a PyTorch kernel of the eager step comes from, by the op that
    launched it and that op's ancestors: the plain BatchNorm of the stem
    and the downsample branches (``_BatchNormCore``, forward and
    backward), the optimizer's ``_foreach`` update, dtype casts
    (``_to_copy``: every f32 master to bf16 and the gradients back, the
    data; the label's cast is a few µs), ``.contiguous()`` and other
    copies, or the rest."""
    names = []
    while e is not None:
        names.append(e.name)
        e = e.cpu_parent
    if any("_BatchNormCore" in n for n in names):
        return "plain_batchnorm"
    if any(n.startswith("aten::_foreach") for n in names):
        return "foreach_update"
    if "aten::_to_copy" in names:
        return "bf16_casts"
    if any(n in ("aten::contiguous", "aten::clone", "aten::copy_")
           for n in names):
        return "copies"
    return "rest"


def _family(name):
    if any(k in name for k in _EPILOGUE_KERNELS):
        return "epilogue_kernels"
    if any(k in name.lower() for k in _CONV_KERNELS):
        return "convolution_kernels"
    return "other"


def _profiled(torch, fn):
    from torch.profiler import ProfilerActivity, profile
    fn()                         # once unprofiled, so the pools are warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return prof, wall_ms


def _device_kernels(prof):
    """{kernel name: [device ms, count]} of one profiled run."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            out[e.key] = [e.self_device_time_total / 1e3, e.count]
    return out


def _summary(what, kernels, wall_ms, glue):
    fam = {"epilogue_kernels": 0.0, "convolution_kernels": 0.0,
           "other": 0.0}
    counts = {k: 0 for k in _KERNEL_NAMES}
    for name, (ms, n) in kernels.items():
        fam[_family(name)] += ms
        for k, pat in _KERNEL_NAMES.items():
            if pat in name:
                counts[k] += n
    busy = sum(fam.values())
    top = sorted(((ms, n, name[:90]) for name, (ms, n) in kernels.items()),
                 reverse=True)
    return {"phase": "profile", "what": what, "wall_ms": wall_ms,
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if busy else None,
            "by_family_ms": fam, "other_split_ms": glue,
            "epilogue_device_launches": counts,
            "top_kernels": [[round(ms, 4), n, name] for ms, n, name
                            in top[:12]]}


def profile_phase(torch, trainer, data, label):
    """One eager ``step()`` and one ``run_steps`` replay under
    torch.profiler, in this order, each run once unprofiled just before
    (warm pools): wall ms, device busy ms and idle share
    of each, device time by family, and the family of PyTorch's own
    kernels ('other') split into bf16 casts, copies, the ``_foreach``
    update, the plain stem / downsample BatchNorm and the rest. In the
    eager step each kernel's category is its launching op's
    (``_glue_category``); a replay launches its kernels without ops, so
    each kernel name's replay time is split in the shares that name had
    across the categories in the eager step. The replay's device counts
    of the four BN kernels are the main path's launches: 48 x K each."""
    prof, wall = _profiled(torch, lambda: trainer.step(data[0], label[0]))
    eager = _device_kernels(prof)
    from torch.autograd import DeviceType
    shares = {}
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        cat = _glue_category(e)
        for kern in e.kernels:
            s = shares.setdefault(kern.name, dict.fromkeys(_GLUE, 0.0))
            s[cat] += kern.duration / 1e3

    def split(kernels):
        glue = dict.fromkeys(_GLUE, 0.0)
        for name, (ms, _) in kernels.items():
            if _family(name) != "other":
                continue
            s = shares.get(name)
            tot = sum(s.values()) if s else 0.0
            if not tot:
                glue["copies" if name.startswith("Memcpy") else "rest"] += ms
                continue
            for cat, v in s.items():
                glue[cat] += ms * v / tot
        return glue

    rows = [_summary(f"one eager SPMDTrainer.step, batch {B}, bf16",
                     eager, wall, split(eager))]
    prof, wall = _profiled(torch, lambda: trainer.run_steps(data, label))
    replay = _device_kernels(prof)
    rows.append(_summary(f"one run_steps replay of the {K_STEPS}-step "
                         f"graph, batch {B}, bf16", replay, wall,
                         split(replay)))
    rows[1]["per_step_device_busy_ms"] = rows[1]["device_busy_ms"] / K_STEPS
    rows[1]["per_step_wall_ms"] = rows[1]["wall_ms"] / K_STEPS
    for row in rows:
        emit(row)
    if any(n != 48 for n in rows[0]["epilogue_device_launches"].values()):
        fail("expected 48 device launches of each BN kernel in one eager "
             f"step, got {rows[0]['epilogue_device_launches']}")
    launched = rows[1]["epilogue_device_launches"]
    if any(n != 48 * K_STEPS for n in launched.values()):
        fail(f"expected {48 * K_STEPS} device launches of each BN kernel "
             f"in one replay, got {launched}")
    return launched

# ---------------------------------------------------------------------------
# phase 6: the flash-attention kernel against its plain version
# ---------------------------------------------------------------------------

def flash_inputs(torch, b, t, h, d, dtype, layout, gen):
    """q, k, v of shape (B, T, H, D): 'qkv' views of one fused projection
    (as the model's _block makes them), 'dense' contiguous tensors, or
    'offset' contiguous views one element off 16-byte alignment."""
    if layout == "qkv":
        qkv = torch.randn((b, t, 3 * h * d), generator=gen,
                          device="cuda").to(dtype)
        return [z.reshape(b, t, h, d) for z in qkv.split(h * d, dim=-1)]
    off = 1 if layout == "offset" else 0
    out = []
    for _ in range(3):
        buf = torch.randn((b * t * h * d + off,), generator=gen,
                          device="cuda").to(dtype)
        out.append(buf[off:].view(b, t, h, d))
    return out


def flash_bound_ms(b, t, h, d, causal, itemsize):
    """The larger of bytes / HBM rate (q, k, v read once, o written once)
    and flops / bf16 tensor-core peak (4*B*H*T^2*D, halved when causal)."""
    moved = 4 * b * t * h * d * itemsize
    flops = 4 * b * h * t * t * d / (2 if causal else 1)
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def flash_tolerance(torch, route, want, v):
    """Per-element tolerance of a flash_fwd output against _flash_plain.
    SIMT route: 2e-5 absolute (randn inputs; the online softmax sums in
    another order), plus one bf16 ulp of the plain output in bf16.
    Tensor-core route: also 2^-8 max|v|, P's bf16 rounding (at most 2^-8
    relative per element, so at most 2^-8 max|v| on the output)."""
    tol = 2e-5 + (2.0 ** -7 * want.float().abs()
                  if want.dtype == torch.bfloat16 else 0.0)
    if route == "tc":
        tol = tol + 2.0 ** -8 * float(v.float().abs().max())
    return tol


def flash_phase(torch, fa):
    """Every case within its route's tolerance of ``_flash_plain`` on the
    same inputs, on the route the case table expects (read from the launch
    counters, which are zeroed before each call). The path's shape and the
    same work at D 128 are timed."""
    import ctypes
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    # (B, T, H, D, causal, dtype, layout, route, timed)
    cases = [(TF_BATCH, TF_T, 8, 64, True, bf16, "qkv", "tc", True),
             (TF_BATCH, TF_T, 4, 128, True, bf16, "qkv", "tc", True),
             (2, 1000, 4, 64, True, bf16, "qkv", "tc", False),
             (2, 64, 4, 64, True, bf16, "dense", "tc", False),
             (3, 37, 2, 64, False, bf16, "dense", "tc", False),
             (2, 129, 2, 64, True, bf16, "dense", "tc", False),
             (2, 1000, 4, 128, False, bf16, "qkv", "tc", False),
             (2, 300, 4, 128, True, bf16, "dense", "tc", False),
             (2, 1000, 4, 32, False, bf16, "dense", "simt", False),
             (2, 129, 2, 64, False, bf16, "offset", "simt", False),
             (2, 1000, 4, 64, True, f32, "qkv", "simt", False),
             (1, 300, 2, 256, True, f32, "dense", "simt", False),
             (2, 129, 2, 64, False, f32, "offset", "simt", False),
             (2, 128, 4, 8, True, f32, "dense", "simt", False)]
    result, worst, bad = None, 0.0, []
    for b, t, h, d, causal, dtype, layout, route, timed in cases:
        q, k, v = flash_inputs(torch, b, t, h, d, dtype, layout, gen)
        scale = 1.0 / d ** 0.5
        fa.reset_launches()
        got = fa.flash_fwd(q, k, v, causal, scale)
        took = "tc" if fa.launches["flash_fwd_tc"] == 1 else "simt"
        counted = fa.launches["flash_fwd"] == 1
        want = fa._flash_plain(q, k, v, causal, scale)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        tol = flash_tolerance(torch, took, want, v)
        ok = (bool(torch.isfinite(got).all()) and bool((diff <= tol).all())
              and took == route == fa.flash_route(q, k, v) and counted)
        err = float(diff.max())
        worst = max(worst, err)
        row = {"phase": "kernel", "kernel": "flash_fwd", "B": b, "T": t,
               "H": h, "D": d, "causal": causal, "dtype": str(dtype)[6:],
               "layout": layout, "route": took, "max_abs_err": err,
               "worst_err_over_tol": float((diff / tol).max()), "ok": ok}
        if not ok:
            bad.append(row)
        if timed:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            o = torch.empty_like(q)
            ts = (q, k, v, o)
            strides = (ctypes.c_longlong * 12)(
                *[st for x in ts for st in x.stride()[:3]])
            lib = fa._lib()

            def simt():   # the SIMT kernel on the same inputs, uncounted
                if lib.mxt_flash_fwd(
                        q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), strides, b, t, h, d, scale,
                        int(causal), 1, 1,
                        torch.cuda.current_stream().cuda_stream):
                    fail("the SIMT flash kernel did not launch")
            row["ms"] = time_ms(
                torch, lambda: fa.flash_fwd(q, k, v, causal, scale), flush)
            row["simt_ms"] = time_ms(torch, simt, flush)
            row["plain_ms"] = time_ms(
                torch, lambda: fa._flash_plain(q, k, v, causal, scale),
                flush, iters=3)
            row["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale), flush)
            row["bound_ms"], row["bound_by"] = flash_bound_ms(
                b, t, h, d, causal, q.element_size())
            flops = 4 * b * h * t * t * d / (2 if causal else 1)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            row["tflops"] = flops / row["ms"] / 1e9
            row["library_tflops"] = flops / row["library_ms"] / 1e9
            if result is None:
                result = dict(row)
            else:
                result["d128"] = {key: row[key] for key in (
                    "H", "D", "ms", "simt_ms", "library_ms", "tflops",
                    "worst_err_over_tol")}
        emit(row)
        del q, k, v, got, want, diff
    torch.cuda.empty_cache()
    if bad:
        fail(f"flash_fwd disagrees with its plain version or took another "
             f"route: {bad}")
    result["max_abs_err"] = worst
    return result


# ---------------------------------------------------------------------------
# phase 7: a small transformer LM, card against host
# ---------------------------------------------------------------------------

def transformer_reference(torch, mt):
    import numpy as np
    from mxnet_tpu_torch.convert import from_transformer_params
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu_torch.ops import flash_attention as fa
    cfg = tf.TransformerConfig(vocab_size=257, d_model=128, n_heads=2,
                               n_layers=2, d_ff=512)
    init = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    arrays = {k: (v.numpy() if isinstance(v, torch.Tensor)
                  else {kk: vv.numpy() for kk, vv in v.items()})
              for k, v in init.items()}
    rs = np.random.RandomState(1)
    tok = torch.from_numpy(rs.randint(0, 257, (2, 256)))
    tgt = torch.from_numpy(rs.randint(0, 257, (2, 256)))
    step, _ = tf.make_train_step(cfg, lr=0.1)
    res = {}
    for dev in ("cpu", "cuda"):
        params = from_transformer_params(arrays, cfg, device=dev)
        fa.reset_launches()
        logits = tf.forward(params, tok, cfg).cpu()
        fwd = fa.launches["flash_fwd"]
        loss = tf.loss_fn(params, tok, tgt, cfg).cpu()
        fa.reset_launches()
        step(params, tok, tgt)
        stepped = fa.launches["flash_fwd"]
        flat = {f"{k}/{kk}": vv.cpu() for k, v in params.items()
                for kk, vv in (v.items() if isinstance(v, dict)
                               else [("", v)])}
        res[dev] = (logits, loss, flat, fwd, stepped)
    (l_c, loss_c, p_c, f_c, s_c), (l_g, loss_g, p_g, f_g, s_g) = \
        res["cpu"], res["cuda"]
    worst = max(float((p_g[k] - p_c[k]).abs().max())
                / max(float(p_c[k].abs().max()), 1e-6) for k in p_c)
    row = {"phase": "transformer_reference", "model": "vocab 257, d_model "
           "128, 2 heads (head dim 64), 2 layers, d_ff 512, T 256, batch 2, "
           "f32, TF32 off, one SGD step lr 0.1",
           "logits_max_abs_err": float((l_g - l_c).abs().max()),
           "loss_card": float(loss_g), "loss_host": float(loss_c),
           "worst_param_err_of_max": worst,
           "flash_fwd_launches": {"card_forward": f_g, "card_step": s_g,
                                  "host_forward": f_c, "host_step": s_c}}
    emit(row)
    if not (torch.allclose(l_g, l_c, rtol=1e-3, atol=1e-3)
            and torch.allclose(loss_g, loss_c, rtol=1e-4, atol=1e-5)
            and worst <= 1e-3):
        fail(f"card and host disagree on the small transformer: {row}")
    if (f_g, s_g, f_c, s_c) != (cfg.n_layers, cfg.n_layers, 0, 0):
        fail(f"small transformer launch counts are wrong: {row}")


# ---------------------------------------------------------------------------
# phase 8: the transformer main path at full width
# ---------------------------------------------------------------------------

def transformer_main(torch, mt, card):
    import math
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    cfg = tf.TransformerConfig(dtype=torch.bfloat16)
    params = tf.init_params(mt.random.seed(0), cfg)
    gen = mt.random.seed(1)
    tok = torch.randint(0, cfg.vocab_size, (TF_BATCH, TF_T), generator=gen,
                        device="cuda")
    tgt = torch.randint(0, cfg.vocab_size, (TF_BATCH, TF_T), generator=gen,
                        device="cuda")
    ntok = TF_BATCH * TF_T
    tf.forward(params, tok, cfg)          # warm-up (cuBLAS handles, caches)
    torch.cuda.synchronize()
    fa.reset_launches()
    t1 = time.perf_counter()
    logits = tf.forward(params, tok, cfg)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t1
    fwd_launches = fa.launches["flash_fwd"]
    fwd_tc = fa.launches["flash_fwd_tc"]
    fwd_finite = bool(torch.isfinite(logits).all())
    del logits
    step, _ = tf.make_train_step(cfg, lr=1e-3)
    warm, _ = step(params, tok, tgt)
    warm = float(warm)
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t2 = time.perf_counter()
    losses = torch.stack([step(params, tok, tgt)[0]
                          for _ in range(TF_K_STEPS)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t2
    step_launches = fa.launches["flash_fwd"]
    step_tc = fa.launches["flash_fwd_tc"]
    losses = losses.cpu()
    row = {"phase": "transformer_train", "model": "TransformerConfig() "
           "(vocab 32000, d_model 512, 8 heads, 4 layers, d_ff 2048), bf16",
           "batch": TF_BATCH, "T": TF_T, "k_steps": TF_K_STEPS,
           "forward_ms": 1e3 * fwd_s, "forward_tokens_per_s": ntok / fwd_s,
           "warmup_loss": warm, "losses": losses.tolist(),
           "step_ms": 1e3 * dt / TF_K_STEPS,
           "train_tokens_per_s": ntok * TF_K_STEPS / dt,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "setup_and_first_calls_s": setup_s,
           "flash_fwd_launches": {"forward": fwd_launches,
                                  "train_steps": step_launches,
                                  "forward_tc": fwd_tc,
                                  "train_steps_tc": step_tc},
           "card": card}
    emit(row)
    if not (fwd_finite and torch.isfinite(losses).all()
            and math.isfinite(warm)):
        fail("non-finite logits or loss on the transformer path")
    if abs(warm - math.log(cfg.vocab_size)) > 1.0:
        fail(f"first loss {warm} is not that of a fresh {cfg.vocab_size}-"
             "token model")
    if fwd_launches != cfg.n_layers or \
            step_launches != cfg.n_layers * TF_K_STEPS:
        fail(f"expected {cfg.n_layers} flash_fwd launches per forward and "
             f"per step, got {fwd_launches} and {step_launches} in "
             f"{TF_K_STEPS} steps")
    if (fwd_tc, step_tc) != (fwd_launches, step_launches):
        fail(f"not every flash_fwd launch took the tensor-core route: "
             f"{fwd_tc} of {fwd_launches} per forward, {step_tc} of "
             f"{step_launches} in {TF_K_STEPS} steps")
    return step_launches, (step, params, tok, tgt)


_MATMUL_KERNELS = ("gemm", "nvjet", "xmma", "cutlass", "matmul")
_FLASH_BWD_RANGE = "mxt::flash_attention_backward"


def profile_transformer_step(torch, step, params, tok, tgt):
    """One train step under torch.profiler. Each device kernel is charged
    to the first family it matches: flash_fwd by name; the attention
    backward when launched inside the backward's record_function range;
    matmuls by name; other."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, tok, tgt)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    fam = {"flash_fwd": 0.0, "attention_backward_recompute": 0.0,
           "matmuls": 0.0, "other": 0.0}
    top = {}

    def walk(e, in_bwd):
        in_bwd = in_bwd or e.name == _FLASH_BWD_RANGE
        for kern in e.kernels:
            ms = kern.duration / 1e3
            name = kern.name.lower()
            if "flash_fwd" in name:
                key = "flash_fwd"
            elif in_bwd:
                key = "attention_backward_recompute"
            elif any(k in name for k in _MATMUL_KERNELS):
                key = "matmuls"
            else:
                key = "other"
            fam[key] += ms
            t = top.setdefault((key, kern.name[:90]), [0.0, 0])
            t[0] += ms
            t[1] += 1
        for c in e.cpu_children:
            walk(c, in_bwd)

    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.cpu_parent is None:
            walk(e, False)
    # the record_function range also shows as a device-side annotation
    # spanning its kernels: leave it out of the kernels' busy time
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.key != _FLASH_BWD_RANGE) / 1e3
    ranked = sorted(((v[0], v[1], fam_, name) for (fam_, name), v
                     in top.items()), reverse=True)
    row = {"phase": "transformer_profile", "what": "one make_train_step "
           f"step, batch {TF_BATCH} x T {TF_T}, bf16, under torch.profiler",
           "wall_ms": wall_ms, "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall_ms if busy else None,
           "by_family_ms": fam,
           "unattributed_ms": busy - sum(fam.values()),
           "top_kernels": [[round(ms, 4), n, f, name] for ms, n, f, name
                           in ranked[:16]]}
    emit(row)
    if fam["flash_fwd"] <= 0.0 or fam["attention_backward_recompute"] <= 0.0:
        fail(f"the profile saw no flash_fwd or attention backward: {row}")


# ---------------------------------------------------------------------------
# phase 10: the imperative front end's ops, card against host
# ---------------------------------------------------------------------------

def _first(out, idx=0):
    return out[idx] if isinstance(out, (tuple, list)) else out


def _op_run(mt, np, name, case, ctx, gradable, index):
    """Forward (and gradients, when ``gradable``) of one op case on
    ``ctx``; numpy results."""
    nd, ag = mt.nd, mt.autograd
    with ctx:
        arrs = [nd.array(a, dtype=a.dtype) for a in case.inputs]
        diff = (list(case.grad_only) if case.grad_only is not None
                else list(range(len(arrs)))) if gradable else []
        for i in diff:
            arrs[i].attach_grad()
        with ag.record(train_mode=True) if gradable else ag.pause():
            out = _first(nd.imperative_invoke(name, tuple(arrs),
                                              dict(case.params)),
                         case.out_index)
        if gradable:
            head = np.asarray(np.random.RandomState(index).randn(
                *out.shape), np.float32)
            out.backward(nd.array(head))
        return [out.asnumpy()] + [arrs[i].grad.asnumpy() for i in diff]


def nd_ops_phase(torch, mt, here):
    import numpy as np
    spec = importlib.util.spec_from_file_location(
        "op_cases", os.path.join(here, "tests", "op_cases.py"))
    cases_mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases_mod)
    reg = mt.ops.registry
    ported = set(reg.list_ops())
    ops = sorted(n for n in cases_mod.CASES if n in ported)
    n_cases = n_grads = 0
    worst, bad = 0.0, []
    for name in ops:
        for i, case in enumerate(cases_mod.CASES[name]):
            gradable = (case.grad is not False
                        and reg.get_op(name).differentiable
                        and len(case.inputs) > 0
                        and all(np.issubdtype(a.dtype, np.floating)
                                for a in case.inputs))
            host = _op_run(mt, np, name, case, mt.cpu(), gradable, i)
            card = _op_run(mt, np, name, case, mt.gpu(0), gradable, i)
            n_cases += 1
            n_grads += len(host) - 1
            for k, (c, h) in enumerate(zip(card, host)):
                c64, h64 = c.astype(np.float64), h.astype(np.float64)
                if c.shape != h.shape or not np.allclose(
                        c64, h64, rtol=case.rtol, atol=case.atol,
                        equal_nan=True):
                    bad.append(f"{name} case {i} "
                               f"{'output' if k == 0 else f'grad {k - 1}'}")
                elif c.size:
                    fin = np.isfinite(h64)
                    if fin.any():
                        worst = max(worst, float(np.abs(c64 - h64)[fin]
                                                 .max()))
    row = {"phase": "nd_ops", "ops": len(ops), "cases": n_cases,
           "gradients": n_grads, "max_abs_err": worst, "failed": bad,
           "what": "card vs host at each op_cases.py case's rtol/atol, "
                   "f32, TF32 off"}
    emit(row)
    if bad or len(ops) < 170:
        fail(f"mx.nd ops disagree between card and host: {row}")


# ---------------------------------------------------------------------------
# phase 11: kernels compiled at run time (rtc.CudaModule over NVRTC)
# ---------------------------------------------------------------------------

RTC_SOURCE = r"""
// User kernels of chip_smoke.py, compiled at run time by NVRTC. The
// elementwise ones round each product and sum apart (__fmul_rn,
// __fadd_rn), as their plain PyTorch versions' separate ops do, so both
// agree bit for bit.
extern "C" __global__ void axpy(const float *a, const float *x,
                                const float *y, float *out, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = __fadd_rn(__fmul_rn(a[i], x[i]), y[i]);
}

extern "C" __global__ void scale2(const float *x, float *out, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * 2.0f;
}

// one block per row: out[r, :] = x[r, :] * (r + 1)
extern "C" __global__ void rowscale(const float *x, float *out, int cols) {
  long long base = blockIdx.x * (long long)cols;
  float s = (float)(blockIdx.x + 1);
  for (int c = threadIdx.x; c < cols; c += blockDim.x)
    out[base + c] = x[base + c] * s;
}

extern "C" __global__ void axpy_bf16(const __nv_bfloat16 *a,
    const __nv_bfloat16 *x, const __nv_bfloat16 *y, __nv_bfloat16 *out,
    long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float p = __bfloat162float(__float2bfloat16_rn(
      __fmul_rn(__bfloat162float(a[i]), __bfloat162float(x[i]))));
  out[i] = __float2bfloat16_rn(__fadd_rn(p, __bfloat162float(y[i])));
}

// MXNet's SGD with momentum, in place: mom = mu*mom - lr*g; w += mom
extern "C" __global__ void sgd_mom(float *w, float *mom, const float *g,
                                   float lr, float mu, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float m = __fsub_rn(__fmul_rn(mu, mom[i]), __fmul_rn(lr, g[i]));
  mom[i] = m;
  w[i] = __fadd_rn(w[i], m);
}
"""
RTC_SIGS = {
    "axpy": "const float *a, const float *x, const float *y, float *out, "
            "int64_t n",
    "scale2": "const float *x, float *out, int64_t n",
    "rowscale": "const float *x, float *out, int cols",
    "axpy_bf16": "const __nv_bfloat16 *a, const __nv_bfloat16 *x, "
                 "const __nv_bfloat16 *y, __nv_bfloat16 *out, int64_t n",
    "sgd_mom": "float *w, float *mom, const float *g, float lr, float mu, "
               "int64_t n",
}
RTC_LIBRARY = {
    "axpy": "torch.addcmul(y, a, x)", "scale2": "torch.mul(x, 2)",
    "rowscale": "torch.mul(x, s[:, None])",
    "axpy_bf16": "torch.addcmul(y, a, x) in bf16 (one rounding)",
    "sgd_mom": "torch._fused_sgd_ over the 4 tensors (PyTorch's momentum "
               "convention, same bytes)",
}
_BLOCK = 256


def _blocks(n):
    return (n + _BLOCK - 1) // _BLOCK


def plain_sgd_mom(torch, w, mom, g, lr, mu):
    """The sgd_mom kernel's function on tensors, in place."""
    with torch.no_grad():
        m = mu * mom - lr * g
        mom.copy_(m)
        w.add_(m)


def rtc_cases(torch, mt, ks, gen):
    """(name, size note, kernel call, plain call, library call, output
    tensor, bytes moved, flops, timed) for each case of the phase."""
    gpu = mt.gpu(0)
    wrap = mt.nd.from_torch

    def rand(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    cases = []
    for n, timed in ((RTC_N, True), (16, False)):
        a, x, y = (rand((n,)) for _ in range(3))
        out = torch.empty_like(a)
        A, X, Y, O = (wrap(t) for t in (a, x, y, out))
        cases.append(("axpy", f"n={n} f32", lambda A=A, X=X, Y=Y, O=O, n=n:
                      ks["axpy"].launch([A, X, Y, O, n], gpu, _blocks(n),
                                        _BLOCK),
                      lambda a=a, x=x, y=y: a * x + y,
                      lambda a=a, x=x, y=y: torch.addcmul(y, a, x), out,
                      16 * n, 2 * n, timed))
    for n, timed in ((RTC_N, True), (4, False)):
        x = rand((n,))
        out = torch.empty_like(x)
        X, O = wrap(x), wrap(out)
        cases.append(("scale2", f"n={n} f32", lambda X=X, O=O, n=n:
                      ks["scale2"].launch([X, O, n], gpu, _blocks(n),
                                          _BLOCK),
                      lambda x=x: x * 2.0, lambda x=x: torch.mul(x, 2),
                      out, 8 * n, n, timed))
    for (r, c), timed in (((RTC_ROWS, RTC_ROWS), True), ((4, 8), False)):
        x = rand((r, c))
        out = torch.empty_like(x)
        s = torch.arange(1, r + 1, device="cuda", dtype=torch.float32)
        X, O = wrap(x), wrap(out)
        cases.append(("rowscale", f"({r}, {c}) f32, grid ({r},)",
                      lambda X=X, O=O, r=r, c=c:
                      ks["rowscale"].launch([X, O, c], gpu, (r,),
                                            (min(_BLOCK, c),)),
                      lambda x=x, r=r: x * torch.arange(
                          1, r + 1, device="cuda",
                          dtype=torch.float32)[:, None],
                      lambda x=x, s=s: torch.mul(x, s[:, None]), out,
                      8 * r * c, r * c, timed))
    n = RTC_N
    a, x, y = (rand((n,), torch.bfloat16) for _ in range(3))
    out = torch.empty_like(a)
    A, X, Y, O = (wrap(t) for t in (a, x, y, out))
    cases.append(("axpy_bf16", f"n={n} bf16", lambda: ks["axpy_bf16"].launch(
        [A, X, Y, O, n], gpu, _blocks(n), _BLOCK),
        lambda: a * x + y, lambda: torch.addcmul(y, a, x), out, 8 * n,
        2 * n, True))
    return cases


def rtc_bound_ms(moved, flops):
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def rtc_phase(torch, mt):
    from mxnet_tpu_torch.ops import _build
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    mod = mt.rtc.CudaModule(RTC_SOURCE)
    ks = {k: mod.get_kernel(k, sig) for k, sig in RTC_SIGS.items()}
    cases = rtc_cases(torch, mt, ks, gen)
    # the facility's own run: each case once through CudaKernel.launch
    mt.rtc.reset_launches()
    t0 = time.perf_counter()
    for case in cases:
        case[2]()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    driven = dict(mt.rtc.launches)
    want = {}
    for case in cases:
        want[case[0]] = want.get(case[0], 0) + 1
    emit({"phase": "rtc_build", "shim_nvcc_s": _build.build_seconds.get(
        "rtc"), "nvrtc_compile_ms": mod.compile_ms,
        "module_load_ms": mod.load_ms.get(0),
        "first_launches_s": first_s, "launches": driven})
    if any(driven.get(k, 0) != v for k, v in want.items()):
        fail(f"rtc launch counts {driven}, expected {want}")
    rows, worst, bad = {}, {}, []
    for name, size, kern, plain, lib, out, moved, flops, timed in cases:
        want_t = plain()
        torch.cuda.synchronize()
        err = float((out.float() - want_t.float()).abs().max())
        worst[name] = max(worst.get(name, 0.0), err)
        row = {"phase": "kernel", "kernel": name, "size": size,
               "max_abs_err": err, "ok": err == 0.0}
        if err != 0.0:
            bad.append(row)
        if timed:
            row["ms"] = time_ms(torch, kern, flush)
            row["plain_ms"] = time_ms(torch, plain, flush)
            row["library_ms"] = time_ms(torch, lib, flush)
            row["bound_ms"], row["bound_by"] = rtc_bound_ms(moved, flops)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            rows[name] = row
        emit(row)
    if bad:
        fail(f"rtc kernels differ from their plain versions: {bad}")
    for name, row in rows.items():
        row["launches"] = driven[name]
        row["max_abs_err"] = worst[name]
    return mod, ks, rows


# ---------------------------------------------------------------------------
# phases 12-13: the imperative MLP with the sgd_mom rtc kernel
# ---------------------------------------------------------------------------

def mlp_loss(nd, x, label, p):
    """Mean cross-entropy of a two-layer ReLU MLP, with mx.nd only (the
    log-softmax from max, exp, sum, log and pick)."""
    h = nd.relu(nd.broadcast_add(nd.dot(x, p["W1"], transpose_b=True),
                                 p["b1"]))
    z = nd.broadcast_add(nd.dot(h, p["W2"], transpose_b=True), p["b2"])
    s = nd.broadcast_sub(z, nd.max(z, axis=1, keepdims=True))
    logp = nd.broadcast_sub(s, nd.log(nd.sum(nd.exp(s), axis=1,
                                             keepdims=True)))
    return -nd.mean(nd.pick(logp, label, axis=1))


def mlp_step(torch, mt, sgd, params, moms, x, label):
    """record -> backward -> SGD with momentum in place: the sgd_mom rtc
    kernel for arrays on the card, its plain version for the host."""
    with mt.autograd.record():
        loss = mlp_loss(mt.nd, x, label, params)
    loss.backward()
    for k in MLP_PARAMS:
        w, m, g = params[k], moms[k], params[k].grad
        if w.context.device_type == "gpu":
            sgd.launch([w, m, g, MLP_LR, MLP_MU, w.size], w.context,
                       _blocks(w.size), _BLOCK)
        else:
            plain_sgd_mom(torch, w.tensor, m.tensor, g.tensor, MLP_LR,
                          MLP_MU)
    return loss


def mlp_numpy(np, dims, seed):
    b, din, dh, dout = dims
    rs = np.random.RandomState(seed)
    return {
        "x": rs.randn(b, din).astype(np.float32),
        "label": rs.randint(0, dout, b).astype(np.float32),
        "W1": (rs.randn(dh, din) / np.sqrt(din)).astype(np.float32),
        "b1": (rs.randn(dh) * 0.1).astype(np.float32),
        "W2": (rs.randn(dout, dh) / np.sqrt(dh)).astype(np.float32),
        "b2": (rs.randn(dout) * 0.1).astype(np.float32),
        "moms": {k: (rs.randn(*s) * 0.01).astype(np.float32) for k, s in
                 (("W1", (dh, din)), ("b1", (dh,)), ("W2", (dout, dh)),
                  ("b2", (dout,)))},
    }


def imperative_reference(torch, mt, sgd):
    import numpy as np
    arr = mlp_numpy(np, MLP_SMALL, 5)
    res = {}
    for ctx in (mt.cpu(), mt.gpu(0)):
        with ctx:
            params = {k: mt.nd.array(arr[k]) for k in MLP_PARAMS}
            moms = {k: mt.nd.array(v) for k, v in arr["moms"].items()}
            for p in params.values():
                p.attach_grad()
            mt.rtc.reset_launches()
            loss = mlp_step(torch, mt, sgd, params, moms,
                            mt.nd.array(arr["x"]), mt.nd.array(arr["label"]))
            mt.nd.waitall()
            launched = mt.rtc.launches.get("sgd_mom", 0)
            out = {"loss": loss.asnumpy()}
            for k in MLP_PARAMS:
                out[f"grad/{k}"] = params[k].grad.asnumpy()
                out[f"param/{k}"] = params[k].asnumpy()
                out[f"mom/{k}"] = moms[k].asnumpy()
            res[ctx.device_type] = (out, launched)
    (host, l_host), (card, l_card) = res["cpu"], res["gpu"]
    errs = {k: float(np.abs(card[k] - host[k]).max())
            / max(float(np.abs(host[k]).max()), 1e-6) for k in host}
    worst = max(errs.values())
    row = {"phase": "imperative_reference", "model": "mx.nd MLP batch 64, "
           "256 -> 256 -> 10, f32, TF32 off, one SGD-momentum step (lr "
           f"{MLP_LR}, mu {MLP_MU})", "loss_card": float(card["loss"]),
           "loss_host": float(host["loss"]),
           "worst_err_of_max": worst, "worst_tensor": max(errs, key=errs.get),
           "sgd_mom_launches": {"card": l_card, "host": l_host}}
    emit(row)
    if worst > 1e-3 or not np.isfinite(card["loss"]):
        fail(f"imperative MLP: card and host disagree: {row}")
    if (l_card, l_host) != (4, 0):
        fail(f"imperative MLP: expected 4 sgd_mom launches on the card and "
             f"none on the host: {row}")


def imperative_train(torch, mt, sgd, card):
    import math
    b, din, dh, dout = MLP_FULL
    gen = mt.random.seed(7)
    t0 = time.perf_counter()

    def init(shape, scale):
        return mt.nd.from_torch(torch.randn(shape, generator=gen,
                                            device="cuda") * scale)

    with mt.gpu(0):
        params = {"W1": init((dh, din), din ** -0.5),
                  "b1": init((dh,), 0.1),
                  "W2": init((dout, dh), dh ** -0.5),
                  "b2": init((dout,), 0.1)}
        moms = {k: mt.nd.zeros(p.shape) for k, p in params.items()}
        for p in params.values():
            p.attach_grad()
        x = init((b, din), 1.0)
        label = mt.nd.from_torch(torch.randint(
            0, dout, (b,), generator=gen, device="cuda").float())
        warm = float(mlp_step(torch, mt, sgd, params, moms, x,
                              label).asscalar())
        setup_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        mt.rtc.reset_launches()
        t1 = time.perf_counter()
        losses = [mlp_step(torch, mt, sgd, params, moms, x, label)
                  for _ in range(MLP_K_STEPS)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        launched = dict(mt.rtc.launches)
        losses = [float(l.asscalar()) for l in losses]
    row = {"phase": "imperative_train", "model": "mx.nd MLP "
           f"{din} -> {dh} -> {dout}, f32, TF32 off, SGD momentum through "
           "the sgd_mom rtc kernel", "batch": b, "k_steps": MLP_K_STEPS,
           "warmup_loss": warm, "losses": losses,
           "step_ms": 1e3 * dt / MLP_K_STEPS,
           "samples_per_s": b * MLP_K_STEPS / dt,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "setup_and_first_step_s": setup_s, "launches": launched,
           "card": card}
    emit(row)
    if not all(math.isfinite(v) for v in [warm] + losses):
        fail("non-finite loss on the imperative path")
    if not 0.0 < warm < 20.0:
        fail(f"first loss {warm} is not that of a fresh {dout}-class model")
    want = {"sgd_mom": 4 * MLP_K_STEPS}
    if {k: v for k, v in launched.items() if v} != want:
        fail(f"expected launches {want} on the imperative path, got "
             f"{launched}")
    return launched["sgd_mom"], (params, moms, x, label)


def profile_imperative_step(torch, mt, sgd, params, moms, x, label,
                            what=f"one imperative MLP step, batch "
                                 f"{MLP_FULL[0]}, f32", steps=1,
                            phase="imperative_profile"):
    """``steps`` more imperative steps under torch.profiler: device time
    of sgd_mom, of matmuls and of the rest, and the device's idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with mt.gpu(0), profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            mlp_step(torch, mt, sgd, params, moms, x, label)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    fam = {"sgd_mom": 0.0, "matmuls": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key.lower()
        key = "sgd_mom" if "sgd_mom" in name else "matmuls" if any(
            k in name for k in _MATMUL_KERNELS) else "other"
        fam[key] += ms
        top.append((ms, e.count, e.key[:90]))
    busy = sum(fam.values())
    top.sort(reverse=True)
    emit({"phase": phase, "what": f"{what}, under torch.profiler",
          "steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy,
          "device_idle_share": 1.0 - busy / wall_ms if busy else None,
          "by_family_ms": fam,
          "top_kernels": [[round(ms, 4), n, name] for ms, n, name
                          in top[:10]]})


def _count_ops(mt, fn):
    """(fn's result, the mx.nd ops it ran): the registry's invoke is
    wrapped for the call, then restored."""
    reg = mt.ops.registry
    real, seen = reg.invoke, []

    def counted(opdef, *a, **kw):
        seen.append(opdef.name)
        return real(opdef, *a, **kw)
    reg.invoke = counted
    try:
        return fn(), seen
    finally:
        reg.invoke = real


def _plain_forward(torch, x, label, p):
    """mlp_loss in plain torch on the tensors behind the NDArrays: the same
    14 ops, with no front end around them."""
    h = torch.maximum(torch.matmul(x, p["W1"].t()) + p["b1"],
                      torch.zeros((), device=x.device))
    z = torch.matmul(h, p["W2"].t()) + p["b2"]
    s = z - torch.amax(z, dim=1, keepdim=True)
    logp = s - torch.log(torch.sum(torch.exp(s), dim=1, keepdim=True))
    return -torch.mean(torch.gather(logp, 1, label.long()[:, None]))


def imperative_example(torch, mt, sgd, here, card):
    """The imperative loop at svm_mnist's shape, where the front end's
    host cost per op sets the step time."""
    import math
    import numpy as np
    b, din, dh, dout = MLP_EXAMPLE
    iters = MLP_EXAMPLE_ITERS
    spec = importlib.util.spec_from_file_location(
        "_digits", os.path.join(here, "examples", "_digits.py"))
    digits = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(digits)
    rs = np.random.RandomState(0)
    batches = []
    for _ in range(iters):
        x, y = digits.digit_batch(rs, b, 10, noise=0.2, jitter=3)
        batches.append((x.reshape(b, din), y.astype(np.float32)))
    arr = mlp_numpy(np, MLP_EXAMPLE, 11)
    with mt.gpu(0):
        params = {k: mt.nd.array(arr[k]) for k in MLP_PARAMS}
        moms = {k: mt.nd.zeros(p.shape) for k, p in params.items()}
        for p in params.values():
            p.attach_grad()

        def upload(i):
            x, y = batches[i % iters]
            return mt.nd.array(x), mt.nd.array(y)

        for i in range(5):                      # warm-up, not timed
            mlp_step(torch, mt, sgd, params, moms, *upload(i))
        x, label = upload(0)
        with mt.autograd.record():
            _, fwd_ops = _count_ops(
                mt, lambda: mlp_loss(mt.nd, x, label, params))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()    # earlier phases' tensors
        split = dict(upload=0.0, forward=0.0, backward=0.0, update=0.0)
        losses = []
        mt.rtc.reset_launches()
        t_start = time.perf_counter()
        for i in range(iters):
            t0 = time.perf_counter()
            x, label = upload(i)
            t1 = time.perf_counter()
            with mt.autograd.record():
                loss = mlp_loss(mt.nd, x, label, params)
            t2 = time.perf_counter()
            loss.backward()
            t3 = time.perf_counter()
            for k in MLP_PARAMS:
                w = params[k]
                sgd.launch([w, moms[k], w.grad, MLP_LR, MLP_MU, w.size],
                           w.context, _blocks(w.size), _BLOCK)
            t4 = time.perf_counter()
            losses.append(loss)
            for key, dt in zip(split, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                split[key] += dt
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_start
        launched = dict(mt.rtc.launches)
        peak = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
        losses = [float(v.asscalar()) for v in losses]

        # the same forward, front end against plain torch, host clock
        tp = {k: p.tensor.detach().requires_grad_() for k, p in
              params.items()}
        tx, tl = x.tensor, label.tensor
        fwd = {}
        for name, run in (
                ("mx_nd", lambda: mlp_loss(mt.nd, x, label, params)),
                ("torch", lambda: _plain_forward(torch, tx, tl, tp))):
            for rep in range(2):                # the first is a warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with mt.autograd.record():
                    for _ in range(iters):
                        run()
                torch.cuda.synchronize()
                fwd[name] = (time.perf_counter() - t0) / iters
    n_ops = len(fwd_ops)
    row = {"phase": "imperative_example", "model": "mx.nd MLP "
           f"{din} -> {dh} -> {dout}, f32, TF32 off, SGD momentum through "
           "the sgd_mom rtc kernel (shape, data and optimizer of "
           "examples/svm/svm_mnist.py; its SVMOutput head replaced by the "
           "log-softmax cross-entropy)", "batch": b, "steps": iters,
           "step_ms": 1e3 * wall / iters,
           "samples_per_s": b * iters / wall,
           "host_ms_per_step": {k: 1e3 * v / iters for k, v in split.items()},
           "forward_ops": n_ops, "ops": fwd_ops,
           "forward_host_ms": {k: 1e3 * v for k, v in fwd.items()},
           "front_end_us_per_op": 1e6 * (fwd["mx_nd"] - fwd["torch"]) / n_ops,
           "mx_nd_us_per_op": 1e6 * fwd["mx_nd"] / n_ops,
           "torch_us_per_op": 1e6 * fwd["torch"] / n_ops,
           "loss_first_10": sum(losses[:10]) / 10,
           "loss_last_10": sum(losses[-10:]) / 10,
           "peak_mem_above_start_gib": peak, "launches": launched,
           "card": card}
    emit(row)
    if not all(math.isfinite(v) for v in losses):
        fail("non-finite loss on the imperative example path")
    if not row["loss_last_10"] < row["loss_first_10"]:
        fail(f"the imperative example's loss did not fall: {row}")
    want = {"sgd_mom": 4 * iters}
    if {k: v for k, v in launched.items() if v} != want:
        fail(f"expected launches {want} on the imperative example path, got "
             f"{launched}")
    profile_imperative_step(
        torch, mt, sgd, params, moms, x, label, steps=20,
        what=f"20 imperative MLP steps, batch {b}, {din} -> {dh} -> {dout}, "
             "f32, the batch already on the card",
        phase="imperative_example_profile")
    return launched["sgd_mom"]


def sgd_mom_timing(torch, mt, sgd, params, moms, flush):
    """sgd_mom at the imperative path's 4 shapes: kernel against its plain
    version (bit for bit), and the times summed over one step."""
    gpu = mt.gpu(0)
    tot = dict(ms=0.0, plain_ms=0.0, max_abs_err=0.0)
    moved = flops = 0
    trip = []
    for k in MLP_PARAMS:
        w, m, g = (t.detach().clone() for t in (
            params[k].tensor, moms[k].tensor, params[k].grad.tensor))
        n = w.numel()
        wk, mk = mt.nd.from_torch(w.clone()), mt.nd.from_torch(m.clone())
        G = mt.nd.from_torch(g)
        sgd.launch([wk, mk, G, MLP_LR, MLP_MU, n], gpu, _blocks(n), _BLOCK)
        plain_sgd_mom(torch, w, m, g, MLP_LR, MLP_MU)
        torch.cuda.synchronize()
        tot["max_abs_err"] = max(tot["max_abs_err"],
                                 float((wk.tensor - w).abs().max()),
                                 float((mk.tensor - m).abs().max()))
        tot["ms"] += time_ms(torch, lambda: sgd.launch(
            [wk, mk, G, MLP_LR, MLP_MU, n], gpu, _blocks(n), _BLOCK), flush)
        tot["plain_ms"] += time_ms(
            torch, lambda: plain_sgd_mom(torch, w, m, g, MLP_LR, MLP_MU),
            flush)
        moved += 20 * n
        flops += 4 * n
        trip.append((wk.tensor, mk.tensor, g))
    if hasattr(torch, "_fused_sgd_"):
        ws, ms_, gs = ([t[i] for t in trip] for i in range(3))
        tot["library_ms"] = time_ms(torch, lambda: torch._fused_sgd_(
            ws, gs, ms_, weight_decay=0.0, momentum=MLP_MU, lr=MLP_LR,
            dampening=0.0, nesterov=False, maximize=False,
            is_first_step=False), flush)
    else:
        tot["library_ms"] = None
    tot["bound_ms"], tot["bound_by"] = rtc_bound_ms(moved, flops)
    emit({"phase": "kernel", "kernel": "sgd_mom", "size": "the imperative "
          "path's 4 parameters (sums over one step)", **tot,
          "ok": tot["max_abs_err"] == 0.0})
    if tot["max_abs_err"] != 0.0:
        fail(f"sgd_mom differs from its plain version: {tot}")
    return tot



def main():
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "mxnet_tpu_torch")):
        fail(f"mxnet_tpu_torch/ not found beside {__file__}")
    sys.path.insert(0, here)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    paths = _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_s": dict(_build.build_seconds),
          "libraries": {k: os.path.relpath(v, here)
                        for k, v in paths.items()},
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    totals = kernel_phase(torch, tk)
    reduction_counter_check(torch, tk)
    small_reference(torch, mt)
    graph_phase(torch, mt)
    trainer, data, label = main_path(torch, mt, card)
    launched = profile_phase(torch, trainer, data, label)
    del trainer, data, label
    torch.cuda.empty_cache()

    flash = flash_phase(torch, fa)
    transformer_reference(torch, mt)
    flash_launches, run = transformer_main(torch, mt, card)
    profile_transformer_step(torch, *run)
    del run
    torch.cuda.empty_cache()

    nd_ops_phase(torch, mt, here)
    mod, ks, rtc_rows = rtc_phase(torch, mt)
    torch.cuda.empty_cache()
    imperative_reference(torch, mt, ks["sgd_mom"])
    sgd_launches, state = imperative_train(torch, mt, ks["sgd_mom"], card)
    profile_imperative_step(torch, mt, ks["sgd_mom"], *state)
    example_launches = imperative_example(torch, mt, ks["sgd_mom"], here,
                                          card)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    sgd = sgd_mom_timing(torch, mt, ks["sgd_mom"], *state[:2], flush)

    kernels = []
    for name, (replaces, _) in KERNELS.items():
        t = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces.split(" ")[0], "launches": launched[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_share": t["bound_ms"] / t["ms"],
            "bound_by": "bytes" if t["bound_by"] == {"bytes"}
            else "operations", "library_ms": t["library_ms"],
            "library": LIBRARY[name],
            "per": f"one training step (48 sites, batch {B}, bf16); "
                   f"launches: device count over one replay of the "
                   f"{K_STEPS}-step graph"})
    kernels.append({
        "name": "flash_fwd", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": flash_launches,
        "max_abs_err": flash["max_abs_err"], "ms": flash["ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_share": flash["bound_share"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "kernel_route": flash["route"], "tflops": flash["tflops"],
        "simt_ms": flash["simt_ms"], "d128": flash["d128"],
        "per": f"one launch (B {TF_BATCH}, T {TF_T}, H 8, D 64, causal, "
               f"bf16); launches over {TF_K_STEPS} train steps, all on "
               "the tensor-core route"})
    for name, row in rtc_rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": "chip_smoke.py",
            "via": RTC_VIA, "replaces": RTC_REPLACES,
            "launches": row["launches"], "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_share": row["bound_share"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "library": RTC_LIBRARY[name],
            "per": f"one launch ({row['size']}); launches in the rtc "
                   "phase's driven run"})
    kernels.append({
        "name": "sgd_mom", "route": "cuda", "source": "chip_smoke.py",
        "via": RTC_VIA, "replaces": RTC_REPLACES, "launches": sgd_launches,
        "max_abs_err": sgd["max_abs_err"], "ms": sgd["ms"],
        "plain_ms": sgd["plain_ms"], "bound_ms": sgd["bound_ms"],
        "bound_share": sgd["bound_ms"] / sgd["ms"],
        "bound_by": sgd["bound_by"], "library_ms": sgd["library_ms"],
        "library": RTC_LIBRARY["sgd_mom"],
        "per": f"one imperative step (4 launches, batch {MLP_FULL[0]}, "
               f"{MLP_FULL[1]} -> {MLP_FULL[2]} -> {MLP_FULL[3]}); launches "
               f"over {MLP_K_STEPS} steps",
        "launches_example": example_launches,
        "nvrtc_compile_ms": mod.compile_ms,
        "module_load_ms": mod.load_ms.get(0)})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
