#!/usr/bin/env python3
"""Drive mxnet_tpu_torch on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            # from the repository root; one card

Phases, each printing JSON lines:

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel of the port from ``mxnet_tpu_torch/csrc`` (nvcc, sm_90a);
2. each kernel of the training path against its plain PyTorch version on
   the card, at every shape the ResNet-50 v1 step gives it and at the
   seven no-residual shapes only the v2 step gives it (plus a ragged R, a
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
   the replay, which the summary line reports, with 16 x K residual
   ``bn_apply`` launches;
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
    ``backward()`` where the case has them (f32, TF32 off); then
    ``mx.nd._contrib_fused_bn_relu`` / ``_contrib_fused_bn_add_relu``
    under ``record()``, card against host, each kernel launched once per
    op on the card and never on the host;
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
14b. then the ResNet-50 v2 path (every pre-activation BN+ReLU a fused
    block, the no-residual branch only), last so the phases above run as
    they did before it: ``resnet_v2_reference``, a small v2
    (``resnet18_v2`` and a thin ``BottleneckV2`` net, NHWC, f32, TF32 off,
    deferred init resolved on the host and carried to the card by
    ``convert``) one step card against host (loss and running statistics
    within 1e-3 of each tensor's largest value, weights too for the thin
    net, ``resnet18_v2``'s weight updates within 5e-2 of their L2 norm;
    one launch of each kernel per fused site on the card, none on the
    host); ``v2_graph``, full-width ``resnet50_v2`` replay against eager
    steps as in ``graph``; ``train_v2``,
    ``get_model("resnet50_v2", layout="NHWC")`` with deferred init,
    ``initialize(Xavier)``, batch 128, bf16 with f32 masters, SGD
    momentum 0.9 lr 0.05, ``run_steps`` of K (the first call probes, runs
    K eager steps and captures; the timed call is one replay);
    ``profile_v2``, as ``profile`` (48 x K device launches of each kernel
    per replay, no residual ``bn_apply``); and ``v2_plain_batchnorm``,
    the device time of the plain BatchNorm at its three v2 sites (the
    input BN at C 3, the stem, the final BN);
14c. then the Gluon Trainer path, f32, TF32 off: ``trainer_reference``,
    a thin ResNet-18 v1 NHWC (``[2,2,2,2]``, widths 8-64, 48x48, batch 4)
    trained 3 steps with ``autograd.record()`` / ``backward()`` /
    ``gluon.Trainer.step`` on the card and on the host from the same
    weights (losses, weights, running statistics and momenta within 1e-3
    of each tensor's largest value; 16 launches of each BN kernel a step
    on the card, none on the host), and the six optimizer configurations
    of ``tests/test_optimizer_aggregation.py`` plus its multi-precision
    one on bare parameters, card against host, with aggregation 4 against
    0 bit for bit on the card; ``optimizer_ops``, every dense optimizer op
    card against host (each element no further from the op in float64
    than the host's, plus 1e-6 + 1e-6 relative); ``gluon_train``,
    ``get_model("resnet50_v1", layout="NHWC")``, ``initialize(Xavier)``,
    ``gluon.Trainer(sgd, lr 0.05, momentum 0.9, kvstore="device")`` at
    batch 32 as ``examples/gluon/image_classification.py`` runs it: one
    untimed step and 10 timed (img/s, ms a step split into forward,
    backward and ``trainer.step`` on the host and on the device, peak
    memory; 48 launches of each BN kernel a step, counts zeroed just
    before and read just after), a profiled step (idle share, 16 residual
    ``bn_apply``) and a profiled ``trainer.step`` at aggregation 4 and 0
    (update calls, device kernels, device and wall ms); ``kernel_f32``,
    each BN kernel against its plain version in f32 at that path's 48
    sites (as phase 2, summed per step);
14d. then the FitLoop path (``fit``, ``fault``, ``io`` with on-card
    staging, ``contrib.chaos``, the telemetry it reports through), f32,
    TF32 off: ``fit_reference``, ``tests/test_chaos.py``'s MLP scenarios
    through ``DeviceStagingIter`` and ``FitLoop`` with asynchronous
    checkpoints, the fault-free run card against host (within 1e-4 of
    each tensor's largest value), and on the card, bit for bit:
    ``kill@10`` and resume against the fault-free run, a ``nan_grad`` step
    leaving weights and momenta as they were, a corrupted latest
    checkpoint quarantined and the fallback's replay; ``fit_train``,
    ``gluon_train``'s ResNet-50 v1 NHWC at batch 32 driven by ``FitLoop``
    over ``DeviceStagingIter(NDArrayIter(256 random images, seed 13))``
    for 2 epochs with ``ckpt_every=4`` and asynchronous checkpoints, under
    deterministic cuDNN: step ms against the bare loop on the same net and
    against ``gluon_train``'s, the step breakdown's shares, the
    checkpoint's ``save()`` and write ms and bytes, ``restore_latest`` ms,
    the memory ledger against ``torch.cuda.memory_allocated()``, 48
    launches of each BN kernel a step; then the same run killed at step
    10 and relaunched, which restores ckpt-8 and must equal the fault-free
    run bit for bit (losses, weights, momenta, running statistics);
    ``megastep_train``, the same workload under ``MXTPU_MEGASTEP=on``
    (the step as one CUDA graph replay per signature) against the
    composed path, from fresh objects: bit for bit without checkpoints
    and with ``ckpt_every=4``, loss scale 128 and ``nan_grad@5`` (skipped
    inside the graph), one cache miss and no wrapper call after the first
    step, the megastep run killed at 10 and resumed bit for bit; median
    step against the composed and bare loops, the idle share of a
    profiled epoch of each (48 device launches of each BN kernel a step
    in the replays), the capture's ms, peak and reserved memory; the six
    ``tests/test_zero.py`` optimizer configurations on a small MLP card
    against host and a Dropout MLP drawing new masks on each replay. The
    checkpoints live in a temporary directory the phase removes;
15. the wall seconds of every phase (a ``wall`` line after each, a
    ``walls`` line with the totals), the ``{"kernels": [...]}`` summary
    (the BN kernels' times are per ResNet-50 v1 training step, the sum
    over the 48 call sites, with the v2 step's sums and launches under
    ``v2``, the f32 Gluon step's under ``f32``, the FitLoop's under
    ``fit`` and the megastep's replays under ``megastep``; flash_fwd's per
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

def path_sites(batch=B):
    """Distinct (R, C, residual) epilogue sites of one ResNet-50 step at
    ``batch`` with their multiplicity (48 sites in all)."""
    sites = []
    for hw, mid, out, blocks in STAGES:
        r = batch * hw * hw
        sites.append((r, mid, False, 2 * blocks))
        sites.append((r, out, True, blocks))
    assert sum(s[3] for s in sites) == 48
    return sites


def v2_path_sites():
    """Distinct (R, C) epilogue sites of one ResNet-50 v2 step at batch B
    with their multiplicity (48 sites, none with a residual): each
    BottleneckV2 has three pre-activation BN+ReLUs, bn1 on the block's
    input (R_in, C_in), bn2 on conv1's output (R_in, mid) and bn3 on the
    strided conv2's output (R_out, mid)."""
    sites = {}
    c_in, hw_in = STAGES[0][1], STAGES[0][0]
    for hw, mid, out, blocks in STAGES:
        for _ in range(blocks):
            r_in, r_out = B * hw_in * hw_in, B * hw * hw
            for key in ((r_in, c_in), (r_in, mid), (r_out, mid)):
                sites[key] = sites.get(key, 0) + 1
            c_in, hw_in = out, hw
    assert sum(sites.values()) == 48
    return [(r, c, False, n) for (r, c), n in sites.items()]


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
    """Every kernel at every (R, C) site of a ResNet-50 v1 step and of a
    v2 step (v2 adds seven no-residual sites v1 never gives the kernels),
    then edge cases; per-step sums for v1 (``totals``) and v2
    (``totals_v2``)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")

    def zero():
        return {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                        max_abs_err=0.0, bound_by=set()) for n in KERNELS}

    totals, totals_v2 = zero(), zero()
    bad = []
    # what time_ms gives an empty kernel: the floor under every row below
    emit({"phase": "kernel", "kernel": "empty (torch.cuda._sleep(0))",
          "timing_floor_ms": time_ms(torch, lambda: torch.cuda._sleep(0),
                                     flush, iters=20)})
    # the path's own shapes (timed), then edge cases (checked only)
    mults = {(r, c, res): [n, 0] for r, c, res, n in path_sites()}
    for r, c, res, n in v2_path_sites():
        mults.setdefault((r, c, res), [0, 0])[1] = n
    cases = [(r, c, res, m, torch.bfloat16, True)
             for (r, c, res), m in mults.items()]
    cases += [(100003, 512, True, (0, 0), torch.bfloat16, False),
              (1001, 9, True, (0, 0), torch.bfloat16, False),
              (25088, 256, True, (0, 0), torch.float32, False)]
    for r, c, has_res, (mult, mult_v2), dtype, timed in cases:
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
            for t, m in ((totals[name], mult), (totals_v2[name], mult_v2)):
                if m or not timed:
                    t["max_abs_err"] = max(t["max_abs_err"], err)
            if timed:
                row["ms"] = time_ms(torch, kern, flush)
                row["plain_ms"] = time_ms(torch, plain, flush)
                row["library_ms"] = time_ms(torch, lib, flush)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    name, r, c, cs["x"].element_size(), has_res)
                row["bound_share"] = row["bound_ms"] / row["ms"]
                row["sites_per_step"] = mult
                row["sites_per_v2_step"] = mult_v2
                for t, m in ((totals[name], mult), (totals_v2[name],
                                                     mult_v2)):
                    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                        t[key] += m * row[key]
                    if m:
                        t["bound_by"].add(row["bound_by"])
            emit(row)
        del cs
    torch.cuda.empty_cache()
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")
    return totals, totals_v2


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


def _residual_variant(name):
    """Whether a ``bn_apply<T, VEC, RES>`` device kernel is the residual
    variant (its last template argument)."""
    args = name.split(_KERNEL_NAMES["bn_apply"], 1)[1].split(">", 1)[0]
    return args.split(",")[-1].strip() == "true"


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
    with_residual = 0
    for name, (ms, n) in kernels.items():
        fam[_family(name)] += ms
        for k, pat in _KERNEL_NAMES.items():
            if pat in name:
                counts[k] += n
        if _KERNEL_NAMES["bn_apply"] in name and _residual_variant(name):
            with_residual += n
    busy = sum(fam.values())
    top = sorted(((ms, n, name[:90]) for name, (ms, n) in kernels.items()),
                 reverse=True)
    return {"phase": "profile", "what": what, "wall_ms": wall_ms,
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if busy else None,
            "by_family_ms": fam, "other_split_ms": glue,
            "epilogue_device_launches": counts,
            "bn_apply_with_residual_launches": with_residual,
            "top_kernels": [[round(ms, 4), n, name] for ms, n, name
                            in top[:12]]}


def profile_phase(torch, trainer, data, label, model="resnet50_v1"):
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

    rows = [_summary(f"{model}: one eager SPMDTrainer.step, batch {B}, "
                     "bf16", eager, wall, split(eager))]
    prof, wall = _profiled(torch, lambda: trainer.run_steps(data, label))
    replay = _device_kernels(prof)
    rows.append(_summary(f"{model}: one run_steps replay of the "
                         f"{K_STEPS}-step graph, batch {B}, bf16", replay,
                         wall, split(replay)))
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
    # v1: one block tail with the residual add per bottleneck (16); v2:
    # every fused site is a pre-activation, none with a residual
    residual = (16 if model == "resnet50_v1" else 0) * K_STEPS
    got = rows[1]["bn_apply_with_residual_launches"]
    if got != residual:
        fail(f"expected {residual} residual bn_apply launches in one "
             f"{model} replay, got {got}")
    return launched

# ---------------------------------------------------------------------------
# the ResNet-50 v2 path: every pre-activation BN+ReLU a fused block
# ---------------------------------------------------------------------------

V2_SMALL = {"resnet18_v2": 16, "bottleneck_v2_thin": 12}   # fused sites


def small_v2(mt, which, device):
    """resnet18_v2 or the thin BottleneckV2 net, NHWC, built with deferred
    initialisation (no input widths given)."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    if which == "resnet18_v2":
        return vision.resnet18_v2(classes=10, layout="NHWC", device=device)
    return vision.ResNetV2(vision.BottleneckV2, *SMALL_SPEC, classes=10,
                           layout="NHWC", device=device)


def resnet_v2_reference(torch, mt):
    """A small v2 trained one step on the card (kernels) and on the host
    (plain versions) from the same numpy weights, f32, TF32 off,
    deterministic cuDNN: the host net's deferred widths are resolved by a
    forward, and ``convert`` creates the card net's tensors from its
    weights. The loss and the running statistics (functions of the
    forward) within 1e-3 of each tensor's largest value; each kernel
    launched once per fused site on the card, never on the host. Weights:
    the thin net's within 1e-3 of each tensor's largest value;
    ``resnet18_v2``'s update (the weight's change in the step) within
    5e-2 of its L2 norm. In ``resnet18_v2`` at this size some ReLU inputs
    lie within rounding of 0, and where card and host round one to
    opposite sides, that channel's gradient moves by a few percent of a
    tensor's largest value (2.2 % on an H100 80GB HBM3); a per-element
    bound cannot tell that from a fault, an L2 bound on the update
    can."""
    from mxnet_tpu_torch.convert import from_mxnet_tpu_params
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    gen = torch.Generator().manual_seed(5)
    data = torch.rand((1, 4, 64, 64, 3), generator=gen)
    label = torch.randint(0, 10, (1, 4), generator=gen).float()
    for which, sites in V2_SMALL.items():
        host = small_v2(mt, which, "cpu")
        host.initialize(mt.init.Xavier(),
                        generator=torch.Generator().manual_seed(0))
        with mt.autograd.pause():
            host(data[0])
        card = small_v2(mt, which, "cuda")
        deferred = sum(p.tensor is None
                       for p in card.collect_params().values())
        start = {k: p.tensor.detach().clone()
                 for k, p in host.collect_params().items()}
        from_mxnet_tpu_params(card, {k: v.numpy() for k, v in start.items()},
                              prefix=host.prefix)
        start = {k[len(host.prefix):]: v for k, v in start.items()}
        res = {}
        for dev, net in (("cpu", host), ("cuda", card)):
            tr = mt.parallel.SPMDTrainer(
                net, gloss.SoftmaxCrossEntropyLoss(),
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
            tk.reset_launches()
            loss = tr.run_steps(data.to(dev), label.to(dev)).cpu()
            torch.cuda.synchronize()
            params = {k[len(net.prefix):]: p.tensor.detach().cpu()
                      for k, p in net.collect_params().items()}
            res[dev] = (loss, params, dict(tk.launches))
        (loss_c, p_c, l_c), (loss_g, p_g, l_g) = res["cpu"], res["cuda"]
        errs = {k: float((p_g[k] - p_c[k]).abs().max())
                / max(float(p_c[k].abs().max()), 1e-6) for k in p_c}
        worst = max(errs, key=errs.get)
        stats = [k for k in p_c if k.endswith(("running_mean",
                                               "running_var"))]
        update_l2 = {k: float((p_g[k] - p_c[k]).norm())
                     / max(float((p_c[k] - start[k]).norm()), 1e-12)
                     for k in p_c if k not in stats}
        worst_l2 = max(update_l2, key=update_l2.get)
        bad = [k for k in stats if errs[k] > 1e-3]
        if which == "resnet18_v2":
            bad += [k for k, e in update_l2.items() if e > 5e-2]
        else:
            bad += [k for k in p_c if errs[k] > 1e-3]
        loss_err = float((loss_g - loss_c).abs().max()) \
            / float(loss_c.abs().max())
        row = {"phase": "resnet_v2_reference", "model": f"{which} NHWC "
               "64x64 batch 4, f32, TF32 off, deferred init",
               "deferred_params_before_convert": deferred,
               "loss_card": float(loss_g[0]), "loss_host": float(loss_c[0]),
               "loss_err_of_max": loss_err,
               "worst_state_err_of_max": errs[worst], "worst_tensor": worst,
               "worst_stat_err_of_max": max(errs[k] for k in stats),
               "worst_update_err_of_l2": update_l2[worst_l2],
               "worst_update_tensor": worst_l2,
               "launches_card": l_g, "launches_host": l_c,
               "fused_sites": sites, "failed": bad}
        emit(row)
        if not deferred:
            fail(f"{which}: nothing was deferred: {row}")
        if loss_err > 1e-3 or bad:
            fail(f"card and host disagree on the small v2 model: {row}")
        if any(n != sites for n in l_g.values()) or any(l_c.values()):
            fail(f"the small v2 model's launches are not one per fused "
                 f"site on the card and none on the host: {row}")
    torch.backends.cudnn.deterministic = prev_det


def v2_net_and_trainer(torch, mt):
    """Full-width ResNet-50 v2 from ``get_model`` with deferred init and
    ``initialize(Xavier)``, and its bf16 SGD-momentum trainer."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    net = get_model("resnet50_v2", layout="NHWC")
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
    trainer = mt.parallel.SPMDTrainer(
        net, gloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
        dtype=torch.bfloat16)
    return net, trainer


def v2_batches(torch, mt, n):
    gen = mt.random.seed(1)
    return [(torch.rand((K_STEPS, B, IMG, IMG, 3), generator=gen,
                        device="cuda"),
             torch.randint(0, 1000, (K_STEPS, B), generator=gen,
                           device="cuda").float()) for _ in range(n)]


def v2_graph_phase(torch, mt):
    """Full-width v2 from one start state (two nets, the same generator)
    through ``run_steps`` twice (the first call resolves the deferred
    widths with the probe, runs K eager steps and captures; the second,
    on new data, replays) and through 2 K eager ``step()`` calls, with
    deterministic cuDNN: losses, weights, momenta and running statistics
    bit for bit, or within 1e-3 of each tensor's largest value."""
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    batches = v2_batches(torch, mt, 2)
    runs = {}
    for how in ("graph", "eager"):
        net, tr = v2_net_and_trainer(torch, mt)
        losses = []
        for d, lab in batches:
            if how == "graph":
                losses.append(tr.run_steps(d, lab))
            else:
                losses.append(torch.stack(
                    [tr.step(d[k], lab[k]) for k in range(K_STEPS)]))
        torch.cuda.synchronize()
        runs[how] = (torch.stack(losses).cpu(), _trainer_state(tr, net),
                     len(tr._graphs))
        del net, tr
    (lg, sg, n_graphs), (le, se, _) = runs["graph"], runs["eager"]
    agree, worst = _agreement(torch, {**sg, "losses": lg},
                              {**se, "losses": le})
    row = {"phase": "v2_graph", "model": "resnet50_v2 NHWC, batch "
           f"{B}, bf16, K {K_STEPS}, deterministic cuDNN",
           "agreement": agree, "worst_err_of_max": worst,
           "losses_graph": lg.tolist(), "losses_eager": le.tolist(),
           "graphs": n_graphs}
    emit(row)
    torch.backends.cudnn.deterministic = prev_det
    torch.cuda.empty_cache()
    if agree is None or n_graphs != 1:
        fail(f"v2 graph replay and eager steps disagree: {row}")


def main_path_v2(torch, mt, card):
    """The v2 path at full width, timed as the v1 path: the first
    ``run_steps`` call resolves the deferred widths (probe), runs K eager
    steps (48 wrapper launches of every kernel per step) and captures;
    the timed call is one replay."""
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    t0 = time.perf_counter()
    net, trainer = v2_net_and_trainer(torch, mt)
    deferred = sum(p.tensor is None for p in net.collect_params().values())
    (data, label), = v2_batches(torch, mt, 1)
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
    row = {"phase": "train_v2", "model": "resnet50_v2 NHWC (get_model, "
           "deferred init)", "batch": B, "image": IMG, "k_steps": K_STEPS,
           "dtype": "bfloat16 compute, f32 masters",
           "how": "one replay of the K-step CUDA graph",
           "deferred_params_at_build": deferred,
           "warmup_losses": warm.tolist(), "losses": losses.tolist(),
           "step_ms": 1e3 * dt / K_STEPS, "img_per_s": B * K_STEPS / dt,
           "peak_mem_gib": torch.cuda.memory_reserved() / gib,
           "replay_peak_allocated_gib": torch.cuda.max_memory_allocated()
           / gib, "first_call_peak_allocated_gib": first_peak,
           "setup_probe_and_first_call_s": setup_s,
           "first_call_wrapper_launches": warm_launches,
           "replay_wrapper_launches": wrapper, "card": card}
    emit(row)
    if not deferred:
        fail("resnet50_v2 built without deferred parameters")
    if not (torch.isfinite(losses).all() and torch.isfinite(warm).all()):
        fail("v2: non-finite loss")
    if not 0.0 < float(warm[0]) < 20.0:
        fail(f"v2: first loss {float(warm[0])} is not that of a fresh "
             "1000-class model")
    if any(v != 48 * K_STEPS for v in warm_launches.values()):
        fail(f"v2: the first (eager) call should launch every kernel "
             f"{48 * K_STEPS} times: {warm_launches}")
    if any(wrapper.values()) or len(trainer._graphs) != 1:
        fail(f"v2: the timed call was not one graph replay: {wrapper}")
    return trainer, data, label


# the plain BatchNorms of the v2 step (R, C): the input BN (C 3, which v1
# does not have), the stem BN after the 7x7 convolution, the final BN
V2_PLAIN_BN = {"input": (B * IMG * IMG, 3),
               "stem": (B * (IMG // 2) ** 2, 64),
               "final": (B * (IMG // 32) ** 2, 2048)}


def v2_plain_bn_sites(torch, mt):
    """Device ms of the plain (composed) training BatchNorm, forward and
    backward, at each of the v2 step's three plain sites, bf16, channel
    last, as the step runs it (``ops.nn.batch_norm``)."""
    from mxnet_tpu_torch.ops import nn as ops
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    out = {}
    for site, (r, c) in V2_PLAIN_BN.items():
        x = torch.randn((r, c), generator=gen, device="cuda") \
            .to(torch.bfloat16).requires_grad_(True)
        g = torch.ones(c, device="cuda", requires_grad=True)
        b = torch.zeros(c, device="cuda", requires_grad=True)
        dy = torch.randn((r, c), generator=gen, device="cuda") \
            .to(torch.bfloat16)
        stats = torch.zeros(c, device="cuda"), torch.ones(c, device="cuda")

        def fwd():
            return ops.batch_norm(x, g, b, *stats, eps=1e-5, fix_gamma=False,
                                  axis=-1, _training=True)[0]

        def fwd_bwd():
            torch.autograd.grad(fwd(), (x, g, b), dy)

        f_ms = time_ms(torch, fwd, flush)
        fb_ms = time_ms(torch, fwd_bwd, flush)
        out[site] = {"R": r, "C": c, "forward_ms": f_ms,
                     "forward_backward_ms": fb_ms}
        del x, dy
    row = {"phase": "v2_plain_batchnorm", "sites": out,
           "sum_forward_backward_ms": sum(v["forward_backward_ms"]
                                          for v in out.values()),
           "what": "plain training BatchNorm (ops.nn.batch_norm), bf16, "
                   "channel last, L2 dirtied before each launch"}
    emit(row)
    torch.cuda.empty_cache()
    return row

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
    if bad or len(ops) < 200:
        fail(f"mx.nd ops disagree between card and host: {row}")
    nd_fused_ops(torch, mt, np)


def nd_fused_ops(torch, mt, np):
    """``mx.nd._contrib_fused_bn_relu`` / ``_contrib_fused_bn_add_relu``
    under ``autograd.record()`` (so ``_training`` comes from autograd),
    card against host: (out, mean, var) and the gradients of data,
    residual, gamma and beta, f32; each kernel launched once per op on
    the card, never on the host."""
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    rs = np.random.RandomState(12)
    c = 64
    x = (rs.randn(4, 14, 14, c) * 2 + 1).astype(np.float32)
    res = rs.randn(4, 14, 14, c).astype(np.float32)
    g = (rs.rand(c) + 0.5).astype(np.float32)
    b = rs.randn(c).astype(np.float32)
    mm, mv = np.zeros(c, np.float32), np.ones(c, np.float32)
    cot = rs.randn(*x.shape).astype(np.float32)
    rows = []
    for name in ("_contrib_fused_bn_relu", "_contrib_fused_bn_add_relu"):
        ins = [x] + ([res] if "add" in name else []) + [g, b, mm, mv]
        diff = range(len(ins) - 2)

        def run(ctx):
            with ctx:
                arrs = [mt.nd.array(a) for a in ins]
                for i in diff:
                    arrs[i].attach_grad()
                with mt.autograd.record():
                    outs = getattr(mt.nd._internal, name)(*arrs)
                outs[0].backward(mt.nd.array(cot))
                return [o.asnumpy() for o in outs] + \
                    [arrs[i].grad.asnumpy() for i in diff]

        tk.reset_launches()
        host = run(mt.cpu())
        host_l = dict(tk.launches)
        tk.reset_launches()
        card = run(mt.gpu(0))
        torch.cuda.synchronize()
        card_l = dict(tk.launches)
        worst = max(float(np.abs(a - h).max()) for a, h in zip(card, host))
        ok = all(np.allclose(a, h, rtol=1e-4, atol=1e-4)
                 for a, h in zip(card, host))
        row = {"phase": "nd_fused_ops", "op": name, "shape": list(x.shape),
               "max_abs_err": worst, "ok": ok, "launches_card": card_l,
               "launches_host": host_l}
        emit(row)
        rows.append(row)
        if not ok or any(n != 1 for n in card_l.values()) \
                or any(host_l.values()):
            fail(f"mx.nd fused epilogue op, card against host: {row}")
    return rows


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



# ---------------------------------------------------------------------------
# the Gluon Trainer path: gluon.Trainer over mx.optimizer, f32
# ---------------------------------------------------------------------------

GT_BATCH, GT_STEPS = 32, 10        # examples/gluon/image_classification.py
GT_OPT = {"learning_rate": 0.05, "momentum": 0.9}
THIN18 = ([2, 2, 2, 2], [8, 8, 16, 32, 64])
THIN_SIZE, THIN_BATCH, THIN_STEPS = 48, 4, 3
# tests/test_optimizer_aggregation.py's six configurations, and its
# multi-precision one (bf16 weights)
TRAINER_OPTS = (
    ("sgd", {"learning_rate": 0.1, "wd": 0.01}, "float32"),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}, "float32"),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}, "float32"),
    ("adam", {"learning_rate": 0.01, "wd": 0.001}, "float32"),
    ("rmsprop", {"learning_rate": 0.01}, "float32"),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}, "float32"),
    ("sgd", {"learning_rate": 0.05, "momentum": 0.9,
             "multi_precision": True}, "bfloat16"),
)


def _state_tensors(trainer):
    """Every optimizer state tensor of a gluon.Trainer, in index order."""
    out = []
    for _, s in sorted(trainer._updaters[0].states.items()):
        stack = [s]
        while stack:
            x = stack.pop(0)
            if isinstance(x, (tuple, list)):
                stack = list(x) + stack
            elif x is not None:
                out.append(x.tensor)
    return out


def _close_of_max(torch, got, want, rel):
    """Worst |got - want| as a fraction of each tensor's largest value."""
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        worst = max(worst, float((a - b).abs().max())
                    / max(float(b.abs().max()), 1e-6))
    return worst, worst <= rel


def _bare_params(torch, mt, values, dtype, device):
    holder = mt.gluon.HybridBlock(prefix="", device=device)
    params = []
    for j, w in enumerate(values):
        p = holder._new_param(f"p{j}", w.shape, dtype=getattr(torch, dtype))
        p.set_data(w)
        params.append(p)
    return holder, params


def _opt_run(torch, mt, opt, kw, dtype, device, agg, seed=0):
    """Three Trainer steps of six bare parameters (shapes (3, j + 2), the
    aggregation test's) from numpy values; (weights, states, dispatches)."""
    import numpy as np
    os.environ["MXTPU_OPTIMIZER_AGGREGATION"] = str(agg)
    rs = np.random.RandomState(seed)
    shapes = [(3, j + 2) for j in range(6)]
    values = [rs.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rs.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(3)]
    _, params = _bare_params(torch, mt, values, dtype, device)
    tr = mt.gluon.Trainer(params, opt, dict(kw), kvstore=None)
    for step in range(3):
        for p, g in zip(params, grads[step]):
            p.grad()._data.copy_(torch.from_numpy(g))
            p._fresh_grad = True
        tr.step(4)
    return ([p.tensor.detach().clone() for p in params],
            [t.clone() for t in _state_tensors(tr)],
            tr.last_update_dispatches)


def _thin_run(torch, mt, weights, prefix, device, data, labels):
    """THIN_STEPS imperative steps of the thin ResNet-18 v1 NHWC:
    record(), forward, loss, backward(), Trainer.step; (losses, params,
    states)."""
    from mxnet_tpu_torch.convert import from_mxnet_tpu_params
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        BasicBlockV1, ResNetV1)
    net = ResNetV1(BasicBlockV1, *THIN18, classes=10, layout="NHWC",
                   device=device)
    from_mxnet_tpu_params(net, weights, prefix=prefix)
    tr = mt.gluon.Trainer(net.collect_params(), "sgd", dict(GT_OPT),
                          kvstore="device")
    lossfn = gloss.SoftmaxCrossEntropyLoss()
    losses = []
    for x, y in zip(data, labels):
        xd = mt.nd.from_torch(x.to(device))
        yd = mt.nd.from_torch(y.to(device))
        with mt.autograd.record():
            loss = lossfn(net(xd), yd)
        loss.backward()
        tr.step(THIN_BATCH)
        losses.append(loss.tensor.detach().cpu())
    params = [p.tensor.detach().clone() for p in
              net.collect_params().values()]
    return torch.stack(losses), params, _state_tensors(tr)


def trainer_reference(torch, mt):
    """gluon.Trainer card against host: the thin ResNet-18 v1 NHWC for
    THIN_STEPS steps from one set of weights and batches (losses, every
    weight, running statistic and momentum within 1e-3 of each tensor's
    largest value; one launch of each BN kernel per fused site and step on
    the card, none on the host); then the seven TRAINER_OPTS on bare
    parameters: card against host (weights and state within 1e-5 of each
    tensor's largest value, bf16 weights within one bf16 ulp of it) and,
    on the card, aggregation 4 against 0 bit for bit with 2 update calls
    against 6."""
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        BasicBlockV1, ResNetV1)
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    agg_before = os.environ.get("MXTPU_OPTIMIZER_AGGREGATION")
    src = ResNetV1(BasicBlockV1, *THIN18, classes=10, layout="NHWC",
                   device="cpu")
    src.initialize(mt.init.Xavier(), generator=torch.Generator()
                   .manual_seed(5))
    weights = {k: p.data().asnumpy()
               for k, p in src.collect_params().items()}
    gen = torch.Generator().manual_seed(6)
    data = [torch.rand((THIN_BATCH, THIN_SIZE, THIN_SIZE, 3), generator=gen)
            for _ in range(THIN_STEPS)]
    labels = [torch.randint(0, 10, (THIN_BATCH,), generator=gen).float()
              for _ in range(THIN_STEPS)]
    tk.reset_launches()
    host = _thin_run(torch, mt, weights, src.prefix, "cpu", data, labels)
    host_launches = dict(tk.launches)
    tk.reset_launches()
    card = _thin_run(torch, mt, weights, src.prefix, "cuda", data, labels)
    torch.cuda.synchronize()
    card_launches = dict(tk.launches)
    loss_ok = torch.allclose(card[0], host[0], rtol=1e-4, atol=1e-5)
    worst_p, ok_p = _close_of_max(torch, card[1], host[1], 1e-3)
    worst_s, ok_s = _close_of_max(torch, card[2], host[2], 1e-3)
    sites = 16 * THIN_STEPS
    row = {"phase": "trainer_reference",
           "model": "thin ResNet-18 v1 NHWC [2,2,2,2] [8,8,16,32,64], "
                    f"{THIN_SIZE}x{THIN_SIZE} batch {THIN_BATCH}, f32, "
                    "TF32 off, gluon.Trainer sgd lr 0.05 momentum 0.9",
           "losses_card": card[0].tolist(), "losses_host": host[0].tolist(),
           "worst_param_err_of_max": worst_p,
           "worst_state_err_of_max": worst_s,
           "card_launches": card_launches, "host_launches": host_launches}
    emit(row)
    if not (loss_ok and ok_p and ok_s):
        fail(f"gluon.Trainer: card and host disagree: {row}")
    if any(v != sites for v in card_launches.values()) or \
            any(host_launches.values()):
        fail(f"the thin ResNet-18 did not launch each kernel {sites} times "
             f"on the card and none on the host: {row}")
    bad = []
    for opt, kw, dtype in TRAINER_OPTS:
        w4, s4, n4 = _opt_run(torch, mt, opt, kw, dtype, "cuda", 4)
        w0, s0, n0 = _opt_run(torch, mt, opt, kw, dtype, "cuda", 0)
        wh, sh, _ = _opt_run(torch, mt, opt, kw, dtype, "cpu", 4)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(w4 + s4, w0 + s0))
        worst_w, ok_w = _close_of_max(
            torch, w4, wh, 2.0 ** -7 if dtype == "bfloat16" else 1e-5)
        worst_st, ok_st = _close_of_max(torch, s4, sh, 1e-5)
        r = {"phase": "trainer_reference", "optimizer": opt,
             "params": sorted(kw), "dtype": dtype,
             "agg4_equals_agg0": same, "dispatches_agg4": n4,
             "dispatches_agg0": n0, "worst_weight_err_of_max": worst_w,
             "worst_state_err_of_max": worst_st,
             "states": len(s4)}
        emit(r)
        if not (same and ok_w and ok_st and n4 == 2 and n0 == 6
                and len(s4) == len(sh)):
            bad.append(r)
    if agg_before is None:
        os.environ.pop("MXTPU_OPTIMIZER_AGGREGATION", None)
    else:
        os.environ["MXTPU_OPTIMIZER_AGGREGATION"] = agg_before
    if bad:
        fail(f"gluon.Trainer configurations failed on the card: {bad}")


# every dense optimizer op: input kinds and parameters
OPT_OP_CASES = {
    "sgd_update": (("w", "g"), dict(lr=0.1, wd=0.01)),
    "sgd_mom_update": (("w", "g", "m"), dict(lr=0.1, momentum=0.9, wd=0.01)),
    "mp_sgd_update": (("w", "g", "w32"), dict(lr=0.1, wd=0.01)),
    "mp_sgd_mom_update": (("w", "g", "m", "w32"),
                          dict(lr=0.1, momentum=0.9, wd=0.01)),
    "nag_mom_update": (("w", "g", "m"), dict(lr=0.1, momentum=0.9, wd=0.01)),
    "adam_update": (("w", "g", "m", "pos"),
                    dict(lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6,
                         wd=0.01)),
    "signsgd_update": (("w", "g"), dict(lr=0.1, wd=0.01)),
    "signum_update": (("w", "g", "m"),
                      dict(lr=0.1, momentum=0.9, wd=0.01, wd_lh=0.02)),
    "rmsprop_update": (("w", "g", "pos"),
                       dict(lr=0.01, gamma1=0.9, epsilon=1e-6, wd=0.01,
                            clip_weights=0.9)),
    "rmspropalex_update": (("w", "g", "pos", "small", "m"),
                           dict(lr=0.01, gamma1=0.9, gamma2=0.8,
                                epsilon=1e-6, wd=0.01)),
    "ftrl_update": (("w", "g", "m", "pos"),
                    dict(lr=0.1, lamda1=0.05, beta=1.5, wd=0.01)),
    "ftml_update": (("w", "g", "pos", "pos", "m"),
                    dict(lr=0.05, beta1=0.6, beta2=0.99, epsilon=1e-6, t=3,
                         wd=0.01, clip_grad=0.8)),
    "_adamw_update": (("w", "g", "m", "pos", "scale"),
                      dict(lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6,
                           wd=0.01, eta=0.7)),
    "_mp_adamw_update": (("w", "g", "m", "pos", "w32", "scale"),
                         dict(lr=0.01, beta1=0.8, beta2=0.99, epsilon=1e-6,
                              wd=0.01, eta=0.7)),
    "_contrib_group_adagrad_update": (("w", "g", "rows"),
                                      dict(lr=0.1, epsilon=1e-5)),
    "multi_sgd_update": (("w", "g"), {}),
    "multi_sgd_mom_update": (("w", "g", "m"), dict(momentum=0.9)),
    "multi_mp_sgd_update": (("w", "g", "w32"), {}),
    "multi_mp_sgd_mom_update": (("w", "g", "m", "w32"), dict(momentum=0.9)),
    "multi_adam_update": (("w", "g", "m", "pos"),
                          dict(beta1=0.8, beta2=0.99, epsilon=1e-6)),
    "multi_nag_mom_update": (("w", "g", "m"), dict(momentum=0.9)),
    "multi_rmsprop_update": (("w", "g", "pos"),
                             dict(gamma1=0.9, epsilon=1e-6,
                                  clip_weights=0.9)),
}
OPT_OP_SHAPES = ((512, 257), (1000,), (64, 3, 3, 32))


def _op_inputs(np, kinds, shapes, rs):
    arrays = []
    for shape in shapes:
        w = None
        for k in kinds:
            if k == "w32":
                arrays.append(w.copy())
            elif k == "rows":
                arrays.append(rs.rand(shape[0]).astype(np.float32) + 0.5)
            elif k == "pos":
                arrays.append(rs.rand(*shape).astype(np.float32) + 0.5)
            elif k == "small":
                arrays.append(0.1 * rs.randn(*shape).astype(np.float32))
            elif k == "scale":
                arrays.append(np.array([0.5], np.float32))
            else:
                a = rs.randn(*shape).astype(np.float32)
                w = a if k == "w" else w
                arrays.append(a)
    return arrays


def optimizer_ops_phase(torch, mt):
    """Every dense optimizer op of the registry (22; the sparse AdaGrad
    raises), card against host on the same numpy inputs, with gradient
    clipping, f32: each element of the card's result no further from the
    op evaluated in float64 on the host than the host's f32 result is,
    plus 1e-6 absolute and 1e-6 relative (Ftrl's z cancels: one rounding
    apart in a term moves it by 4e-6 at values of 1e-2, on either
    device). The one-tensor ops at (512, 257), the multi-tensor ops over
    three shapes."""
    import numpy as np
    from mxnet_tpu_torch.ops import registry as reg
    bad, worst, n_out = [], 0.0, 0
    for name, (kinds, params) in OPT_OP_CASES.items():
        rs = np.random.RandomState(len(name))
        params = dict(params)
        if name.startswith("multi_"):
            shapes = OPT_OP_SHAPES
            params.update(lrs=(0.1, 0.05, 0.2), wds=(0.01, 0.0, 0.02),
                          num_weights=3)
        else:
            shapes = OPT_OP_SHAPES[:1]
            params.setdefault("lr", 0.1)
        if name != "ftml_update" and "adamw" not in name:
            params.update(rescale_grad=0.5, clip_gradient=0.8)
        elif "adamw" in name:
            params["clip_gradient"] = 0.8
        else:
            params["rescale_grad"] = 0.5
        arrays = _op_inputs(np, kinds, shapes, rs)
        fn = reg.get_op(name).fn
        outs = {}
        for dev, dt in (("cpu", torch.float32), ("cuda", torch.float32),
                        ("f64", torch.float64)):
            o = fn(*[torch.from_numpy(a).to("cpu" if dev == "f64" else dev,
                                            dt) for a in arrays], **params)
            outs[dev] = o if isinstance(o, tuple) else (o,)
        torch.cuda.synchronize()
        err, ok = 0.0, True
        for a, b, ref in zip(outs["cuda"], outs["cpu"], outs["f64"]):
            a, b = a.double().cpu(), b.double()
            err = max(err, float((a - b).abs().max()))
            ok = ok and bool(((a - ref).abs() <= (b - ref).abs() + 1e-6
                              + 1e-6 * ref.abs()).all())
            n_out += 1
        worst = max(worst, err)
        if not ok:
            bad.append((name, err))
    row = {"phase": "optimizer_ops", "ops": len(OPT_OP_CASES),
           "outputs": n_out, "max_abs_err": worst, "ok": not bad,
           "tolerance": "|card - f64| <= |host - f64| + 1e-6 + 1e-6 |f64|"}
    emit(row)
    if bad:
        fail(f"optimizer ops: card and host disagree: {bad}")


def kernel_f32_phase(torch, tk):
    """Each BN kernel against its plain version in f32 at the Gluon path's
    (R, C) sites (ResNet-50 v1 at batch GT_BATCH): bn_bwd_apply bit for
    bit, bn_apply within one f32 ulp, the reductions within 1e-5 of the
    sum of magnitudes; kernel, plain and library ms and the bound, summed
    over the 48 sites of one step."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    tot = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   max_abs_err=0.0, bound_by=set()) for n in KERNELS}
    bad = []
    for r, c, has_res, mult in path_sites(GT_BATCH):
        cs = make_case(torch, tk, r, c, has_res, torch.float32, gen)
        for name, (kern, plain, lib) in calls(torch, tk, cs).items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err, ok = max_err(torch, tk, name, cs, got, want)
            row = {"phase": "kernel_f32", "kernel": name, "R": r, "C": c,
                   "residual": has_res, "dtype": "float32",
                   "max_abs_err": err, "ok": ok,
                   "ms": time_ms(torch, kern, flush),
                   "plain_ms": time_ms(torch, plain, flush),
                   "library_ms": time_ms(torch, lib, flush),
                   "sites_per_step": mult}
            row["bound_ms"], row["bound_by"] = bound_ms(name, r, c, 4,
                                                        has_res)
            row["bound_share"] = row["bound_ms"] / row["ms"]
            emit(row)
            if not ok:
                bad.append(row)
            t = tot[name]
            t["max_abs_err"] = max(t["max_abs_err"], err)
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                t[key] += mult * row[key]
            t["bound_by"].add(row["bound_by"])
        del cs
    torch.cuda.empty_cache()
    if bad:
        fail(f"f32 kernel disagrees with its plain version: {bad}")
    return tot


def _host_top(torch, prof, n=12):
    """The host's costliest ops of a profiled run: [self ms, calls,
    name], by self time on the CPU."""
    from torch.autograd import DeviceType
    rows = [(e.self_cpu_time_total / 1e3, e.count, e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CPU]
    return [[round(ms, 3), c, k[:60]] for ms, c, k in sorted(rows,
                                                              reverse=True)[:n]]


def _profile_update(torch, trainer, params, agg):
    """One trainer.step (the same gradients again) under torch.profiler
    at aggregation ``agg``: device kernels, device ms and wall ms."""
    os.environ["MXTPU_OPTIMIZER_AGGREGATION"] = str(agg)

    def step():
        for p in params:
            p._fresh_grad = True
        trainer.step(GT_BATCH)

    prof, wall = _profiled(torch, step)
    kernels = _device_kernels(prof)
    return {"aggregation": agg, "host_top_ops": _host_top(torch, prof, 6),
            "update_calls": trainer.last_update_dispatches,
            "device_kernels": sum(n for _, n in kernels.values()),
            "device_ms": sum(ms for ms, _ in kernels.values()),
            "wall_ms": wall}


def gluon_train(torch, mt, card):
    """The Gluon path at full width, as examples/gluon/image_classification
    .py runs it: get_model("resnet50_v1", layout="NHWC"),
    initialize(Xavier), hybridize(), gluon.Trainer(sgd, lr 0.05, momentum
    0.9, kvstore="device"), batch 32 of 224x224 in f32 (TF32 off),
    MXTPU_OPTIMIZER_AGGREGATION 4. One untimed step, then GT_STEPS timed
    (counts zeroed just before, read just after: 48 launches of each BN
    kernel a step); host and device ms of forward, backward and
    trainer.step (CUDA events; a device span includes the time the card
    waited for the host); one profiled step for the device's idle share
    and the residual bn_apply launches (16); one profiled trainer.step at
    aggregation 4 and at 0."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    agg_before = os.environ.get("MXTPU_OPTIMIZER_AGGREGATION")
    os.environ["MXTPU_OPTIMIZER_AGGREGATION"] = "4"
    t0 = time.perf_counter()
    net = get_model("resnet50_v1", layout="NHWC")
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
    net.hybridize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", dict(GT_OPT),
                               kvstore="device")
    lossfn = gloss.SoftmaxCrossEntropyLoss()
    gen = mt.random.seed(1)
    batches = [(mt.nd.from_torch(torch.rand(
                    (GT_BATCH, IMG, IMG, 3), generator=gen, device="cuda")),
                mt.nd.from_torch(torch.randint(
                    0, 1000, (GT_BATCH,), generator=gen,
                    device="cuda").float())) for _ in range(2)]
    live = [p for p in net.collect_params().values()
            if p.grad_req != "null"]
    marks = {}

    def mark(key):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        marks.setdefault(key, []).append((time.perf_counter(), e))

    def step(i, timed=False):
        x, y = batches[i % 2]
        if timed:
            mark("start")
        with mt.autograd.record():
            loss = lossfn(net(x), y)
        if timed:
            mark("forward")
        loss.backward()
        if timed:
            mark("backward")
        trainer.step(GT_BATCH)
        if timed:
            mark("step")
        return loss

    first = step(0).tensor.detach().clone()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gib = 2.0 ** 30
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    t1 = time.perf_counter()
    losses = [step(i + 1, timed=True) for i in range(GT_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launches = dict(tk.launches)
    peak = torch.cuda.max_memory_allocated() / gib
    losses = torch.stack([l.tensor.detach().mean() for l in losses]).cpu()
    split = {}
    order = ("start", "forward", "backward", "step")
    for a, b in zip(order, order[1:]):
        host = [hb - ha for (ha, _), (hb, _) in zip(marks[a], marks[b])]
        dev = [ea.elapsed_time(eb) for (_, ea), (_, eb)
               in zip(marks[a], marks[b])]
        split[b] = {"host_ms": 1e3 * sum(host) / len(host),
                    "device_ms": sum(dev) / len(dev)}
    prof, wall = _profiled(torch, lambda: step(0))
    summary = _summary(f"resnet50_v1 NHWC: one gluon.Trainer step, batch "
                       f"{GT_BATCH}, f32", _device_kernels(prof), wall, {})
    summary["host_top_ops"] = _host_top(torch, prof)
    emit(summary)
    updates = [_profile_update(torch, trainer, live, agg) for agg in (4, 0)]
    for u in updates:
        emit({"phase": "gluon_update", **u})
    if agg_before is None:
        os.environ.pop("MXTPU_OPTIMIZER_AGGREGATION", None)
    else:
        os.environ["MXTPU_OPTIMIZER_AGGREGATION"] = agg_before
    row = {"phase": "gluon_train", "model": 'get_model("resnet50_v1", '
           'layout="NHWC")', "batch": GT_BATCH, "image": IMG,
           "steps": GT_STEPS, "dtype": "float32, TF32 off",
           "optimizer": "gluon.Trainer sgd lr 0.05 momentum 0.9, "
                        "kvstore device, aggregation 4",
           "parameters": len(live),
           "first_loss": float(first.mean()), "losses": losses.tolist(),
           "step_ms": 1e3 * dt / GT_STEPS, "img_per_s": GT_BATCH
           * GT_STEPS / dt, "split": split,
           "device_idle_share": summary["device_idle_share"],
           "peak_allocated_gib": peak,
           "launches": launches,
           "launches_per_step": {k: v / GT_STEPS
                                 for k, v in launches.items()},
           "bn_apply_residual_per_step":
               summary["bn_apply_with_residual_launches"],
           "update_calls_per_step": updates[0]["update_calls"],
           "setup_and_first_step_s": setup_s, "card": card}
    emit(row)
    if not (torch.isfinite(losses).all() and 0.0 < row["first_loss"] < 20.0):
        fail(f"gluon_train: bad loss {row['first_loss']} {losses.tolist()}")
    if any(v != 48 * GT_STEPS for v in launches.values()):
        fail(f"gluon_train: expected {48 * GT_STEPS} launches of each BN "
             f"kernel over {GT_STEPS} steps: {launches}")
    if row["bn_apply_residual_per_step"] != 16 or any(
            n != 48 for n in summary["epilogue_device_launches"].values()):
        fail(f"gluon_train: the profiled step's BN launches: {summary}")
    if not updates[0]["update_calls"] < updates[1]["update_calls"] or \
            not updates[0]["device_kernels"] < updates[1]["device_kernels"]:
        fail(f"gluon_train: aggregation 4 should take fewer calls and "
             f"kernels than 0: {updates}")
    return launches, row


# ---------------------------------------------------------------------------
# the FitLoop path: fit, fault, io staging, chaos, telemetry
# ---------------------------------------------------------------------------

FIT_IMAGES, FIT_EPOCHS, FIT_CKPT_EVERY, FIT_KILL = 256, 2, 4, 10
FIT_STEPS = FIT_EPOCHS * FIT_IMAGES // 32
FIT_REF_OPT = {"learning_rate": 0.05, "momentum": 0.9}


def _mse(p, y):
    return ((p - y) ** 2).mean()


def _fit_state(torch, net, trainer):
    """Every parameter (running statistics included) by structural name and
    every optimizer state tensor, cloned."""
    out = {f"param:{k}": p.tensor.detach().clone()
           for k, p in net._collect_params_with_prefix().items()}
    for j, t in enumerate(_state_tensors(trainer)):
        out[f"state:{j}"] = t.detach().clone()
    return out


def _not_bitwise(torch, got, want):
    """Names of the tensors of ``want`` that ``got`` does not equal bit for
    bit (a missing name counts)."""
    return sorted(k for k in want
                  if k not in got or not torch.equal(got[k], want[k]))


def _await_ckpt(d, step, timeout=300.0):
    """A killed run's writer thread may still be finishing ckpt-<step>."""
    t = time.time()
    while not os.path.exists(os.path.join(d, f"ckpt-{step}", "DONE")):
        if time.time() - t > timeout:
            fail(f"checkpoint {step} in {d} never completed")
        time.sleep(0.01)


def _mlp_loop(mt, ctx, ckpt_dir, **kw):
    """tests/test_chaos.py's _build scenario on ``ctx``: Dense(8, relu),
    Dense(1) from numpy weights (seed 0), SGD momentum 0.9 lr 0.05, batch 8
    of 64 samples (seed 42) shuffled with seed 13, staged onto ``ctx``."""
    import numpy as np
    rs = np.random.RandomState(42)
    X = rs.randn(64, 4).astype(np.float32)
    w = rs.randn(4, 1).astype(np.float32)
    Y = X @ w + 0.01 * rs.randn(64, 1).astype(np.float32)
    init = np.random.RandomState(0)
    with ctx:
        net = mt.gluon.nn.HybridSequential()
        net.add(mt.gluon.nn.Dense(8, in_units=4, activation="relu"),
                mt.gluon.nn.Dense(1, in_units=8))
        for _, p in sorted(net._collect_params_with_prefix().items()):
            p.set_data(0.5 * init.randn(*p.shape).astype(np.float32))
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(FIT_REF_OPT), kvstore=None)
        itr = mt.io.DeviceStagingIter(mt.io.NDArrayIter(
            X, Y, batch_size=8, shuffle=True, seed=13))
        loop = mt.fit.FitLoop(net, trainer, _mse, itr, ckpt_dir=ckpt_dir,
                              heartbeat=False, **kw)
    return net, trainer, loop


def _mlp_fit(torch, mt, ctx, ckpt_dir, epochs, plan=None, **kw):
    """One run of the MLP scenario: (result or None if killed, state)."""
    from mxnet_tpu_torch.contrib import chaos
    net, trainer, loop = _mlp_loop(mt, ctx, ckpt_dir, **kw)
    if plan:
        chaos.install(plan)
    res = None
    try:
        with ctx:
            res = loop.fit(epochs=epochs)
    except chaos.ChaosKilled:
        pass
    finally:
        chaos.uninstall()
    return res, _fit_state(torch, net, trainer)


def fit_reference(torch, mt, tmp):
    """The FitLoop scenarios of tests/test_chaos.py on the MLP, f32, TF32
    off, staged through DeviceStagingIter, asynchronous checkpoints: the
    fault-free run card against host (losses and every weight and momentum
    within 1e-4 of each tensor's largest value); then on the card, bit for
    bit: kill@10 and resume against the fault-free run (losses, weights,
    momenta), a nan_grad step skipped (weights and momenta equal to those
    before the step, the loss scale backed off), a corrupted latest
    checkpoint quarantined with the fallback's replay equal to the
    fault-free run."""
    host, card = mt.cpu(), mt.gpu(0)
    d = lambda name: os.path.join(tmp, name)  # noqa: E731
    rh, sh = _mlp_fit(torch, mt, host, d("ff_host"), 2, ckpt_every=2)
    rc, sc = _mlp_fit(torch, mt, card, d("ff_card"), 2, ckpt_every=2)
    loss_err, loss_ok = _close_of_max(
        torch, [torch.tensor(rc.losses)], [torch.tensor(rh.losses)], 1e-4)
    state_err, state_ok = _close_of_max(
        torch, [sc[k] for k in sh], [sh[k] for k in sh], 1e-4)
    # kill@10, relaunch with fresh objects: resumes from ckpt-10
    killed, _ = _mlp_fit(torch, mt, card, d("kill"), 2, plan="kill@10",
                         ckpt_every=2)
    _await_ckpt(d("kill"), 10)
    rk, sk = _mlp_fit(torch, mt, card, d("kill"), 2, ckpt_every=2)
    kill_bad = _not_bitwise(torch, sk, sc)
    # nan_grad@3: the state after the skipped step is the state before it
    _, before = _mlp_fit(torch, mt, card, None, 1, plan="kill@3")
    _, after = _mlp_fit(torch, mt, card, None, 1, plan="nan_grad@3,kill@4")
    rn, _ = _mlp_fit(torch, mt, card, None, 1, plan="nan_grad@3",
                     loss_scale=2.0)
    nan_bad = _not_bitwise(torch, after, before)
    # ckpt_corrupt@8: quarantined, the relaunch falls back to ckpt-4
    r1, s1 = _mlp_fit(torch, mt, card, d("ff1"), 1, ckpt_every=4)
    _mlp_fit(torch, mt, card, d("corrupt"), 1, plan="ckpt_corrupt@8",
             ckpt_every=4)
    rf, sf = _mlp_fit(torch, mt, card, d("corrupt"), 1, ckpt_every=4)
    corrupt_bad = _not_bitwise(torch, sf, s1)
    row = {"phase": "fit_reference",
           "model": "MLP 4 -> 8 (ReLU) -> 1, batch 8 of 64, SGD momentum "
                    "0.9, f32, TF32 off, DeviceStagingIter, async ckpt",
           "card_vs_host": {"loss_err_of_max": loss_err,
                            "state_err_of_max": state_err,
                            "losses_card": rc.losses,
                            "losses_host": rh.losses},
           "kill_resume": {"killed": killed is None,
                           "resumed_from": rk.resumed_from,
                           "losses_bitwise": rk.losses == rc.losses[10:],
                           "state_not_bitwise": kill_bad},
           "nan_skip": {"skipped_steps": rn.skipped_steps,
                        "loss_scale": rn.loss_scale,
                        "state_not_bitwise": nan_bad},
           "corrupt_fallback": {
               "resumed_from": rf.resumed_from,
               "quarantined": os.path.isdir(os.path.join(d("corrupt"),
                                                         "ckpt-8.bad")),
               "losses_bitwise": rf.losses == r1.losses[4:],
               "state_not_bitwise": corrupt_bad}}
    emit(row)
    if not (loss_ok and state_ok):
        fail(f"fit_reference: card and host disagree: {row}")
    if killed is not None or rk.resumed_from != 10 or \
            row["kill_resume"]["losses_bitwise"] is not True or kill_bad:
        fail(f"fit_reference: kill@10 + resume is not the fault-free run "
             f"bit for bit: {row}")
    if rn.skipped_steps != [3] or not rn.loss_scale < 2.0 or nan_bad:
        fail(f"fit_reference: the nan_grad step was not a no-op: {row}")
    if rf.resumed_from != 4 or not row["corrupt_fallback"]["quarantined"] \
            or row["corrupt_fallback"]["losses_bitwise"] is not True or \
            corrupt_bad:
        fail(f"fit_reference: corrupt checkpoint fallback failed: {row}")


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _shares(records):
    """Wall-clock shares of each segment over some per-step records."""
    wall = sum(r["wall"] for r in records)
    segs = {k for r in records for k in r if k != "wall"}
    return {k: sum(r.get(k, 0.0) for r in records) / wall
            for k in sorted(segs)}


def fit_train(torch, mt, card, gluon_row, tmp):
    """The FitLoop path at full width, as examples/gluon/resilient_fit.py
    uses it: get_model("resnet50_v1", layout="NHWC"), initialize(Xavier)
    from seed 0, gluon.Trainer(sgd, lr 0.05, momentum 0.9, kvstore
    "device"), aggregation 4, f32 with TF32 off and deterministic cuDNN;
    DeviceStagingIter(NDArrayIter(FIT_IMAGES random images and labels from
    seed 1, batch 32, shuffled with seed 13)); FitLoop(ckpt_every 4,
    async_ckpt) for 2 epochs (16 steps). Then the same run killed at step
    10 (chaos kill@10) and relaunched with fresh objects: it restores
    ckpt-8 and replays steps 8-15, and its losses, weights, momenta and
    running statistics must equal the fault-free run's bit for bit. The
    BN kernels launch 48 times a step (wrapper counts, zeroed just before
    each fit and read just after). Reported: step ms (FitLoop against the
    bare record / backward / trainer.step loop on the same net, with and
    without the loss fetched to the host each step, and gluon_train's;
    one epoch each of the loop without checkpoints, without staging and
    without the sentinel, and one profiled epoch for the card's idle
    share), the breakdown's shares, the checkpoint's save() (loop
    thread) and write (writer thread: files, SHA-256, rename) ms and
    bytes, restore_latest ms with verify, and the memory ledger by
    category against torch.cuda.memory_allocated() after step 5."""
    import gc
    import numpy as np
    from mxnet_tpu_torch.contrib import chaos
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    from mxnet_tpu_torch.telemetry import memory as tmem
    agg_before = os.environ.get("MXTPU_OPTIMIZER_AGGREGATION")
    os.environ["MXTPU_OPTIMIZER_AGGREGATION"] = "4"
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    X = rng.random((FIT_IMAGES, IMG, IMG, 3), dtype=np.float32)
    Y = rng.integers(0, 1000, FIT_IMAGES).astype(np.float32)
    data_s = time.perf_counter() - t0
    lossfn = gloss.SoftmaxCrossEntropyLoss()
    mid = {}

    def at_step_end(step, loss):
        if step == 5:
            torch.cuda.synchronize()
            mid.update(ledger=tmem.ledger().snapshot(),
                       reconcile=tmem.reconcile(),
                       allocated=torch.cuda.memory_allocated())

    def build(d, on_step_end=None):
        net = get_model("resnet50_v1", layout="NHWC")
        net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(GT_OPT), kvstore="device")
        itr = mt.io.DeviceStagingIter(mt.io.NDArrayIter(
            X, Y, batch_size=GT_BATCH, shuffle=True, seed=13))
        loop = mt.fit.FitLoop(net, trainer, lossfn, itr, ckpt_dir=d,
                              ckpt_every=FIT_CKPT_EVERY, async_ckpt=True,
                              on_step_end=on_step_end)
        return net, trainer, loop

    def run(loop, plan=None):
        if plan:
            chaos.install(plan)
        tk.reset_launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        try:
            res = loop.fit(epochs=FIT_EPOCHS)
        except chaos.ChaosKilled:
            res = None
        finally:
            chaos.uninstall()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t, dict(tk.launches)

    dir_a, dir_b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
    base = tmem.ledger().snapshot()
    net, trainer, loop = build(dir_a, at_step_end)
    torch.cuda.reset_peak_memory_stats()
    res_a, wall_a, launches = run(loop)
    peak = torch.cuda.max_memory_allocated()
    state_a = _fit_state(torch, net, trainer)
    bd = res_a.step_breakdown
    walls = [r["wall"] for r in bd["per_step"]]
    steady = bd["per_step"][1:]
    saves = FIT_STEPS // FIT_CKPT_EVERY
    # the bare loop on the same net and batches, same call
    xb = [mt.nd.array(X[i * GT_BATCH:(i + 1) * GT_BATCH]) for i in (0, 1)]
    yb = [mt.nd.array(Y[i * GT_BATCH:(i + 1) * GT_BATCH]) for i in (0, 1)]

    def bare(i, sync):
        with mt.autograd.record():
            loss = lossfn(net(xb[i % 2]), yb[i % 2])
        loss.backward()
        trainer.step(GT_BATCH)
        if sync:                   # the loss to the host, as FitLoop does
            loss.mean().asscalar()

    bare_ms = {}
    for sync in (False, True):
        bare(0, sync)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i in range(GT_STEPS):
            bare(i + 1, sync)
        torch.cuda.synchronize()
        bare_ms[sync] = 1e3 * (time.perf_counter() - t) / GT_STEPS
    # where the FitLoop's extra time goes: one epoch of each variant on
    # the same net (medians and means of steps 1-7), and one profiled
    # epoch of the loop without checkpoints for the card's idle share
    def loop_for(staged=True, ckpt=None, **kw):
        src = mt.io.NDArrayIter(X, Y, batch_size=GT_BATCH, shuffle=True,
                                seed=13)
        return mt.fit.FitLoop(
            net, trainer, lossfn,
            mt.io.DeviceStagingIter(src) if staged else src, ckpt_dir=ckpt,
            ckpt_every=FIT_CKPT_EVERY, async_ckpt=True, **kw)

    def epoch_ms(loop):
        res = loop.fit(epochs=1, resume=False)
        torch.cuda.synchronize()
        w = [1e3 * r["wall"] for r in res.step_breakdown["per_step"][1:]]
        return {"median": float(np.median(w)), "mean": float(np.mean(w))}

    variants = {
        "fitloop": epoch_ms(loop_for(ckpt=os.path.join(tmp, "v"))),
        "no_checkpoints": epoch_ms(loop_for()),
        "no_checkpoints_unstaged": epoch_ms(loop_for(staged=False)),
        "no_checkpoints_no_sentinel": epoch_ms(
            loop_for(skip_nonfinite=False))}
    prof, prof_wall = _profiled(
        torch, lambda: loop_for().fit(epochs=1, resume=False))
    fit_profile = _summary("one FitLoop epoch (8 steps), no checkpoints",
                           _device_kernels(prof), prof_wall, {})
    fit_profile["host_top_ops"] = _host_top(torch, prof)
    emit(fit_profile)
    # the checkpoint alone: save() on this thread, the write on the
    # writer thread, twice; then restore_latest (verify included)
    ck = os.path.join(tmp, "w")
    cm = mt.fault.CheckpointManager(ck, async_write=True)
    save_ms, wait_ms = [], []
    for step in (1, 2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        cm.save(step, net=net, trainer=trainer)
        save_ms.append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        cm.wait()
        wait_ms.append(1e3 * (time.perf_counter() - t))
    ckpt_bytes = _dir_bytes(os.path.join(dir_a, "ckpt-16"))
    t = time.perf_counter()
    mt.fault.CheckpointManager(dir_a).verify(16)
    verify_ms = 1e3 * (time.perf_counter() - t)
    t = time.perf_counter()
    restored = mt.fault.CheckpointManager(dir_a).restore_latest(
        net=net, trainer=trainer)
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t)
    after_restore = _not_bitwise(torch, _fit_state(torch, net, trainer),
                                 state_a)
    del net, trainer, loop, xb, yb, restored
    gc.collect()
    # killed at step 10, relaunched with fresh objects
    net, trainer, loop = build(dir_b)
    killed, _, _ = run(loop, plan=f"kill@{FIT_KILL}")
    del net, trainer, loop
    gc.collect()
    resume_from = FIT_KILL // FIT_CKPT_EVERY * FIT_CKPT_EVERY
    _await_ckpt(dir_b, resume_from)
    net, trainer, loop = build(dir_b)
    res_b, wall_b, launches_b = run(loop)
    state_b = _fit_state(torch, net, trainer)
    kill_bad = _not_bitwise(torch, state_b, state_a)
    del net, trainer, loop, state_a, state_b
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = prev_det
    if agg_before is None:
        os.environ.pop("MXTPU_OPTIMIZER_AGGREGATION", None)
    else:
        os.environ["MXTPU_OPTIMIZER_AGGREGATION"] = agg_before
    gib = 2.0 ** 30
    row = {"phase": "fit_train",
           "model": 'get_model("resnet50_v1", layout="NHWC")',
           "batch": GT_BATCH, "image": IMG, "images": FIT_IMAGES,
           "epochs": FIT_EPOCHS, "steps": res_a.step,
           "dtype": "float32, TF32 off, deterministic cuDNN",
           "loop": "FitLoop(ckpt_every 4, async_ckpt) over DeviceStagingIter"
                   "(NDArrayIter(shuffle, seed 13)), gluon.Trainer sgd lr "
                   "0.05 momentum 0.9, kvstore device, aggregation 4",
           "data_s": data_s, "wall_s": wall_a,
           "step_ms_first": 1e3 * walls[0],
           "step_ms_median": 1e3 * float(np.median(walls[1:])),
           "step_ms_mean_after_first": 1e3 * float(np.mean(walls[1:])),
           "img_per_s_median": GT_BATCH / float(np.median(walls[1:])),
           "bare_loop_step_ms": bare_ms[False],
           "bare_loop_synced_step_ms": bare_ms[True],
           "gluon_train_step_ms": gluon_row["step_ms"],
           "variants_step_ms": variants,
           "device_idle_share_no_checkpoints":
               fit_profile["device_idle_share"],
           "shares": bd["shares"], "shares_after_first": _shares(steady),
           "accounted_frac": bd["accounted_frac"],
           "diagnoses": bd["diagnoses"][:3],
           "checkpoint": {
               "saves": saves,
               "save_ms_in_loop": 1e3 * bd["seconds"].get("checkpoint", 0.0)
               / saves,
               "save_ms": save_ms, "write_wait_ms": wait_ms,
               "write_ms_writer_thread": [1e3 * s for s in cm.write_seconds],
               "bytes": ckpt_bytes, "verify_ms": verify_ms,
               "restore_latest_ms": restore_ms,
               "restore_not_bitwise": after_restore},
           "memory": {"ledger_after_step_5": mid.get("ledger"),
                      "ledger_before_build": base,
                      "reconcile_after_step_5": mid.get("reconcile"),
                      "allocated_after_step_5": mid.get("allocated"),
                      "peak_allocated_gib": peak / gib,
                      "fit_result": {k: v for k, v in res_a.memory.items()
                                     if k != "per_step"}},
           "launches": launches,
           "launches_per_step": {k: v / res_a.step
                                 for k, v in launches.items()},
           "kill_resume": {"killed_at": FIT_KILL, "killed": killed is None,
                           "resumed_from": res_b.resumed_from,
                           "resumed_steps": len(res_b.losses),
                           "resume_wall_s": wall_b,
                           "launches": launches_b,
                           "losses_bitwise":
                               res_b.losses == res_a.losses[resume_from:],
                           "state_not_bitwise": kill_bad},
           "losses": res_a.losses, "card": card}
    emit(row)
    if not (np.all(np.isfinite(res_a.losses)) and
            0.0 < res_a.losses[0] < 20.0) or res_a.step != FIT_STEPS:
        fail(f"fit_train: bad run {res_a.losses}")
    if any(v != 48 * res_a.step for v in launches.values()) or \
            any(v != 48 * len(res_b.losses) for v in launches_b.values()):
        fail(f"fit_train: expected 48 launches of each BN kernel a step: "
             f"{launches} {launches_b}")
    if killed is not None or res_b.resumed_from != resume_from or \
            row["kill_resume"]["losses_bitwise"] is not True or kill_bad:
        fail(f"fit_train: the killed-then-resumed run is not the "
             f"fault-free run bit for bit: {row['kill_resume']}")
    if after_restore:
        fail(f"fit_train: restore_latest did not give back the final "
             f"state: {after_restore[:5]}")
    # the ledger is process-wide (host tensors of earlier phases too): hold
    # what this run added against the card's allocation
    if not mid or sum(mid["ledger"].values()) - sum(base.values()) > \
            mid["allocated"]:
        fail(f"fit_train: the memory ledger exceeds the allocator's count: "
             f"{row['memory']}")
    return launches, row


# the megastep's card-vs-host MLP: tests/test_zero.py's six OPTS
MEGA_OPTS = (
    ("sgd", {"learning_rate": 0.1, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01, "wd": 0.001}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
)
MEGA_SKIP, MEGA_SCALE = 5, 128.0


def _mega_mlp(torch, mt, ctx, opt, kw, mega, dropout=None, steps=4,
              repeat=False):
    """tests/test_megastep.py's MLP (Dense 16 ReLU, Dense 4, L2 loss,
    batch 4) from numpy weights (seed 0) and data (seed 0) on ``ctx``,
    ``steps`` FitLoop steps with the megastep on or off; ``dropout`` puts
    a Dropout between the layers, ``repeat`` feeds one batch every step.
    Returns (losses, every weight and optimizer state tensor)."""
    import numpy as np
    os.environ["MXTPU_MEGASTEP"] = "on" if mega else "off"
    rs = np.random.RandomState(0)
    X = rs.rand(4 if repeat else steps * 4, 16).astype(np.float32)
    Y = rs.rand(4 if repeat else steps * 4, 4).astype(np.float32)
    if repeat:
        X, Y = np.tile(X, (steps, 1)), np.tile(Y, (steps, 1))
    init = np.random.RandomState(0)
    with ctx:
        net = mt.gluon.nn.Sequential()
        net.add(mt.gluon.nn.Dense(16, in_units=16, activation="relu"))
        if dropout is not None:
            net.add(mt.gluon.nn.Dropout(dropout))
        net.add(mt.gluon.nn.Dense(4, in_units=16))
        for _, p in sorted(net._collect_params_with_prefix().items()):
            p.set_data(0.5 * init.randn(*p.shape).astype(np.float32))
        tr = mt.gluon.Trainer(net.collect_params(), opt, dict(kw))
        loop = mt.fit.FitLoop(net, tr, mt.gluon.loss.L2Loss(),
                              mt.io.NDArrayIter(X, Y, batch_size=4),
                              heartbeat=False)
        res = loop.fit(epochs=1)
    return res.losses, [p.tensor.detach().clone() for p in tr._params] + \
        [t.clone() for t in _state_tensors(tr)]


def megastep_train(torch, mt, card, fit_row, tmp):
    """MXTPU_MEGASTEP=on: FitLoop's whole step (forward, backward, the
    chaos poison site, the finiteness sentinel, the grouped update, the
    loss mean) as one CUDA graph replay per input signature, on
    fit_train's workload: get_model("resnet50_v1", layout="NHWC"),
    Xavier from seed 0, gluon.Trainer(sgd, lr 0.05, momentum 0.9, kvstore
    "device"), aggregation 4, f32, TF32 off, deterministic cuDNN,
    DeviceStagingIter(NDArrayIter(FIT_IMAGES images and labels from seed
    1, batch 32, shuffled with seed 13)), 2 epochs (16 steps). Two runs
    of each of the megastep and the composed path, from fresh objects:
    without checkpoints (losses, weights, momenta and running statistics
    bit for bit; the BN wrappers launch 48 times each, all in the eager
    first step (a capture records without counting, a replay calls no
    wrapper), the signature cache one miss), and with checkpoints every 4 steps, loss
    scale 128 and chaos nan_grad@5 (step 5 skipped inside the graph, the
    scale backed off, bit for bit). Then the megastep run killed at step
    10 and relaunched from ckpt-8, bit for bit the fault-free megastep
    run. Timed: the median step of each run without checkpoints and of
    the bare record / backward / trainer.step loop; one profiled epoch of
    each (the card's idle share; 48 device launches of each BN kernel a
    step in the megastep's replays); the capture's ms; peak allocation
    and memory_reserved() of each run. Then the small MLP for each of
    tests/test_zero.py's six optimizer configurations: the megastep on
    the card against the port on the host within 1e-4 of each tensor's
    largest value, and against the composed path on the card bit for
    bit; and a Dropout MLP whose replays draw new masks."""
    import gc
    import numpy as np
    from mxnet_tpu_torch import megastep as tms
    from mxnet_tpu_torch.contrib import chaos
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    saved = {k: os.environ.get(k) for k in ("MXTPU_OPTIMIZER_AGGREGATION",
                                           "MXTPU_MEGASTEP")}
    os.environ["MXTPU_OPTIMIZER_AGGREGATION"] = "4"
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    rng = np.random.default_rng(1)
    X = rng.random((FIT_IMAGES, IMG, IMG, 3), dtype=np.float32)
    Y = rng.integers(0, 1000, FIT_IMAGES).astype(np.float32)
    lossfn = gloss.SoftmaxCrossEntropyLoss()
    gib = 2.0 ** 30

    def build(d=None, **kw):
        net = get_model("resnet50_v1", layout="NHWC")
        net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(GT_OPT), kvstore="device")
        return net, trainer, loop_over(net, trainer, d, **kw)

    def loop_over(net, trainer, d=None, **kw):
        itr = mt.io.DeviceStagingIter(mt.io.NDArrayIter(
            X, Y, batch_size=GT_BATCH, shuffle=True, seed=13))
        return mt.fit.FitLoop(net, trainer, lossfn, itr, ckpt_dir=d,
                              ckpt_every=FIT_CKPT_EVERY, async_ckpt=True,
                              **kw)

    def run(loop, mega, plan=None, epochs=FIT_EPOCHS):
        os.environ["MXTPU_MEGASTEP"] = "on" if mega else "off"
        if plan:
            chaos.install(plan)
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tk.reset_launches()
        try:
            res = loop.fit(epochs=epochs)
        except chaos.ChaosKilled:
            res = None
        finally:
            chaos.uninstall()
        torch.cuda.synchronize()
        return res, {"peak_allocated_gib":
                     torch.cuda.max_memory_allocated() / gib,
                     "reserved_gib": torch.cuda.memory_reserved() / gib}

    def median_ms(res):
        return 1e3 * float(np.median([r["wall"] for r in
                                      res.step_breakdown["per_step"][1:]]))

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    # 1. without checkpoints: the composed path, then the megastep
    net, trainer, loop = build()
    res_c, mem_c = run(loop, False)
    state_c = _fit_state(torch, net, trainer)
    del net, trainer, loop
    release()
    net, trainer, loop = build(on_step_end=lambda s, l: per_step.append(
        dict(tk.launches)))
    per_step = []
    res_m, mem_m = run(loop, True)
    state_m = _fit_state(torch, net, trainer)
    launches_run = dict(tk.launches)
    info = tms.cache_info(net)
    capture_ms = net._mxtpu_megastep_cache.snapshot_items()[0][1] \
        .capture_ms
    parity_bad = _not_bitwise(torch, state_m, state_c)
    del state_m, state_c
    # the bare loop on the same net and batches, same call
    xb = [mt.nd.array(X[i * GT_BATCH:(i + 1) * GT_BATCH]) for i in (0, 1)]
    yb = [mt.nd.array(Y[i * GT_BATCH:(i + 1) * GT_BATCH]) for i in (0, 1)]

    def bare(i):
        with mt.autograd.record():
            loss = lossfn(net(xb[i % 2]), yb[i % 2])
        loss.backward()
        trainer.step(GT_BATCH)
        loss.mean().asscalar()     # the loss to the host, as FitLoop does

    bare(0)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for i in range(GT_STEPS):
        bare(i + 1)
    torch.cuda.synchronize()
    bare_ms = 1e3 * (time.perf_counter() - t) / GT_STEPS
    # one profiled epoch of each on the same net (the megastep's replays
    # reuse the captured graph: same net, same signature)
    profiles = {}
    for name, mega in (("megastep", True), ("composed", False)):
        os.environ["MXTPU_MEGASTEP"] = "on" if mega else "off"
        prof, wall = _profiled(torch, lambda: loop_over(net, trainer).fit(
            epochs=1, resume=False))
        profiles[name] = _summary(
            f"one FitLoop epoch (8 steps), {name}, no checkpoints",
            _device_kernels(prof), wall, {})
        profiles[name]["host_top_ops"] = _host_top(torch, prof, 8)
        emit(profiles[name])

    def bare_epoch():
        for i in range(FIT_IMAGES // GT_BATCH):
            bare(i)

    prof, wall = _profiled(torch, bare_epoch)
    profiles["bare"] = _summary("the bare loop, 8 steps",
                                _device_kernels(prof), wall, {})
    emit(profiles["bare"])
    del net, trainer, loop, xb, yb, prof
    release()
    # 2. checkpoints every 4, loss scale 128, nan_grad@5; then kill@10
    plan = f"nan_grad@{MEGA_SKIP}"
    dirs = {k: os.path.join(tmp, f"mega_{k}") for k in ("c", "m", "k")}
    net, trainer, loop = build(dirs["c"], loss_scale=MEGA_SCALE)
    res_cc, _ = run(loop, False, plan)
    state_cc = _fit_state(torch, net, trainer)
    del net, trainer, loop
    release()
    net, trainer, loop = build(dirs["m"], loss_scale=MEGA_SCALE)
    res_mc, _ = run(loop, True, plan)
    state_mc = _fit_state(torch, net, trainer)
    del net, trainer, loop
    release()
    sentinel_bad = _not_bitwise(torch, state_mc, state_cc)
    del state_cc
    net, trainer, loop = build(dirs["k"], loss_scale=MEGA_SCALE)
    killed, _ = run(loop, True, f"{plan},kill@{FIT_KILL}")
    del net, trainer, loop
    release()
    resume_from = FIT_KILL // FIT_CKPT_EVERY * FIT_CKPT_EVERY
    _await_ckpt(dirs["k"], resume_from)
    net, trainer, loop = build(dirs["k"], loss_scale=MEGA_SCALE)
    res_r, _ = run(loop, True)
    kill_bad = _not_bitwise(torch, _fit_state(torch, net, trainer),
                            state_mc)
    del net, trainer, loop, state_mc
    release()
    # 3. the small MLP: card against host, card megastep against composed
    mlp = {}
    for opt, kw in MEGA_OPTS:
        lh, th = _mega_mlp(torch, mt, mt.cpu(), opt, kw, True)
        lc, tc = _mega_mlp(torch, mt, mt.gpu(0), opt, kw, True)
        lo, to = _mega_mlp(torch, mt, mt.gpu(0), opt, kw, False)
        loss_err, loss_ok = _close_of_max(
            torch, [torch.tensor(lc)], [torch.tensor(lh)], 1e-4)
        err, ok = _close_of_max(torch, tc, th, 1e-4)
        mlp[f"{opt}{'-centered' if kw.get('centered') else ''}"
            f"{'-momentum' if kw.get('momentum') else ''}"] = {
            "loss_err_of_max": loss_err, "state_err_of_max": err,
            "ok": loss_ok and ok, "card_bitwise_composed": lc == lo and all(
                torch.equal(a, b) for a, b in zip(tc, to))}
    drop, _ = _mega_mlp(torch, mt, mt.gpu(0), "sgd", {"learning_rate": 0.0},
                        True, dropout=0.5, steps=5, repeat=True)
    torch.backends.cudnn.deterministic = prev_det
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    warm_launches_moved = any(d != per_step[0] for d in per_step)
    mega_launches = profiles["megastep"]["epilogue_device_launches"]
    row = {"phase": "megastep_train",
           "model": 'get_model("resnet50_v1", layout="NHWC")',
           "batch": GT_BATCH, "image": IMG, "steps": res_m.step,
           "dtype": "float32, TF32 off, deterministic cuDNN",
           "loop": "FitLoop over DeviceStagingIter(NDArrayIter(shuffle, "
                   "seed 13)), gluon.Trainer sgd lr 0.05 momentum 0.9, "
                   "kvstore device, aggregation 4, MXTPU_MEGASTEP on / off",
           "step_ms_median": {"megastep": median_ms(res_m),
                              "composed": median_ms(res_c),
                              "bare_loop": bare_ms,
                              "fit_train_composed":
                                  fit_row["step_ms_median"]},
           "step_ms_first": {"megastep": 1e3 * res_m.step_breakdown[
                                 "per_step"][0]["wall"],
                             "composed": 1e3 * res_c.step_breakdown[
                                 "per_step"][0]["wall"]},
           "capture_ms": capture_ms,
           "img_per_s_median": {"megastep": 1e3 * GT_BATCH
                                / median_ms(res_m)},
           "device_idle_share": {k: v["device_idle_share"]
                                 for k, v in profiles.items()},
           "device_busy_ms_per_step": {
               k: v["device_busy_ms"] / (FIT_IMAGES // GT_BATCH)
               for k, v in profiles.items()},
           "memory": {"megastep": mem_m, "composed": mem_c},
           "shares": res_m.step_breakdown["shares"],
           "parity_not_bitwise": parity_bad,
           "losses_bitwise": res_m.losses == res_c.losses,
           "cache": info._asdict(),
           "wrapper_launches_in_run": launches_run,
           "wrapper_launches_moved_after_step_0": warm_launches_moved,
           "device_launches_profiled_epoch": mega_launches,
           "sentinel": {"plan": plan, "loss_scale_start": MEGA_SCALE,
                        "skipped": {"megastep": res_mc.skipped_steps,
                                    "composed": res_cc.skipped_steps},
                        "loss_scale": {"megastep": res_mc.loss_scale,
                                       "composed": res_cc.loss_scale},
                        "losses_bitwise": res_mc.losses == res_cc.losses,
                        "state_not_bitwise": sentinel_bad},
           "kill_resume": {"killed_at": FIT_KILL, "killed": killed is None,
                           "resumed_from": res_r.resumed_from,
                           "losses_bitwise":
                               res_r.losses == res_mc.losses[resume_from:],
                           "state_not_bitwise": kill_bad},
           "mlp_card_vs_host": mlp,
           "dropout_replay_losses": drop,
           "losses": res_m.losses, "card": card}
    emit(row)
    if not (np.all(np.isfinite(res_m.losses)) and
            0.0 < res_m.losses[0] < 20.0) or res_m.step != FIT_STEPS:
        fail(f"megastep_train: bad run {res_m.losses}")
    if parity_bad or not row["losses_bitwise"]:
        fail(f"megastep_train: megastep and composed differ: "
             f"{parity_bad[:5]}")
    if info.misses != 1 or info.hits != FIT_STEPS - 1 or \
            warm_launches_moved or any(v != 48 for v in
                                       launches_run.values()):
        fail(f"megastep_train: warm steps are not one replay each: "
             f"{row['cache']} {per_step[0]} {launches_run}")
    if any(v != 48 * (FIT_IMAGES // GT_BATCH) for v in
           mega_launches.values()):
        fail(f"megastep_train: expected 48 launches of each BN kernel a "
             f"step in the replays: {mega_launches}")
    if res_mc.skipped_steps != [MEGA_SKIP] or \
            res_cc.skipped_steps != [MEGA_SKIP] or \
            res_mc.loss_scale != MEGA_SCALE / 2 or sentinel_bad or \
            not row["sentinel"]["losses_bitwise"]:
        fail(f"megastep_train: the nan_grad step: {row['sentinel']}")
    if killed is not None or res_r.resumed_from != resume_from or \
            row["kill_resume"]["losses_bitwise"] is not True or kill_bad:
        fail(f"megastep_train: the killed-then-resumed run is not the "
             f"fault-free run bit for bit: {row['kill_resume']}")
    if not all(v["ok"] and v["card_bitwise_composed"]
               for v in mlp.values()):
        fail(f"megastep_train: the MLP card against host: {mlp}")
    if len(set(drop[1:])) != len(drop) - 1:
        fail(f"megastep_train: replays drew one dropout mask: {drop}")
    return mega_launches, row


def fit_phases(torch, mt, card, gluon_row, timed):
    """fit_reference, fit_train and megastep_train, their checkpoints in
    one temporary directory removed afterwards; the BN kernels' launches
    of fit_train's run and of the megastep's profiled epoch."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="mxt_fit_")
    try:
        timed("fit_reference", fit_reference, torch, mt, tmp)
        launches, fit_row = timed("fit_train", fit_train, torch, mt, card,
                                  gluon_row, tmp)
        mega_launches, _ = timed("megastep_train", megastep_train, torch,
                                 mt, card, fit_row, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, mega_launches


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
    walls = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        emit({"phase": "wall", "of": name, "seconds": walls[name]})
        return out

    t0 = time.perf_counter()
    paths = _build.build()
    walls["build"] = time.perf_counter() - t0
    emit({"phase": "build", "seconds": walls["build"],
          "nvcc_s": dict(_build.build_seconds),
          "libraries": {k: os.path.relpath(v, here)
                        for k, v in paths.items()},
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    totals, totals_v2 = timed("kernel", kernel_phase, torch, tk)
    timed("reduction_counters", reduction_counter_check, torch, tk)
    timed("reference", small_reference, torch, mt)
    timed("graph", graph_phase, torch, mt)
    trainer, data, label = timed("train", main_path, torch, mt, card)
    launched = timed("profile", profile_phase, torch, trainer, data, label)
    del trainer, data, label
    torch.cuda.empty_cache()

    flash = timed("flash", flash_phase, torch, fa)
    timed("transformer_reference", transformer_reference, torch, mt)
    flash_launches, run = timed("transformer_train", transformer_main,
                                torch, mt, card)
    timed("transformer_profile", profile_transformer_step, torch, *run)
    del run
    torch.cuda.empty_cache()

    timed("nd_ops", nd_ops_phase, torch, mt, here)
    mod, ks, rtc_rows = timed("rtc", rtc_phase, torch, mt)
    torch.cuda.empty_cache()
    timed("imperative_reference", imperative_reference, torch, mt,
          ks["sgd_mom"])
    sgd_launches, state = timed("imperative_train", imperative_train, torch,
                                mt, ks["sgd_mom"], card)
    timed("imperative_profile", profile_imperative_step, torch, mt,
          ks["sgd_mom"], *state)
    example_launches = timed("imperative_example", imperative_example,
                             torch, mt, ks["sgd_mom"], here, card)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    sgd = timed("sgd_mom_timing", sgd_mom_timing, torch, mt, ks["sgd_mom"],
                *state[:2], flush)
    del state, flush
    torch.cuda.empty_cache()

    # the v2 path last, so the earlier phases run as they did before it
    timed("resnet_v2_reference", resnet_v2_reference, torch, mt)
    timed("v2_graph", v2_graph_phase, torch, mt)
    trainer, data, label = timed("train_v2", main_path_v2, torch, mt, card)
    launched_v2 = timed("profile_v2", profile_phase, torch, trainer, data,
                        label, "resnet50_v2")
    del trainer, data, label
    torch.cuda.empty_cache()
    timed("v2_plain_batchnorm", v2_plain_bn_sites, torch, mt)

    # the Gluon Trainer path (gluon.Trainer over mx.optimizer, f32), after
    # the v2 phases so every earlier row stays as it was
    timed("trainer_reference", trainer_reference, torch, mt)
    timed("optimizer_ops", optimizer_ops_phase, torch, mt)
    gluon_launches, gluon_row = timed("gluon_train", gluon_train, torch, mt,
                                      card)
    torch.cuda.empty_cache()
    totals_f32 = timed("kernel_f32", kernel_f32_phase, torch, tk)
    # the FitLoop path, after every earlier phase
    fit_launches, mega_launches = fit_phases(torch, mt, card, gluon_row,
                                             timed)
    v2 = ("resnet_v2_reference", "v2_graph", "train_v2", "profile_v2",
          "v2_plain_batchnorm")
    gluon = ("trainer_reference", "optimizer_ops", "gluon_train",
             "kernel_f32")
    fits = ("fit_reference", "fit_train", "megastep_train")
    emit({"phase": "walls", "seconds": walls,
          "total_s": sum(walls.values()),
          "earlier_phases_s": sum(v for k, v in walls.items()
                                  if k not in v2 + gluon + fits),
          "v2_phases_s": sum(walls[k] for k in v2),
          "gluon_trainer_phases_s": sum(walls[k] for k in gluon),
          "fit_phases_s": sum(walls[k] for k in fits)})

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
                   f"{K_STEPS}-step graph",
            "v2": {"launches": launched_v2[name],
                   "max_abs_err": totals_v2[name]["max_abs_err"],
                   "ms": totals_v2[name]["ms"],
                   "plain_ms": totals_v2[name]["plain_ms"],
                   "bound_ms": totals_v2[name]["bound_ms"],
                   "library_ms": totals_v2[name]["library_ms"],
                   "per": "one resnet50_v2 step (48 no-residual sites); "
                          "launches over one replay"},
            "f32": {"launches": gluon_launches[name],
                    "max_abs_err": totals_f32[name]["max_abs_err"],
                    "ms": totals_f32[name]["ms"],
                    "plain_ms": totals_f32[name]["plain_ms"],
                    "bound_ms": totals_f32[name]["bound_ms"],
                    "bound_by": "bytes" if totals_f32[name]["bound_by"]
                    == {"bytes"} else "operations",
                    "library_ms": totals_f32[name]["library_ms"],
                    "per": f"one gluon.Trainer ResNet-50 v1 step (48 "
                           f"sites, batch {GT_BATCH}, f32); launches over "
                           f"the {GT_STEPS} timed steps of gluon_train"},
            "fit": {"launches": fit_launches[name],
                    "launches_per_step": fit_launches[name] / FIT_STEPS,
                    "per": "the f32 block's kernel at the same sites; "
                           f"launches over the {FIT_STEPS} steps of "
                           "fit_train's fault-free FitLoop run"},
            "megastep": {"launches": mega_launches[name],
                         "launches_per_step": mega_launches[name]
                         / (FIT_IMAGES // GT_BATCH),
                         "per": "device launches in one profiled FitLoop "
                                "epoch (8 steps) under MXTPU_MEGASTEP=on, "
                                "every step one CUDA graph replay"}})
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
