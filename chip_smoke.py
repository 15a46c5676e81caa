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
   bytes / 3.35 TB/s and flops / 67 TFLOP/s, H100 SXM peaks);
3. correctness of the path: a small channel-last ResNetV1 trained one step
   on the card (kernels) and on the host (plain versions) from the same
   weights, f32, TF32 off; logits, loss and every updated tensor compared;
4. the main path: full-width ResNet-50 v1, NHWC, space-to-depth stem,
   224x224, bf16 compute with f32 masters, SGD momentum 0.9 lr 0.05,
   ``SPMDTrainer.run_steps`` of K steps. Launch counters are zeroed just
   before the measured call and read just after; every kernel must have
   launched 48 times per step. Step time, img/s and peak memory;
5. one more step under ``torch.profiler``: device time by kernel family
   and the device's idle share of the step;
6. the flash-attention forward kernel against its plain PyTorch version
   at the transformer path's shape (B 8, T 2048, H 8, D 64, causal, bf16,
   q/k/v as views of the qkv projection; timed, with SDPA as its
   yardstick and the bound the larger of bytes / 3.35 TB/s and flops /
   989 TFLOP/s) and at edge cases (ragged T, T under one tile, D 8 to 256,
   non-causal, f32, unaligned views);
7. a small transformer LM card against host, f32, TF32 off: logits, loss
   and every parameter after one ``make_train_step`` step, with exactly
   n_layers ``flash_fwd`` launches per forward on the card and none on the
   host;
8. the transformer main path at full width: ``TransformerConfig()`` in
   bf16, batch 8 x T 2048; one timed ``forward`` (tokens/s), then K timed
   ``make_train_step`` steps (step ms, tokens/s, peak memory), counters
   zeroed just before each and read just after: 4 launches per forward
   and per step;
9. one more train step under ``torch.profiler``: device time of
   ``flash_fwd``, of the attention backward (the plain recompute), of
   matmuls and of the rest, and the device's idle share;
10. the ``{"kernels": [...]}`` summary (the BN kernels' times are per
    ResNet training step, the sum over the 48 call sites; flash_fwd's per
    launch at the path's shape) and, last, the device line.

Any failure exits non-zero. Without a CUDA device, or without the
repository beside it, it exits non-zero and prints no result.
"""
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
    order). Elementwise: the kernel rounds as the plain version does, so
    both agree to one unit in the last place of the output type."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst, ok = 0.0, True
    for a, w in zip(got, want):
        d = (a.float() - w.float()).abs()
        worst = max(worst, float(d.max()))
        if name in ("bn_stats", "bn_bwd_stats"):
            tol = 1e-5 * reduction_scale(torch, tk, name, cs) + 1e-6
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


# ---------------------------------------------------------------------------
# phase 3: the path on a small model, card against host
# ---------------------------------------------------------------------------

def small_reference(torch, mt):
    from mxnet_tpu_torch.convert import from_mxnet_tpu_params
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (
        BottleneckV1, ResNetV1)
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    spec = ([1, 1, 1, 1], [8, 16, 32, 64, 128])
    nets = {dev: ResNetV1(BottleneckV1, *spec, classes=10, layout="NHWC",
                          stem_s2d=True, device=dev)
            for dev in ("cpu", "cuda")}
    nets["cpu"].initialize(generator=torch.Generator().manual_seed(0))
    from_mxnet_tpu_params(nets["cuda"], {
        k: p.data().detach().numpy()
        for k, p in nets["cpu"].collect_params().items()},
        prefix=nets["cpu"].prefix)
    gen = torch.Generator().manual_seed(1)
    data = torch.rand((1, 4, 64, 64, 3), generator=gen)
    label = torch.randint(0, 10, (1, 4), generator=gen).float()
    res = {}
    tk.reset_launches()
    for dev, net in nets.items():
        net.train()
        logits = net(data[0].to(dev)).detach().cpu()
        tr = mt.parallel.SPMDTrainer(
            net, gloss.SoftmaxCrossEntropyLoss(),
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
        loss = tr.run_steps(data.to(dev), label.to(dev)).cpu()
        params = {k: p.data().detach().cpu()
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
# phase 4: the main path
# ---------------------------------------------------------------------------

def main_path(torch, mt, card):
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
    warm = trainer.run_steps(data, label).cpu()
    setup_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    t1 = time.perf_counter()
    losses = trainer.run_steps(data, label)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    launched = dict(tk.launches)
    losses = losses.cpu()
    row = {"phase": "train", "model": "resnet50_v1 NHWC stem_s2d",
           "batch": B, "image": IMG, "k_steps": K_STEPS,
           "dtype": "bfloat16 compute, f32 masters",
           "warmup_losses": warm.tolist(), "losses": losses.tolist(),
           "step_ms": 1e3 * dt / K_STEPS, "img_per_s": B * K_STEPS / dt,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "setup_and_first_call_s": setup_s, "launches": launched,
           "card": card}
    emit(row)
    if not (torch.isfinite(losses).all() and torch.isfinite(warm).all()):
        fail("non-finite loss")
    if not 0.0 < float(warm[0]) < 20.0:
        fail(f"first loss {float(warm[0])} is not that of a fresh "
             "1000-class model")
    want = 48 * K_STEPS
    if any(v != want for v in launched.values()):
        fail(f"expected {want} launches of every kernel, got {launched}")
    return launched, trainer, data, label


_EPILOGUE_KERNELS = ("bn_stats_partial", "sum_partials", "bn_apply<",
                     "bn_bwd_stats_partial", "bn_bwd_apply<")
_CONV_KERNELS = ("conv", "cudnn", "xmma", "implicit", "gemm", "sm90_",
                 "wgrad", "dgrad", "fprop")


def profile_step(torch, trainer, data, label):
    """One more training step under torch.profiler: device time by kernel
    family and the device's idle share of the step's wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.step(data[0], label[0])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    fam = {"epilogue_kernels": 0.0, "convolution_kernels": 0.0, "other": 0.0}
    top = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3
        name = e.key
        if any(k in name for k in _EPILOGUE_KERNELS):
            fam["epilogue_kernels"] += ms
        elif any(k in name.lower() for k in _CONV_KERNELS):
            fam["convolution_kernels"] += ms
        else:
            fam["other"] += ms
        top.append((ms, e.count, name[:90]))
    busy = sum(fam.values())
    top.sort(reverse=True)
    row = {"phase": "profile", "what": "one SPMDTrainer.step, batch "
           f"{B}, bf16, under torch.profiler", "wall_ms": wall_ms,
           "device_busy_ms": busy,
           "device_idle_share": 1.0 - busy / wall_ms if busy else None,
           "by_family_ms": fam,
           "top_kernels": [[round(ms, 4), n, name] for ms, n, name
                           in top[:12]]}
    emit(row)


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


def flash_phase(torch, fa):
    """Every case within tolerance of ``_flash_plain`` on the same inputs:
    f32 within 2e-5 absolute (randn inputs; the online softmax sums in
    another order), bf16 within one bf16 ulp of the plain output plus that
    f32 allowance. The path's shape is timed."""
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    bf16, f32 = torch.bfloat16, torch.float32
    # (B, T, H, D, causal, dtype, layout, timed)
    cases = [(TF_BATCH, TF_T, 8, 64, True, bf16, "qkv", True),
             (2, 1000, 4, 64, True, bf16, "qkv", False),
             (2, 64, 4, 64, True, bf16, "dense", False),
             (3, 37, 2, 64, False, bf16, "dense", False),
             (2, 1000, 4, 32, False, bf16, "dense", False),
             (2, 1000, 4, 128, False, bf16, "qkv", False),
             (2, 1000, 4, 64, True, f32, "qkv", False),
             (1, 300, 2, 256, True, f32, "dense", False),
             (2, 129, 2, 64, False, f32, "offset", False),
             (2, 128, 4, 8, True, f32, "dense", False)]
    result, worst, bad = None, 0.0, []
    for b, t, h, d, causal, dtype, layout, timed in cases:
        q, k, v = flash_inputs(torch, b, t, h, d, dtype, layout, gen)
        scale = 1.0 / d ** 0.5
        got = fa.flash_fwd(q, k, v, causal, scale)
        want = fa._flash_plain(q, k, v, causal, scale)
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        tol = 2e-5 + (2.0 ** -7 * want.float().abs() if dtype == bf16
                      else 0.0)
        ok = bool(torch.isfinite(got).all()) and bool((diff <= tol).all())
        err = float(diff.max())
        worst = max(worst, err)
        row = {"phase": "kernel", "kernel": "flash_fwd", "B": b, "T": t,
               "H": h, "D": d, "causal": causal, "dtype": str(dtype)[6:],
               "layout": layout, "max_abs_err": err, "ok": ok}
        if not ok:
            bad.append(row)
        if timed:
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            row["ms"] = time_ms(
                torch, lambda: fa.flash_fwd(q, k, v, causal, scale), flush)
            row["plain_ms"] = time_ms(
                torch, lambda: fa._flash_plain(q, k, v, causal, scale),
                flush, iters=3)
            row["library_ms"] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, scale=scale), flush)
            row["bound_ms"], row["bound_by"] = flash_bound_ms(
                b, t, h, d, causal, q.element_size())
            result = dict(row)
        emit(row)
        del q, k, v, got, want, diff
    torch.cuda.empty_cache()
    if bad:
        fail(f"flash_fwd disagrees with its plain version: {bad}")
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
                                  "train_steps": step_launches},
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
          "libraries": {k: os.path.relpath(v, here)
                        for k, v in paths.items()},
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    totals = kernel_phase(torch, tk)
    small_reference(torch, mt)
    launched, trainer, data, label = main_path(torch, mt, card)
    profile_step(torch, trainer, data, label)
    del trainer, data, label
    torch.cuda.empty_cache()

    flash = flash_phase(torch, fa)
    transformer_reference(torch, mt)
    flash_launches, run = transformer_main(torch, mt, card)
    profile_transformer_step(torch, *run)

    kernels = []
    for name, (replaces, _) in KERNELS.items():
        t = totals[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces.split(" ")[0], "launches": launched[name],
            "max_abs_err": t["max_abs_err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes" if t["bound_by"] == {"bytes"}
            else "operations", "library_ms": t["library_ms"],
            "library": LIBRARY[name],
            "per": f"one training step (48 sites, batch {B}, bf16)"})
    kernels.append({
        "name": "flash_fwd", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": flash_launches,
        "max_abs_err": flash["max_abs_err"], "ms": flash["ms"],
        "plain_ms": flash["plain_ms"], "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"], "library_ms": flash["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "per": f"one launch (B {TF_BATCH}, T {TF_T}, H 8, D 64, causal, "
               f"bf16); launches over {TF_K_STEPS} train steps"})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
