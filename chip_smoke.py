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
6. the ``{"kernels": [...]}`` summary (times are per training step: the
   sum over the 48 call sites) and, last, the device line.

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
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
