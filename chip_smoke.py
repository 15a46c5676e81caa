#!/usr/bin/env python3
"""Drive mxnet_tpu_torch on one NVIDIA card and check it end to end.

    python3 chip_smoke.py            # from the repository root; one card

Phases, each printing JSON lines:

1. the card (``nvidia-smi`` name and power limit) and the build of every
   CUDA kernel of the port from ``mxnet_tpu_torch/csrc`` (nvcc, sm_90a);
2. each kernel of the training path against its plain PyTorch version on
   the card, at every shape the ResNet-50 v1 step gives it and at the
   seven no-residual shapes only the v2 step gives it (plus a ragged R, a
   C that takes the scalar path, and an f32 case; bn_apply and
   bn_bwd_apply bit for bit, the reductions within 1e-5 of the sum of
   magnitudes): maximum error, the
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
   of its routes (``flash_route``: the tensor-core kernel for bf16 or f16
   with D a multiple of 8 up to 256 and aligned views, the general kernel
   (3xTF32 on the tensor cores) for the rest), each case at its route's
   tolerance and with the route it took read from the launch counters:
   the transformer path's shape (B 8, T 2048, H 8, D 64, causal, bf16,
   q/k/v as views of the qkv projection; timed, with TFLOP/s, the general
   kernel on the same inputs, SDPA as the yardstick and the bound the
   larger of bytes / 3.35 TB/s and flops / 989 TFLOP/s), the same work at
   D 128, in f16, at D 80 (padded to 128) and at D 256 in f16 (64-key
   tiles; all timed), the LM's default f32 shape on the general route (timed
   against SDPA in f32, naming the kernels SDPA ran and the TF32 flags,
   the bound as 3xTF32 and on f32 FMAs), and edge cases (ragged T, T under one tile, f16, D 8
   to 256 with D 80, 96, 192 padded to a multiple of 64, f32 at D 1, 12,
   100, 320 and 512, f16 and bf16 at D 100, unaligned views);
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
   matmuls and of the rest, and the device's idle share; then
   ``transformer_train_f32``: the default ``TransformerConfig()`` (f32),
   batch 8 x T 2048, as phase 8 (TF32 off), every flash launch on the
   general route, and one of its steps profiled as above;
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
14e. then ResNet-50 v1 in f16: ``kernel_f16``, each BN kernel against its
    plain version in f16 at the v1 path's 48 sites (as phase 2, summed per
    step); ``train_f16``, the main path with ``SPMDTrainer(dtype=
    torch.float16)``, one timed replay of the K = 4 graph; ``profile_f16``,
    48 x K device launches of each BN kernel in the replay;
14f. then the Mixture-of-Experts LM, remat and Gluon's user blocks:
    ``transformer_moe_reference``, a small MoE LM (2 layers, both MoE, 4
    experts, T 128, head dim 64) one step card against host from the same
    converted weights, f32, TF32 off: every MoE call's routing identical
    token by token, logits, loss and every updated tensor within 1e-3 of
    each tensor's largest value, 2 flash launches per forward on the card;
    ``transformer_moe_train``, ``TransformerConfig(n_experts=8,
    moe_every=2, capacity_factor=1.25, router_k=1, aux_loss_coef=0.01)``
    (Switch's routing settings) in bf16 at batch 8 x T 2048: ms a step,
    tokens/s, peak memory and flash launches (4 a step, all on the
    tensor-core route) over 4 timed steps; one timed step with router_k 2
    (GShard's top-2); loss and every gradient with ``remat=True`` bit for
    bit those without, from the same start, and remat's timed steps (8
    flash launches a step); ``resnet_remat``, the main path's ResNet-50
    v1 through ``SPMDTrainer(remat=False)``, ``remat=True`` and
    ``remat=True`` with ``MXNET_BACKWARD_MIRROR_POLICY=convs`` from one
    start (deterministic cuDNN): one timed replay each, weights, momenta
    and running statistics against the plain run's bit for bit (or within
    1e-3, the row says which), replay ms, first-call peak and reserved
    memory, and each BN kernel's launches in the first call and in a
    profiled replay (48 x K; with remat 96 x K for ``bn_stats`` and
    ``bn_apply``, whose forward runs again in backward); ``gluon_user_block``,
    ``examples/capsnet/capsnet.py``'s CapsNet written as there
    (``params.get``, ``hybrid_forward`` over ``mx.nd``): 3
    ``gluon.Trainer`` steps card against host (1e-3), ``SPMDTrainer``'s
    K-step graph against eager steps with the ``params.get`` weight
    trained, and ``save_parameters`` on the card loaded on the host bit
    for bit;
14g. then the dense ``mx.nd`` op families: ``random_ops``, every random
    op on the card at 2^22 draws (moments within 5 standard errors,
    Kolmogorov-Smirnov for uniform / normal / gamma / exponential,
    shuffle a permutation, multinomial by chi-square), ``seed(s)``
    repeating every draw bit for bit and ``seed(s + 1)`` changing it,
    ``initialize()`` after ``seed(1)`` against ``seed(0)``, and a Dropout
    MLP's K-step graph replayed from one start after ``seed(s)`` twice
    (bit for bit) and after ``seed(s + 1)`` (other masks);
    ``flash_registry``, ``mx.nd.contrib.flash_attention`` at the LM shape
    (B 8, T 2048, H 8, D 64, causal) in bf16 and f32, forward and
    backward under ``record()``: one launch each, on the tensor-core
    route in bf16 and the general route in f32 (the counters), output
    within flash_phase's tolerance, gradients the plain attention's;
    ``ssd_example``, ``examples/ssd/train_ssd.py`` at its settings card
    against host from the same weights (losses within 1e-4 relative, the
    last below the first, the same detection rows); ``ssd300_decode``,
    ``MultiBoxPrior`` / ``MultiBoxTarget`` / ``MultiBoxDetection`` at
    MXNet example/ssd's SSD300 widths (8732 anchors, 21 classes, batch
    32): median ms of 10 calls, peak memory above the phase's start,
    targets and kept rows card against host (a flipped row passes only
    with its decision's IoU margin under 1e-6). ``nd_ops`` holds
    ``_linalg_syevd`` and ``_linalg_gelqf`` by their invariants;
14h. then the input pipeline: ``image_ops``, each of the 14 ``_image_*``
    ops on the card against the same op on the host on an NHWC uint8
    (128, 256, 256, 3) batch from seed 0 (the elementwise ops bit for
    bit, contrast and the color jitter within 1, ``_image_resize`` to 224
    in bilinear, bicubic and nearest within 1 in uint8 and 1e-3 of 255 in
    f32; the random ops on degenerate ranges, the jitter's factors drawn
    on the card and applied on the host, the flips' coin share over 1,000
    calls; the card's median ms of each); ``input_pipeline``, 640 records
    of 256x256x3 uint8 (npy payloads, labels from seed 1) written with
    ``mx.recordio``, ``RecordPipeline``'s order (shuffle, seed 0, two
    epochs) equal to the splitmix64 permutation computed in numpy,
    ``ImageRecordIter`` at ``train_imagenet.py``'s settings (crop 224,
    mirror, its mean / std, 8 decode threads) with a center-cropped batch
    against numpy, and img/s of it (also with PyTorch's intra-op threads
    set to 1 for one epoch), of ``DataLoader(ImageRecordDataset
    (...).transform_first(Compose([RandomResizedCrop(224),
    RandomFlipLeftRight(), ToTensor(), Normalize(...)])), batch 128, 8
    forked workers, pin_memory=True)`` and of the same loader with no
    workers, every batch on the card with its labels in order;
    ``imagenet_example``, ``train_imagenet.py``'s record path: resnet50_v1
    NHWC with the space-to-depth stem, bf16 with f32 masters, SGD momentum
    0.9 lr 0.05 wd 1e-4, batch 128, ``SPMDTrainer.step`` fed by that
    ``ImageRecordIter`` (NCHW batch transposed to NHWC on the card): 2
    warm-up and 4 timed steps (ms a step, img/s; 48 launches of each BN
    kernel a step, counted from zero over the timed steps), one profiled
    fed step (the card's idle share), and the same trainer on one batch
    already on the card (4 timed steps). The records live in a temporary
    directory the phases remove;
15. the wall seconds of every phase (a ``wall`` line after each, a
    ``walls`` line with the totals), the ``{"kernels": [...]}`` summary
    (the BN kernels' times are per ResNet-50 v1 training step, the sum
    over the 48 call sites, with the v2 step's sums and launches under
    ``v2``, the f32 Gluon step's under ``f32``, the FitLoop's under
    ``fit``, the megastep's replays under ``megastep``, the f16 step's
    under ``f16`` and the ImageRecordIter-fed steps' under ``data_fed``;
    flash_fwd's (the tensor-core route) per launch at the
    bf16 path's shape and flash_fwd_general's at the default f32 LM's,
    with that LM's launches; the tensor-core row also carries the general
    kernel on the same bf16 inputs with its bound and SDPA's time, and
    the MoE LM's launches; both flash rows carry ``launches_registry``,
    their route's launches in ``flash_registry``; the rtc kernels' per
    launch at the sizes
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
TF32_FLOPS_PER_S = 495e12       # H100 SXM, dense TF32 tensor cores
TF_BATCH, TF_T, TF_K_STEPS = 8, 2048, 4
FLASH_SOURCE = "mxnet_tpu_torch/csrc/flash_attention.cu"
FLASH_REPLACES = "mxnet_tpu/ops/pallas_kernels.py:85"   # _build_flash
# ResNet-50 v1 stages: (H = W, bottleneck width, output width, blocks)
STAGES = ((56, 64, 256, 3), (28, 128, 512, 4), (14, 256, 1024, 6),
          (7, 512, 2048, 3))
SOURCE = "mxnet_tpu_torch/csrc/fused_bn_act.cu"
KERNELS = {  # name -> replaced TPU kernel (operations per element: in
    # mxnet_tpu_torch/ops/kernel_cost.py)
    "bn_stats": "mxnet_tpu/ops/pallas_kernels.py:231 _bn_stats_call",
    "bn_apply": "mxnet_tpu/ops/pallas_kernels.py:261 _bn_apply_call",
    "bn_bwd_stats": "mxnet_tpu/ops/pallas_kernels.py:298 _bn_bwd_stats_call",
    "bn_bwd_apply": "mxnet_tpu/ops/pallas_kernels.py:340 _bn_bwd_apply_call",
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
    order). bn_apply and bn_bwd_apply: bit-identical (they round operation
    by operation as the plain versions do), in f32, bf16 and f16."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst, ok = 0.0, True
    for a, w in zip(got, want):
        d = (a.float() - w.float()).abs()
        worst = max(worst, float(d.max()))
        if name in ("bn_stats", "bn_bwd_stats"):
            tol = 1e-5 * reduction_scale(torch, tk, name, cs) + 1e-6
            ok = ok and bool((d <= tol).all())
        else:
            ok = ok and torch.equal(a, w)
    return worst, ok


def site_bytes_flops(name, r, c, itemsize, has_res):
    """The package's formula (``mxnet_tpu_torch/ops/kernel_cost.py``),
    which the efficiency plane counts with too."""
    from mxnet_tpu_torch.ops import kernel_cost
    return kernel_cost.site_bytes_flops(name, r, c, itemsize, has_res)


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

def main_path(torch, mt, card, dtype=None):
    """The timed ``run_steps`` is one replay of the K-step graph, captured
    by the first call (which runs its K steps eagerly first, counted:
    ``SPMDTrainer.program_stats()``, whose FLOPs must be K times its first
    step's within 1 %). A replay calls no wrapper, so its launches are
    read on the device by the profile phase that follows. ``dtype``: the
    compute type (bf16 unless given; f32 masters either way)."""
    dtype = dtype or torch.bfloat16
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    t0 = time.perf_counter()
    net = resnet50_v1(layout="NHWC", stem_s2d=True)
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
    trainer = mt.parallel.SPMDTrainer(
        net, gloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
        dtype=dtype)
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
    # the K-step graph's counted cost (its first call's K eager steps)
    program = trainer.program_stats()
    one_step = trainer.program_stats(step=True)
    if abs(program["flops"] - K_STEPS * one_step["flops"]) > \
            0.01 * program["flops"] or not program["flops"] > 0:
        fail(f"program_stats: {program['flops']} FLOPs for {K_STEPS} "
             f"steps, {one_step['flops']} for one")
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
    row = {"phase": "train" if dtype == torch.bfloat16 else
           f"train_{str(dtype)[6:]}", "model": "resnet50_v1 NHWC stem_s2d",
           "batch": B, "image": IMG, "k_steps": K_STEPS,
           "dtype": f"{str(dtype)[6:]} compute, f32 masters",
           "how": "one replay of the K-step CUDA graph",
           "warmup_losses": warm.tolist(), "losses": losses.tolist(),
           "step_ms": 1e3 * dt / K_STEPS, "img_per_s": B * K_STEPS / dt,
           "peak_mem_gib": replay_mem["reserved_gib"],
           "replay_memory": replay_mem,
           "first_call_peak_allocated_gib": first_peak,
           "program_stats": program, "program_stats_one_step": one_step,
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


def profile_phase(torch, trainer, data, label, model="resnet50_v1",
                  dtype="bf16"):
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
                     f"{dtype}", eager, wall, split(eager))]
    prof, wall = _profiled(torch, lambda: trainer.run_steps(data, label))
    replay = _device_kernels(prof)
    rows.append(_summary(f"{model}: one run_steps replay of the "
                         f"{K_STEPS}-step graph, batch {B}, {dtype}", replay,
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


def flash_flops(b, t, h, d, causal):
    """4*B*H*T^2*D, halved when causal (``mxnet_tpu_torch/ops/
    kernel_cost.py``)."""
    from mxnet_tpu_torch.ops import kernel_cost
    return kernel_cost.flash_flops(b, t, h, d, causal)


def flash_bound_ms(b, t, h, d, causal, itemsize):
    """The larger of bytes / HBM rate (q, k, v read once, o written once)
    and flops / the tensor cores' peak for the inputs: 16-bit at 989
    TFLOP/s; f32 as 3xTF32, three passes at 495 TFLOP/s (the least time
    for f32-accurate products on this card; on f32 FMAs, 67 TFLOP/s, see
    ``flash_f32_fma_bound_ms``)."""
    from mxnet_tpu_torch.ops import kernel_cost
    moved = kernel_cost.flash_bytes(b, t, h, d, itemsize)
    flops = flash_flops(b, t, h, d, causal)
    t_ops = flops / BF16_FLOPS_PER_S if itemsize == 2 \
        else 3 * flops / TF32_FLOPS_PER_S
    t_bytes = moved / HBM_BYTES_PER_S
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops \
        else "operations"


def flash_general16_design_floor_ms(b, t, h, d, causal):
    """The general kernel's own floor on 16-bit inputs, not the work's
    bound: its Q K^T is one TF32 pass (16-bit values are exact in TF32)
    and its P V two (P is f32, split in two), so 1.5 x the flops at 495
    TFLOP/s, or the 16-bit bytes if larger."""
    return 1e3 * max(4 * b * t * h * d * 2 / HBM_BYTES_PER_S,
                     1.5 * flash_flops(b, t, h, d, causal) / TF32_FLOPS_PER_S)


def flash_f32_fma_bound_ms(b, t, h, d, causal):
    return 1e3 * max(4 * b * t * h * d * 4 / HBM_BYTES_PER_S,
                     flash_flops(b, t, h, d, causal) / F32_FLOPS_PER_S)


def flash_tolerance(torch, route, want, v):
    """Per-element tolerance of a flash_fwd output against _flash_plain.
    Both routes: 2e-5 absolute (randn inputs; the online softmax sums in
    another order, and 3xTF32 drops about 2^-22 of each product), plus one
    unit in the last place of a 16-bit output (2^-7 |want| in bf16,
    2^-10 |want| in f16). Tensor-core route: also P's rounding to the input
    type, at most 2^-8 max|v| in bf16 and 2^-11 max|v| in f16."""
    ulp, p_round = {torch.bfloat16: (2.0 ** -7, 2.0 ** -8),
                    torch.float16: (2.0 ** -10, 2.0 ** -11),
                    torch.float32: (0.0, 0.0)}[want.dtype]
    tol = 2e-5 + ulp * want.float().abs()
    if route == "tc":
        tol = tol + p_round * float(v.float().abs().max())
    return tol


def _time_flash(torch, fa, row, q, k, v, causal, scale, flush, F):
    """The route's time, the plain version's, SDPA's (the yardstick; its
    backend read off the profiler's kernel names), the bound and rates."""
    from torch.profiler import ProfilerActivity, profile
    b, t, h, d = q.shape
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                              scale=scale)
    row["ms"] = time_ms(
        torch, lambda: fa.flash_fwd(q, k, v, causal, scale), flush)
    row["plain_ms"] = time_ms(
        torch, lambda: fa._flash_plain(q, k, v, causal, scale), flush,
        iters=3)
    row["library_ms"] = time_ms(torch, sdpa, flush)
    sdpa()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sdpa()
        torch.cuda.synchronize()
    row["library_kernels"] = sorted({e.key[:80] for e in prof.key_averages()
                                     if e.device_type.name == "CUDA"})
    row["bound_ms"], row["bound_by"] = flash_bound_ms(
        b, t, h, d, causal, q.element_size())
    flops = flash_flops(b, t, h, d, causal)
    row["bound_share"] = row["bound_ms"] / row["ms"]
    row["tflops"] = flops / row["ms"] / 1e9
    row["library_tflops"] = flops / row["library_ms"] / 1e9


def flash_phase(torch, fa):
    """Every case within its route's tolerance of ``_flash_plain`` on the
    same inputs, on the route the case table expects (read from the launch
    counters, which are zeroed before each call). Timed: the LM path's bf16
    shape and the same work at D 128 (tensor-core route, with the general
    kernel on the same inputs beside it), and the LM's default f32 shape
    (general route) against SDPA in f32."""
    import ctypes
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    tc, gn = "tc", "general"
    # (B, T, H, D, causal, dtype, layout, route, timed)
    cases = [(TF_BATCH, TF_T, 8, 64, True, bf16, "qkv", tc, True),
             (TF_BATCH, TF_T, 4, 128, True, bf16, "qkv", tc, True),
             (TF_BATCH, TF_T, 8, 64, True, f16, "qkv", tc, True),
             (TF_BATCH, TF_T, 8, 80, True, bf16, "qkv", tc, True),
             (TF_BATCH, TF_T, 2, 256, True, f16, "qkv", tc, True),
             (TF_BATCH, TF_T, 8, 64, True, f32, "qkv", gn, True),
             (2, 1000, 4, 64, True, bf16, "qkv", tc, False),
             (2, 64, 4, 64, True, bf16, "dense", tc, False),
             (3, 37, 2, 64, False, bf16, "dense", tc, False),
             (2, 129, 2, 64, True, bf16, "dense", tc, False),
             (2, 1000, 4, 128, False, bf16, "qkv", tc, False),
             (2, 300, 4, 128, True, bf16, "dense", tc, False),
             (2, 1000, 4, 32, False, bf16, "dense", tc, False),
             (2, 128, 4, 8, True, bf16, "dense", tc, False),
             (2, 1000, 4, 64, True, f16, "qkv", tc, False),
             (2, 300, 4, 128, True, f16, "dense", tc, False),
             (2, 1000, 4, 80, True, bf16, "qkv", tc, False),
             (2, 300, 4, 80, False, f16, "dense", tc, False),
             (2, 1000, 4, 96, True, f16, "qkv", tc, False),
             (2, 300, 4, 96, False, bf16, "dense", tc, False),
             (2, 1000, 4, 256, True, bf16, "dense", tc, False),
             (2, 300, 4, 256, False, f16, "qkv", tc, False),
             (1, 129, 2, 192, True, bf16, "dense", tc, False),
             (2, 1000, 4, 64, True, f32, "qkv", gn, False),
             (1, 300, 2, 256, True, f32, "dense", gn, False),
             (2, 129, 2, 64, False, f32, "offset", gn, False),
             (2, 128, 4, 8, True, f32, "dense", gn, False),
             (2, 300, 2, 12, True, f32, "dense", gn, False),
             (2, 300, 2, 100, False, f32, "qkv", gn, False),
             (1, 300, 2, 320, True, f32, "dense", gn, False),
             (1, 200, 2, 512, True, f32, "dense", gn, False),
             (2, 300, 2, 100, True, f16, "dense", gn, False),
             (2, 300, 2, 100, False, bf16, "qkv", gn, False),
             (2, 129, 2, 64, True, f16, "offset", gn, False),
             (2, 129, 2, 64, False, bf16, "offset", gn, False),
             (2, 129, 2, 36, True, f16, "qkv", gn, False),
             (1, 1, 1, 1, False, f32, "dense", gn, False)]
    result, worst, bad = {}, 0.0, []
    for b, t, h, d, causal, dtype, layout, route, timed in cases:
        q, k, v = flash_inputs(torch, b, t, h, d, dtype, layout, gen)
        scale = 1.0 / d ** 0.5
        fa.reset_launches()
        got = fa.flash_fwd(q, k, v, causal, scale)
        took = [r for r in (tc, gn) if fa.launches[f"flash_fwd_{r}"] == 1]
        took = took[0] if len(took) == 1 else None
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
            _time_flash(torch, fa, row, q, k, v, causal, scale, flush, F)
            if route == tc:
                o = torch.empty_like(q)
                strides = (ctypes.c_longlong * 12)(
                    *[st for x in (q, k, v, o) for st in x.stride()[:3]])
                lib = fa._lib()

                def general():   # the general kernel on the same inputs
                    if lib.mxt_flash_fwd(
                            q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), strides, b, t, h, d, scale,
                            int(causal), fa._DTYPE_CODE[dtype],
                            fa._unit((q, k, v)),
                            torch.cuda.current_stream().cuda_stream):
                        fail("the general flash kernel did not launch")
                row["general_ms"] = time_ms(torch, general, flush)
                # the same work on the same inputs as the tensor-core
                # route: 1x the flops at the 16-bit rate, or the bytes
                row["general_bound_ms"], row["general_bound_by"] = \
                    flash_bound_ms(b, t, h, d, causal, q.element_size())
                row["general_bound_share"] = (row["general_bound_ms"]
                                              / row["general_ms"])
                row["general_design_floor_ms"] = \
                    flash_general16_design_floor_ms(b, t, h, d, causal)
                # SDPA on these same 16-bit inputs
                row["general_library_ms"] = row["library_ms"]
            else:
                row["bound_f32_fma_ms"] = flash_f32_fma_bound_ms(
                    b, t, h, d, causal)
                row["library_tf32"] = {
                    "cuda.matmul.allow_tf32":
                        torch.backends.cuda.matmul.allow_tf32,
                    "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
            if route == gn:
                result["general"] = dict(row)
            elif "tc" not in result:
                result["tc"] = dict(row, other_shapes=[])
            else:
                keys = ("H", "D", "dtype", "ms", "general_ms",
                        "general_bound_ms", "general_bound_share",
                        "general_design_floor_ms", "general_library_ms",
                        "plain_ms",
                        "library_ms", "bound_ms", "bound_share", "tflops",
                        "worst_err_over_tol")
                result["tc"]["other_shapes"].append(
                    {key: row[key] for key in keys})
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
    arrays = tf.nest_params({k: v.numpy() for k, v in
                             tf.flat_params(init).items()})
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
        flat = {k: v.cpu() for k, v in tf.flat_params(params).items()}
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

def transformer_main(torch, mt, card, dtype=None):
    """``TransformerConfig()`` at batch TF_BATCH x T TF_T: bf16 (``dtype``
    torch.bfloat16), every flash launch on the tensor-core route; or the
    default configuration itself (``dtype`` None: f32), every launch on
    the general route."""
    import math
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu_torch.ops import flash_attention as fa
    t0 = time.perf_counter()
    cfg = tf.TransformerConfig(dtype=dtype)
    route = "tc" if dtype == torch.bfloat16 else "general"
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
    fwd_tc = fa.launches[f"flash_fwd_{route}"]
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
    step_tc = fa.launches[f"flash_fwd_{route}"]
    losses = losses.cpu()
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    row = {"phase": "transformer_train" if route == "tc"
           else "transformer_train_f32", "model": "TransformerConfig() "
           f"(vocab 32000, d_model 512, 8 heads, 4 layers, d_ff 2048), "
           f"{name}", "flash_route": route,
           "batch": TF_BATCH, "T": TF_T, "k_steps": TF_K_STEPS,
           "forward_ms": 1e3 * fwd_s, "forward_tokens_per_s": ntok / fwd_s,
           "warmup_loss": warm, "losses": losses.tolist(),
           "step_ms": 1e3 * dt / TF_K_STEPS,
           "train_tokens_per_s": ntok * TF_K_STEPS / dt,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
           "setup_and_first_calls_s": setup_s,
           "flash_fwd_launches": {"forward": fwd_launches,
                                  "train_steps": step_launches,
                                  f"forward_{route}": fwd_tc,
                                  f"train_steps_{route}": step_tc},
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
        fail(f"not every flash_fwd launch took the {route} route: "
             f"{fwd_tc} of {fwd_launches} per forward, {step_tc} of "
             f"{step_launches} in {TF_K_STEPS} steps")
    return step_launches, (step, params, tok, tgt)


_MATMUL_KERNELS = ("gemm", "nvjet", "xmma", "cutlass", "matmul")
_FLASH_BWD_RANGE = "mxt::flash_attention_backward"


def profile_transformer_step(torch, step, params, tok, tgt, dtype="bf16"):
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
    row = {"phase": "transformer_profile" if dtype == "bf16" else
           f"transformer_profile_{dtype}", "what": "one make_train_step "
           f"step, batch {TF_BATCH} x T {TF_T}, {dtype}, under "
           "torch.profiler",
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


# held on the card by their invariants, not elementwise: cuSOLVER may
# choose other signs for Q's rows and the eigenvectors than LAPACK
LINALG_BY_INVARIANT = ("_linalg_syevd", "_linalg_gelqf")


def _linalg_invariants(torch, mt, np, name, case):
    """The card's outputs of ``gelqf`` (L Q = A, Q Q^T = I, L lower) or
    ``syevd`` (V^T diag(w) V = A, V V^T = I, w the host's), as residuals
    relative to max |A|."""
    nd = mt.nd
    a = case.inputs[0]
    outs = {}
    for key, ctx in (("host", mt.cpu()), ("card", mt.gpu(0))):
        with ctx:
            outs[key] = [o.asnumpy().astype(np.float64) for o in
                         nd.imperative_invoke(name, (nd.array(a),), {})]
    a64, scale = a.astype(np.float64), float(np.abs(a).max())
    if name == "_linalg_gelqf":
        l, q = outs["card"]
        res = {"LQ=A": np.abs(l @ q - a64).max() / scale,
               "QQt=I": np.abs(q @ q.T - np.eye(q.shape[0])).max(),
               "L lower": np.abs(np.triu(l, 1)).max() / scale}
    else:
        v, w = outs["card"]
        res = {"VtdiagwV=A": np.abs(v.T @ np.diag(w) @ v - a64).max() / scale,
               "VVt=I": np.abs(v @ v.T - np.eye(v.shape[0])).max(),
               "w=host": np.abs(w - outs["host"][1]).max() / scale}
    res = {k: float(x) for k, x in res.items()}
    res["max_residual"] = max(res.values())
    return res


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
    worst, bad, invariants = 0.0, [], {}
    for name in ops:
        if name in LINALG_BY_INVARIANT:
            for i, case in enumerate(cases_mod.CASES[name]):
                invariants[f"{name} case {i}"] = res = \
                    _linalg_invariants(torch, mt, np, name, case)
                n_cases += 1
                if res["max_residual"] > 1e-4:
                    bad.append(f"{name} case {i} invariants")
            continue
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
           "invariants": invariants,
           "what": "card vs host at each op_cases.py case's rtol/atol, "
                   "f32, TF32 off; _linalg_syevd and _linalg_gelqf by "
                   "their invariants instead (cuSOLVER may choose other "
                   "signs than LAPACK)"}
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


def kernel_dtype_phase(torch, tk, dtype, batch, phase, seed):
    """Each BN kernel against its plain version in ``dtype`` at the
    ResNet-50 v1 path's (R, C) sites at ``batch``: bn_apply and
    bn_bwd_apply bit for bit, the reductions within 1e-5 of the sum of
    magnitudes; kernel, plain and library ms and the bound, summed over
    the 48 sites of one step."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    tot = {n: dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   max_abs_err=0.0, bound_by=set()) for n in KERNELS}
    bad = []
    for r, c, has_res, mult in path_sites(batch):
        cs = make_case(torch, tk, r, c, has_res, dtype, gen)
        for name, (kern, plain, lib) in calls(torch, tk, cs).items():
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err, ok = max_err(torch, tk, name, cs, got, want)
            row = {"phase": phase, "kernel": name, "R": r, "C": c,
                   "residual": has_res, "dtype": str(dtype)[6:],
                   "max_abs_err": err, "ok": ok,
                   "ms": time_ms(torch, kern, flush),
                   "plain_ms": time_ms(torch, plain, flush),
                   "library_ms": time_ms(torch, lib, flush),
                   "sites_per_step": mult}
            row["bound_ms"], row["bound_by"] = bound_ms(
                name, r, c, cs["x"].element_size(), has_res)
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
        fail(f"{phase}: kernel disagrees with its plain version: {bad}")
    return tot


def kernel_f32_phase(torch, tk):
    """The BN kernels in f32 at the Gluon path's sites (batch GT_BATCH)."""
    return kernel_dtype_phase(torch, tk, torch.float32, GT_BATCH,
                              "kernel_f32", 8)


def kernel_f16_phase(torch, tk):
    """The BN kernels in f16 at the v1 path's sites (batch B)."""
    return kernel_dtype_phase(torch, tk, torch.float16, B, "kernel_f16", 11)


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


# ---------------------------------------------------------------------------
# the MoE transformer, remat and Gluon's user blocks
# ---------------------------------------------------------------------------

MOE_CFG = dict(n_experts=8, moe_every=2, capacity_factor=1.25, router_k=1,
               aux_loss_coef=0.01)      # Switch's settings, the JAX defaults
MOE_STEPS = 4


def _routing_probe(torch, tf, moe, log):
    """Wrap the transformer's ``moe_ffn`` so each call also records its
    routing (the 0/1 dispatch, on the host); returns the undo."""
    real = tf.moe_ffn

    def probed(x, params, n_experts, capacity_factor=1.25, k=1, act=None):
        b, t, d = x.shape
        disp, _, _ = moe.route(x.reshape(b * t, d), params["gate"],
                               n_experts, capacity_factor, k)
        log.append(disp.to(torch.bool).cpu())
        return real(x, params, n_experts, capacity_factor, k, act)

    tf.moe_ffn = probed
    return lambda: setattr(tf, "moe_ffn", real)


def transformer_moe_reference(torch, mt):
    """A small MoE LM (2 layers, MoE on both, 4 experts, T 128, head dim
    64: the flash kernel's shape) one step on the card and on the host
    from the same converted weights, f32, TF32 off: the routing of every
    MoE call identical token by token, logits, loss and every updated
    tensor within 1e-3 of each tensor's largest value; n_layers flash
    launches per forward on the card, none on the host."""
    import numpy as np
    from mxnet_tpu_torch.convert import from_transformer_params
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import moe
    cfg = tf.TransformerConfig(vocab_size=257, d_model=128, n_heads=2,
                               n_layers=2, d_ff=512, n_experts=4,
                               moe_every=1)
    init = tf.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    arrays = tf.nest_params({k: v.numpy() for k, v in
                             tf.flat_params(init).items()})
    rs = np.random.RandomState(1)
    tok = torch.from_numpy(rs.randint(0, 257, (2, 128)))
    tgt = torch.from_numpy(rs.randint(0, 257, (2, 128)))
    step, _ = tf.make_train_step(cfg, lr=0.1)
    res = {}
    for dev in ("cpu", "cuda"):
        params = from_transformer_params(arrays, cfg, device=dev)
        routes = []
        undo = _routing_probe(torch, tf, moe, routes)
        try:
            fa.reset_launches()
            logits = tf.forward(params, tok, cfg).cpu()
            fwd = fa.launches["flash_fwd"]
            loss = tf.loss_fn(params, tok, tgt, cfg).cpu()
            step(params, tok, tgt)
        finally:
            undo()
        res[dev] = (logits, loss, {k: v.cpu() for k, v in
                                   tf.flat_params(params).items()}, fwd,
                    routes)
    (l_c, loss_c, p_c, f_c, r_c), (l_g, loss_g, p_g, f_g, r_g) = \
        res["cpu"], res["cuda"]
    worst = max(float((p_g[k].float() - p_c[k].float()).abs().max())
                / max(float(p_c[k].float().abs().max()), 1e-6) for k in p_c)
    same_routes = len(r_g) == len(r_c) == 3 * cfg.n_layers and all(
        torch.equal(a, b) for a, b in zip(r_g, r_c))
    row = {"phase": "transformer_moe_reference", "model": "vocab 257, "
           "d_model 128, 2 heads (head dim 64), 2 layers both MoE (4 "
           "experts, top-1, capacity factor 1.25), d_ff 512, T 128, batch "
           "2, f32, TF32 off, one SGD step lr 0.1",
           "logits_max_abs_err": float((l_g - l_c).abs().max()),
           "loss_card": float(loss_g), "loss_host": float(loss_c),
           "worst_param_err_of_max": worst,
           "moe_calls": len(r_g), "routing_identical": same_routes,
           "tokens_kept": [int(r.sum()) for r in r_g],
           "flash_fwd_launches": {"card_forward": f_g, "host_forward": f_c}}
    emit(row)
    if not same_routes:
        fail(f"card and host route tokens differently: {row}")
    if not (torch.allclose(l_g, l_c, rtol=1e-3, atol=1e-3)
            and torch.allclose(loss_g, loss_c, rtol=1e-4, atol=1e-5)
            and worst <= 1e-3):
        fail(f"card and host disagree on the small MoE transformer: {row}")
    if (f_g, f_c) != (cfg.n_layers, 0):
        fail(f"small MoE transformer launch counts are wrong: {row}")


def _moe_steps(torch, tf, fa, cfg, params, tok, tgt, steps):
    """One untimed step, then ``steps`` timed ones (counters zeroed just
    before, read just after): (losses, ms a step, peak GiB, the peak above
    what was allocated when the timed steps began (the step's own working
    memory: activations, gradients, temporaries), launches, tensor-core
    launches)."""
    step, _ = tf.make_train_step(cfg, lr=1e-3)
    step(params, tok, tgt)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fa.reset_launches()
    t0 = time.perf_counter()
    losses = torch.stack([step(params, tok, tgt)[0] for _ in range(steps)])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    return (losses.cpu(), 1e3 * dt / steps, peak / 2 ** 30,
            (peak - base) / 2 ** 30, fa.launches["flash_fwd"],
            fa.launches["flash_fwd_tc"])


def transformer_moe_train(torch, mt, card):
    """The LM with Switch MoE layers at full width: ``TransformerConfig(
    **MOE_CFG, dtype=bf16)`` (vocab 32000, d_model 512, 8 heads, 4 layers,
    d_ff 2048, experts on layers 1 and 3), batch TF_BATCH x T TF_T: ms a
    step, tokens/s, peak memory, flash launches (4 a step, all on the
    tensor-core route); one timed step with router_k 2 (GShard's top-2);
    then loss and every gradient of one step with remat=True against
    remat=False from the same start, bit for bit, and remat's timed steps
    (8 flash launches a step: each layer's forward runs again in
    backward), whose losses must be those of the k1 run bit for bit."""
    import dataclasses
    import math
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu_torch.ops import flash_attention as fa
    cfg = tf.TransformerConfig(**MOE_CFG, dtype=torch.bfloat16)
    gen = mt.random.seed(1)
    tok = torch.randint(0, cfg.vocab_size, (TF_BATCH, TF_T), generator=gen,
                        device="cuda")
    tgt = torch.randint(0, cfg.vocab_size, (TF_BATCH, TF_T), generator=gen,
                        device="cuda")
    start = {k: v.clone() for k, v in
             tf.flat_params(tf.init_params(mt.random.seed(0), cfg)).items()}
    ntok = TF_BATCH * TF_T
    rows = {}
    for name, over, steps in (("k1", {}, MOE_STEPS),
                              ("k2", {"router_k": 2}, 1),
                              ("remat", {"remat": True}, MOE_STEPS)):
        c = dataclasses.replace(cfg, **over)
        params = tf.nest_params({k: v.clone() for k, v in start.items()})
        losses, ms, peak, above, n, n_tc = _moe_steps(
            torch, tf, fa, c, params, tok, tgt, steps)
        rows[name] = {"router_k": c.router_k, "remat": c.remat,
                      "losses": losses.tolist(), "step_ms": ms,
                      "train_tokens_per_s": ntok / ms * 1e3,
                      "peak_mem_gib": peak, "step_peak_above_start_gib":
                      above, "timed_steps": steps,
                      "flash_fwd_launches": n, "flash_fwd_tc_launches": n_tc}
        del params
        torch.cuda.empty_cache()
        if not torch.isfinite(losses).all():
            fail(f"non-finite MoE loss ({name}): {rows[name]}")
        per_step = cfg.n_layers * (2 if c.remat else 1)
        if n != per_step * steps or n_tc != n:
            fail(f"expected {per_step} flash launches a step, all on the "
                 f"tensor-core route ({name}): {rows[name]}")
    # remat against plain from one start: loss and every gradient
    grads = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        ws = {k: v.clone().requires_grad_() for k, v in start.items()}
        loss = tf.loss_fn(tf.nest_params(ws), tok, tgt, c)
        gs = torch.autograd.grad(loss, list(ws.values()))
        grads[remat] = (loss.detach(), dict(zip(ws, gs)))
        del ws, loss, gs
    (lp, gp), (lr_, gr) = grads[False], grads[True]
    bitwise = torch.equal(lp, lr_) and all(torch.equal(gp[k], gr[k])
                                           for k in gp)
    # the timed runs through make_train_step, from one start on one batch
    same_losses = rows["remat"]["losses"] == rows["k1"]["losses"]
    worst = max(float((gr[k].float() - gp[k].float()).abs().max())
                / max(float(gp[k].float().abs().max()), 1e-30) for k in gp)
    first = float(lp)
    row = {"phase": "transformer_moe_train", "model": "TransformerConfig("
           "n_experts=8, moe_every=2, capacity_factor=1.25, router_k=1, "
           "aux_loss_coef=0.01) (vocab 32000, d_model 512, 8 heads, 4 "
           "layers, d_ff 2048), bf16", "batch": TF_BATCH, "T": TF_T,
           "dispatch_elements_per_moe_layer": {
               k: ntok * 8 * max(1, math.ceil(ntok * 1.25 * kk / 8))
               for k, kk in (("k1", 1), ("k2", 2))},
           "runs": rows, "remat_loss_and_grads_bit_for_bit": bitwise,
           "remat_train_step_losses_bit_for_bit": same_losses,
           "remat_worst_grad_err_of_max": worst, "first_loss": first,
           "card": card}
    emit(row)
    if not bitwise:
        fail(f"remat's loss or gradients differ from the plain step's: "
             f"{worst}")
    if not same_losses:
        fail(f"make_train_step's losses with remat differ from those "
             f"without: {rows['remat']['losses']} {rows['k1']['losses']}")
    if abs(first - math.log(cfg.vocab_size)) > 1.0:
        fail(f"first loss {first} is not that of a fresh "
             f"{cfg.vocab_size}-token model")
    del grads, start
    torch.cuda.empty_cache()
    return rows["k1"]["flash_fwd_launches"]


REMAT_RUNS = (("plain", False, "full"), ("remat", True, "full"),
              ("remat_convs", True, "convs"))


def resnet_remat(torch, mt, card):
    """The main path's ResNet-50 v1 (NHWC, s2d stem, bf16 b128, K 4, SGD
    momentum) through ``SPMDTrainer(remat=False)``, ``remat=True`` and
    ``remat=True`` under ``MXNET_BACKWARD_MIRROR_POLICY=convs``, each from
    the same start (Xavier from seed 0, deterministic cuDNN): the first
    call (K eager steps, then the capture) and one timed replay; memory as
    read and above what was allocated / reserved when the run began (the
    earlier phases' blocks stay cached in between). After the
    replay weights, momenta and running statistics against the plain
    run's: bit for bit, or within 1e-3 of each tensor's largest value
    where cuDNN picked other algorithms (the row says which). Launches: the
    first call's wrapper counts and one profiled replay's device counts;
    with remat the forward kernels (bn_stats, bn_apply) run twice, the
    backward ones once: 96 x K and 48 x K."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    gen = mt.random.seed(1)
    data = torch.rand((K_STEPS, B, IMG, IMG, 3), generator=gen,
                      device="cuda")
    label = torch.randint(0, 1000, (K_STEPS, B), generator=gen,
                          device="cuda").float()
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    gib = 2.0 ** 30
    rows, states = {}, {}
    for name, remat, policy in REMAT_RUNS:
        torch.cuda.synchronize()
        alloc0 = torch.cuda.memory_allocated()
        reserved0 = torch.cuda.memory_reserved()
        os.environ["MXNET_BACKWARD_MIRROR_POLICY"] = policy
        try:
            net = resnet50_v1(layout="NHWC", stem_s2d=True)
            net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
            tr = mt.parallel.SPMDTrainer(
                net, gloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
                optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
                dtype=torch.bfloat16, remat=remat)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tk.reset_launches()
            warm = tr.run_steps(data, label)
            torch.cuda.synchronize()
        finally:
            os.environ.pop("MXNET_BACKWARD_MIRROR_POLICY", None)
        first = dict(tk.launches)
        first_peak = torch.cuda.max_memory_allocated() / gib
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        losses = tr.run_steps(data, label)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        reserved = torch.cuda.memory_reserved() / gib
        states[name] = {**_trainer_state(tr, net),
                        "losses": losses.detach().clone()}
        prof, wall = _profiled(torch, lambda: tr.run_steps(data, label))
        counts = _summary(name, _device_kernels(prof), wall,
                          {})["epilogue_device_launches"]
        rows[name] = {"remat": remat, "policy": policy,
                      "warm_losses": warm.cpu().tolist(),
                      "losses": losses.cpu().tolist(),
                      "replay_step_ms": 1e3 * dt / K_STEPS,
                      "img_per_s": B * K_STEPS / dt,
                      "first_call_peak_allocated_gib": first_peak,
                      "first_call_peak_above_start_gib":
                      first_peak - alloc0 / gib,
                      "reserved_after_replay_gib": reserved,
                      "reserved_above_start_gib": reserved - reserved0 / gib,
                      "first_call_wrapper_launches": first,
                      "replay_device_launches": counts}
        fwd_n = (96 if remat else 48) * K_STEPS
        want = {"bn_stats": fwd_n, "bn_apply": fwd_n,
                "bn_bwd_stats": 48 * K_STEPS, "bn_bwd_apply": 48 * K_STEPS}
        if first != want or counts != want:
            fail(f"{name}: expected BN launches {want} in the first call "
                 f"and in a replay, got {first} and {counts}")
        if not torch.isfinite(losses).all():
            fail(f"{name}: non-finite loss")
        del tr, net, warm, losses, prof
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = prev_det
    agree = {}
    for name in ("remat", "remat_convs"):
        agree[name] = _agreement(torch, states[name], states["plain"])
    row = {"phase": "resnet_remat", "model": "resnet50_v1 NHWC stem_s2d, "
           "bf16 compute, f32 masters, SGD momentum 0.9 lr 0.05",
           "batch": B, "k_steps": K_STEPS, "runs": rows,
           "agreement_with_plain": {k: {"agreement": a, "worst_err_of_max": w}
                                    for k, (a, w) in agree.items()},
           "card": card}
    emit(row)
    bad = {k: v for k, v in agree.items() if v[0] is None}
    if bad:
        fail(f"remat's state after one replay differs from the plain "
             f"run's: {bad}")
    del states, data, label
    torch.cuda.empty_cache()


# examples/capsnet/capsnet.py
CAPS_SIZE, CAPS_CLS, CAPS_PRIM, CAPS_PRIM_DIM, CAPS_DIM, CAPS_ITERS = \
    16, 10, 4 * 4 * 8, 8, 16, 3
CAPS_BATCH, CAPS_STEPS, CAPS_K = 64, 3, 2


def capsnet_class(mx):
    """``examples/capsnet/capsnet.py``'s CapsNet, over ``mx``."""
    nn = mx.gluon.nn

    class CapsNet(nn.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.conv1 = nn.Conv2D(32, 5, layout="NHWC", in_channels=1,
                                       activation="relu")
                self.prim = nn.Conv2D(CAPS_PRIM_DIM * 8, 5, strides=2,
                                      layout="NHWC", in_channels=32)
            self.W = self.params.get(
                "caps_weight", shape=(CAPS_PRIM, CAPS_CLS * CAPS_DIM,
                                      CAPS_PRIM_DIM))

        @staticmethod
        def squash(F, s, axis):
            n2 = F.sum(F.square(s), axis=axis, keepdims=True)
            return F.broadcast_mul(s, n2 / (1.0 + n2) / F.sqrt(n2 + 1e-9))

        def hybrid_forward(self, F, x, caps_weight):
            h = self.prim(self.conv1(x))
            u = F.reshape(h, shape=(0, -1, CAPS_PRIM_DIM))
            u = self.squash(F, u, axis=2)
            uT = F.transpose(u, axes=(1, 2, 0))
            uh = F.batch_dot(caps_weight, uT)
            uh = F.transpose(uh, axes=(2, 0, 1))
            u_hat = F.reshape(uh, shape=(0, CAPS_PRIM, CAPS_CLS, CAPS_DIM))
            b = F.sum(u_hat * 0.0, axis=3)
            for it in range(CAPS_ITERS):
                c = F.softmax(b, axis=2)
                s = F.sum(F.broadcast_mul(
                    u_hat, F.expand_dims(c, axis=3)), axis=1)
                v = self.squash(F, s, axis=2)
                if it < CAPS_ITERS - 1:
                    b = b + F.sum(F.broadcast_mul(
                        u_hat, F.expand_dims(v, axis=1)), axis=3)
            return F.sqrt(F.sum(F.square(v), axis=2) + 1e-9)

    return CapsNet


def _margin_rows(lengths, y):
    """The example's margin loss per sample, on tensors."""
    pos = (0.9 - lengths).clamp(min=0) ** 2
    neg = (lengths - 0.1).clamp(min=0) ** 2
    return (y * pos + 0.5 * (1.0 - y) * neg).sum(dim=1)


def gluon_user_block(torch, mt, card):
    """CapsNet as MXNet users write it (``params.get``, ``hybrid_forward``
    over ``mx.nd``), f32, TF32 off: CAPS_STEPS ``record()`` / ``backward()``
    / ``gluon.Trainer`` (Adam) steps on the card and on the host from the
    same weights (losses and weights within 1e-3 of each tensor's largest
    value); ``SPMDTrainer.run_steps`` twice (eager K steps and capture,
    then a replay) against 2 K eager steps (bit for bit, or within 1e-3
    where cuDNN picked other algorithms), the ``params.get`` weight moved
    by every run (its gradient reached it); ``save_parameters`` on the card
    and ``load_parameters`` into a fresh host block, bit for bit."""
    import tempfile
    import numpy as np
    mx = mt
    CapsNet = capsnet_class(mx)
    rs = np.random.RandomState(0)
    xs = rs.rand(CAPS_STEPS, CAPS_BATCH, CAPS_SIZE, CAPS_SIZE, 1).astype(
        np.float32)
    ys = np.eye(CAPS_CLS, dtype=np.float32)[
        rs.randint(0, CAPS_CLS, (CAPS_STEPS, CAPS_BATCH))]
    nets = {}
    for dev, ctx in (("cpu", mx.cpu()), ("cuda", mx.gpu(0))):
        with ctx:
            nets[dev] = CapsNet(prefix=f"capsnet_{dev}_")
    nets["cpu"].initialize(mx.init.Xavier(),
                           generator=torch.Generator().manual_seed(0))
    start = {k: p.data().asnumpy() for k, p in
             nets["cpu"]._collect_params_with_prefix().items()}
    for k, p in nets["cuda"]._collect_params_with_prefix().items():
        p.set_data(start[k])
    res = {}
    for dev, net in nets.items():
        ctx = mx.cpu() if dev == "cpu" else mx.gpu(0)
        trainer = mx.gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": 2e-3})
        losses = []
        for x, y in zip(xs, ys):
            with mx.autograd.record():
                lengths = net(mx.nd.array(x, ctx=ctx))
                L = mx.nd.mean(mx.nd.sum(
                    mx.nd.array(y, ctx=ctx) * mx.nd.relu(0.9 - lengths) ** 2
                    + 0.5 * (1.0 - mx.nd.array(y, ctx=ctx))
                    * mx.nd.relu(lengths - 0.1) ** 2, axis=1))
            L.backward()
            trainer.step(CAPS_BATCH)
            losses.append(float(L.asnumpy()))
        res[dev] = (losses, {k: p.data().asnumpy() for k, p in
                             net._collect_params_with_prefix().items()})
    (lc, pc), (lg, pg) = res["cpu"], res["cuda"]
    worst = max(float(np.abs(pg[k] - pc[k]).max())
                / max(float(np.abs(pc[k]).max()), 1e-6) for k in pc)
    loss_err = max(abs(a - b) / max(abs(b), 1e-6) for a, b in zip(lg, lc))
    moved = float(np.abs(pg["caps_weight"] - start["caps_weight"]).max())
    trainer_row = {"losses_card": lg, "losses_host": lc,
                   "worst_param_err_of_max": worst,
                   "worst_loss_rel_err": loss_err,
                   "caps_weight_max_update": moved}
    if not (worst <= 1e-3 and loss_err <= 1e-3 and moved > 0):
        fail(f"CapsNet gluon.Trainer card and host disagree: {trainer_row}")

    # SPMDTrainer: the K-step graph against eager steps
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    data = torch.from_numpy(xs[:CAPS_K]).cuda()
    label = torch.from_numpy(ys[:CAPS_K]).cuda()
    runs = {}
    for how in ("graph", "eager"):
        with mx.gpu(0):
            net = CapsNet(prefix=f"capsnet_{how}_")
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(start[k])
        tr = mt.parallel.SPMDTrainer(
            net, _margin_rows, optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9})
        if how == "graph":
            losses = torch.cat([tr.run_steps(data, label)
                                for _ in range(2)])
        else:
            losses = torch.stack([tr.step(data[k], label[k])
                                  for _ in range(2) for k in range(CAPS_K)])
        torch.cuda.synchronize()
        runs[how] = ({"losses": losses.detach().clone(),
                      **_trainer_state(tr, net)}, len(tr._graphs))
    torch.backends.cudnn.deterministic = prev_det
    (sg, n_graphs), (se, _) = runs["graph"], runs["eager"]
    agree, g_worst = _agreement(torch, sg, se)
    caps = [k for k in sg if k.endswith("param/caps_weight")]
    caps_moved = {how: float((runs[how][0][caps[0]].cpu()
                              - torch.from_numpy(start["caps_weight"]))
                             .abs().max()) for how in runs}
    spmd_row = {"agreement": agree, "worst_err_of_max": g_worst,
                "graphs": n_graphs, "losses_graph": sg["losses"].tolist(),
                "losses_eager": se["losses"].tolist(),
                "caps_weight_max_update": caps_moved}
    if agree is None or n_graphs != 1 or not all(caps_moved.values()):
        fail(f"CapsNet SPMDTrainer graph against eager: {spmd_row}")

    # save_parameters on the card, load_parameters on the host
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "capsnet.params")
        nets["cuda"].save_parameters(path)
        with mx.cpu():
            fresh = CapsNet(prefix="capsnet_fresh_")
        fresh.load_parameters(path)
    got = {k: p.data().asnumpy() for k, p in
           fresh._collect_params_with_prefix().items()}
    saved_bitwise = got.keys() == pg.keys() and all(
        np.array_equal(got[k], pg[k]) for k in pg)
    row = {"phase": "gluon_user_block", "model": "examples/capsnet/"
           f"capsnet.py CapsNet (16x16x1, conv 32, primary caps 128 x 8, "
           f"digit caps 10 x 16, 3 routing iterations), batch {CAPS_BATCH}, "
           "f32, TF32 off", "gluon_trainer": trainer_row,
           "spmd_graph": spmd_row, "save_load_bit_for_bit": saved_bitwise,
           "card": card}
    emit(row)
    if not saved_bitwise:
        fail("save_parameters on the card and load_parameters on the host "
             "are not bit for bit")


# ---------------------------------------------------------------------------
# the dense mx.nd op families: random streams, the flash registry op, the
# SSD detector example and the SSD300 target / decode ops
# ---------------------------------------------------------------------------

RANDOM_DRAWS = 1 << 22
# (op, params, mean, variance, scipy.stats distribution name and args for
# the Kolmogorov-Smirnov test, or None)
RANDOM_CREATION = [
    ("_random_uniform", {"low": -1.0, "high": 3.0}, 1.0, 16 / 12,
     ("uniform", (-1, 4))),
    ("_random_normal", {"loc": 2.0, "scale": 3.0}, 2.0, 9.0,
     ("norm", (2, 3))),
    ("_random_gamma", {"alpha": 2.5, "beta": 2.0}, 5.0, 10.0,
     ("gamma", (2.5, 0, 2.0))),
    ("_random_exponential", {"lam": 4.0}, 0.25, 1 / 16,
     ("expon", (0, 0.25))),
    ("_random_poisson", {"lam": 3.5}, 3.5, 3.5, None),
    ("_random_negative_binomial", {"k": 3, "p": 0.4}, 4.5, 11.25, None),
    ("_random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5},
     2.0, 4.0, None),
    ("_random_randint", {"low": -3, "high": 7}, 1.5, 8.25, None),
]
# the _like ops on a tensor of RANDOM_DRAWS ones, and the _sample_ ops with
# one parameter value (a 1-element array) and RANDOM_DRAWS draws each
RANDOM_LIKE = [
    ("_random_uniform_like", {"low": 1.0, "high": 2.0}, 1.5, 1 / 12),
    ("_random_normal_like", {"loc": -1.0, "scale": 0.5}, -1.0, 0.25),
    ("_random_exponential_like", {"lam": 2.0}, 0.5, 0.25),
    ("_random_gamma_like", {"alpha": 3.0, "beta": 0.5}, 1.5, 0.75),
    ("_random_poisson_like", {"lam": 6.0}, 6.0, 6.0),
    ("_random_negative_binomial_like", {"k": 2, "p": 0.5}, 2.0, 4.0),
    ("_random_generalized_negative_binomial_like",
     {"mu": 3.0, "alpha": 0.25}, 3.0, 5.25),
]
RANDOM_SAMPLE = [
    ("_sample_uniform", (2.0, 6.0), 4.0, 16 / 12),
    ("_sample_normal", (1.0, 2.0), 1.0, 4.0),
    ("_sample_gamma", (2.0, 3.0), 6.0, 18.0),
    ("_sample_exponential", (5.0,), 0.2, 0.04),
    ("_sample_poisson", (2.5,), 2.5, 2.5),
]


def _moments_ok(np, x, mean, var):
    """(mean error / its standard error, variance error / its standard
    error) of the draws ``x`` (float64 numpy)."""
    n = x.size
    m4 = float(np.mean((x - x.mean()) ** 4))
    se_var = max(np.sqrt(max(m4 - x.var() ** 2, 0.0) / n), 1e-300)
    return (abs(x.mean() - mean) / np.sqrt(var / n),
            abs(x.var() - var) / se_var)


def _random_draws(torch, mt):
    """One draw of every rng op on the card (small), for the seed checks."""
    nd = mt.nd
    dev = mt.gpu(0)
    ones = nd.ones((64,), ctx=dev)
    out = [getattr(nd.op, op)(shape=(64,), ctx=dev, **p)
           for op, p, *_ in RANDOM_CREATION]
    out += [getattr(nd.op, op)(ones, **p) for op, p, *_ in RANDOM_LIKE]
    out += [getattr(nd.op, op)(*[nd.array([a], ctx=dev) for a in args],
                               shape=(64,))
            for op, args, *_ in RANDOM_SAMPLE]
    out.append(mt.random.shuffle(nd.arange(64, ctx=dev)))
    out.append(mt.random.multinomial(nd.array([0.2, 0.3, 0.5], ctx=dev),
                                      shape=(64,)))
    return [o.asnumpy() for o in out]


def _dropout_graph_losses(torch, mt, seeds):
    """A Dropout MLP through ``SPMDTrainer.run_steps``' K-step CUDA graph:
    from one start state (weights restored in place before each replay),
    one replay after each ``seed(s)`` of ``seeds``; the (K,) losses of
    each."""
    from mxnet_tpu_torch.gluon import loss as gloss
    nn = mt.gluon.nn
    net = nn.HybridSequential()
    net.add(nn.Dense(256, in_units=64, activation="relu", device="cuda"),
            nn.Dropout(0.5), nn.Dense(8, in_units=256, device="cuda"))
    net.initialize(generator=torch.Generator("cuda").manual_seed(3))
    tr = mt.parallel.SPMDTrainer(net, gloss.L2Loss(),
                                 optimizer_params={"learning_rate": 0.05})
    gen = torch.Generator("cuda").manual_seed(4)
    data = torch.randn((4, 32, 64), generator=gen, device="cuda")
    label = torch.randn((4, 32, 8), generator=gen, device="cuda")
    with mt.autograd.train_mode():
        tr.run_steps(data, label)                # the eager steps + capture
        params = [p.tensor for p in net.collect_params().values()]
        start = [t.detach().clone() for t in params]
        out = []
        for s in seeds:
            with torch.no_grad():
                for t, v in zip(params, start):
                    t.copy_(v)
            mt.random.seed(s)
            out.append(tr.run_steps(data, label).cpu())
    return out


def random_ops_phase(torch, mt):
    """Every rng op on the card at 2^22 draws: moments within 5 standard
    errors, Kolmogorov-Smirnov for uniform / normal / gamma / exponential,
    shuffle a permutation, multinomial frequencies by chi-square; seed(s)
    twice the same draws bit for bit and seed(s + 1) others; the default
    initialize() after seed(1) other weights than after seed(0); a Dropout
    net's K-step graph replays after seed(s) bit for bit alike and after
    seed(s + 1) with other masks."""
    import numpy as np
    from scipy import stats
    nd = mt.nd
    dev = mt.gpu(0)
    rows, bad = [], []

    def check(name, x, mean, var, dist=None):
        zm, zv = _moments_ok(np, x, mean, var)
        row = {"op": name, "n": int(x.size), "mean": float(x.mean()),
               "var": float(x.var()), "z_mean": float(zm),
               "z_var": float(zv)}
        if dist is not None:
            d = getattr(stats, dist[0])(*dist[1])
            row["ks_p"] = float(stats.kstest(x, d.cdf).pvalue)
        rows.append(row)
        if zm > 5 or zv > 5 or row.get("ks_p", 1.0) < 1e-4:
            bad.append(name)

    mt.random.seed(123)
    for op, p, mean, var, dist in RANDOM_CREATION:
        x = getattr(nd.op, op)(shape=(RANDOM_DRAWS,), ctx=dev, **p)
        if x.context != dev:
            fail(f"{op} made its output on {x.context}")
        check(op, x.asnumpy().astype(np.float64), mean, var, dist)
    ones = nd.ones((RANDOM_DRAWS,), ctx=dev)
    for op, p, mean, var in RANDOM_LIKE:
        check(op, getattr(nd.op, op)(ones, **p).asnumpy().astype(
            np.float64), mean, var)
    for op, args, mean, var in RANDOM_SAMPLE:
        x = getattr(nd.op, op)(*[nd.array([a], ctx=dev) for a in args],
                               shape=(RANDOM_DRAWS,))
        check(op, x.asnumpy().reshape(-1).astype(np.float64), mean, var)
    perm = mt.random.shuffle(nd.arange(RANDOM_DRAWS, ctx=dev)).asnumpy()
    is_perm = bool((np.sort(perm) == np.arange(RANDOM_DRAWS)).all()
                   and (perm != np.arange(RANDOM_DRAWS)).any())
    p = np.array([0.1, 0.2, 0.3, 0.4])
    idx = mt.random.multinomial(nd.array(p, ctx=dev),
                                shape=(RANDOM_DRAWS,)).asnumpy()
    chi_p = float(stats.chisquare(np.bincount(idx, minlength=4),
                                  p / p.sum() * RANDOM_DRAWS).pvalue)
    zs, tries = nd.op.sample_unique_zipfian(range_max=1000,
                                            shape=(64, 100), ctx=dev)
    zs = zs.asnumpy()
    zipf_ok = zs.shape == (64, 100) and all(
        len(set(r)) == 100 for r in zs) and \
        bool((tries.asnumpy() >= 100).all())

    mt.random.seed(7)
    a = _random_draws(torch, mt)
    mt.random.seed(7)
    b = _random_draws(torch, mt)
    mt.random.seed(8)
    c = _random_draws(torch, mt)
    same = all(np.array_equal(x, y) for x, y in zip(a, b))
    other = all(not np.array_equal(x, z) for x, z in zip(a, c))

    def dense_init(s):
        mt.random.seed(s)
        net = mt.gluon.nn.Dense(64, in_units=32, device="cuda")
        net.initialize()
        return [p.data().asnumpy() for p in net.collect_params().values()]
    init_differs = not np.array_equal(dense_init(0)[0], dense_init(1)[0])
    init_repeats = np.array_equal(dense_init(1)[0], dense_init(1)[0])
    l1, l2, l3 = _dropout_graph_losses(torch, mt, (11, 11, 12))
    graph_same = bool(torch.equal(l1, l2))
    graph_other = not bool(torch.equal(l1, l3))

    row = {"phase": "random_ops", "draws": RANDOM_DRAWS, "ops": rows,
           "failed": bad, "shuffle_is_permutation": is_perm,
           "multinomial_chi2_p": chi_p, "unique_zipfian_ok": zipf_ok,
           "seed_repeats_bitwise": same, "next_seed_differs": other,
           "init_after_seed1_differs": init_differs,
           "init_repeats": init_repeats,
           "graph_replays_after_seed_bitwise": graph_same,
           "graph_replay_after_next_seed_differs": graph_other,
           "graph_losses": [l1.tolist(), l2.tolist(), l3.tolist()],
           "what": "every rng op on the card (default generator of the "
                   "card), moments within 5 standard errors, KS p > 1e-4"}
    emit(row)
    if bad or not (is_perm and chi_p > 1e-4 and zipf_ok and same and other
                   and init_differs and init_repeats and graph_same
                   and graph_other):
        fail(f"random ops on the card: {row}")


def flash_registry_phase(torch, mt, fa):
    """``mx.nd.contrib.flash_attention`` at the LM shape (B 8, T 2048,
    H 8, D 64, causal) in bf16 and f32, forward and backward under
    ``autograd.record()``: the tensor-core route for bf16 and the general
    route for f32 read off the launch counters; the output held to the
    plain version at flash_phase's tolerance and the gradients to the
    plain attention's (the backward recomputes through it); the launches
    of the driven run."""
    from mxnet_tpu_torch.parallel.ring_attention import attention
    nd, ag = mt.nd, mt.autograd
    b, t, h, d = TF_BATCH, TF_T, 8, 64
    scale = 1.0 / d ** 0.5
    gen = torch.Generator(device="cuda").manual_seed(21)
    out_rows, launched = [], {}
    for dtype, route in ((torch.bfloat16, "tc"), (torch.float32, "general")):
        q, k, v = (torch.randn((b, t, h, d), generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        head = torch.randn((b, t, h, d), generator=gen,
                           device="cuda").to(dtype)
        xs = [nd.from_torch(x.clone()) for x in (q, k, v)]
        for x in xs:
            x.attach_grad()
        before = dict(fa.launches)
        with ag.record():
            out = nd.contrib.flash_attention(*xs, causal=True)
        out.backward(nd.from_torch(head))
        torch.cuda.synchronize()
        counts = {n: fa.launches[n] - before[n] for n in fa.launches}
        launched[route] = counts[f"flash_fwd_{route}"]
        want = fa._flash_plain(q, k, v, True, scale)
        tol = flash_tolerance(torch, route, want, v)
        err = (out.tensor.detach().float() - want.float()).abs()
        ok_out = bool((err <= tol).all())
        qkv = [x.detach().requires_grad_() for x in (q, k, v)]
        ref = attention(*qkv, causal=True, scale=scale)
        grads = torch.autograd.grad(ref, qkv, head)
        gerr = max(float((x.grad.tensor.float() - g.float()).abs().max())
                   for x, g in zip(xs, grads))
        gscale = max(float(g.float().abs().max()) for g in grads)
        row = {"dtype": str(dtype).split(".")[-1], "route": route,
               "launches": counts, "max_abs_err": float(err.max()),
               "within_tolerance": ok_out, "grad_max_abs_err": gerr,
               "grad_max_abs": gscale}
        out_rows.append(row)
        emit({"phase": "flash_registry", **row})
        del xs, out, want, qkv, ref, grads
        torch.cuda.empty_cache()
        if counts[f"flash_fwd_{route}"] != 1 or counts["flash_fwd"] != 1 \
                or not ok_out or gerr > 1e-6 * max(gscale, 1.0):
            fail(f"flash_registry: {row}")
    return launched, out_rows


# examples/ssd/train_ssd.py's settings
SSD_SIZES, SSD_RATIOS = (0.3, 0.45), (1.0, 2.0)
SSD_ANCHORS = len(SSD_SIZES) + len(SSD_RATIOS) - 1
SSD_BATCH, SSD_ITERS, SSD_LR = 8, 8, 0.05


def ssd_synthetic_batch(np, rs, batch, size=32):
    """The example's data: images each with one bright square, labelled
    with its box."""
    data = rs.rand(batch, 3, size, size).astype(np.float32) * 0.1
    labels = np.zeros((batch, 1, 5), np.float32)
    for i in range(batch):
        w = rs.randint(8, 16)
        x0 = rs.randint(0, size - w)
        y0 = rs.randint(0, size - w)
        data[i, :, y0:y0 + w, x0:x0 + w] = 1.0
        labels[i, 0] = [0, x0 / size, y0 / size, (x0 + w) / size,
                        (y0 + w) / size]
    return data, labels


def ssd_net(mx):
    """The example's backbone and two heads, in one container."""
    nn = mx.gluon.nn
    net = nn.HybridSequential(prefix="ssd_")
    with net.name_scope():
        backbone = nn.HybridSequential()
        backbone.add(nn.Conv2D(16, 3, 2, 1, activation="relu"),
                     nn.Conv2D(32, 3, 2, 1, activation="relu"))
        net.add(backbone, nn.Conv2D(SSD_ANCHORS * 2, 3, padding=1),
                nn.Conv2D(SSD_ANCHORS * 4, 3, padding=1))
    return net


def ssd_heads(mx, net, x):
    nd = mx.nd
    feat = net[0](x)
    anchors = nd.contrib.MultiBoxPrior(feat, sizes=SSD_SIZES,
                                       ratios=SSD_RATIOS)
    b = x.shape[0]
    cp = net[1](feat).reshape((b, SSD_ANCHORS * 2, -1)).reshape((b, 2, -1))
    bp = net[2](feat).reshape((b, -1))
    return anchors.reshape((1, -1, 4)), cp, bp


def ssd_example_phase(torch, mt):
    """examples/ssd/train_ssd.py at its settings (batch 8, 8 iterations,
    lr 0.05, seed 0) on the card and on the host from the same weights:
    losses per step within 1e-4 relative, the last below the first, and
    the same detection rows kept by MultiBoxDetection."""
    import numpy as np
    nd, ag = mt.nd, mt.autograd
    gloss = mt.gluon.loss
    rs = np.random.RandomState(0)
    batches = [ssd_synthetic_batch(np, rs, SSD_BATCH)
               for _ in range(SSD_ITERS)]
    res = {}
    weights = None
    for key, ctx in (("host", mt.cpu()), ("card", mt.gpu(0))):
        with ctx:
            mt.random.seed(0)
            net = ssd_net(mt)
            net.initialize(mt.init.Xavier())
            ssd_heads(mt, net, nd.array(batches[0][0]))
            params = net._collect_params_with_prefix()
            if weights is None:
                weights = {k: p.data().asnumpy() for k, p in params.items()}
            else:
                for k, v in weights.items():
                    params[k].set_data(v)
            trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                       {"learning_rate": SSD_LR})
            cls_loss, l1_loss = gloss.SoftmaxCrossEntropyLoss(), \
                gloss.L1Loss()
            losses = []
            t0 = time.perf_counter()
            for data_np, labels_np in batches:
                x, labels = nd.array(data_np), nd.array(labels_np)
                with ag.record():
                    anchors, cp, bp = ssd_heads(mt, net, x)
                    with ag.pause():
                        bt, bm, ct = nd.contrib.MultiBoxTarget(anchors,
                                                               labels, cp)
                    loss = cls_loss(nd.transpose(cp, axes=(0, 2, 1)),
                                    ct).mean() + \
                        l1_loss(bp * bm, bt).mean()
                loss.backward()
                trainer.step(SSD_BATCH)
                losses.append(float(loss.asscalar()))
            wall = time.perf_counter() - t0
            anchors, cp, bp = ssd_heads(mt, net, x)
            det = nd.contrib.MultiBoxDetection(nd.softmax(cp, axis=1), bp,
                                               anchors).asnumpy()
            res[key] = (losses, det, wall)
    (lh, dh, wh), (lg, dg, wg) = res["host"], res["card"]
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(lg, lh))
    kept_h, kept_g = dh[..., 0] >= 0, dg[..., 0] >= 0
    same_rows = bool((kept_h == kept_g).all())
    row_err = float(np.abs(dg - dh)[kept_h & kept_g].max()) \
        if (kept_h & kept_g).any() else 0.0
    row = {"phase": "ssd_example", "losses_card": lg, "losses_host": lh,
           "max_rel_loss_diff": rel, "kept_card": int(kept_g.sum()),
           "kept_host": int(kept_h.sum()), "same_rows_kept": same_rows,
           "kept_row_max_abs_diff": row_err, "train_s_card": wg,
           "train_s_host": wh, "what": "batch 8, 8 iterations, lr 0.05, "
           "seed 0; card vs host from the same weights, f32, TF32 off"}
    emit(row)
    if rel > 1e-4 or not lg[-1] < lg[0] or not same_rows \
            or not kept_g.any() or row_err > 1e-4:
        fail(f"ssd_example: {row}")


# MXNet example/ssd's VGG16-reduced SSD300 (symbol_factory.py): six maps
SSD300_MAPS = (38, 19, 10, 5, 3, 1)
SSD300_SIZES = ((.1, .141), (.2, .272), (.37, .447), (.54, .619),
                (.71, .79), (.88, .961))
SSD300_RATIOS = ((1, 2, .5), (1, 2, .5, 3, 1 / 3), (1, 2, .5, 3, 1 / 3),
                 (1, 2, .5, 3, 1 / 3), (1, 2, .5), (1, 2, .5))
SSD300_STEPS = tuple(s / 300 for s in (8, 16, 32, 64, 100, 300))
SSD300_CLASSES, SSD300_BATCH, SSD300_MAX_GT = 21, 32, 16
SSD300_TARGET = {"overlap_threshold": 0.5, "negative_mining_ratio": 3,
                 "negative_mining_thresh": 0.5, "ignore_label": -1}
SSD300_DETECT = {"nms_threshold": 0.45, "nms_topk": 400, "threshold": 0.01}


def ssd300_inputs(np):
    """Ground truth (1-16 boxes an image), class predictions and box
    offsets from one seed."""
    rs = np.random.RandomState(300)
    labels = np.full((SSD300_BATCH, SSD300_MAX_GT, 5), -1, np.float32)
    for i in range(SSD300_BATCH):
        for j in range(rs.randint(1, SSD300_MAX_GT + 1)):
            x0, y0 = rs.uniform(0, 0.8, 2)
            w, h = rs.uniform(0.05, 0.5, 2)
            labels[i, j] = [rs.randint(0, SSD300_CLASSES - 1), x0, y0,
                            min(x0 + w, 1.0), min(y0 + h, 1.0)]
    n = sum(m * m * (len(s) + len(r) - 1) for m, s, r in
            zip(SSD300_MAPS, SSD300_SIZES, SSD300_RATIOS))
    logits = rs.randn(SSD300_BATCH, SSD300_CLASSES, n).astype(np.float32)
    prob = np.exp(logits * 2)
    prob = (prob / prob.sum(1, keepdims=True)).astype(np.float32)
    loc = (rs.randn(SSD300_BATCH, n * 4) * 0.5).astype(np.float32)
    return labels, logits, prob, loc


def ssd300_anchors(mt, ctx):
    nd = mt.nd
    parts = []
    for m, s, r, st in zip(SSD300_MAPS, SSD300_SIZES, SSD300_RATIOS,
                           SSD300_STEPS):
        parts.append(nd.contrib.MultiBoxPrior(
            nd.zeros((1, 1, m, m), ctx=ctx), sizes=s, ratios=r,
            steps=(st, st)))
    return nd.concat(*parts, dim=1)


def _iou64(np, a, b):
    tl = np.maximum(a[..., :2], b[..., :2])
    br = np.minimum(a[..., 2:4], b[..., 2:4])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area = lambda x: np.clip(x[..., 2] - x[..., 0], 0, None) * \
        np.clip(x[..., 3] - x[..., 1], 0, None)          # noqa: E731
    return inter / np.maximum(area(a) + area(b) - inter, 1e-12)


def _target_margins(np, anchors, labels, flips):
    """|best IoU - 0.5| (float64) of each anchor whose match flipped."""
    out = []
    for bi, a in zip(*flips):
        lab = labels[bi][labels[bi][:, 0] >= 0]
        best = _iou64(np, anchors[a][None].astype(np.float64),
                      lab[:, 1:5].astype(np.float64)).max()
        out.append(abs(best - 0.5))
    return out


def _detection_margins(np, host_rows, card_rows, flips, thr):
    """For each kept row that flipped: the least |IoU - thr| (float64)
    against the earlier rows of its class, from the two decodings' boxes
    (the rows are in the same score order on both)."""
    out = []
    for bi, j in zip(*flips):
        rows = np.where(host_rows[bi][:, :1] >= 0, host_rows[bi],
                        card_rows[bi]).astype(np.float64)
        cls = rows[j, 0]
        earlier = rows[:j][rows[:j, 0] == cls]
        if not len(earlier):
            out.append(float("inf"))
            continue
        out.append(float(np.abs(_iou64(np, earlier[:, 2:6],
                                       rows[j, 2:6][None]) - thr).min()))
    return out


def ssd300_decode_phase(torch, mt):
    """MultiBoxPrior, MultiBoxTarget and MultiBoxDetection at SSD300's
    widths (8732 anchors, 21 classes, batch 32): median ms of 10 calls
    after a warm-up and the peak memory above the phase's start; card
    against host on the same inputs, targets within 1e-5 and the same
    kept detection rows with coordinates within 1e-5 (a flipped row
    passes only with the IoU margin of its decision, under 1e-6)."""
    import numpy as np
    nd = mt.nd
    labels, logits, prob, loc = ssd300_inputs(np)
    out = {}
    for key, ctx in (("host", mt.cpu()), ("card", mt.gpu(0))):
        with ctx:
            anchors = ssd300_anchors(mt, ctx)
            lab, cp, pr, lp = (nd.array(a) for a in (labels, logits, prob,
                                                     loc))
            tgt = nd.contrib.MultiBoxTarget(anchors, lab, cp,
                                            **SSD300_TARGET)
            det = nd.contrib.MultiBoxDetection(pr, lp, anchors,
                                               **SSD300_DETECT)
            out[key] = ([t.asnumpy() for t in tgt], det.asnumpy(),
                        anchors.asnumpy())
    # timing and memory on the card
    dev = mt.gpu(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with dev:
        lab, cp, pr, lp = (nd.array(a) for a in (labels, logits, prob, loc))
        anchors = ssd300_anchors(mt, dev)
        calls = {
            "MultiBoxPrior": lambda: ssd300_anchors(mt, dev),
            "MultiBoxTarget": lambda: nd.contrib.MultiBoxTarget(
                anchors, lab, cp, **SSD300_TARGET),
            "MultiBoxDetection": lambda: nd.contrib.MultiBoxDetection(
                pr, lp, anchors, **SSD300_DETECT)}
        ms = {}
        for name, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            ts = []
            for _ in range(10):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append(1e3 * (time.perf_counter() - t0))
            ms[name] = float(np.median(ts))
    peak = torch.cuda.max_memory_allocated() - base
    (th, dh, ah), (tg, dg, ag_) = out["host"], out["card"]
    n = ah.shape[1]
    anchor_err = float(np.abs(ag_ - ah).max())
    # targets: the same matches, encodings within 1e-5
    flips = np.nonzero((th[2] != tg[2]) |
                       (th[1].reshape(SSD300_BATCH, n, 4)[..., 0] !=
                        tg[1].reshape(SSD300_BATCH, n, 4)[..., 0]))
    t_margins = _target_margins(np, ah[0], labels, flips)
    same = np.repeat((th[2] == tg[2])[..., None], 4, -1).reshape(
        SSD300_BATCH, -1)
    target_err = float(np.abs(tg[0] - th[0])[same].max())
    # detections: the same kept rows, coordinates within 1e-5
    kh, kg = dh[..., 0] >= 0, dg[..., 0] >= 0
    dflips = np.nonzero(kh != kg)
    d_margins = _detection_margins(np, dh, dg, dflips,
                                   SSD300_DETECT["nms_threshold"])
    both = kh & kg
    det_err = float(np.abs(dg - dh)[both].max())
    row = {"phase": "ssd300_decode", "anchors": int(n),
           "batch": SSD300_BATCH, "classes": SSD300_CLASSES,
           "gt_boxes": int((labels[..., 0] >= 0).sum()),
           "ms_median": ms, "peak_bytes_above_start": int(peak),
           "anchor_max_abs_diff": anchor_err,
           "target_max_abs_diff": target_err,
           "target_flips": len(t_margins),
           "target_flip_margins": t_margins,
           "positives_host": int((th[2] > 0).sum()),
           "kept_host": int(kh.sum()), "kept_card": int(kg.sum()),
           "detection_max_abs_diff": det_err,
           "detection_flips": len(d_margins),
           "detection_flip_margins": d_margins,
           "what": "SSD300 (VGG16-reduced, MXNet example/ssd settings), "
                   "card vs host on the same inputs, f32; ms = host clock "
                   "around each call ending in torch.cuda.synchronize()"}
    emit(row)
    if n != 8732 or anchor_err > 1e-5 or target_err > 1e-5 \
            or det_err > 1e-5 or any(m >= 1e-6 for m in t_margins) \
            or any(m >= 1e-6 for m in d_margins) or not kh.any():
        fail(f"ssd300_decode: {row}")
    return row


# ---------------------------------------------------------------------------
# the input pipeline: mx.nd.image, RecordIO, the record iterators,
# gluon.data, and the ImageNet example fed from records
# ---------------------------------------------------------------------------

IMG_BATCH = (128, 256, 256, 3)    # NHWC uint8, seed 0
A20_RECORDS, A20_SIDE, A20_CROP = 640, 256, 224
# examples/image_classification/train_imagenet.py:52-53
IMAGENET_MEAN_STD = dict(mean_r=123.68, mean_g=116.779, mean_b=103.939,
                         std_r=58.393, std_g=57.12, std_b=57.375)
# gluon's ToTensor scale ([0, 1]) of the same statistics
GLUON_MEAN = (0.485, 0.456, 0.406)
GLUON_STD = (0.229, 0.224, 0.225)
A20_WARM, A20_TIMED = 2, 4


def _median_ms(torch, fn, iters=5):
    times = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return sorted(times)[len(times) // 2]


def _flip_share(torch, io_, op, axis, calls=1000):
    """Share of ``calls`` random flips of a tiny image that flipped, and
    whether every output was the image or its flip."""
    x = torch.arange(12, dtype=torch.uint8, device="cuda").reshape(2, 2, 3)
    outs = torch.stack([op(x) for _ in range(calls)]).cpu()
    x, f = x.cpu(), torch.flip(x.cpu(), (axis,))
    flipped = (outs == f).flatten(1).all(1)
    same = (outs == x).flatten(1).all(1)
    return float(flipped.float().mean()), bool((flipped | same).all())


def image_ops_phase(torch, mt):
    """Each of the 14 ``_image_*`` ops on the card against the same op on
    the host, on an NHWC uint8 (128, 256, 256, 3) batch from seed 0: the
    elementwise ops bit for bit, contrast / color jitter within 1 (uint8;
    the jitter's linear stages together and its hue alone),
    resize to 224 within 1 in uint8 and 1e-3 of 255 in f32 (the first 16
    images), bilinear, bicubic and nearest. The random ops run on
    degenerate ranges; the color jitter's factors are drawn on the card
    and handed to the host; the flips' coin share over 1,000 calls. Card
    ms: the median of 5 calls, host clock ended by ``synchronize()``."""
    import numpy as np
    from mxnet_tpu_torch.ops import image_ops as io_
    host = torch.from_numpy(np.random.RandomState(0).randint(
        0, 256, IMG_BATCH).astype(np.uint8))
    card = host.cuda()
    host16 = host[:16].float()
    card16 = host16.cuda()
    rows = []

    def check(name, card_fn, host_fn, tol, exact, note=None):
        got = card_fn()
        torch.cuda.synchronize()
        want = host_fn()
        err = float((got.cpu().double() - want.double()).abs().max())
        row = {"phase": "image_ops", "op": name, "shape": list(got.shape),
               "dtype": str(got.dtype)[6:], "max_abs_err": err,
               "tolerance": 0.0 if exact else tol,
               "ms": _median_ms(torch, card_fn)}
        if note:
            row["note"] = note
        rows.append(row)
        emit(row)
        if (exact and err != 0.0) or err > tol:
            fail(f"image_ops: {name} card against host {err} "
                 f"(tolerance {0.0 if exact else tol})")

    t_card = io_._image_to_tensor(card)
    t_host = io_._image_to_tensor(host)
    check("_image_to_tensor", lambda: io_._image_to_tensor(card),
          lambda: t_host, 0.0, True)
    norm = dict(mean=GLUON_MEAN, std=GLUON_STD)
    check("_image_normalize", lambda: io_._image_normalize(t_card, **norm),
          lambda: io_._image_normalize(t_host, **norm), 0.0, True)
    del t_card, t_host
    for name in ("_image_flip_left_right", "_image_flip_top_bottom"):
        fn = getattr(io_, name)
        check(name, lambda: fn(card), lambda: fn(host), 0.0, True)
    for name, axis in (("_image_random_flip_left_right", 2),
                       ("_image_random_flip_top_bottom", 1)):
        fn = getattr(io_, name)
        flips = torch.flip(host, (axis,))
        out = fn(card).cpu()
        err = min(float((out.int() - host.int()).abs().max()),
                  float((out.int() - flips.int()).abs().max()))
        share, valid = _flip_share(torch, io_, fn, axis - 1)
        row = {"phase": "image_ops", "op": name, "shape": list(out.shape),
               "dtype": "uint8", "max_abs_err": err,
               "tolerance": 0.0, "ms": _median_ms(torch, lambda: fn(card)),
               "flip_share_1000_calls": share}
        rows.append(row)
        emit(row)
        # 0.5 within 5 standard errors of 1,000 fair coins
        if err != 0.0 or not valid or abs(share - 0.5) > 0.08:
            fail(f"image_ops: {name} gave {err} against x / flip(x), "
                 f"share {share}, valid {valid}")
    del flips, out
    degenerate = (("_image_random_brightness", 1.3, 0.0, True),
                  ("_image_random_contrast", 0.7, 1.0, False),
                  ("_image_random_saturation", 1.4, 0.0, True),
                  ("_image_random_hue", 0.2, 0.0, True))
    for name, f, tol, exact in degenerate:
        fn = getattr(io_, name)
        check(name, lambda: fn(card, min_factor=f, max_factor=f),
              lambda: fn(host, min_factor=f, max_factor=f), tol, exact,
              f"min_factor = max_factor = {f}")
    # the jitter's own path (factors drawn on the card in the op's order,
    # stages in its fixed order) in two well-conditioned settings: the
    # three linear stages together, and hue alone on the uint8 image. Hue
    # after stages that push f32 values past 255 is ill-conditioned in
    # the JAX op's HLS round trip itself (s = diff / (2 - vmax - vmin)
    # with l near 1), where the card and the host part by tens.
    gen = torch.Generator(device="cuda")
    for jitter in (dict(brightness=0.4, contrast=0.4, saturation=0.4),
                   dict(hue=0.1)):
        gen.manual_seed(5)
        state = gen.get_state()
        factors = io_.jitter_factors(
            jitter.get("brightness", 0.0), jitter.get("contrast", 0.0),
            jitter.get("saturation", 0.0), jitter.get("hue", 0.0), gen,
            card.device)
        host_factors = {k: v.cpu() for k, v in factors.items()}

        def jitter_card():
            gen.set_state(state)
            return io_._image_random_color_jitter(card, generator=gen,
                                                  **jitter)

        check(f"_image_random_color_jitter {'+'.join(jitter)}",
              jitter_card, lambda: io_.color_jitter(host, host_factors),
              1.0, False, "factors drawn on the card, the host applies "
              "them: " + json.dumps({k: float(v) for k, v in
                                     host_factors.items()}))
    alpha = (0.1, -0.2, 0.3)
    check("_image_adjust_lighting",
          lambda: io_._image_adjust_lighting(card, alpha=alpha),
          lambda: io_._image_adjust_lighting(host, alpha=alpha), 0.0, True)
    check("_image_random_lighting",
          lambda: io_._image_random_lighting(card, alpha_std=0.0),
          lambda: io_._image_random_lighting(host, alpha_std=0.0), 0.0,
          True, "alpha_std = 0")
    for interp, method in ((1, "bilinear"), (2, "bicubic"), (0, "nearest")):
        kw = dict(size=A20_CROP, interp=interp)
        check(f"_image_resize {method}",
              lambda: io_._image_resize(card, **kw),
              lambda: io_._image_resize(host, **kw), 1.0, False,
              "uint8, 256 -> 224")
        check(f"_image_resize {method} f32",
              lambda: io_._image_resize(card16, **kw),
              lambda: io_._image_resize(host16, **kw), 1e-3 * 255, False,
              "float32, the first 16 images, 256 -> 224")
    emit({"phase": "image_ops", "ops": len({r["op"].split()[0]
                                            for r in rows}),
          "rows": len(rows)})
    return rows


def _splitmix_permutations(np, n, seed, epochs):
    """The native pipeline's shuffle (src/recordio.cc ShuffleOffsets) in
    numpy uint64: each epoch's order of range(n)."""
    golden = np.uint64(0x9E3779B97F4A7C15)
    order = list(range(n))
    out = []
    with np.errstate(over="ignore"):
        for epoch in range(epochs):
            x = np.uint64(seed) + golden * np.uint64(epoch + 1)
            for i in range(n, 1, -1):
                x = x + golden
                z = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
                z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
                z = z ^ (z >> np.uint64(31))
                j = int(z % np.uint64(i))
                order[i - 1], order[j] = order[j], order[i - 1]
            out.append(list(order))
    return out


def write_records(np, mt, tmp):
    """640 records of 256x256x3 uint8 images (npy payloads) with labels,
    both from seed 1; (rec path, images, labels)."""
    import io as _io
    rs = np.random.RandomState(1)
    labels = rs.randint(0, 1000, A20_RECORDS)
    images = rs.randint(0, 256, (A20_RECORDS, A20_SIDE, A20_SIDE, 3),
                        dtype=np.uint8)
    rec = os.path.join(tmp, "train.rec")
    w = mt.recordio.MXIndexedRecordIO(os.path.join(tmp, "train.idx"), rec,
                                      "w")
    for i in range(A20_RECORDS):
        buf = _io.BytesIO()
        np.save(buf, images[i])
        w.write_idx(i, mt.recordio.pack(
            mt.recordio.IRHeader(0, float(labels[i]), i, 0), buf.getvalue()))
    w.close()
    return rec, images, labels


def record_iter(mt, rec, **kw):
    """train_imagenet.py's ImageRecordIter at this run's settings."""
    args = dict(path_imgrec=rec, data_shape=(3, A20_CROP, A20_CROP),
                batch_size=B, shuffle=True, rand_crop=True,
                rand_mirror=True, preprocess_threads=8, **IMAGENET_MEAN_STD)
    args.update(kw)
    return mt.io.ImageRecordIter(**args)


def _epoch_rate(torch, batches):
    """(img/s, batches) of draining ``batches``, each batch's arrays
    synchronized on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = []
    for b in batches:
        out.append(b)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = sum(int((b.data[0] if hasattr(b, "data") else b[0]).shape[0])
            for b in out)
    return n / dt, out


def input_pipeline_phase(torch, mt, tmp):
    """RecordIO through the card: the records written, RecordPipeline's
    shuffled order against the splitmix64 permutation over two epochs,
    img/s of ImageRecordIter (train_imagenet.py's settings, 8 decode
    threads) and of the DataLoader over ImageRecordDataset with the gluon
    transforms, 8 forked workers and pinned staging, and with no workers;
    each checked against a host reference on a small part."""
    import numpy as np
    from mxnet_tpu_torch.gluon.data import DataLoader
    from mxnet_tpu_torch.gluon.data.vision import ImageRecordDataset
    from mxnet_tpu_torch.gluon.data.vision import transforms as T
    from mxnet_tpu_torch.io.record_io import RecordPipeline
    t0 = time.perf_counter()
    rec, images, labels = write_records(np, mt, tmp)
    write_s = time.perf_counter() - t0
    rec_bytes = os.path.getsize(rec)

    # the pipeline's order: record ids over two shuffled epochs
    pipe = RecordPipeline(rec, num_threads=8, shuffle=True, seed=0)
    orders = []
    for _ in range(2):
        ids = []
        while True:
            r = pipe.next()
            if r is None:
                break
            ids.append(mt.recordio.unpack(r)[0].id)
        orders.append(ids)
        pipe.reset()
    pipe.close()
    want = _splitmix_permutations(np, A20_RECORDS, 0, 2)
    if orders != want:
        fail("RecordPipeline's shuffled order is not the native "
             "pipeline's splitmix64 permutation")

    # ImageRecordIter: a deterministic batch against numpy, then img/s
    check_it = record_iter(mt, rec, shuffle=False, rand_crop=False,
                           rand_mirror=False)
    b0 = check_it.next()
    off = (A20_SIDE - A20_CROP) // 2
    mean = np.asarray([IMAGENET_MEAN_STD[k] for k in
                       ("mean_r", "mean_g", "mean_b")], np.float32)
    std = np.asarray([IMAGENET_MEAN_STD[k] for k in
                      ("std_r", "std_g", "std_b")], np.float32)
    ref = ((images[:B, off:off + A20_CROP, off:off + A20_CROP]
            .astype(np.float32) - mean) / std).transpose(0, 3, 1, 2)
    iter_err = float(np.abs(b0.data[0].asnumpy() - ref).max())
    if b0.data[0].context.device_type != "gpu" or iter_err > 1e-5 \
            or not np.array_equal(b0.label[0].asnumpy(),
                                  labels[:B].astype(np.float32)):
        fail(f"ImageRecordIter's center-cropped batch: {iter_err} from "
             "numpy, or its labels / device differ")
    check_it.close()
    it = record_iter(mt, rec)
    first_rate, _ = _epoch_rate(torch, it)
    it.reset()
    iter_rate, batches = _epoch_rate(torch, it)
    it.close()
    # the same with one intra-op thread: 8 decode threads each running
    # PyTorch's CPU ops on an OpenMP team of the core count oversubscribe
    # the host (set process-wide for this epoch only, then restored)
    intra = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        it1 = record_iter(mt, rec)
        intra1_rate, _ = _epoch_rate(torch, it1)
        it1.close()
    finally:
        torch.set_num_threads(intra)
    shapes = {tuple(b.data[0].shape) for b in batches}
    if shapes != {(B, 3, A20_CROP, A20_CROP)} or any(
            not torch.isfinite(b.data[0]._data).all() for b in batches):
        fail(f"ImageRecordIter batches: shapes {shapes} or non-finite")
    del batches

    # DataLoader over the records with the gluon transforms
    tf = T.Compose([T.RandomResizedCrop(A20_CROP), T.RandomFlipLeftRight(),
                    T.ToTensor(), T.Normalize(GLUON_MEAN, GLUON_STD)])
    ds = ImageRecordDataset(rec).transform_first(tf)
    rates = {}
    for workers in (8, 0):
        loader = DataLoader(ds, batch_size=B, num_workers=workers,
                            pin_memory=workers > 0, last_batch="discard")
        rate, out = _epoch_rate(torch, loader)
        if workers:
            rates["workers_8_first_epoch"] = rate
            rate, out = _epoch_rate(torch, loader)
        rates[f"workers_{workers}"] = rate
        devs = {str(x.context) for b in out for x in b}
        lab = np.concatenate([b[1].asnumpy() for b in out])
        data_ok = all(tuple(b[0].shape) == (B, 3, A20_CROP, A20_CROP)
                      and bool(torch.isfinite(b[0]._data).all())
                      for b in out)
        if devs != {"gpu(0)"} or not data_ok or not np.array_equal(
                lab, labels[:len(lab)].astype(np.float32)):
            fail(f"DataLoader(num_workers={workers}): devices {devs}, "
                 "shapes / finiteness or labels wrong")
        del out
    row = {"phase": "input_pipeline", "records": A20_RECORDS,
           "image": [A20_SIDE, A20_SIDE, 3], "rec_bytes": rec_bytes,
           "write_s": write_s,
           "pipeline_order": "splitmix64 permutation, 2 epochs: equal",
           "image_record_iter": {
               "img_per_s": iter_rate, "first_epoch_img_per_s": first_rate,
               "img_per_s_one_intraop_thread": intra1_rate,
               "intraop_threads": intra,
               "preprocess_threads": 8, "batch": B,
               "center_crop_batch_max_abs_err": iter_err},
           "dataloader": {"img_per_s_8_workers_pinned":
                          rates["workers_8"],
                          "first_epoch_img_per_s_8_workers":
                          rates["workers_8_first_epoch"],
                          "img_per_s_no_workers": rates["workers_0"],
                          "batch": B, "device": "gpu(0)"}}
    emit(row)
    return rec, row


def imagenet_example_phase(torch, mt, card, rec):
    """train_imagenet.py's record path in the port: resnet50_v1 NHWC with
    the space-to-depth stem, bf16 with f32 masters, SGD momentum 0.9 lr
    0.05 wd 1e-4, batch 128, ``SPMDTrainer.step`` fed by the
    ImageRecordIter of input_pipeline (the batch transposed to NHWC on the
    card): 2 warm-up steps, 4 timed (the BN kernels counted, 48 a step
    each), one profiled; then the same trainer on one batch already on the
    card, 4 timed steps."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    net = resnet50_v1(layout="NHWC", stem_s2d=True)
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
    trainer = mt.parallel.SPMDTrainer(
        net, gloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
        optimizer_params={"learning_rate": 0.05, "momentum": 0.9,
                          "wd": 1e-4}, dtype=torch.bfloat16)
    it = record_iter(mt, rec)

    def batch():
        try:
            b = it.next()
        except StopIteration:
            it.reset()
            b = it.next()
        return (b.data[0]._data.permute(0, 2, 3, 1).contiguous(),
                b.label[0]._data)

    def fed():
        return trainer.step(*batch())

    warm = [float(fed()) for _ in range(A20_WARM)]
    torch.cuda.synchronize()
    tk.reset_launches()
    t0 = time.perf_counter()
    losses = [fed() for _ in range(A20_TIMED)]
    torch.cuda.synchronize()
    fed_dt = time.perf_counter() - t0
    launches = dict(tk.launches)
    losses = [float(v) for v in losses]
    x0, y0 = batch()
    trainer.step(x0, y0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = [trainer.step(x0, y0) for _ in range(A20_TIMED)]
    torch.cuda.synchronize()
    staged_dt = time.perf_counter() - t0
    staged = [float(v) for v in staged]
    prof, wall = _profiled(torch, fed)
    summary = _summary(f"resnet50_v1: one SPMDTrainer.step fed by "
                       f"ImageRecordIter (next() included), batch {B}, "
                       "bf16", _device_kernels(prof), wall, None)
    it.close()
    row = {"phase": "imagenet_example",
           "model": "resnet50_v1 NHWC stem_s2d", "batch": B,
           "dtype": "bf16 compute, f32 masters",
           "optimizer": "sgd lr 0.05 momentum 0.9 wd 1e-4",
           "fed": {"step_ms": 1e3 * fed_dt / A20_TIMED,
                   "img_per_s": B * A20_TIMED / fed_dt,
                   "losses": losses, "warmup_losses": warm,
                   "wrapper_launches": launches},
           "pre_staged": {"step_ms": 1e3 * staged_dt / A20_TIMED,
                          "img_per_s": B * A20_TIMED / staged_dt,
                          "losses": staged},
           "profiled_fed_step": {
               "wall_ms": summary["wall_ms"],
               "device_busy_ms": summary["device_busy_ms"],
               "device_idle_share": summary["device_idle_share"],
               "epilogue_device_launches":
                   summary["epilogue_device_launches"]},
           "card": card}
    emit(row)
    if not all(np_isfinite(v) for v in warm + losses + staged):
        fail("imagenet_example: non-finite loss")
    if not 0.0 < warm[0] < 20.0:
        fail(f"imagenet_example: first loss {warm[0]} is not that of a "
             "fresh 1000-class model")
    if any(launches[k] != 48 * A20_TIMED for k in KERNELS):
        fail(f"imagenet_example: expected {48 * A20_TIMED} launches of "
             f"each BN kernel over {A20_TIMED} fed steps: {launches}")
    if any(n != 48 for n in summary["epilogue_device_launches"].values()):
        fail("imagenet_example: expected 48 device launches of each BN "
             f"kernel in the profiled step: "
             f"{summary['epilogue_device_launches']}")
    return launches, row


def np_isfinite(v):
    return v == v and abs(v) != float("inf")


def a20_phases(torch, mt, card, timed):
    """image_ops, input_pipeline and imagenet_example, the records in one
    temporary directory removed afterwards."""
    import shutil
    import tempfile
    timed("image_ops", image_ops_phase, torch, mt)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="mxt_rec_")
    try:
        rec, _ = timed("input_pipeline", input_pipeline_phase, torch, mt,
                       tmp)
        launches, _ = timed("imagenet_example", imagenet_example_phase,
                            torch, mt, card, rec)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


PLANES_ENV = ("MXTPU_OPTIMIZER_AGGREGATION", "MXTPU_MEGASTEP",
              "MXTPU_NUMERICS", "MXTPU_EFFICIENCY", "MXTPU_RUN_REPORT_DIR",
              "MXTPU_MEM_DUMP_DIR", "MXTPU_DEVICE_PEAK", "MXTPU_AUTOTUNE")
PLANES_ON = {"MXTPU_NUMERICS": "on,every=2", "MXTPU_EFFICIENCY": "on"}
PLANES_PLAN, PLANES_SCALE = "nan_grad@5", 128.0
PLANES_TRACE = (7, 9)   # the trace starts after step 7, stops after 9
PLANES_FENCE = "10"     # run_compare's noise fence, percent


def measure_peaks(torch):
    """The card's f32 matmul FLOP/s (8192^3, TF32 off), bf16 matmul FLOP/s
    (8192^3) and device-to-device copy bytes/s (1 GiB read and 1 GiB
    written), each from CUDA events over repeated calls after a warm-up."""
    n = 8192

    def per_call(fn, reps):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / 1e3 / reps

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    a = torch.randn((n, n), generator=gen, device="cuda")
    b = torch.randn((n, n), generator=gen, device="cuda")
    t32 = per_call(lambda: torch.mm(a, b), 5)
    a16, b16 = a.bfloat16(), b.bfloat16()
    t16 = per_call(lambda: torch.mm(a16, b16), 20)
    del a, b, a16, b16
    src = torch.empty(2 ** 30, dtype=torch.uint8, device="cuda")
    dst = torch.empty_like(src)
    tc = per_call(lambda: dst.copy_(src), 10)
    del src, dst
    torch.backends.cuda.matmul.allow_tf32 = prev
    torch.cuda.empty_cache()
    return {"f32_matmul_flops_per_s": 2 * n ** 3 / t32,
            "bf16_matmul_flops_per_s": 2 * n ** 3 / t16,
            "copy_bytes_per_s": 2 * 2 ** 30 / tc,
            "how": "8192^3 torch.mm f32 (TF32 off) x5 and bf16 x20; "
                   "1 GiB device copy x10 (read + write); CUDA events"}


def resnet_matmul_flops(torch, mt, net, x):
    """Forward FLOPs of the convolutions and the dense layer of one
    inference forward on ``x``, from the layers' shapes (2 x multiply-adds
    each: 2 x output elements x weight elements per output channel), and
    the stem convolution's (the first to run) with its weight's name."""
    from mxnet_tpu_torch.gluon.nn import Conv2D, Dense
    seen = []

    def hook(mod, _inp, out):
        w = [p for k, p in mod.collect_params().items()
             if k.endswith("weight")][0]
        seen.append((w.name, 2 * out.numel() * w.tensor.numel()
                     // w.tensor.shape[0]))
    hs = [m.register_forward_hook(hook) for m in net.modules()
          if isinstance(m, (Conv2D, Dense))]
    try:
        with mt.autograd.pause():
            net(x)
    finally:
        for h in hs:
            h.remove()
    return sum(f for _, f in seen), seen[0][1], seen[0][0]


def telemetry_planes(torch, mt, card, tmp):
    """The rest of the telemetry (the numerics and efficiency planes, the
    program costs, the metrics registry, run reports, the autotuner,
    mx.profiler) on ResNet-50 v1 at published widths, 224x224, f32, batch
    32, TF32 off, deterministic cuDNN: fit_train's FitLoop route
    (get_model("resnet50_v1", layout="NHWC"), hybridized, gluon.Trainer
    sgd momentum, DeviceStagingIter, 2 epochs = 16 steps), all runs from
    one start and one data order, loss scale 128 and chaos nan_grad@5:
    (a) planes off, composed; (b) MXTPU_NUMERICS=on,every=2,
    MXTPU_EFFICIENCY=on, MXTPU_RUN_REPORT_DIR, composed, with a
    start_xla_trace window over steps 8-9; (c) as (b) under
    MXTPU_MEGASTEP=on (two graphs: the stats variant and the plain one);
    (d) a repeat of (b); (e) MXTPU_AUTOTUNE=on,probe=2,warmup=1, composed.
    The card's f32 and bf16 matmul FLOP/s and its copy bandwidth are
    measured first and set as MXTPU_DEVICE_PEAK. Checked: (b), (c), (d)
    and (e) bit for bit (weights, momenta, losses) against (a); step 5
    skipped and its numerics_*.json naming the parameter nan_grad
    poisoned (the trainer's first trainable one in name order, the stem
    BatchNorm's beta);
    sampled windows at steps 0, 2, ..., 14; FLOPs a step of (b) and (c)
    within 1 % of each other and within 2 % of the analytic count (the
    forward convolution and dense FLOPs x 3, less the stem's input
    gradient); MFU below 1; the BN kernels' reported bytes equal to
    kernel_cost.site_bytes_flops over the 48 f32 sites; run_compare on
    (b) and (d) exits 0 with equal loss hashes; the registry's
    Prometheus text; (e)'s tuning report and restored environment; 48
    device launches of each BN kernel a step in the trace; the wrappers'
    launches: 48 a step in the composed runs, 96 in all under the
    megastep (the two graphs' eager first steps). Printed: the ledger
    plus the programs' temp bytes against memory_allocated() after step
    7 of (b), and the phase's wall."""
    import gc
    import glob
    import subprocess
    import numpy as np
    from mxnet_tpu_torch import profiler
    from mxnet_tpu_torch.contrib import chaos
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    from mxnet_tpu_torch.ops import kernel_cost
    from mxnet_tpu_torch.telemetry import memory as tmem
    from mxnet_tpu_torch.telemetry.registry import default_registry
    t_phase = time.perf_counter()
    saved = {k: os.environ.get(k) for k in PLANES_ENV}
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    bad = []
    try:
        peaks = measure_peaks(torch)
        emit({"phase": "telemetry_planes", "what": "peaks", "card": card,
              **peaks})
        os.environ["MXTPU_DEVICE_PEAK"] = (
            f"flops={peaks['f32_matmul_flops_per_s']!r},"
            f"bw={peaks['copy_bytes_per_s']!r}")
        os.environ["MXTPU_OPTIMIZER_AGGREGATION"] = "4"
        rng = np.random.default_rng(1)
        X = rng.random((FIT_IMAGES, IMG, IMG, 3), dtype=np.float32)
        Y = rng.integers(0, 1000, FIT_IMAGES).astype(np.float32)
        lossfn = gloss.SoftmaxCrossEntropyLoss()

        def run(name, env, on_step_end=None, mid=None):
            for k in PLANES_ENV:
                if k not in ("MXTPU_OPTIMIZER_AGGREGATION",
                             "MXTPU_DEVICE_PEAK"):
                    os.environ.pop(k, None)
            os.environ.update(env)
            if mid is not None:
                gc.collect()
                torch.cuda.synchronize()
                mid["base"] = torch.cuda.memory_allocated()
            net = get_model("resnet50_v1", layout="NHWC")
            net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
            net.hybridize()
            trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                       dict(GT_OPT), kvstore="device")
            itr = mt.io.DeviceStagingIter(mt.io.NDArrayIter(
                X, Y, batch_size=GT_BATCH, shuffle=True, seed=13))
            loop = mt.fit.FitLoop(net, trainer, lossfn, itr,
                                  loss_scale=PLANES_SCALE,
                                  on_step_end=on_step_end)
            chaos.install(PLANES_PLAN)
            gc.collect()
            torch.cuda.synchronize()
            tk.reset_launches()
            t = time.perf_counter()
            try:
                res = loop.fit(epochs=FIT_EPOCHS)
            finally:
                chaos.uninstall()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            out = {"res": res, "wall_s": wall, "launches": dict(tk.launches),
                   "state": _fit_state(torch, net, trainer), "net": net,
                   "first": next(p.name for p in trainer._params
                                 if p.grad_req != "null")}
            del trainer, loop, itr
            return out

        a = run("a", {})
        xb = mt.nd.array(X[:GT_BATCH])
        fwd, stem, stem_w = resnet_matmul_flops(torch, mt, a["net"], xb)
        analytic = 3 * fwd - stem
        del a["net"], xb
        mid = {}

        def in_b(step, _loss):
            if step == PLANES_TRACE[0]:
                torch.cuda.synchronize()
                mid.update(
                    allocated=torch.cuda.memory_allocated(),
                    ledger=tmem.ledger().summary(),
                    programs=[{k: r.get(k) for k in (
                        "kind", "label", "temp_bytes", "output_bytes",
                        "argument_bytes", "held_bytes")}
                        for r in tmem.program_report()])
                profiler.start_xla_trace(os.path.join(tmp, "trace"))
            elif step == PLANES_TRACE[1]:
                mid["trace"] = profiler.stop_xla_trace()

        planes = dict(PLANES_ON)
        runs = {"a": a}
        for name, extra, hook in (
                ("b", {}, in_b), ("c", {"MXTPU_MEGASTEP": "on"}, None),
                ("d", {}, None)):
            env = dict(planes, MXTPU_RUN_REPORT_DIR=os.path.join(
                tmp, f"reports_{name}"),
                MXTPU_MEM_DUMP_DIR=os.path.join(tmp, f"dumps_{name}"),
                **extra)
            runs[name] = run(name, env, hook, mid if hook else None)
            del runs[name]["net"]
        runs["e"] = run("e", {"MXTPU_AUTOTUNE": "on,probe=2,warmup=1"})
        del runs["e"]["net"]
        agg_after = os.environ.get("MXTPU_OPTIMIZER_AGGREGATION")
        gc.collect()
        torch.cuda.empty_cache()

        # bit for bit against (a), the plane-off run
        for name in "bcde":
            diff = _not_bitwise(torch, runs[name]["state"], a["state"])
            if diff or runs[name]["res"].losses != a["res"].losses:
                bad.append(f"{name}: not bit for bit with (a): {diff[:4]}")
        steps = FIT_STEPS
        want_launch = {"a": 48 * steps, "b": 48 * steps, "c": 96,
                       "d": 48 * steps, "e": 48 * steps}
        for name, n in want_launch.items():
            got = runs[name]["launches"]
            if any(v != n for v in got.values()):
                bad.append(f"{name}: wrapper launches {got}, want {n}")
        rows = {}
        for name in "bcd":
            res = runs[name]["res"]
            num, eff = res.numerics, res.efficiency
            dumps = sorted(glob.glob(os.path.join(
                tmp, f"dumps_{name}", "numerics_*.json")))
            culprit = json.load(open(dumps[-1]))["culprit"] if dumps \
                else None
            rows[name] = {
                "skipped_steps": res.skipped_steps,
                "culprit": culprit and culprit["name"],
                "sampled_steps": [r["step"] for r in num["recent"]],
                "grad_norm_last": num.get("grad_norm"),
                "flops_per_step": eff["flops_per_step"],
                "bytes_per_step": eff["bytes_per_step"],
                "mfu": eff["mfu"], "bw_util": eff["bw_util"],
                "achieved_flops_per_s": eff["achieved_flops_per_s"],
                "achieved_bytes_per_s": eff["achieved_bytes_per_s"],
                "samples_per_s": eff["samples_per_s"],
                "roofline": eff["roofline"], "estimate": eff["estimate"],
                "per_program": [{k: p[k] for k in ("kind", "label",
                                                   "flops",
                                                   "bytes_accessed",
                                                   "dispatches")}
                                for p in eff["per_program"]],
                "wall_s": runs[name]["wall_s"],
                "median_step_ms": 1e3 * float(np.median(
                    [r["wall"] for r in res.step_breakdown["per_step"]])),
                "run_report": res.run_report}
            r = rows[name]
            if r["skipped_steps"] != [5]:
                bad.append(f"{name}: skipped {r['skipped_steps']}")
            # nan_grad poisons the trainer's first trainable parameter
            # (natural name order), the one the plane must name
            r["poisoned"] = runs[name]["first"]
            if r["culprit"] != r["poisoned"]:
                bad.append(f"{name}: culprit {r['culprit']!r}, poisoned "
                           f"{r['poisoned']!r}")
            if r["sampled_steps"] != list(range(0, steps, 2)):
                bad.append(f"{name}: sampled {r['sampled_steps']}")
            if abs(r["flops_per_step"] - analytic) > 0.02 * analytic:
                bad.append(f"{name}: {r['flops_per_step']} FLOPs a step, "
                           f"analytic {analytic}")
            if not 0 < r["mfu"] < 1 or r["estimate"]:
                bad.append(f"{name}: mfu {r['mfu']} estimate "
                           f"{r['estimate']}")
        fb, fc = rows["b"]["flops_per_step"], rows["c"]["flops_per_step"]
        if abs(fb - fc) > 0.01 * fb:
            bad.append(f"FLOPs a step: composed {fb}, megastep {fc}")
        # the BN kernels' reported bytes a step against the formula over
        # the 48 f32 sites
        kb = {}
        for prog in tmem.program_report():
            if prog["kind"] != "cached_op":
                continue
            for k, v in (prog.get("kernels") or {}).items():
                kb[k] = kb.get(k, 0.0) + v["bytes"]
        want_kb = {k: float(sum(kernel_cost.site_bytes_flops(
            k, r, c, 4, res_)[0] * m for r, c, res_, m in path_sites(
                GT_BATCH))) for k in KERNELS}
        if kb != want_kb:
            bad.append(f"BN reported bytes {kb}, formula {want_kb}")
        # run_compare on (b) and (d)
        cmp_ = subprocess.run(
            [sys.executable, os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "tools", "run_compare.py"),
             rows["b"]["run_report"], rows["d"]["run_report"], "--fence",
             PLANES_FENCE, "--json"], capture_output=True, text=True)
        rb, rd = (json.load(open(rows[n]["run_report"])) for n in "bd")
        if cmp_.returncode != 0 or \
                rb["loss"]["sha256_16"] != rd["loss"]["sha256_16"]:
            bad.append(f"run_compare rc {cmp_.returncode}: "
                       f"{cmp_.stdout[-400:]} {cmp_.stderr[-400:]}")
        prom = default_registry().render_prometheus()
        need = ("mxtpu_mfu", "mxtpu_numerics_grad_norm",
                "mxtpu_numerics_nonfinite_steps_total", "mxtpu_loss_scale",
                'mxtpu_compile_total{kind="graph_capture"}',
                'mxtpu_compile_total{kind="nvcc"}',
                "mxtpu_autotune_probe_steps_total",
                "mxtpu_autotune_chosen_agg")
        from mxnet_tpu_torch.ops import _build
        if not _build.build_seconds:    # nothing was built in this process
            need = tuple(k for k in need if "nvcc" not in k)
        missing = [k for k in need if k not in prom]
        if missing:
            bad.append(f"prometheus lacks {missing}")
        tune = runs["e"]["res"].tuning_report
        if tune["status"] != "locked" or agg_after != "4":
            bad.append(f"autotune {tune['status']}, aggregation after "
                       f"{agg_after!r}")
        # the trace window: steps 8 and 9 of (b)
        trace = json.load(open(mid["trace"]))["traceEvents"]
        dev = [e for e in trace if e.get("cat") == "kernel"]
        in_trace = {k: sum(1 for e in dev if v in e.get("name", ""))
                    for k, v in _KERNEL_NAMES.items()}
        if any(v != 2 * 48 for v in in_trace.values()):
            bad.append(f"trace: BN kernels {in_trace}, want 96 each")
        # this run's bytes: allocated after step 7 less what was allocated
        # before its net was built (earlier phases' and runs' tensors)
        ours = mid["allocated"] - mid["base"]
        ledger = mid["ledger"]["live_bytes"]
        # the block's forward and backward programs (activations and
        # workspaces live there)
        progs = [p for p in mid["programs"] if p["kind"] == "cached_op"]
        temp = sum(int(p.get("temp_bytes") or 0) for p in progs)
        gap = {"allocated_bytes": mid["allocated"],
               "allocated_before_build_bytes": mid["base"],
               "run_allocated_bytes": ours,
               "ledger_bytes": ledger,
               "ledger_by_category": mid["ledger"]["by_category"],
               "run_allocated_over_ledger": ours / ledger,
               "programs_temp_bytes": temp, "programs": progs,
               "left_bytes": ours - ledger,
               "left_after_temp_bytes": ours - ledger - temp}
        launches = {k: sum(runs[n]["launches"][k] for n in runs)
                    for k in KERNELS}
        emit({"phase": "telemetry_planes", "card": card,
              "config": "resnet50-fitloop-planes-f32-b32",
              "peaks": peaks, "device_peak": os.environ.get(
                  "MXTPU_DEVICE_PEAK"),
              "analytic_flops_per_step": analytic,
              "forward_matmul_flops": fwd, "stem_flops": stem,
              "stem_weight": stem_w, "runs": rows,
              "wall_s": {n: runs[n]["wall_s"] for n in runs},
              "median_step_ms": {n: 1e3 * float(np.median(
                  [r["wall"] for r in runs[n]["res"].step_breakdown[
                      "per_step"]])) for n in runs},
              # steps 2-15 but 5: the sampled (even) and unsampled (odd)
              # numerics steps apart
              "median_even_odd_ms": {n: [1e3 * float(np.median(
                  [r["wall"] for i, r in enumerate(runs[n][
                      "res"].step_breakdown["per_step"])
                   if i >= 2 and i != 5 and i % 2 == k])) for k in (0, 1)]
                  for n in runs},
              "step_ms": {n: [round(1e3 * r["wall"], 3) for r in runs[n][
                  "res"].step_breakdown["per_step"]] for n in runs},
              "mfu_at_median_step": {n: rows[n]["flops_per_step"]
                                     / (rows[n]["median_step_ms"] / 1e3)
                                     / peaks["f32_matmul_flops_per_s"]
                                     for n in rows},
              "bn_reported_bytes_per_step": kb,
              "bn_formula_bytes_per_step": want_kb,
              "run_compare": json.loads(cmp_.stdout) if cmp_.stdout
              else cmp_.stderr,
              "tuning_report": tune, "trace_bn_launches": in_trace,
              "memory_after_step_7": gap, "launches": launches,
              "launches_by_run": {n: runs[n]["launches"] for n in runs},
              "prometheus_lines": len(prom.splitlines()),
              "phase_wall_s": time.perf_counter() - t_phase,
              "failures": bad})
    finally:
        torch.backends.cudnn.deterministic = prev_det
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if bad:
        fail("telemetry_planes: " + "; ".join(bad))
    return launches


def fit_phases(torch, mt, card, gluon_row, timed):
    """fit_reference, fit_train, megastep_train and telemetry_planes,
    their files in one temporary directory removed afterwards; the BN
    kernels' launches of fit_train's run, of the megastep's profiled
    epoch and of the telemetry_planes runs."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="mxt_fit_")
    try:
        timed("fit_reference", fit_reference, torch, mt, tmp)
        launches, fit_row = timed("fit_train", fit_train, torch, mt, card,
                                  gluon_row, tmp)
        mega_launches, _ = timed("megastep_train", megastep_train, torch,
                                 mt, card, fit_row, tmp)
        torch.cuda.empty_cache()
        planes_launches = timed("telemetry_planes", telemetry_planes, torch,
                                mt, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, mega_launches, planes_launches


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
                                torch, mt, card, torch.bfloat16)
    timed("transformer_profile", profile_transformer_step, torch, *run)
    del run
    torch.cuda.empty_cache()
    # the LM's default configuration (f32): the general flash route
    general_launches, run = timed("transformer_train_f32", transformer_main,
                                  torch, mt, card)
    timed("transformer_profile_f32", profile_transformer_step, torch, *run,
          "f32")
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
    fit_launches, mega_launches, planes_launches = fit_phases(
        torch, mt, card, gluon_row, timed)
    # ResNet-50 v1 in f16 (the BN kernels' f16 instances), after every
    # earlier phase
    totals_f16 = timed("kernel_f16", kernel_f16_phase, torch, tk)
    trainer, data, label = timed("train_f16", main_path, torch, mt, card,
                                 torch.float16)
    launched_f16 = timed("profile_f16", profile_phase, torch, trainer, data,
                         label, "resnet50_v1", "f16")
    del trainer, data, label
    torch.cuda.empty_cache()
    # the MoE LM, remat and Gluon's user blocks, after every earlier phase
    timed("transformer_moe_reference", transformer_moe_reference, torch, mt)
    moe_launches = timed("transformer_moe_train", transformer_moe_train,
                         torch, mt, card)
    timed("resnet_remat", resnet_remat, torch, mt, card)
    timed("gluon_user_block", gluon_user_block, torch, mt, card)
    # the dense mx.nd op families, after every earlier phase
    timed("random_ops", random_ops_phase, torch, mt)
    registry_launches, _ = timed("flash_registry", flash_registry_phase,
                                 torch, mt, fa)
    torch.cuda.empty_cache()
    timed("ssd_example", ssd_example_phase, torch, mt)
    timed("ssd300_decode", ssd300_decode_phase, torch, mt)
    torch.cuda.empty_cache()
    # the input pipeline and the ImageNet example, after every earlier
    # phase
    fed_launches = a20_phases(torch, mt, card, timed)
    v2 = ("resnet_v2_reference", "v2_graph", "train_v2", "profile_v2",
          "v2_plain_batchnorm")
    gluon = ("trainer_reference", "optimizer_ops", "gluon_train",
             "kernel_f32")
    fits = ("fit_reference", "fit_train", "megastep_train",
            "telemetry_planes")
    f16 = ("kernel_f16", "train_f16", "profile_f16")
    moe_remat = ("transformer_moe_reference", "transformer_moe_train",
                 "resnet_remat", "gluon_user_block")
    a19 = ("random_ops", "flash_registry", "ssd_example", "ssd300_decode")
    a20 = ("image_ops", "input_pipeline", "imagenet_example")
    emit({"phase": "walls", "seconds": walls,
          "total_s": sum(walls.values()),
          "earlier_phases_s": sum(v for k, v in walls.items()
                                  if k not in v2 + gluon + fits + f16
                                  + moe_remat + a19 + a20),
          "a20_phases_s": sum(walls[k] for k in a20),
          "a19_phases_s": sum(walls[k] for k in a19),
          "moe_remat_user_block_phases_s": sum(walls[k] for k in moe_remat),
          "v2_phases_s": sum(walls[k] for k in v2),
          "gluon_trainer_phases_s": sum(walls[k] for k in gluon),
          "fit_phases_s": sum(walls[k] for k in fits),
          "f16_phases_s": sum(walls[k] for k in f16)})

    kernels = []
    for name, replaces in KERNELS.items():
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
            "f16": {"launches": launched_f16[name],
                    "max_abs_err": totals_f16[name]["max_abs_err"],
                    "ms": totals_f16[name]["ms"],
                    "plain_ms": totals_f16[name]["plain_ms"],
                    "bound_ms": totals_f16[name]["bound_ms"],
                    "bound_by": "bytes" if totals_f16[name]["bound_by"]
                    == {"bytes"} else "operations",
                    "library_ms": totals_f16[name]["library_ms"],
                    "per": f"one ResNet-50 v1 step (48 sites, batch {B}, "
                           "f16); launches: device count over one replay "
                           f"of the {K_STEPS}-step f16 graph"},
            "megastep": {"launches": mega_launches[name],
                         "launches_per_step": mega_launches[name]
                         / (FIT_IMAGES // GT_BATCH),
                         "per": "device launches in one profiled FitLoop "
                                "epoch (8 steps) under MXTPU_MEGASTEP=on, "
                                "every step one CUDA graph replay"},
            "planes": {"launches": planes_launches[name],
                       "per": "wrapper launches over telemetry_planes' "
                              "five 16-step FitLoop runs (the megastep "
                              "run's two eager first steps only)"},
            "data_fed": {"launches": fed_launches[name],
                         "per": f"wrapper launches over the {A20_TIMED} "
                                "timed imagenet_example steps fed by "
                                "ImageRecordIter (bf16, batch "
                                f"{B})"}})
    tcr, gnr = flash["tc"], flash["general"]
    kernels.append({
        "name": "flash_fwd", "route": "cuda", "source": FLASH_SOURCE,
        "replaces": FLASH_REPLACES, "launches": flash_launches,
        "max_abs_err": tcr["max_abs_err"], "ms": tcr["ms"],
        "plain_ms": tcr["plain_ms"], "bound_ms": tcr["bound_ms"],
        "bound_share": tcr["bound_share"],
        "bound_by": tcr["bound_by"], "library_ms": tcr["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention",
        "kernel_route": "tc", "entry": "mxt_flash_fwd_tc",
        "tflops": tcr["tflops"], "general_ms": tcr["general_ms"],
        "general_bound_ms": tcr["general_bound_ms"],
        "general_bound_by": tcr["general_bound_by"],
        "general_bound_share": tcr["general_bound_share"],
        "general_design_floor_ms": tcr["general_design_floor_ms"],
        "general_library_ms": tcr["general_library_ms"],
        "launches_moe": moe_launches,
        "launches_registry": registry_launches["tc"],
        "other_shapes": tcr["other_shapes"],
        "max_abs_err_all_cases": flash["max_abs_err"],
        "per": f"one launch (B {TF_BATCH}, T {TF_T}, H 8, D 64, causal, "
               f"bf16); launches over {TF_K_STEPS} bf16 train steps, all on "
               "the tensor-core route"})
    kernels.append({
        "name": "flash_fwd_general", "route": "cuda",
        "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
        "launches": general_launches, "max_abs_err": gnr["max_abs_err"],
        "ms": gnr["ms"], "plain_ms": gnr["plain_ms"],
        "bound_ms": gnr["bound_ms"], "bound_share": gnr["bound_share"],
        "bound_by": gnr["bound_by"], "library_ms": gnr["library_ms"],
        "library": "torch.nn.functional.scaled_dot_product_attention, f32",
        "library_kernels": gnr["library_kernels"],
        "library_tf32": gnr["library_tf32"],
        "kernel_route": "general", "entry": "mxt_flash_fwd",
        "tflops": gnr["tflops"],
        "bound_f32_fma_ms": gnr["bound_f32_fma_ms"],
        "launches_registry": registry_launches["general"],
        "per": f"one launch (B {TF_BATCH}, T {TF_T}, H 8, D 64, causal, "
               f"f32; bound as 3xTF32); launches over {TF_K_STEPS} train "
               "steps of the default (f32) TransformerConfig(), all on the "
               "general route"})
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
