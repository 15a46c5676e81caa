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
    batch 32 as ``examples/gluon/image_classification.py`` runs it,
    hybridized (its CachedOp captures the forward and backward graphs at
    the first step): one untimed step and 10 timed replays (img/s, ms a
    step split into forward, backward and ``trainer.step`` on the host
    and on the device, peak memory; 48 wrapper launches of each BN kernel
    in the capturing step, none in the replays), a profiled step (idle
    share, 48 device launches of each BN kernel, 16 residual
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
    over ``DeviceStagingIter(NDArrayIter(192 random images, seed 13))``
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
14e. then ``cached_op``, a real CachedOp behind ``hybridize()``: a small
    channel-last ResNetV1 (12 fused sites) and a hybridized user block
    over ``mx.nd.contrib.flash_attention`` (f32 general route, bf16
    tensor-core route) against the same blocks un-hybridized: inference
    and 3 training steps (outputs, losses, gradients, updated weights,
    moving statistics, momenta) bit for bit or within 1e-3 of each
    tensor's largest value, no wrapper call in a warm step and 12 device
    launches of each BN kernel in its replay, the expected cache hits and
    misses, a new capture when ``MXTPU_FUSED_EPILOGUE`` toggles, a fresh
    capture (never a stale replay) after a parameter's storage is
    rebound, the BN ticket counters back at 0; and ``serving``:
    ``get_model("resnet50_v1", layout="NHWC")`` at full size (224x224x3
    f32 items) behind ``serving.ModelServer`` with its defaults (max batch
    32, buckets 1-32, 5 ms, queue depth 256): ``warmup()`` of every
    bucket (capture ms each), 8 clients x 64 single images with 1 worker
    and with 2 (img/s, p50 / p99, mean batch and fill, the card's idle
    share, no cache miss after warmup, every response against an eager
    forward of its padded batch within 1e-3), padding rows inert,
    ``serve_slow`` delaying a dispatch while expired requests are never
    dispatched, eager against replay ms at batch 1 and 32, and
    ``examples/serving/resnet_server.py`` under the port's names (its
    ``--smoke`` path, and its zoo path up to the SIGTERM drain, exit 75);
14i. then ``dist_train``, data-parallel training over
    ``torch.distributed``: (a) in a child (``chip_smoke.py
    --nccl-check``, beside (b)) a one-rank NCCL group, every collective of
    ``parallel/collectives.py`` on CUDA tensors against its definition
    and the tiled reduce-scatter route taken; (b) two ranks sharing the
    card over gloo (``python -m mxnet_tpu_torch.launch -n 2 python3
    chip_smoke.py --dist-rank DIR``), each training
    ``get_model("resnet50_v1", layout="NHWC")`` hybridized, f32 batch 32
    a rank from its own seed, TF32 off, deterministic cuDNN, sgd lr 0.05
    momentum 0.9 over ``mx.kv.create("dist_sync")``, DT_STEPS steps in
    each of: the default buckets, ``MXTPU_ZERO=1``, ZeRO with
    ``MXTPU_COMM_OVERLAP=on``, and 2-bit compression (threshold 0.05):
    both ranks' weights bit for bit alike and equal to a one-process
    reference on the card (both ranks' batches through two copies of the
    net, each keeping its BatchNorm statistics, the gradients summed
    g0 + g1, through the port's compressor in the last variant), each
    rank's running statistics its reference copy's, 48 wrapper launches
    of each BN kernel a rank (the capturing step) and 48 device launches
    a rank in a profiled forward and backward; ms a step, comm ms, peak
    allocation and ZeRO's optimizer-state share a rank; (c) the megastep
    at ``MXTPU_ZERO_WORLD=4`` on the megastep cell's net (4 FitLoop
    steps) bit for bit against the composed ZeRO step; (d)
    ``examples/distributed_training/cifar10_dist.py`` as two ranks with
    ``mxnet_tpu`` resolved to the port (``chip_smoke.py
    --example-rank``), both printing DONE;
14j. then ``fleet_train``, the self-healing fleet (``python -m
    mxnet_tpu_torch.launch -n 2 --supervise ... python3 chip_smoke.py
    --fleet-rank DIR``): FitLoop on dist_train's hybridized ResNet-50 v1,
    f32, the global batch 64 at every world (32 a rank at world 2),
    checkpoints every 2 steps, 20 steps, ``MXTPU_COLL_HEALTH=1`` and a
    4 s watchdog; one supervised run takes (a) chaos ``kill@5`` on rank 1
    (the supervisor shrinks to 1, its spot model returns the slot 50 s
    after the kill, it grows back to 2 from step 8, where generation 1
    holds) and (b) chaos ``kv_hang:1`` three steps later (rank 0's flight
    record names rank 1, the supervisor shrinks on it): worlds 2, 1, 2, 1
    from steps 0, 4, 8, 10; the final weights bit for bit those of plain
    launches over the same world schedule from the same checkpoint steps;
    detection, relaunch and restore ms, steps redone, ms a step at world
    2 and 1; (c), beside the reference launches, two epochs under
    ``MXTPU_ZERO=1`` at world 2 with every step sampled by the numerics
    plane and ``nan_grad@1``: both ranks' merged records alike and equal
    to a one-process reference of step 0 (counts and maxima exactly, sums
    1e-6), one culprit, run reports with ``world_size`` 2, 48 device
    launches of each BN kernel a rank in FitLoop's step 2 (profiled); (d)
    a zero restart budget fails with the forensic bundle;
14k. then ``mesh_lm``, the meshes (``chip_smoke.py --mesh-rank DIR``,
    two ranks over gloo): ``TransformerConfig()`` in bf16 at B 8, T 2048,
    three ``make_train_step`` steps on {tp: 2}, {sp: 2} (ring attention),
    {dp: 2}, the pipeline step on {pp: 2} (2 microbatches), the MoE LM on
    {ep: 2}, each against the one-process step on the card: in bf16 the
    losses within 1e-4 and the gathered weights within 2e-2, and again in
    f32 at lr 0.1 with losses, weights and updates within 1e-4; flash 4
    launches a step at H 4 a rank under tp, none under sp;
    ``SPMDTrainer(mesh={dp: 2})`` on ResNet-50 v1 batch 64 a rank, the
    halves from different distributions, in bf16 and f32, with
    global-batch BatchNorm statistics (the first step's batch moments and
    weight updates within 4x the rounding floor, the one-process step on
    the batch of 128 with its halves swapped; a per-rank control must
    miss), 48 launches of each BN
    kernel a rank a step, ``run_steps`` eager; ms a step a rank, wire
    bytes a step, peak memory against the one-process step, and the
    flash kernel at the tp shape (H 4) with its bound and SDPA's time;
14l. then the sparse phases (A11) and the int8 / symbol phases (A13),
    each described in its function's docstring, then ``serving_fleet``
    (A23, see its docstring): the registry, FleetServer
    hot-swap of full-width ResNet-50 under load with the AOT signature
    bundle, FleetRouter over replica processes on the card (a SIGKILL
    with 24 requests in flight, a scale-up with no kernel build and no
    signature miss, a rolling deploy, drain exit 75), the causal
    self-attention model served on the tensor-core flash route,
    ``make_scan_forward`` and the lookup tier; then ``rnn_lm``
    (A14's recurrent stack, see its docstring): the fused RNN op card
    against host at the word LM's widths in every mode,
    ``examples/rnn/word_language_model.py``'s model at its full medium
    width (vocab 10000, 650 / 650, 2 layers, bptt 35, batch 32, dropout
    0.5) trained eagerly and as CUDA graph replays, ``mx.rnn`` through
    the Executor with ``BucketSentenceIter``, the four recurrent recipes
    and ``gluon.loss.CTCLoss``; it adds no kernel;
14m. and last A14's symbolic training surface and graph features (each
    phase's docstring has its gates; no kernel is added, the BN kernels
    are reached through the Executor): ``module_resnet50``,
    ``mx.mod.Module`` training the exported full-width ResNet-50 v1 NHWC
    symbol (a step against a Gluon Trainer step, 48 device launches of
    each BN kernel in a profiled step, ``Module.fit`` with
    ``module_checkpoint`` and a bit-for-bit resume, step ms against the
    Gluon step); ``bucketing_lm``, ``BucketingModule`` at the word LM's
    widths over four buckets (card against host, one storage per
    parameter, the loss falling, ms a step a bucket) and the recipes
    ``examples/rnn/bucketing.py`` and
    ``examples/image_classification/train_mnist.py`` on the card;
    ``graph_features``, a foreach LSTM against the fused RNN op,
    ``mx.nd.contrib`` control flow and a ``Custom`` op in a hybridized
    block card against host, and ``optimize_for`` on the ResNet-50
    symbol bit for bit the unpartitioned graph;
15. the wall seconds of every phase (a ``wall`` line after each, a
    ``walls`` line with the totals, ``rnn_lm``'s under
    ``a14_rnn_phases_s``, the three A14 module phases' under
    ``a14_module_phases_s``), the ``{"kernels": [...]}`` summary
    (the BN kernels' times are per ResNet-50 v1 training step, the sum
    over the 48 call sites, with the v2 step's sums and launches under
    ``v2``, the f32 Gluon step's under ``f32``, the FitLoop's under
    ``fit``, the megastep's replays under ``megastep``, the f16 step's
    under ``f16``, the ImageRecordIter-fed steps' under ``data_fed``,
    the small hybridized net's replayed step under ``cached_op`` and a
    rank's profiled step of ``dist_train`` under ``dist_train``, the
    fleet's under ``fleet_train``, the dp mesh's under ``mesh_dp`` and
    ``Module.fit``'s wrapper launches under ``module``;
    flash_fwd's (the tensor-core route) per launch at the
    bf16 path's shape and flash_fwd_general's at the default f32 LM's,
    with that LM's launches; the tensor-core row also carries the general
    kernel on the same bf16 inputs with its bound and SDPA's time, and
    the MoE LM's launches, and the kernel at the tp shape under
    ``tp_shape`` with the launches a rank a step; both flash rows carry ``launches_registry``,
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
import re
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


_MARK = "spin_kernel"  # the kernel of torch.cuda._sleep
_MARK_CYCLES, _WARM_CYCLES = 1000, 200_000  # a mark; 0.1 ms of warm-up
_MARK_MAX_US = 20.0     # a spin kernel shorter than this is a mark


def _profiled(torch, fn, marks=False, warm=0):
    """(profile, wall ms) of one run of ``fn`` after one unprofiled run.

    With ``marks`` a short spin kernel runs just before and just after
    ``fn``, after ``warm`` spin kernels of 0.1 ms: the first launches of a
    window have gone unrecorded late in the whole run (a Module step's
    first ``bn_stats`` and ``bn_apply``, or the leading mark alone), so
    the warm-up gives the profiler launches to lose. ``_window_whole``
    says whether the window recorded both marks with every other kernel
    between them; ``_device_kernels`` leaves the spin kernels out."""
    from torch.profiler import ProfilerActivity, profile
    fn()                         # once unprofiled, so the pools are warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if marks:
            for _ in range(warm):
                torch.cuda._sleep(_WARM_CYCLES)
            torch.cuda.synchronize()
            torch.cuda._sleep(_MARK_CYCLES)
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        if marks:
            torch.cuda._sleep(_MARK_CYCLES)
            torch.cuda.synchronize()
    return prof, wall_ms


def _spans(prof):
    """(marks, warm-up spins, other kernels) of a window: device events,
    each sorted by start."""
    from torch.autograd import DeviceType
    dev = sorted((e for e in prof.events() if e.device_type ==
                  DeviceType.CUDA), key=lambda e: e.time_range.start)
    spin = [e for e in dev if _MARK in e.name]
    marks = [e for e in spin if e.time_range.elapsed_us() < _MARK_MAX_US]
    return (marks, [e for e in spin if e not in marks],
            [e for e in dev if _MARK not in e.name])


def _window_whole(prof):
    """Whether a ``marks=True`` window recorded both marks, and every
    other kernel between them."""
    marks, _, rest = _spans(prof)
    return len(marks) == 2 and all(
        marks[0].time_range.end <= e.time_range.start and
        e.time_range.end <= marks[1].time_range.start for e in rest)


def _window_report(prof):
    """What one profiled window recorded: marks and warm-up spins kept,
    device kernels against kernel-launch calls on the host (parsed and as
    kineto returned them), the kernels' span against the host events'
    (ms from the first host event), the three longest gaps between
    kernels, and the forward BN kernels in device order (s:
    ``bn_stats``, a: ``bn_apply``)."""
    from torch.autograd import DeviceType
    marks, warm, dev = _spans(prof)
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    t0 = min(e.time_range.start for e in cpu) if cpu else 0.0
    gaps = sorted(((b.time_range.start - a.time_range.end) / 1e3,
                   (a.time_range.end - t0) / 1e3, a.name[:40])
                  for a, b in zip(dev, dev[1:]))[-3:]
    seq = "".join("s" if _KERNEL_NAMES["bn_stats"] in e.name else "a"
                  for e in dev if _KERNEL_NAMES["bn_stats"] in e.name
                  or _KERNEL_NAMES["bn_apply"] in e.name)
    try:
        raw = sum(1 for k in prof.profiler.kineto_results.events()
                  if k.device_type() == DeviceType.CUDA)
    except Exception as e:        # a report, not a gate
        raw = repr(e)[:80]
    return {"marks_ms": [(m.time_range.start - t0) / 1e3 for m in marks],
            "warm_spins": len(warm), "device_kernels": len(dev),
            "kineto_device_events": raw,
            "launch_calls": sum(e.name in ("cudaLaunchKernel",
                                           "cuLaunchKernel",
                                           "cudaLaunchKernelExC",
                                           "cuLaunchKernelEx")
                                for e in cpu),
            "host_span_ms": [0.0, (max(e.time_range.end for e in cpu)
                                   - t0) / 1e3 if cpu else None],
            "device_span_ms": [(dev[0].time_range.start - t0) / 1e3,
                               (dev[-1].time_range.end - t0) / 1e3]
            if dev else None,
            "longest_gaps_ms": gaps, "forward_bn": seq}


def _device_kernels(prof):
    """{kernel name: [device ms, count]} of one profiled run (without the
    window's marks)."""
    from torch.autograd import DeviceType
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and _MARK not in e.key:
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
    MXTPU_OPTIMIZER_AGGREGATION 4. The hybridized net runs through its
    CachedOp: the untimed first step captures the forward and backward
    graphs (its warm-up calls each BN kernel wrapper 48 times), and the
    GT_STEPS timed steps replay them (wrapper counts zeroed just before,
    read just after: none, a replay calls no wrapper); host and device ms
    of forward, backward and trainer.step (CUDA events; a device span
    includes the time the card waited for the host); one profiled step
    for the device's idle share and the BN kernels' device launches in
    the graphs (48 each, 16 bn_apply with the residual: the launches this
    phase reports); one profiled trainer.step at aggregation 4 and at
    0."""
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

    tk.reset_launches()
    first = step(0).tensor.detach().clone()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    capture_launches = dict(tk.launches)
    gib = 2.0 ** 30
    torch.cuda.reset_peak_memory_stats()
    tk.reset_launches()
    t1 = time.perf_counter()
    losses = [step(i + 1, timed=True) for i in range(GT_STEPS)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t1
    warm_wrappers = dict(tk.launches)
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
    launches = dict(summary["epilogue_device_launches"])
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
           "launches_per_step": launches,
           "capture_step_wrapper_launches": capture_launches,
           "timed_steps_wrapper_launches": warm_wrappers,
           "cache_info": tuple(net._cached_op.cache_info()),
           "capture_ms": net._cached_op.capture_ms(),
           "graph_pool_bytes": {k: v["temp_bytes"] for k, v in
                                net._cached_op.memory_analysis().items()},
           "bn_apply_residual_per_step":
               summary["bn_apply_with_residual_launches"],
           "update_calls_per_step": updates[0]["update_calls"],
           "setup_and_first_step_s": setup_s, "card": card}
    emit(row)
    if not (torch.isfinite(losses).all() and 0.0 < row["first_loss"] < 20.0):
        fail(f"gluon_train: bad loss {row['first_loss']} {losses.tolist()}")
    if any(v != 48 for v in capture_launches.values()) or \
            any(warm_wrappers.values()):
        fail(f"gluon_train: expected 48 wrapper launches of each BN kernel "
             f"in the capturing step and none in the {GT_STEPS} replayed "
             f"steps: {capture_launches} {warm_wrappers}")
    if row["bn_apply_residual_per_step"] != 16 or any(
            n != 48 for n in summary["epilogue_device_launches"].values()):
        fail(f"gluon_train: the profiled step's BN launches: {summary}")
    if row["cache_info"][:2] != (GT_STEPS + 2, 1):
        fail(f"gluon_train: cache_info {row['cache_info']}, want "
             f"{GT_STEPS + 2} hits and 1 miss")
    if not updates[0]["update_calls"] < updates[1]["update_calls"] or \
            not updates[0]["device_kernels"] < updates[1]["device_kernels"]:
        fail(f"gluon_train: aggregation 4 should take fewer calls and "
             f"kernels than 0: {updates}")
    return launches, row


# ---------------------------------------------------------------------------
# the FitLoop path: fit, fault, io staging, chaos, telemetry
# ---------------------------------------------------------------------------

# 192 images (12 steps; 256 and 16 steps before the A14 module phases)
FIT_IMAGES, FIT_EPOCHS, FIT_CKPT_EVERY, FIT_KILL = 192, 2, 4, 10
FIT_STEPS = FIT_EPOCHS * FIT_IMAGES // 32
FIT_EPOCH_STEPS = FIT_IMAGES // 32
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
    async_ckpt) for 2 epochs (FIT_STEPS, 12 steps). Then the same run
    killed at step 10 (chaos kill@10) and relaunched with fresh objects: it
    restores ckpt-8 and replays steps 8-11, and its losses, weights, momenta and
    running statistics must equal the fault-free run's bit for bit. The
    BN kernels launch 48 times a step (wrapper counts, zeroed just before
    each fit and read just after). Reported: step ms (FitLoop against the
    bare record / backward / trainer.step loop on the same net, with and
    without the loss fetched to the host each step, and gluon_train's;
    one epoch each of the loop without checkpoints, without staging and
    without the sentinel, and one profiled epoch for the card's idle
    share; then one epoch and one profiled epoch without checkpoints with
    the net hybridized, its CachedOp's graphs replayed every step), the
    breakdown's shares, the checkpoint's save() (loop
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
    fit_profile = _summary(f"one FitLoop epoch ({FIT_EPOCH_STEPS} steps), "
                           "no checkpoints",
                           _device_kernels(prof), prof_wall, {})
    fit_profile["host_top_ops"] = _host_top(torch, prof)
    emit(fit_profile)
    # the same loop with the net hybridized: every step replays the
    # CachedOp's forward and backward graphs (the first captures them)
    net.hybridize()
    variants["no_checkpoints_hybridized"] = epoch_ms(loop_for())
    prof, prof_wall = _profiled(
        torch, lambda: loop_for().fit(epochs=1, resume=False))
    hyb_profile = _summary(f"one FitLoop epoch ({FIT_EPOCH_STEPS} steps), "
                           "no checkpoints, "
                           "the net hybridized (CachedOp graphs)",
                           _device_kernels(prof), prof_wall, {})
    hyb_profile["host_top_ops"] = _host_top(torch, prof)
    emit(hyb_profile)
    hyb_cache = tuple(net._cached_op.cache_info())
    net.hybridize(False)
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
    ckpt_bytes = _dir_bytes(os.path.join(dir_a, f"ckpt-{FIT_STEPS}"))
    t = time.perf_counter()
    mt.fault.CheckpointManager(dir_a).verify(FIT_STEPS)
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
           "device_idle_share_no_checkpoints_hybridized":
               hyb_profile["device_idle_share"],
           "hybridized_cache_info": hyb_cache,
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
    1, batch 32, shuffled with seed 13)), 2 epochs (FIT_STEPS). Two runs
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
            f"one FitLoop epoch ({FIT_EPOCH_STEPS} steps), {name}, "
            "no checkpoints",
            _device_kernels(prof), wall, {})
        profiles[name]["host_top_ops"] = _host_top(torch, prof, 8)
        emit(profiles[name])

    def bare_epoch():
        for i in range(FIT_IMAGES // GT_BATCH):
            bare(i)

    prof, wall = _profiled(torch, bare_epoch)
    profiles["bare"] = _summary(f"the bare loop, {FIT_EPOCH_STEPS} steps",
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

    def probed(x, params, n_experts, capacity_factor=1.25, k=1, act=None,
               mesh=None):
        b, t, d = x.shape
        disp, _, _ = moe.route(x.reshape(b * t, d), params["gate"],
                               n_experts, capacity_factor, k)
        log.append(disp.to(torch.bool).cpu())
        return real(x, params, n_experts, capacity_factor, k, act, mesh=mesh)

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
    the stem convolution's (the first to run) with its weight's name. The
    net runs un-hybridized: a CachedOp's warm-up and capture would each
    run the hooks."""
    from mxnet_tpu_torch.gluon.nn import Conv2D, Dense
    net.hybridize(False)
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
    sgd momentum, DeviceStagingIter, 2 epochs = FIT_STEPS), all runs from
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
    launches: 48 in each composed run (the hybridized net's CachedOp
    captures its forward and backward graphs after one eager warm-up, and
    every step replays them), 96 in all under the megastep (the two
    graphs' eager first steps; the net runs inline). Printed: the ledger
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
        want_launch = {"a": 48, "b": 48, "c": 96, "d": 48, "e": 48}
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


# ---------------------------------------------------------------------------
# CachedOp (hybridize) and the serving core
# ---------------------------------------------------------------------------

CO_SPEC = ([1, 1, 1, 1], [16, 32, 64, 128, 256])    # 4 bottlenecks
CO_BATCH, CO_IMG, CO_SITES, CO_STEPS = 16, 64, 12, 3
CO_FLASH = (2, 256, 4, 64)                          # B, T, H, D, causal
SERVE_CLIENTS, SERVE_PER_CLIENT, SERVE_BURST = 8, 64, 8
SERVE_DEADLINES_MS = (None, 2000.0, 5000.0)         # a client's mix
SERVE_TIMED = 20                                    # latency repeats


def _agree_all(torch, pairs):
    """_agreement over (name, got, want) tensors: ('bit for bit' | 'within
    1e-3' | None, worst, names not bit for bit)."""
    got = {n: g.detach() for n, g, _ in pairs}
    want = {n: w.detach() for n, _, w in pairs}
    verdict, worst = _agreement(torch, got, want)
    return verdict, worst, _not_bitwise(torch, got, want)


def _co_resnet(mt):
    from mxnet_tpu_torch.gluon.model_zoo.vision.resnet import (BottleneckV1,
                                                               ResNetV1)
    net = ResNetV1(BottleneckV1, *CO_SPEC, classes=10, layout="NHWC",
                   stem_s2d=True)
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
    return net


def _co_flash_block(mt, units, heads):
    """A user block over ``mx.nd.contrib.flash_attention``: a fused QKV
    projection, causal flash attention, an output projection."""
    class FlashSelfAttention(mt.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.qkv = mt.gluon.nn.Dense(3 * units, flatten=False,
                                             in_units=units)
                self.proj = mt.gluon.nn.Dense(units, flatten=False,
                                              in_units=units)

        def hybrid_forward(self, F, x):
            b, t, _ = x.shape
            q, k, v = F.split(self.qkv(x).reshape((b, t, 3, heads, -1)),
                              num_outputs=3, axis=2, squeeze_axis=True)
            o = F.contrib.flash_attention(q, k, v, causal=True)
            return self.proj(o.reshape((b, t, units)))
    return FlashSelfAttention()


def _co_same_weights(torch, src, dst):
    with torch.no_grad():
        for a, b in zip(src.collect_params().values(),
                        dst.collect_params().values()):
            b.set_data(a.data())


def _co_grads(net):
    return {f"grad:{i}": p.grad().tensor.clone()
            for i, p in enumerate(net.collect_params().values())
            if p.grad_req != "null"}


def _co_params(net):
    return {f"param:{i}": p.tensor.detach().clone()
            for i, p in enumerate(net.collect_params().values())}


def cached_op_phase(torch, mt, card):
    """A real CachedOp behind hybridize() on the card: a small channel-last
    ResNetV1 (4 bottlenecks, widths 16-256, 12 fused BN sites, batch 16 of
    64x64, f32, TF32 off, deterministic cuDNN) and a hybridized user block
    over mx.nd.contrib.flash_attention (B 2, T 256, H 4, D 64, causal, f32
    on the general route and bf16 on the tensor-core route), each against
    the same block un-hybridized with the same weights. Checked: inference
    (the cold call captures, the next replays) and CO_STEPS training steps
    (record, SoftmaxCrossEntropy, backward, gluon.Trainer sgd momentum):
    outputs, losses, every gradient, the updated weights and moving
    statistics and the momenta, bit for bit or within 1e-3 of each
    tensor's largest value (the row names the tensors that are not bit
    for bit); a warm training step calls no kernel wrapper, and its
    profiled replay launches each BN kernel 12 times on the device (4
    residual bn_apply); cache_info equal to the expected hits and misses;
    MXTPU_FUSED_EPILOGUE=0 captures anew (a miss) and matches the eager
    composed epilogue, and switching back replays the first graph (a hit);
    a parameter whose storage is rebound is captured again, never replayed
    stale; two training forwards before their backwards (two slots) and a
    second backward through the first (retain_graph) against eager, the
    second backward's gradients equal to the first's; the BN ticket
    counters back at 0; the capture ms per signature
    and the graph pools' bytes (memory_analysis)."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    bad, rows = [], {}
    gen = torch.Generator(device="cuda").manual_seed(16)
    try:
        eager, hyb = _co_resnet(mt), _co_resnet(mt)
        xs = [torch.rand((CO_BATCH, CO_IMG, CO_IMG, 3), generator=gen,
                         device="cuda") for _ in range(CO_STEPS + 2)]
        ys = [torch.randint(0, 10, (CO_BATCH,), generator=gen,
                            device="cuda").float()
              for _ in range(CO_STEPS + 2)]
        with mt.autograd.pause():
            eager(mt.nd.from_torch(xs[0]))
            hyb(mt.nd.from_torch(xs[0]))
        _co_same_weights(torch, eager, hyb)
        hyb.hybridize()
        op_infos = {}
        # inference: the cold call captures, the second replays
        x0 = mt.nd.from_torch(xs[0])
        want = eager(x0).tensor
        t = time.perf_counter()
        first = hyb(x0).tensor
        torch.cuda.synchronize()
        cold_ms = 1e3 * (time.perf_counter() - t)
        second = hyb(x0).tensor
        v = _agree_all(torch, [("cold", first, want), ("warm", second, want)])
        rows["inference"] = {"agreement": v[0], "worst": v[1],
                             "not_bitwise": v[2], "cold_call_ms": cold_ms}
        if v[0] is None:
            bad.append(f"inference: {rows['inference']}")
        op_infos["inference"] = tuple(hyb._cached_op.cache_info())
        # training: step 1 captures the forward and backward graphs
        lossfn = gloss.SoftmaxCrossEntropyLoss()
        trs = [mt.gluon.Trainer(n.collect_params(), "sgd", dict(GT_OPT),
                                kvstore="device") for n in (eager, hyb)]
        steps = []
        for i in range(CO_STEPS):
            x, y = mt.nd.from_torch(xs[i + 1]), mt.nd.from_torch(ys[i + 1])
            outs = []
            for net, tr in zip((eager, hyb), trs):
                if net is hyb and i == CO_STEPS - 1:
                    tk.reset_launches()
                with mt.autograd.record():
                    out = net(x)
                    loss = lossfn(out, y)
                loss.backward()
                grads = _co_grads(net)
                tr.step(CO_BATCH)
                torch.cuda.synchronize()
                outs.append({"out": out.tensor.detach(),
                             "loss": loss.tensor.detach(), **grads,
                             **_co_params(net),
                             **{f"state:{j}": s.detach().clone()
                                for j, s in enumerate(_state_tensors(tr))}})
            warm_wrappers = dict(tk.launches) if i == CO_STEPS - 1 else None
            v = _agree_all(torch, [(k, outs[1][k], outs[0][k])
                                   for k in outs[0]])
            steps.append({"step": i, "agreement": v[0], "worst": v[1],
                          "not_bitwise": v[2][:8],
                          "n_not_bitwise": len(v[2])})
            if v[0] is None:
                bad.append(f"training step {i}: {steps[-1]}")
        rows["training"] = steps
        op_infos["training"] = tuple(hyb._cached_op.cache_info())
        if any(warm_wrappers.values()):
            bad.append(f"a warm training step called kernel wrappers: "
                       f"{warm_wrappers}")
        # one more warm step, profiled: the BN kernels inside the graphs
        # (the eager net takes the same steps, so the moving statistics
        # stay equal)

        def warm_step(net):
            with mt.autograd.record():
                loss = lossfn(net(mt.nd.from_torch(xs[-1])),
                              mt.nd.from_torch(ys[-1]))
            loss.backward()
        prof, wall = _profiled(torch, lambda: warm_step(hyb))
        for _ in range(2):
            warm_step(eager)
        summary = _summary("small ResNetV1 NHWC, one hybridized training "
                           "step (forward and backward graph replays)",
                           _device_kernels(prof), wall, {})
        rows["profiled_warm_step"] = {
            k: summary[k] for k in ("wall_ms", "device_busy_ms",
                                    "device_idle_share",
                                    "epilogue_device_launches",
                                    "bn_apply_with_residual_launches")}
        if any(n != CO_SITES for n in
               summary["epilogue_device_launches"].values()) or \
                summary["bn_apply_with_residual_launches"] != 4:
            bad.append(f"profiled warm step: {rows['profiled_warm_step']}")
        op_infos["profiled"] = tuple(hyb._cached_op.cache_info())
        # the trace flags: a toggle captures anew, switching back replays
        os.environ["MXTPU_FUSED_EPILOGUE"] = "0"
        try:
            want0 = eager(x0).tensor
            got0 = hyb(x0).tensor
            op_infos["flag_off"] = tuple(hyb._cached_op.cache_info())
        finally:
            os.environ.pop("MXTPU_FUSED_EPILOGUE", None)
        want1 = eager(x0).tensor
        got1 = hyb(x0).tensor
        op_infos["flag_back"] = tuple(hyb._cached_op.cache_info())
        v = _agree_all(torch, [("flag_off", got0, want0),
                               ("flag_back", got1, want1)])
        rows["flag_toggle"] = {"agreement": v[0], "worst": v[1],
                               "not_bitwise": v[2]}
        if v[0] is None:
            bad.append(f"flag toggle: {rows['flag_toggle']}")
        # a rebound parameter: its storage swapped (as cast() does)
        pe = next(iter(eager.collect_params().values()))
        ph = next(iter(hyb.collect_params().values()))
        stale = hyb(x0).tensor.clone()
        new = (pe.tensor.detach() * 0.5).contiguous()
        pe.set_data(new)
        with torch.no_grad():
            ph.tensor.data = new.clone()
        want2 = eager(x0).tensor
        got2 = hyb(x0).tensor
        v = _agree_all(torch, [("rebound", got2, want2)])
        rows["rebound"] = {"agreement": v[0], "worst": v[1],
                           "changed": not torch.equal(stale, got2),
                           "parameter": ph.name}
        if v[0] is None or not rows["rebound"]["changed"]:
            bad.append(f"rebound parameter: {rows['rebound']}")
        op_infos["rebound"] = tuple(hyb._cached_op.cache_info())
        # two forwards of one signature before their backwards (a second
        # slot, captured after the rebind dropped the training graphs),
        # and the first forward's backward twice (retain_graph)

        def two_forwards(net):
            (xa, ya), (xb, yb) = [(mt.nd.from_torch(xs[i]),
                                   mt.nd.from_torch(ys[i])) for i in (1, 2)]
            with mt.autograd.record():
                la = lossfn(net(xa), ya)
                lb = lossfn(net(xb), yb)
            res = {"loss_a": la.tensor.detach(), "loss_b": lb.tensor.detach()}
            la.backward(retain_graph=True)
            res.update({f"a_{k}": v for k, v in _co_grads(net).items()})
            la.backward()
            res.update({f"a2_{k}": v for k, v in _co_grads(net).items()})
            lb.backward()
            res.update({f"b_{k}": v for k, v in _co_grads(net).items()})
            return {**res, **_co_params(net)}
        got3, want3 = two_forwards(hyb), two_forwards(eager)
        pairs = [(k, got3[k], want3[k]) for k in want3] + \
            [(k, got3[k], got3["a" + k[2:]]) for k in got3
             if k.startswith("a2_")]
        v = _agree_all(torch, pairs)
        slots = [len(var.slots) for _k, e in
                 hyb._cached_op._cache.snapshot_items()
                 for var in e.variants.values() if var.grad]
        rows["two_forwards"] = {"agreement": v[0], "worst": v[1],
                                "not_bitwise": v[2][:8],
                                "training_slots": slots}
        if v[0] is None or slots != [2]:
            bad.append(f"two forwards, then the backwards: "
                       f"{rows['two_forwards']}")
        op_infos["two_forwards"] = tuple(hyb._cached_op.cache_info())
        # hits, misses: inference (1 miss, 1 hit); training CO_STEPS calls
        # (1 miss) and the profiled step twice; the flag toggle (a miss,
        # then a hit); the rebound parameter's call and the one before it;
        # the two forwards
        expect = {"inference": (1, 1), "training": (1 + CO_STEPS - 1, 2),
                  "profiled": (CO_STEPS + 2, 2),
                  "flag_off": (CO_STEPS + 2, 3),
                  "flag_back": (CO_STEPS + 3, 3),
                  "rebound": (CO_STEPS + 5, 3),
                  "two_forwards": (CO_STEPS + 7, 3)}
        got_hm = {k: op_infos[k][:2] for k in expect}
        if got_hm != expect:
            bad.append(f"cache_info (hits, misses) {got_hm}, want {expect}")
        rows["cache_info"] = op_infos
        rows["capture_ms"] = hyb._cached_op.capture_ms()
        rows["memory_analysis"] = hyb._cached_op.memory_analysis()
        del eager, hyb, trs, outs, xs, ys
        torch.cuda.empty_cache()
        # the flash-attention user block, f32 (general route) and bf16
        # (tensor-core route)
        b, t_, h, d = CO_FLASH
        for dtype, route in ((torch.float32, "general"),
                             (torch.bfloat16, "tc")):
            blocks = [_co_flash_block(mt, h * d, h) for _ in range(2)]
            for blk in blocks:
                blk.initialize(mt.init.Xavier(), generator=mt.random.seed(3))
                blk.cast(dtype)
            _co_same_weights(torch, blocks[0], blocks[1])
            blocks[1].hybridize()
            x = mt.nd.from_torch(torch.randn((b, t_, h * d), generator=gen,
                                             device="cuda").to(dtype))
            head = mt.nd.from_torch(torch.randn((b, t_, h * d),
                                                generator=gen,
                                                device="cuda").to(dtype))
            res = []
            for blk in blocks:
                for _ in range(2):       # the cold call, then a replay
                    fa.reset_launches()
                    with mt.autograd.record():
                        out = blk(x)
                    out.backward(head)
                    torch.cuda.synchronize()
                res.append({"out": out.tensor.detach(), **_co_grads(blk),
                            "launches": dict(fa.launches)})
            v = _agree_all(torch, [(k, res[1][k], res[0][k])
                                   for k in res[0] if k != "launches"])
            row = {"dtype": str(dtype).split(".")[-1], "route": route,
                   "agreement": v[0], "worst": v[1], "not_bitwise": v[2],
                   "eager_launches": res[0]["launches"],
                   "replay_wrapper_launches": res[1]["launches"],
                   "cache_info": tuple(blocks[1]._cached_op.cache_info())}
            rows[f"flash_{route}"] = row
            if v[0] is None or res[0]["launches"][f"flash_fwd_{route}"] \
                    != 1 or res[1]["launches"]["flash_fwd"] != 0:
                bad.append(f"flash user block ({route}): {row}")
            del blocks, res, x, head
        left = {str(k): int(v.abs().sum()) for k, v in tk._tickets.items()}
        rows["tickets_left"] = left
        if any(left.values()):
            bad.append(f"BN ticket counters not back at 0: {left}")
    finally:
        torch.backends.cudnn.deterministic = prev_det
        os.environ.pop("MXTPU_FUSED_EPILOGUE", None)
    emit({"phase": "cached_op", "card": card, **rows, "failures": bad})
    if bad:
        fail("cached_op: " + "; ".join(bad))
    return rows


def _serve_load(torch, srv, images, workers_label,
                per_client=SERVE_PER_CLIENT):
    """SERVE_CLIENTS client threads, each submitting ``per_client`` single
    images in bursts of SERVE_BURST (waiting for each burst's answers),
    deadlines cycling through SERVE_DEADLINES_MS. Returns the wall, every
    (image index, future) pair and the errors."""
    import threading
    done, errors = [], []
    lock = threading.Lock()

    def client(c):
        base = c * per_client
        for s in range(0, per_client, SERVE_BURST):
            futs = []
            for j in range(base + s, base + s + SERVE_BURST):
                dl = SERVE_DEADLINES_MS[j % len(SERVE_DEADLINES_MS)]
                futs.append((j, srv.submit(images[j], deadline_ms=dl)))
            for j, f in futs:
                try:
                    f.result(timeout=120)
                except Exception as e:
                    with lock:
                        errors.append((j, repr(e)))
            with lock:
                done.extend(futs)

    srv.reset_metrics()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(SERVE_CLIENTS)]
    t = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join(300)
    wall = time.perf_counter() - t
    if any(th.is_alive() for th in threads):
        fail(f"serving ({workers_label}): clients still waiting after 300 s")
    return wall, done, errors


def _serve_check_rows(torch, mt, net, srv, images, done):
    """Every response against an eager forward of the same padded batch
    (the batch's rows, zero rows up to its bucket): worst error as a
    fraction of the batch's largest logit, and the batches checked."""
    import numpy as np
    from mxnet_tpu_torch.serving import pad_rows
    batches = {}
    for j, f in done:
        if f.done() and f._error is None:
            batches.setdefault(f.dispatch_seq, []).append((j, f.result(0)))
    worst, exact = 0.0, 0
    with torch.no_grad():
        for seq, items in sorted(batches.items()):
            rows = [images[j] for j, _ in items]
            x = pad_rows(rows, srv._table.pad_to(len(rows)))
            want = net(mt.nd.from_torch(torch.from_numpy(x).cuda())
                       ).tensor[:len(rows)].cpu()
            got = torch.from_numpy(np.stack([r for _, r in items]))
            worst = max(worst, float((got - want).abs().max())
                        / max(float(want.abs().max()), 1e-6))
            exact += int(torch.equal(got, want))
    return worst, len(batches), exact


def _serve_latency(torch, fn, x):
    """Median ms of ``fn(x)`` (synchronised), SERVE_TIMED calls after one
    warm call."""
    import numpy as np
    fn(x)
    torch.cuda.synchronize()
    times = []
    for _ in range(SERVE_TIMED):
        t = time.perf_counter()
        fn(x)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    return float(np.median(times))


def serving_phase(torch, mt, card):
    """The serving core at full size: get_model("resnet50_v1",
    layout="NHWC") at the published widths and full depth, 224x224x3 f32
    items, TF32 off, deterministic cuDNN, served through ModelServer with
    its defaults (max batch 32, buckets 1-32, 5 ms queue latency, queue
    depth 256). warmup() captures every bucket (the capture ms of each);
    8 client threads then submit 64 single images each (bursts of 8,
    deadlines None / 2 s / 5 s), with 1 worker and with 2: img/s, p50 and
    p99 latency, the mean batch and its fill, cache misses after warmup
    (must be 0), and every response against an eager forward of the same
    padded batch (1e-3 of its largest logit). A profiled run of the 1-worker
    server (8 x 16 images) gives the card's idle share. Then: the padding
    rows never change a real row (a bucket-8 batch of 7 rows with zero and
    with random padding, bit for bit); chaos serve_slow@200 delays a
    dispatch, and requests that expire behind it are rejected with
    DeadlineExceeded and never dispatched; the eager un-hybridized forward
    against the CachedOp replay at batch 1 and 32 (median ms); and
    examples/serving/resnet_server.py run under the port's names, its
    --smoke path and its zoo path to the SIGTERM drain (exit 75)."""
    import numpy as np
    from mxnet_tpu_torch.contrib import chaos
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    from mxnet_tpu_torch.serving import (DeadlineExceeded, ModelServer,
                                         batch_buckets)
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    bad, rows = [], {}
    try:
        net = get_model("resnet50_v1", layout="NHWC")
        net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
        with mt.autograd.pause():
            net(mt.nd.from_torch(torch.zeros((1, IMG, IMG, 3),
                                              device="cuda")))
        gen = torch.Generator().manual_seed(17)
        n_img = SERVE_CLIENTS * SERVE_PER_CLIENT
        images = torch.rand((n_img, IMG, IMG, 3), generator=gen).numpy()
        shape = (IMG, IMG, 3)
        for workers in (1, 2):
            srv = ModelServer(net, bucket_shapes=[shape], workers=workers,
                              name=f"resnet50_v1-w{workers}")
            srv.start()
            t = time.perf_counter()
            built = srv.warmup()
            warm_s = time.perf_counter() - t
            after_warm = srv.cache.cache_info()
            wall, done, errors = _serve_load(torch, srv, images,
                                             f"{workers} worker(s)")
            misses = srv.cache.cache_info().misses - after_warm.misses
            m = srv.metrics_json()
            worst, n_batches, exact = _serve_check_rows(
                torch, mt, net, srv, images, done)
            fill = m["dispatched_rows_total"] / max(
                1, m["dispatched_rows_total"] + m["padded_rows_total"])
            row = {"workers": workers, "buckets": list(batch_buckets(
                       srv.max_batch_size)),
                   "max_batch": srv.max_batch_size,
                   "max_queue_latency_ms": srv.max_queue_latency_ms,
                   "queue_depth": srv.queue_depth,
                   "warmup_signatures": built, "warmup_s": warm_s,
                   "capture_ms": srv.cache.capture_ms(),
                   "graph_pool_bytes": {k: v["temp_bytes"] for k, v in
                                        srv.cache.program_memory().items()},
                   "requests": len(done), "responses": m["responses_total"],
                   "rejected": m["rejected"], "errors": errors[:4],
                   "wall_s": wall, "img_per_s": m["responses_total"] / wall,
                   "latency_ms": m["latency_ms"]["total"],
                   "compute_ms": m["latency_ms"]["compute"],
                   "queue_ms": m["latency_ms"]["queue"],
                   "batches": m["batches_total"],
                   "mean_batch": m["batch_size"]["mean"],
                   "batch_fill": fill,
                   "cache_misses_after_warmup": misses,
                   "rows_vs_eager_worst": worst,
                   "batches_checked": n_batches,
                   "batches_bit_for_bit": exact}
            rows[f"workers_{workers}"] = row
            emit({"phase": "serving", "what": f"{workers} worker(s)",
                  "card": card, **row})
            if misses or built != len(batch_buckets(srv.max_batch_size)):
                bad.append(f"{workers} worker(s): {built} signatures "
                           f"warmed, {misses} misses after warmup")
            if errors or m["responses_total"] != n_img:
                bad.append(f"{workers} worker(s): {errors[:4]}, "
                           f"{m['responses_total']} responses")
            if worst > 1e-3:
                bad.append(f"{workers} worker(s): responses {worst} off "
                           "the eager forward of their padded batch")
            if workers == 1:
                from torch.profiler import ProfilerActivity, profile
                short = images[:SERVE_CLIENTS * 16]
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    pwall, _, _ = _serve_load(torch, srv, short, "profiled",
                                              per_client=16)
                busy = sum(ms for ms, _ in _device_kernels(prof).values())
                rows["profiled"] = {"images": len(short), "wall_ms":
                                    1e3 * pwall, "device_busy_ms": busy,
                                    "device_idle_share":
                                        1.0 - busy / (1e3 * pwall)}
                # the padding never changes a real row
                x7 = images[:7]
                zero = np.concatenate([x7, np.zeros((1,) + shape,
                                                    np.float32)])
                rnd = np.concatenate([x7, images[7:8]])
                a = srv.cache(srv.cache.batch(zero)).tensor[:7].cpu()
                b = srv.cache(srv.cache.batch(rnd)).tensor[:7].cpu()
                rows["padding_rows_inert"] = bool(torch.equal(a, b))
                if not rows["padding_rows_inert"]:
                    bad.append("padding rows changed a real row")
                # serve_slow delays a dispatch; expired requests are
                # never dispatched
                chaos.install("serve_slow@200")
                try:
                    srv.reset_metrics()
                    t = time.perf_counter()
                    first = srv.submit(images[0])
                    time.sleep(0.05)
                    doomed = [srv.submit(images[i], deadline_ms=20)
                              for i in range(1, 5)]
                    first.result(timeout=60)
                    first_ms = 1e3 * (time.perf_counter() - t)
                    expired = 0
                    for f in doomed:
                        try:
                            f.result(timeout=60)
                        except DeadlineExceeded:
                            expired += 1
                    mm = srv.metrics_json()
                    injected = chaos.active().injected["serve_slow"]
                finally:
                    chaos.uninstall()
                rows["chaos"] = {"first_ms": first_ms, "expired": expired,
                                 "dispatched_rows":
                                     mm["dispatched_rows_total"],
                                 "injected": injected}
                if first_ms < 200 or expired != 4 or \
                        mm["dispatched_rows_total"] != 1:
                    bad.append(f"serve_slow: {rows['chaos']}")
                # eager against the replay at batch 1 and 32
                lat = {}
                with torch.no_grad():
                    for bsz in (1, srv.max_batch_size):
                        xb = srv.cache.batch(images[:bsz])
                        lat[bsz] = {
                            "eager_ms": _serve_latency(torch, net, xb),
                            "replay_ms": _serve_latency(torch, srv.cache,
                                                        xb)}
                rows["forward_ms"] = lat
                emit({"phase": "serving", "what": "forward_ms",
                      "card": card, **lat})
                # where a batch-32 forward's device time goes, eager
                # against the replay
                with torch.no_grad():
                    xb = srv.cache.batch(images[:srv.max_batch_size])
                    for what, fn in (("eager", net),
                                     ("replay", srv.cache)):
                        prof, wall = _profiled(torch, lambda: fn(xb))
                        summ = _summary(f"resnet50_v1 forward, batch "
                                        f"{srv.max_batch_size}, {what}",
                                        _device_kernels(prof), wall, {})
                        rows[f"profile_b32_{what}"] = {
                            k: summ[k] for k in ("wall_ms",
                                                 "device_busy_ms",
                                                 "by_family_ms",
                                                 "top_kernels")}
                        emit({"phase": "serving", "card": card,
                              "what": f"profile_b32_{what}",
                              **rows[f"profile_b32_{what}"]})
            srv.stop()
            del srv
            torch.cuda.empty_cache()
        rows["example"] = resnet_server_example(torch, mt)
        for r in rows["example"].values():
            if not r["ok"]:
                bad.append(f"resnet_server.py: {r}")
    finally:
        torch.backends.cudnn.deterministic = prev_det
    emit({"phase": "serving", "card": card,
          "config": "resnet50-serve-f32-b32", **{
              k: v for k, v in rows.items() if not k.startswith("workers")},
          "failures": bad})
    if bad:
        fail("serving: " + "; ".join(bad))
    return rows


def resnet_server_example(torch, mt):
    """examples/serving/resnet_server.py with ``mxnet_tpu`` resolved to the
    port (its module names aliased for the run): the --smoke path, and the
    zoo path (resnet18_v1 at 32x32, the example's defaults) up to a
    SIGTERM once serve_forever's handlers are in place, which must drain
    and exit with the resumable code."""
    import contextlib
    import io as _io
    import runpy
    import signal
    import threading
    from mxnet_tpu_torch.gluon.model_zoo import vision
    here = os.path.dirname(os.path.abspath(__file__))
    script = os.path.join(here, "examples", "serving", "resnet_server.py")
    alias = {"mxnet_tpu": mt, "mxnet_tpu.gluon": mt.gluon,
             "mxnet_tpu.serving": mt.serving,
             "mxnet_tpu.gluon.model_zoo": mt.gluon.model_zoo,
             "mxnet_tpu.gluon.model_zoo.vision": vision}
    server_cls = mt.serving.ModelServer
    install = server_cls.install_signal_handlers

    def install_then_term(self):
        install(self)
        threading.Timer(0.5, signal.raise_signal, (signal.SIGTERM,)).start()

    out = {}
    saved_argv = sys.argv
    saved_mods = {k: sys.modules.get(k) for k in alias}
    try:
        sys.modules.update(alias)
        server_cls.install_signal_handlers = install_then_term
        for name, argv, code in (("smoke", ["--smoke", "--requests", "64"],
                                  0), ("zoo", [], 75)):
            sys.argv = [script] + argv
            buf = _io.StringIO()
            t = time.perf_counter()
            rc = None
            with contextlib.redirect_stdout(buf):
                try:
                    runpy.run_path(script, run_name="__main__")
                except SystemExit as e:
                    rc = e.code or 0
            text = buf.getvalue()
            n = int(argv[argv.index("--requests") + 1]) if argv else 128
            ok = rc == code and f"served {n}/{n} requests" in text and \
                ("SMOKE OK" in text if code == 0
                 else "serving until SIGTERM" in text)
            out[name] = {"argv": argv, "exit_code": rc, "ok": ok,
                         "wall_s": time.perf_counter() - t,
                         "lines": [ln for ln in text.splitlines()
                                   if ln.startswith(("warmup", "served",
                                                     "SMOKE"))]}
            emit({"phase": "serving", "what": f"resnet_server.py {name}",
                  **out[name]})
    finally:
        server_cls.install_signal_handlers = install
        sys.argv = saved_argv
        for k, v in saved_mods.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    return out


# ---------------------------------------------------------------------------
# data-parallel training over torch.distributed: dist_train
# ---------------------------------------------------------------------------

DT_STEPS = 3         # 5 before the A14 module phases
DT_VARIANTS = ("dist_sync", "zero", "zero_overlap", "compress")
DT_ENV = {"dist_sync": {},
          "zero": {"MXTPU_ZERO": "1"},
          "zero_overlap": {"MXTPU_ZERO": "1", "MXTPU_COMM_OVERLAP": "on"},
          "compress": {}}
DT_COMPRESSION = {"type": "2bit", "threshold": 0.05}
DT_MEGA_WORLD, DT_MEGA_IMAGES = 4, 128


def _free_port():
    """A free port for a coordinator. Each worker's command endpoint
    binds the coordinator's port (+ the generation under ``launch
    --supervise``) + 100 + its rank (``kvstore_server._cmd_port``), so
    the port stays that far below 65535."""
    import socket
    while True:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        if port + 100 + 64 <= 65535:
            return port


def _dt_batch(torch, mt, step, rank):
    """Rank ``rank``'s batch of step ``step`` (the same in every process
    on this card)."""
    gen = torch.Generator(device="cuda").manual_seed(1000 + 10 * step + rank)
    x = torch.rand((GT_BATCH, IMG, IMG, 3), generator=gen, device="cuda")
    y = torch.randint(0, 1000, (GT_BATCH,), generator=gen,
                      device="cuda").float()
    return mt.nd.from_torch(x), mt.nd.from_torch(y)


def _dt_net(mt):
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    net = get_model("resnet50_v1", layout="NHWC")
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
    net.hybridize()
    return net


def _dt_setup(torch):
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    os.environ["MXTPU_OPTIMIZER_AGGREGATION"] = "4"


def dist_rank(argv):
    """One rank of dist_train (b), started by ``python -m
    mxnet_tpu_torch.launch -n 2 python3 chip_smoke.py --dist-rank DIR``:
    the ResNet-50 v1 step over ``mx.kv.create("dist_sync")`` in each
    variant, from the same start (weights and running statistics put
    back in place), DT_STEPS steps each; the final weights and running
    statistics go to DIR, the numbers to DIR/rank<r>.json."""
    import torch
    _dt_setup(torch)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    from mxnet_tpu_torch.parallel import collectives as coll
    out_dir = argv[0]
    if not kvstore_server.init_distributed():
        fail("dist_rank: no group in the environment")
    info = kvstore_server.group_info()
    rank = info["rank"]
    net = _dt_net(mt)
    lossfn = gloss.SoftmaxCrossEntropyLoss()
    named = sorted(net._collect_params_with_prefix().items())
    start = {k: p.tensor.detach().clone() for k, p in named}
    tk.reset_launches()
    rows = {}
    for variant in DT_VARIANTS:
        for k in ("MXTPU_ZERO", "MXTPU_COMM_OVERLAP"):
            os.environ.pop(k, None)
        os.environ.update(DT_ENV[variant])
        with torch.no_grad():
            for k, p in named:
                p.tensor.copy_(start[k])
        kv = mt.kv.create("dist_sync")
        trainer = mt.gluon.Trainer(
            net.collect_params(), "sgd", dict(GT_OPT), kvstore=kv,
            compression_params=DT_COMPRESSION
            if variant == "compress" else None)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per = []
        for s in range(DT_STEPS):
            x, y = _dt_batch(torch, mt, s, rank)
            t0 = time.perf_counter()
            with mt.autograd.record():
                loss = lossfn(net(x), y)
            with trainer.overlap_scope() as scope:
                loss.backward()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            trainer.allreduce_grads()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            trainer.update(GT_BATCH)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            if s == 0:
                # the steady peak: after the first step (in the first
                # variant the CachedOp's capture)
                torch.cuda.reset_peak_memory_stats()
            per.append({"step_ms": 1e3 * (t3 - t0),
                        "forward_backward_ms": 1e3 * (t1 - t0),
                        "allreduce_grads_ms": 1e3 * (t2 - t1),
                        "update_ms": 1e3 * (t3 - t2),
                        "loss": float(loss.tensor.mean()),
                        "launched_in_backward":
                            getattr(scope, "launched_in_backward", 0)})
        peak = torch.cuda.max_memory_allocated()
        resident = torch.cuda.memory_allocated()
        live = [p for _, p in named if p.grad_req != "null"]
        state = sum(t.numel() * t.element_size()
                    for t in _state_tensors(trainer))
        unsharded = sum(p.tensor.numel() * p.tensor.element_size()
                        for p in live)
        torch.save({"weights": {k: p.tensor.detach().cpu()
                                for k, p in named if p.grad_req != "null"},
                    "aux": {k: p.tensor.detach().cpu()
                            for k, p in named if p.grad_req == "null"}},
                   os.path.join(out_dir, f"{variant}_r{rank}.pt"))
        warm = per[1:]

        def median(f):
            return sorted(f(r) for r in warm)[len(warm) // 2]
        zero = variant.startswith("zero")
        rows[variant] = {
            "steps": per,
            "step_ms_median": median(lambda r: r["step_ms"]),
            "forward_backward_ms_median":
                median(lambda r: r["forward_backward_ms"]),
            "allreduce_grads_ms_median":
                median(lambda r: r["allreduce_grads_ms"]),
            "update_ms_median": median(lambda r: r["update_ms"]),
            # ZeRO's allgather runs inside the update
            "comm_ms_median": median(lambda r: r["allreduce_grads_ms"] + (
                r["update_ms"] if zero else 0.0)),
            "collectives": {
                "allreduce": trainer.last_allreduce_collectives,
                "reduce_scatter": trainer.last_reduce_scatter_collectives,
                "allgather": trainer.last_allgather_collectives},
            # after step 1: the transient peak over what stays (the
            # graphs' pools were allocated at the first variant's capture)
            "peak_allocated_gib": peak / 2.0 ** 30,
            "resident_gib": resident / 2.0 ** 30,
            "optimizer_state_bytes": state,
            "unsharded_state_bytes": unsharded,
            "state_share": state / unsharded,
            "wire_bytes_last_key": getattr(kv, "_last_wire_bytes", 0)}
        kv.barrier()
    wrappers = dict(tk.launches)
    # one more forward and backward, profiled: the BN kernels' device
    # launches in a replayed step (the weights are saved already)
    x, y = _dt_batch(torch, mt, 0, rank)

    def fwd_bwd():
        with mt.autograd.record():
            loss = lossfn(net(x), y)
        loss.backward()
    prof, wall = _profiled(torch, fwd_bwd)
    summary = _summary(f"dist_train rank {rank}: forward + backward",
                       _device_kernels(prof), wall, {})
    out = {"rank": rank, "group": info, "variants": rows,
           "wrapper_launches": wrappers,
           "device_launches_per_step": summary["epilogue_device_launches"],
           "device_idle_share": summary["device_idle_share"],
           "routes": dict(coll.routes)}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    print(f"dist_rank {rank}: done", flush=True)


def nccl_check(argv):
    """dist_train (a), in a child process: a one-rank NCCL group on the
    card (the backend rule: one rank, one card), each collective of
    ``parallel/collectives.py`` on CUDA tensors held to its definition at
    world 1, the tiled reduce-scatter route taken."""
    import numpy as np
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    from mxnet_tpu_torch.parallel import collectives as coll
    info = kvstore_server.join_group(f"127.0.0.1:{_free_port()}", 1, 0)
    checks = {}
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn(1 << 20, generator=gen, device="cuda")
    for op in ("sum", "mean", "max", "min"):
        t = x.clone()
        coll.cross_process_allreduce(t, op=op)
        checks[f"allreduce_{op}"] = bool(torch.equal(t, x))
    checks["allgather"] = bool(torch.equal(coll.cross_process_allgather(x),
                                           x[None]))
    parts = [(0, 1000), (5000, 70000), (70000, 1 << 20)]
    routes0 = dict(coll.routes)
    got = coll.cross_process_reduce_scatter(x, parts, all_parts=[parts])
    checks["reduce_scatter_tiled"] = all(
        torch.equal(g, x[lo:hi]) for g, (lo, hi) in zip(got, parts)) and \
        coll.routes["tiled"] == routes0["tiled"] + 1
    got = coll.cross_process_reduce_scatter(x, parts)
    checks["reduce_scatter_allreduce"] = all(
        torch.equal(g, x[lo:hi]) for g, (lo, hi) in zip(got, parts))
    rag = coll.cross_process_allgather_ragged(x[:777])
    checks["allgather_ragged"] = len(rag) == 1 and bool(
        torch.equal(rag[0], x[:777]))
    checks["exchange_bytes"] = coll.cross_process_exchange_bytes(
        b"\x00abc") == [b"\x00abc"]
    checks["allgather_object"] = coll.cross_process_allgather_object(
        {"k": np.arange(3).tolist()}) == [{"k": [0, 1, 2]}]
    checks["reform"] = [m["rank"] for m in
                        coll.cross_process_reform("c", expect=1)] == [0]
    coll.barrier()
    checks["barrier"] = True
    kv = mt.kv.create("dist_sync")
    kv.init(0, mt.nd.from_torch(x))
    kv.push(0, mt.nd.from_torch(x * 2))
    o = mt.nd.from_torch(torch.empty_like(x))
    kv.pull(0, out=o)
    checks["kvstore_push_pull"] = kv.num_workers == 1 and bool(
        torch.equal(o.tensor, x * 2))
    emit({"phase": "dist_train", "what": "nccl", "group": info,
          "backend": coll.backend(), "checks": checks,
          "routes": dict(coll.routes)})
    if coll.backend() != "nccl" or not all(checks.values()):
        fail(f"nccl_check: {coll.backend()} {checks}")


def example_rank(argv):
    """dist_train (d): one rank of ``examples/distributed_training/
    cifar10_dist.py`` with ``mxnet_tpu`` and ``mxnet_tpu.kvstore_server``
    resolved to the port."""
    import runpy
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    sys.modules.update({"mxnet_tpu": mt,
                        "mxnet_tpu.kvstore_server": kvstore_server,
                        "mxnet_tpu.gluon": mt.gluon})
    script = os.path.join(here, argv[0])
    sys.argv = [script] + argv[1:]
    runpy.run_path(script, run_name="__main__")


def _dt_start(args):
    """Start a dist_train child: (Popen, start time)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = here + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(args, cwd=here, env=env, text=True,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE), time.perf_counter()


def _dt_wait(started, timeout, what):
    """Wait for a child of :func:`_dt_start`: (its completed process, its
    wall from the start); a non-zero exit fails the run."""
    popen, t = started
    try:
        out, err = popen.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        popen.kill()
        popen.communicate()
        fail(f"dist_train {what}: still running after {timeout} s")
    wall = time.perf_counter() - t
    proc = subprocess.CompletedProcess(popen.args, popen.returncode, out,
                                       err)
    if proc.returncode != 0:
        print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
        fail(f"dist_train {what}: exit {proc.returncode}")
    return proc, wall


def _dt_launch(args, timeout, what):
    return _dt_wait(_dt_start(args), timeout, what)


def _dt_reference(torch, mt, compress):
    """The one-process reference of dist_train (b) on the card: rank 0's
    and rank 1's batches through two copies of the net (each its own
    BatchNorm statistics), the gradients summed g0 + g1 (through the
    port's compressor first when ``compress``: each rank's payload
    decoded), one step on copy 0, its weights copied into copy 1."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gradient_compression import GradientCompression
    nets = [_dt_net(mt), _dt_net(mt)]
    lossfn = gloss.SoftmaxCrossEntropyLoss()
    trainer = mt.gluon.Trainer(nets[0].collect_params(), "sgd",
                               dict(GT_OPT), kvstore="device")
    comps = [GradientCompression(**DT_COMPRESSION) for _ in nets]
    named = [sorted(n._collect_params_with_prefix().items()) for n in nets]
    live = [[p for _, p in nd if p.grad_req != "null"] for nd in named]
    for s in range(DT_STEPS):
        grads = []
        for r, net in enumerate(nets):
            x, y = _dt_batch(torch, mt, s, r)
            with mt.autograd.record():
                loss = lossfn(net(x), y)
            loss.backward()
            gs = [p.grad().tensor.clone() for p in live[r]]
            if compress:
                gs = [comps[r].roundtrip(i, g) for i, g in enumerate(gs)]
            grads.append(gs)
        with torch.no_grad():
            for p, a, b in zip(live[0], *grads):
                p.grad().tensor.copy_(a + b)
        trainer.step(GT_BATCH)
        with torch.no_grad():
            for p0, p1 in zip(live[0], live[1]):
                p1.tensor.copy_(p0.tensor)
    return ({k: p.tensor.detach().cpu() for k, p in named[0]
             if p.grad_req != "null"},
            [{k: p.tensor.detach().cpu() for k, p in nd
              if p.grad_req == "null"} for nd in named])


def _dt_megastep(torch, mt):
    """dist_train (c): ``MXTPU_ZERO=1`` with ``MXTPU_ZERO_WORLD=4`` on the
    megastep cell's workload (ResNet-50 v1 f32 b32 through FitLoop, 4
    steps): the megastep's one-graph step, whose loopback reduce-scatter
    runs inside the graph, against the composed ZeRO step bit for bit
    (losses, weights, running statistics, every shard's momenta)."""
    import numpy as np
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    rng = np.random.default_rng(3)
    X = rng.random((DT_MEGA_IMAGES, IMG, IMG, 3), dtype=np.float32)
    Y = rng.integers(0, 1000, DT_MEGA_IMAGES).astype(np.float32)
    os.environ.update({"MXTPU_ZERO": "1",
                       "MXTPU_ZERO_WORLD": str(DT_MEGA_WORLD)})
    out = {}
    try:
        for mega in (False, True):
            os.environ["MXTPU_MEGASTEP"] = "on" if mega else "off"
            net = get_model("resnet50_v1", layout="NHWC")
            net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
            trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                       dict(GT_OPT),
                                       kvstore=mt.kv.create("local"))
            itr = mt.io.DeviceStagingIter(mt.io.NDArrayIter(
                X, Y, batch_size=GT_BATCH))
            loop = mt.fit.FitLoop(net, trainer,
                                  gloss.SoftmaxCrossEntropyLoss(), itr,
                                  ckpt_dir=None, heartbeat=False)
            res = loop.fit(epochs=1)
            out[mega] = (res, _fit_state(torch, net, trainer))
            del net, trainer, loop, itr
            torch.cuda.empty_cache()
    finally:
        for k in ("MXTPU_ZERO", "MXTPU_ZERO_WORLD", "MXTPU_MEGASTEP"):
            os.environ.pop(k, None)
    (res_c, st_c), (res_m, st_m) = out[False], out[True]
    bad = _not_bitwise(torch, st_m, st_c)
    row = {"phase": "dist_train", "what": "megastep_zero_world4",
           "world": DT_MEGA_WORLD, "steps": res_c.step,
           "zero": res_m.zero, "losses_composed": res_c.losses,
           "losses_megastep": res_m.losses, "tensors": len(st_c),
           "not_bitwise": bad[:8]}
    emit(row)
    if bad or res_c.losses != res_m.losses or not res_m.zero or \
            res_m.zero["world"] != DT_MEGA_WORLD:
        fail(f"dist_train (c): megastep under ZeRO world {DT_MEGA_WORLD} "
             f"against the composed step: {row}")
    return row


def dist_train(torch, mt, card):
    """(a) NCCL on the card in a one-rank child; (b) two ranks sharing the
    card over gloo through ``mxnet_tpu_torch.launch``: the Gluon
    ResNet-50 v1 step (``gluon_train``'s net, optimizer and batch 32 a
    rank, each rank's data from its own seed, hybridized, deterministic
    cuDNN, TF32 off) for DT_STEPS steps in each of dist_sync with the
    default buckets, MXTPU_ZERO=1, ZeRO with MXTPU_COMM_OVERLAP=on, and
    2-bit compression: both ranks' weights bit for bit alike and equal to
    the one-process reference (through the compressor in the last), each
    rank's running statistics equal to its reference copy's, 48 device
    launches of each BN kernel a rank a step; (c) the megastep under a
    simulated ZeRO world of 4 against the composed ZeRO step; (d)
    ``examples/distributed_training/cifar10_dist.py`` as two ranks."""
    import tempfile
    here = os.path.dirname(os.path.abspath(__file__))
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            os.environ.get("MXTPU_OPTIMIZER_AGGREGATION"))
    _dt_setup(torch)
    walls = {}
    nccl = None
    try:
        # (a) runs beside (b): a one-rank check that times nothing
        nccl = _dt_start([sys.executable, os.path.abspath(__file__),
                          "--nccl-check"])
        with tempfile.TemporaryDirectory(dir=here) as out_dir:
            proc, walls["ranks"] = _dt_launch(
                [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
                 sys.executable, os.path.abspath(__file__), "--dist-rank",
                 out_dir], 600, "(b) ranks")
            nccl_proc, walls["nccl"] = _dt_wait(nccl, 300, "(a) nccl")
            print(nccl_proc.stdout.strip().splitlines()[-1], flush=True)
            ranks = []
            for r in range(2):
                with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
            t = time.perf_counter()
            refs = {False: _dt_reference(torch, mt, False),
                    True: _dt_reference(torch, mt, True)}
            walls["reference"] = time.perf_counter() - t
            results = {}
            for v in DT_VARIANTS:
                got = [torch.load(os.path.join(out_dir, f"{v}_r{r}.pt"))
                       for r in range(2)]
                want_w, want_aux = refs[v == "compress"]
                results[v] = {
                    "ranks_alike": _not_bitwise(torch, got[1]["weights"],
                                                got[0]["weights"]),
                    "vs_reference": _not_bitwise(torch, got[0]["weights"],
                                                 want_w),
                    "running_stats_vs_reference": [
                        _not_bitwise(torch, got[r]["aux"], want_aux[r])
                        for r in range(2)],
                    "weights": len(want_w)}
            torch.cuda.empty_cache()
        t = time.perf_counter()
        mega = _dt_megastep(torch, mt)
        walls["megastep"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        proc, walls["example"] = _dt_launch(
            [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
             sys.executable, os.path.abspath(__file__), "--example-rank",
             os.path.join("examples", "distributed_training",
                          "cifar10_dist.py"), "--epochs", "1",
             "--num-batches", "2"], 300, "(d) example")
        # both ranks write to one pipe: their lines may interleave
        example = sorted(re.findall(r"worker \d+: DONE", proc.stdout))
    finally:
        if nccl is not None and nccl[0].poll() is None:
            nccl[0].kill()
            nccl[0].communicate()
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = prev[:2]
        if prev[2] is None:
            os.environ.pop("MXTPU_OPTIMIZER_AGGREGATION", None)
        else:
            os.environ["MXTPU_OPTIMIZER_AGGREGATION"] = prev[2]
    row = {"phase": "dist_train", "card": card,
           "model": 'get_model("resnet50_v1", layout="NHWC"), hybridized',
           "ranks": 2, "backend": ranks[0]["group"]["backend"],
           "batch_per_rank": GT_BATCH, "steps": DT_STEPS,
           "optimizer": "gluon.Trainer sgd lr 0.05 momentum 0.9, "
                        "aggregation 4, f32, TF32 off",
           "compression": DT_COMPRESSION,
           "per_rank": [{v: {k: val for k, val in
                             ranks[r]["variants"][v].items()
                             if k != "steps"} for v in DT_VARIANTS}
                        for r in range(2)],
           "losses_rank0": {v: [s["loss"] for s in
                                ranks[0]["variants"][v]["steps"]]
                            for v in DT_VARIANTS},
           "launched_in_backward": {v: [s["launched_in_backward"] for s in
                                        ranks[0]["variants"][v]["steps"]]
                                    for v in DT_VARIANTS},
           "bitwise": results,
           "wrapper_launches": [ranks[r]["wrapper_launches"]
                                for r in range(2)],
           "device_launches_per_step": [ranks[r][
               "device_launches_per_step"] for r in range(2)],
           "routes": [ranks[r]["routes"] for r in range(2)],
           "megastep": {"not_bitwise": mega["not_bitwise"]},
           "example": example, "walls_s": walls}
    emit(row)
    bad = [v for v, res in results.items()
           if res["ranks_alike"] or res["vs_reference"] or
           any(res["running_stats_vs_reference"])]
    if row["backend"] != "gloo" or bad:
        fail(f"dist_train (b): variants not bit for bit: {bad} "
             f"{ {v: results[v] for v in bad} }")
    for r in range(2):
        dl = ranks[r]["device_launches_per_step"]
        wl = ranks[r]["wrapper_launches"]
        if any(n != 48 for n in dl.values()) or \
                any(n != 48 for n in wl.values()):
            fail(f"dist_train (b): rank {r}: 48 launches of each BN kernel "
                 f"expected, device {dl}, wrappers {wl}")
    for v in ("zero", "zero_overlap"):
        shares = [ranks[r]["variants"][v]["state_share"] for r in range(2)]
        if not all(0.3 < s < 0.7 for s in shares) or \
                abs(sum(shares) - 1.0) > 1e-9:
            fail(f"dist_train (b): ZeRO state shares {shares}")
    if not any(row["launched_in_backward"]["zero_overlap"]):
        fail("dist_train (b): no bucket launched from backward under "
             "MXTPU_COMM_OVERLAP=on")
    if example != ["worker 0: DONE", "worker 1: DONE"]:
        fail(f"dist_train (d): the example's ranks printed {example}")
    return {k: ranks[0]["device_launches_per_step"][k]
            for k in ranks[0]["device_launches_per_step"]}, row



# ---------------------------------------------------------------------------
# fleet_train: the self-healing fleet on full-width ResNet-50 v1
# ---------------------------------------------------------------------------

FL_IMAGES, FL_GLOBAL, FL_EPOCHS, FL_CKPT_EVERY = 128, 64, 10, 2
FL_STEPS = FL_EPOCHS * FL_IMAGES // FL_GLOBAL      # 20
FL_EVENT_AT = 5       # generation 0's kill: step 5 (ckpt-4 before)
FL_HOLD_AT = 8        # generation 1 (world 1) holds after step 8 until
#                       the grow's SIGTERM drains it: the schedule is fixed
FL_HOLD_MAX_S = 120.0
FL_RECOVERY_S = 50.0  # the spot model gives a lost slot back after this
# (a generation reaches its first step 25-38 s after the decision that
# started it: relaunch 10-19 s, then the build, restore and capture)
# [(world, first step)] of the supervised run's generations: ckpt-4
# before the kill at 5, the hold at 8, ckpt-10 before the hang at 11
FL_SCHEDULE = [(2, 0), (1, 4), (2, FL_HOLD_AT), (1, FL_HOLD_AT + 2)]
FL_TIMEOUT_S = 4.0    # the hung-collective watchdog
FL_GRACE_S = 3.0


def _fl_data(np):
    rng = np.random.default_rng(1)
    X = rng.random((FL_IMAGES, IMG, IMG, 3), dtype=np.float32)
    Y = rng.integers(0, 1000, FL_IMAGES).astype(np.float32)
    return X, Y


def _fl_latest(ck):
    best = 0
    if os.path.isdir(ck):
        for name in os.listdir(ck):
            if name.startswith("ckpt-") and "." not in name and \
                    os.path.exists(os.path.join(ck, name, "DONE")):
                best = max(best, int(name.split("-", 1)[1]))
    return best


def _fl_sync(out_dir, rank):
    """This rank's checkpoint dir brought up to the newest any rank holds
    (checkpoints are the same on every rank)."""
    import shutil
    ck = os.path.join(out_dir, f"ckpt_r{rank}")
    peers = [os.path.join(out_dir, d) for d in os.listdir(out_dir)
             if d.startswith("ckpt_r")]
    best = max(peers, key=_fl_latest, default=None)
    if best and best != ck and _fl_latest(best) > _fl_latest(ck):
        if os.path.isdir(ck):
            shutil.rmtree(ck)
        shutil.copytree(best, ck)
    return ck


def _fl_chaos(rank, gen, base):
    stop = os.environ.get("FLEET_STOP")
    if stop:
        step, world = stop.split(":")
        return f"resize@{int(step)}:{int(world)}"
    ev = json.loads(os.environ.get("FLEET_EVENTS", "{}")).get(str(gen))
    if not ev:
        return os.environ.get("FLEET_CHAOS", "")
    at = ev["at"] if "at" in ev else base + ev["offset"]
    if ev["kind"] == "kill":
        return f"kill@{at}" if rank == ev["rank"] else ""
    return f"kv_hang:{ev['rank']}@{at}"


def fleet_rank(argv):
    """One rank of one generation of fleet_train, started by
    ``python -m mxnet_tpu_torch.launch [--supervise] -n 2 python3
    chip_smoke.py --fleet-rank DIR``: FitLoop on dist_train's hybridized
    ResNet-50 v1 (f32, TF32 off, deterministic cuDNN) over dist_sync, the
    global batch FL_GLOBAL at every world, checkpoints every
    FL_CKPT_EVERY steps into the rank's dir (brought up to the newest
    first), this generation's chaos from FLEET_EVENTS / FLEET_STOP; writes
    DIR/gen<g>_r<rank>.json and, at the end, the final weights."""
    import signal
    t_start = time.monotonic()
    # a SIGTERM before FitLoop's handler (a grow while this process
    # imports) is a drain with nothing trained
    signal.signal(signal.SIGTERM, lambda *_: os._exit(75))
    import numpy as np
    import torch
    _dt_setup(torch)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    from mxnet_tpu_torch.base import env
    from mxnet_tpu_torch.contrib.chaos import ChaosKilled
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    out_dir = argv[0]
    kvstore_server.init_distributed()
    kv = mt.kv.create("dist_sync")
    rank, nw = kv.rank, kv.num_workers
    t_joined = time.monotonic()
    gen = int(os.environ.get("MXTPU_SUPERVISE_GEN", "0"))
    target = int(os.environ.get("FLEET_TARGET", "2"))
    ck = _fl_sync(out_dir, rank)
    base = _fl_latest(ck)
    if gen > 0 and rank == 0 and base:
        # the checkpoint this generation resumes from, kept for the
        # reference chain (FitLoop prunes old checkpoints)
        import shutil
        shutil.copytree(os.path.join(ck, f"ckpt-{base}"),
                        os.path.join(out_dir, "resumed", f"ckpt-{base}"),
                        dirs_exist_ok=True)
    spec = _fl_chaos(rank, gen, base)
    env.set("MXTPU_CHAOS", spec or None)
    X, Y = _fl_data(np)
    itr = mt.io.DeviceStagingIter(mt.io.NDArrayIter(
        X, Y, batch_size=FL_GLOBAL // nw, shuffle=True, seed=13,
        num_parts=nw, part_index=rank))
    net = _dt_net(mt)
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", dict(GT_OPT),
                               kvstore=kv)
    path = os.path.join(out_dir, f"gen{gen}_r{rank}.json")
    rec = {"gen": gen, "world": nw, "rank": rank, "start": base,
           "chaos": spec, "t_start": t_start, "t_joined": t_joined,
           "t_built": time.monotonic()}
    with open(path, "w") as f:
        json.dump(rec, f)
    last = []
    hold = str(gen) in os.environ.get("FLEET_HOLD_GENS", "").split(",")
    prof_at = int(os.environ.get("FLEET_PROFILE", "-1"))
    prof = []

    def on_step_end(step, loss):
        # a step's wall: from the end of the previous step's callback
        if last:
            rec.setdefault("step_ms", []).append(
                1e3 * (time.perf_counter() - last[0]))
        rec.setdefault("t_first_step", time.monotonic())
        # a generation may be retired at any step: its record is kept
        # up to date
        with open(path, "w") as f:
            json.dump(rec, f)
        if step + 1 == prof_at:
            # the device's launches of FitLoop's own step prof_at
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            prof.append(profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]))
            prof[0].__enter__()
            prof.append(time.perf_counter())
        elif step == prof_at:
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - prof[1])
            prof[0].__exit__(None, None, None)
            rec["profiled_step"] = step
            rec["device_launches_per_step"] = _summary(
                "fleet", _device_kernels(prof[0]), wall, {})[
                "epilogue_device_launches"]
        if hold and nw < target and step + 1 == FL_HOLD_AT:
            # wait at the step boundary for the grow's drain
            until = time.monotonic() + FL_HOLD_MAX_S
            while loop._preempted is None and time.monotonic() < until:
                time.sleep(0.05)
        last[:] = [time.perf_counter()]
    epochs = int(os.environ.get("FLEET_EPOCHS", str(FL_EPOCHS)))
    loop = mt.fit.FitLoop(net, trainer, gloss.SoftmaxCrossEntropyLoss(), itr,
                          ckpt_dir=ck, ckpt_every=FL_CKPT_EVERY,
                          async_ckpt=False, heartbeat=False,
                          on_step_end=on_step_end)
    tk.reset_launches()
    try:
        res = loop.fit(epochs=epochs, batch_size=FL_GLOBAL)
    except ChaosKilled:
        with open(os.path.join(out_dir, "killed.json"), "w") as f:
            json.dump({"rank": rank, "t": time.monotonic(), "gen": gen}, f)
        os._exit(1)
    rec.update(end=res.step, resumed_from=res.resumed_from,
               elastic=res.elastic, prefix=net.prefix,
               wrapper_launches=dict(tk.launches),
               numerics=res.numerics, run_report=res.run_report,
               zero=res.zero, skipped=res.skipped_steps,
               comm_health=None if res.comm_health is None else {
                   k: res.comm_health[k] for k in
                   ("checks", "watchdog_fired", "flight_records",
                    "straggler_rank", "max_skew_ms", "desync")})
    torch.save({k: p.tensor.detach().cpu()
                for k, p in sorted(net._collect_params_with_prefix().items())},
               os.path.join(out_dir, f"final_r{rank}.pt"))
    with open(path, "w") as f:
        json.dump(rec, f, default=str)
    print(f"fleet_rank {rank}: gen {gen} world {nw} done at {res.step}",
          flush=True)


def _fl_start(args, env):
    """``python -m mxnet_tpu_torch.launch args`` started, its output
    piped."""
    here = os.path.dirname(os.path.abspath(__file__))
    full = dict(os.environ)
    full["PYTHONPATH"] = here + os.pathsep + full.get("PYTHONPATH", "")
    full.update(env)
    return subprocess.Popen([sys.executable, "-m", "mxnet_tpu_torch.launch"]
                            + args, cwd=here, env=full,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)


def _fl_wait(proc, t0, timeout):
    """(CompletedProcess, wall) of a :func:`_fl_start`; its process group
    is killed at ``timeout`` seconds after ``t0``."""
    try:
        out, err = proc.communicate(
            timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        fail(f"fleet_train: {proc.args[3:6]} ran past {timeout} s")
    return (subprocess.CompletedProcess(proc.args, proc.returncode, out, err),
            time.perf_counter() - t0)


def _fl_launch(args, env, timeout):
    t = time.perf_counter()
    return _fl_wait(_fl_start(args, env), t, timeout)


def _fl_records(out):
    recs = {}
    for name in os.listdir(out):
        if name.startswith("gen") and name.endswith(".json"):
            with open(os.path.join(out, name)) as f:
                r = json.load(f)
            recs[(r["gen"], r["rank"])] = r
    return recs


def _fl_supervised(out, events, recovery, extra=None):
    """A supervised fleet of 2; returns (proc, summary, records, wall)."""
    os.makedirs(os.path.join(out, "dumps"))
    env = {"FLEET_EVENTS": json.dumps(events), "FLEET_TARGET": "2",
           "FLEET_HOLD_GENS": "1",
           "MXTPU_MEM_DUMP_DIR": os.path.join(out, "dumps")}
    env.update(extra or {})
    proc, wall = _fl_launch(
        ["-n", "2", "--coordinator", f"127.0.0.1:{_free_port()}",
         "--supervise", "--supervise-ckpt", os.path.join(out, "ckpt_r0"),
         "--supervise-dir", os.path.join(out, "state"),
         "--supervise-grace", str(FL_GRACE_S),
         "--supervise-recovery", str(recovery), sys.executable,
         os.path.abspath(__file__), "--fleet-rank", out], env, 600)
    summary = None
    if "SUPERVISOR_SUMMARY " in proc.stdout:
        summary = json.loads(proc.stdout.split("SUPERVISOR_SUMMARY ", 1)[1]
                             .splitlines()[0])
    return proc, summary, _fl_records(out), wall


def _fl_schedule(recs):
    """``[(world, start)]`` of the generations that trained, in order."""
    gens = sorted((g, r["world"], r["start"]) for (g, rk), r in recs.items()
                  if rk == 0)
    segs = [(w, s) for _, w, s in gens]
    return [seg for i, seg in enumerate(segs)
            if i + 1 == len(segs) or segs[i + 1][1] > seg[1]]


def _fl_segment(out, world, start, stop):
    """One plain launch of a reference segment under MXTPU_ELASTIC=on:
    ``world`` ranks from the newest checkpoint in ``out`` (step ``start``)
    to ``stop`` (``(step, next_world)``: ``resize@step:next_world``, a
    checkpoint at step and the drain code) or to the end."""
    env = {"FLEET_TARGET": str(world), "MXTPU_ELASTIC": "on"}
    if stop:
        env["FLEET_STOP"] = f"{stop[0]}:{stop[1]}"
    proc, wall = _fl_launch(
        ["-n", str(world), "--coordinator", f"127.0.0.1:{_free_port()}",
         sys.executable, os.path.abspath(__file__), "--fleet-rank", out],
        env, 400)
    want = 75 if stop else 0
    if proc.returncode != want:
        print(proc.stdout[-3000:], proc.stderr[-6000:], file=sys.stderr)
        fail(f"fleet_train reference segment ({world}, {start} -> {stop}): "
             f"exit {proc.returncode}, expected {want}")
    return wall


def _fl_reference(torch, tmp, segs, seeds):
    """The unsupervised reference of a world schedule (``[(world,
    start)]``): plain launches over the same worlds from the same
    checkpoint steps, each segment from the checkpoint the previous one
    wrote. The first segment is the supervised run's own generation 0 (a
    plain launch until the kill): the chain starts from the checkpoint its
    successor resumed from, copied from ``seeds``. Returns rank 0's final
    weights and the segments' walls."""
    import shutil
    out = os.path.join(tmp, "ref")
    first = f"ckpt-{segs[1][1]}"
    shutil.copytree(os.path.join(seeds, first),
                    os.path.join(out, "ckpt_r0", first))
    walls = []
    for i in range(1, len(segs)):
        stop = (segs[i + 1][1], segs[i + 1][0]) if i + 1 < len(segs) \
            else None
        walls.append(_fl_segment(out, segs[i][0], segs[i][1], stop))
    return torch.load(os.path.join(out, "final_r0.pt")), walls


def _fl_numerics_reference(torch, mt, np):
    """fleet_train (c)'s one-process reference of step 0: both ranks'
    batches (the first of each rank's shard) through two copies of the
    net, each with its own BatchNorm statistics, the gradients summed in
    rank order (the gloo sum), then one gluon.Trainer update of the same
    net sampled by the numerics plane: its per-parameter records."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.telemetry import numerics
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark,
            {k: os.environ.get(k) for k in ("MXTPU_OPTIMIZER_AGGREGATION",
                                            "MXTPU_NUMERICS")})
    _dt_setup(torch)
    os.environ["MXTPU_NUMERICS"] = "on,every=1"
    try:
        return _fl_numerics_step(torch, mt, np, gloss, numerics)
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = prev[:2]
        for k, v in prev[2].items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _fl_numerics_step(torch, mt, np, gloss, numerics):
    X, Y = _fl_data(np)
    nets = [_dt_net(mt), _dt_net(mt)]
    lossfn = gloss.SoftmaxCrossEntropyLoss()
    for r, net in enumerate(nets):
        it = mt.io.NDArrayIter(X, Y, batch_size=FL_GLOBAL // 2, shuffle=True,
                               seed=13, num_parts=2, part_index=r)
        b = next(iter(it))
        with mt.autograd.record():
            loss = lossfn(net(mt.nd.array(b.data[0].asnumpy())),
                          mt.nd.array(b.label[0].asnumpy()))
        loss.backward()
    named = [sorted(n._collect_params_with_prefix().items()) for n in nets]
    with torch.no_grad():
        for (_, p0), (_, p1) in zip(*named):
            if p0.grad_req != "null":
                p0.grad().tensor.copy_(p0.grad().tensor + p1.grad().tensor)
    trainer = mt.gluon.Trainer(nets[0].collect_params(), "sgd", dict(GT_OPT),
                               kvstore=None)
    numerics.reset_run()
    trainer.update(FL_GLOBAL)
    stats = trainer.last_numerics_stats
    items = [(names, mat.float().cpu().numpy()) for names, mat in stats]
    rec = numerics.record_step(0, items, trainer=trainer)
    rec = dict(rec, prefix=nets[0].prefix)
    del nets, trainer
    return rec


def _fl_strip(name, prefix=None):
    """A parameter name without its net's prefix (the prefixes count
    nets per process)."""
    if prefix and name.startswith(prefix):
        return name[len(prefix):]
    return name.split("_", 1)[1] if "_" in name else name


def fleet_train(torch, mt, card):
    """The self-healing fleet at full width: two ranks sharing the card
    over gloo, each running FitLoop on dist_train's hybridized ResNet-50 v1
    (f32, batch FL_GLOBAL/2 a rank at world 2, FL_GLOBAL at world 1: the
    global batch, and with it every re-split, stays exact), checkpoints
    every FL_CKPT_EVERY steps, MXTPU_ELASTIC=on from the second generation
    on, ``MXTPU_COLL_HEALTH=1`` and a FL_TIMEOUT_S watchdog, through
    ``python -m mxnet_tpu_torch.launch -n 2 --supervise``. One supervised
    run takes both faults: (a) chaos kill@FL_EVENT_AT on rank 1 in
    generation 0, the supervisor shrinks to world 1, its spot capacity
    model offers the slot back FL_RECOVERY_S after the kill (generation 1
    holds at step FL_HOLD_AT until then) and it grows to 2; (b) chaos
    kv_hang:1 three steps into generation 2, rank 0's watchdog writes a
    flight record naming rank 1, the supervisor reads it, shrinks to 1 and
    the run finishes: the schedule FL_SCHEDULE. Its final weights must
    equal bit for bit plain launches over the same world schedule from the
    same checkpoint steps (generation 0 is a plain launch until the kill,
    so the chain starts from the checkpoint generation 1 resumed from).
    (c), while the reference chain runs: two epochs under MXTPU_ZERO=1 at
    world 2 with MXTPU_NUMERICS sampling every step and nan_grad@1: both
    ranks publish the same merged stats, equal to a one-process reference
    of step 0 (non-finite counts and maxima exactly, sums 1e-6 relative),
    name the same culprit, write run reports with world_size 2, and the
    device runs 48 of each BN kernel in FitLoop's own step 2 (profiled
    from the step callbacks). (d) MXTPU_SUPERVISE_MAX_RESTARTS=0: the
    first death fails the job with the forensic bundle (over the flight
    records of (b)). Each part prints its row as it ends."""
    import shutil
    import tempfile
    import numpy as np
    here = os.path.dirname(os.path.abspath(__file__))
    off = time.time() - time.monotonic()     # epoch minus monotonic
    tmp = tempfile.mkdtemp(dir=here, prefix="fleet_")
    out = {"phase": "fleet_train", "card": card,
           "model": 'get_model("resnet50_v1", layout="NHWC"), hybridized, '
                    "f32, TF32 off, deterministic cuDNN",
           "global_batch": FL_GLOBAL, "steps": FL_STEPS,
           "ckpt_every": FL_CKPT_EVERY, "event_at": FL_EVENT_AT,
           "recovery_s": FL_RECOVERY_S, "hold_at": FL_HOLD_AT,
           "watchdog_s": FL_TIMEOUT_S}
    try:
        a = os.path.join(tmp, "a")
        proc, summ, recs, wall = _fl_supervised(
            a, {"0": {"kind": "kill", "rank": 1, "at": FL_EVENT_AT},
                "2": {"kind": "kv_hang", "rank": 1, "offset": 3}},
            FL_RECOVERY_S, {"MXTPU_COLL_TIMEOUT_S": str(FL_TIMEOUT_S),
                            "MXTPU_COLL_HEALTH": "1"})
        if proc.returncode != 0 or summ is None:
            print(proc.stdout[-3000:], proc.stderr[-8000:], file=sys.stderr)
            fail(f"fleet_train: supervised run exit {proc.returncode}")
        segs = _fl_schedule(recs)
        gl = summ["gen_log"]
        r0 = {g: r for (g, rk), r in recs.items() if rk == 0}
        last = r0[max(r0)]
        with open(os.path.join(a, "killed.json")) as f:
            killed = json.load(f)
        from mxnet_tpu_torch.telemetry import collective as coll
        flights = coll.scan_flight_records(os.path.join(a, "dumps"))
        named = [f for f in flights if f["absent_rank"] == 1]
        since = min(f["hung_since"] for f in named) if named else None
        hang_gen = next((i for i, e in enumerate(summ["gen_log"])
                         if e["outcome"] == "incident" and i > 0), None)
        ms = lambda r: sorted(r.get("step_ms", [0])[1:] or [0])
        out["run"] = {
            "schedule": segs, "events": summ["events"],
            "grows": summ["grows"], "restarts": summ["restarts"],
            "final_world": summ["final_world"], "end": last.get("end"),
            "elastic": last.get("elastic"),
            "comm_health": last.get("comm_health"),
            "generations": [{k: r.get(k) for k in (
                "gen", "world", "start", "end", "t_start", "t_joined",
                "t_built", "t_first_step")} for g, r in sorted(r0.items())],
            "gen_log": gl,
            "flight_records": [{k: f[k] for k in ("rank", "absent_rank",
                                                  "hung_since")}
                               for f in flights],
            "kill_detection_ms": 1e3 * (gl[0]["t_decide"] - killed["t"]),
            "hang_detection_ms": None if since is None or hang_gen is None
            else 1e3 * (gl[hang_gen]["t_decide"] + off - since),
            "relaunch_ms": [1e3 * (r0[g]["t_joined"] - gl[g - 1]["t_decide"])
                            for g in sorted(r0) if g >= 1],
            "join_to_first_step_ms": [
                1e3 * (r["t_first_step"] - r["t_joined"])
                for g, r in sorted(r0.items()) if r.get("t_first_step")],
            "steps_redone": [FL_EVENT_AT - segs[1][1]] + (
                [r0[hang_gen]["start"] + 3 - segs[3][1]]
                if hang_gen is not None and len(segs) > 3 else []),
            "step_ms_world2": ms(r0.get(2, {})),
            "step_ms_world1": ms(last),
            "step_ms_note": "generation 2 (world 2) and 3 (world 1) "
                            "run with MXTPU_COLL_HEALTH=1, and every "
                            "second step writes a checkpoint",
            "supervised_wall_s": wall}
        emit({"phase": "fleet_train", "part": "run", **out["run"]})
        if summ["grows"] != 1 or segs != FL_SCHEDULE or \
                [e["kind"] for e in summ["events"]] != ["crash", "hang"] or \
                not named or 0 not in {f["rank"] for f in named} or \
                last.get("end") != FL_STEPS:
            fail(f"fleet_train (a, b): {out['run']}")
        # restore: the final checkpoint into a fresh net, on the card
        from mxnet_tpu_torch import fault
        net = _dt_net(mt)
        tr = mt.gluon.Trainer(net.collect_params(), "sgd", dict(GT_OPT))
        cm = fault.CheckpointManager(os.path.join(a, "ckpt_r0"))
        torch.cuda.synchronize()
        t = time.perf_counter()
        cm.restore_latest(net=net, trainer=tr)
        torch.cuda.synchronize()
        out["run"]["restore_ms"] = 1e3 * (time.perf_counter() - t)
        del net, tr
        torch.cuda.empty_cache()

        # (c) numerics merged under distributed ZeRO, run reports: started
        # now, it shares the card with the reference chain
        c = os.path.join(tmp, "c")
        os.makedirs(c)
        t_c = time.perf_counter()
        proc_c = _fl_start(
            ["-n", "2", "--coordinator", f"127.0.0.1:{_free_port()}",
             sys.executable, os.path.abspath(__file__), "--fleet-rank", c],
            {"MXTPU_ZERO": "1", "MXTPU_NUMERICS": "on,every=1",
             "FLEET_CHAOS": "nan_grad@1", "FLEET_EPOCHS": "2",
             "FLEET_PROFILE": "2",
             "MXTPU_RUN_REPORT_DIR": os.path.join(c, "reports"),
             "MXTPU_MEM_DUMP_DIR": os.path.join(c, "dumps")})
        try:
            # the unsupervised reference of the same schedule, bit for bit
            want, ref_walls = _fl_reference(torch, tmp, segs,
                                            os.path.join(a, "resumed"))
        except BaseException:
            os.killpg(proc_c.pid, 9)
            proc_c.communicate()
            raise
        proc, wall = _fl_wait(proc_c, t_c, 400)
        bad = _not_bitwise(torch, torch.load(os.path.join(a, "final_r0.pt")),
                           want)
        out["reference"] = {"walls_s": ref_walls, "not_bitwise": bad[:8],
                            "tensors": len(want),
                            "restore_ms": out["run"]["restore_ms"]}
        emit({"phase": "fleet_train", "part": "reference",
              **out["reference"]})
        if bad:
            fail(f"fleet_train: not bit for bit: {out['reference']}")
        if proc.returncode != 0:
            print(proc.stdout[-3000:], proc.stderr[-8000:], file=sys.stderr)
            fail(f"fleet_train (c): exit {proc.returncode}")
        recs = _fl_records(c)
        ranks = [recs[(0, r)] for r in range(2)]
        ref = _fl_numerics_reference(torch, mt, np)
        torch.cuda.empty_cache()
        got0 = ranks[0]["numerics"]["recent"][0]
        same = ranks[0]["numerics"]["recent"] == \
            ranks[1]["numerics"]["recent"]
        culprits = [r["numerics"]["culprits"] for r in ranks]
        want = {_fl_strip(k, ref["prefix"]): v
                for k, v in ref["per_param"].items()}
        gotp = {_fl_strip(k, ranks[0]["prefix"]): v
                for k, v in got0["per_param"].items()}
        worst, exact_bad = 0.0, []
        for k, st in want.items():
            got_st = gotp.get(k, {})
            if set(got_st) != set(st):
                exact_bad.append((k, sorted(got_st), sorted(st)))
                continue
            for f, v in st.items():
                g = got_st[f]
                if f in ("absmax", "nonfinite"):
                    if g != v:
                        exact_bad.append((k, f, g, v))
                else:
                    worst = max(worst, abs(g - v) / max(abs(v), 1e-30))
        reports = []
        for r in ranks:
            with open(r["run_report"]) as f:
                reports.append(json.load(f)["fingerprint"]["world_size"])
        out["numerics_zero"] = {
            "zero": ranks[0]["zero"], "ranks_same_records": same,
            "culprits": culprits, "skipped": ranks[0]["skipped"],
            "params_compared": len(want), "exact_mismatches": exact_bad[:5],
            "max_rel_err_sums": worst,
            "grad_norm": [got0["grad_norm"], ref["grad_norm"]],
            "report_world_size": reports,
            "step_ms_world2_beside_the_reference": ms(ranks[0]),
            "profiled_step": [r.get("profiled_step") for r in ranks],
            "device_launches_per_step": [
                r.get("device_launches_per_step") for r in ranks],
            "wall_s": wall}
        emit({"phase": "fleet_train", "part": "numerics_zero",
              **out["numerics_zero"]})
        if not same or culprits[0] != culprits[1] or not culprits[0] or \
                exact_bad or worst > 1e-6 or set(gotp) != set(want) or \
                reports != [2, 2] or ranks[0]["zero"]["world"] != 2:
            fail(f"fleet_train (c): {out['numerics_zero']}")
        for r, dl in enumerate(out["numerics_zero"][
                "device_launches_per_step"]):
            if not dl or any(n != 48 for n in dl.values()) or \
                    ranks[r].get("profiled_step") != 2:
                fail(f"fleet_train: rank {r}: 48 device launches of each "
                     f"BN kernel a step expected, got {dl}")

        # (d) no restart budget: fail loudly with the bundle
        d = os.path.join(tmp, "d")
        shutil.copytree(os.path.join(a, "dumps"), os.path.join(d, "dumps"))
        proc, wall = _fl_launch(
            ["-n", "2", "--coordinator", f"127.0.0.1:{_free_port()}",
             "--supervise", "--supervise-dir", os.path.join(d, "state"),
             sys.executable, "-c", "import sys; sys.exit(3)"],
            {"MXTPU_SUPERVISE_MAX_RESTARTS": "0",
             "MXTPU_MEM_DUMP_DIR": os.path.join(d, "dumps")}, 120)
        summ = json.loads(proc.stdout.split("SUPERVISOR_SUMMARY ", 1)[1]
                          .splitlines()[0]) \
            if "SUPERVISOR_SUMMARY " in proc.stdout else {}
        bundle = summ.get("forensics")
        out["budget"] = {"exit": proc.returncode,
                         "bundle_files": sorted(os.listdir(bundle))
                         if bundle else None, "wall_s": wall}
        emit({"phase": "fleet_train", "part": "budget", **out["budget"]})
        if proc.returncode != 1 or not bundle or "events.json" not in \
                out["budget"]["bundle_files"] or not any(
                n.startswith("coll_flight_")
                for n in out["budget"]["bundle_files"]):
            fail(f"fleet_train (d): {out['budget']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit(out)
    return out


# ---------------------------------------------------------------------------
# mesh_lm: the meshes at full width, two ranks sharing the card over gloo
# ---------------------------------------------------------------------------

MESH_AXES = ("tp", "sp", "dp", "pp", "ep")
# each mesh in bf16 (the configuration) and in f32 (the gradients' check)
MESH_CASES = tuple((a + suffix, {a: 2}) for suffix in ("", "_f32")
                   for a in MESH_AXES)
MESH_STEPS = 3
MESH_SPMD_BATCH = 128                 # global; 64 a rank
BN_MOMENTUM = 0.9                     # gluon BatchNorm's default
SPMD_CASES = (("spmd_dp", "bfloat16"), ("spmd_dp_f32", None))
SPMD_TOP = ("features.7.2.", "output.")     # the last block and the head
# SPMDTrainer {dp: 2} against its one-process step on the whole batch:
# each error at most SPMD_FLOOR_X times the same error of the
# one-process step on the batch with its halves swapped (the rounding
# floor: ResNet-50 at its initial weights amplifies rounding through its
# depth, and a reordered f32 batch moves the first block's updates by
# 2 %); the loss within SPMD_LOSS_TOL (relative)
SPMD_FLOOR_X = 4.0
SPMD_LOSS_TOL = {"spmd_dp": 1e-2, "spmd_dp_f32": 1e-5}


def _mesh_f32(name):
    return name.endswith("_f32")


def _mesh_lr(name):
    """bf16: the LM's own default (1e-3); f32 steps at 0.1, so the
    updates carry the gradients far above f32 rounding (bf16 rounds
    ``w - lr g`` to 2^-8 |w|, above most updates at either rate)."""
    return 0.1 if _mesh_f32(name) else 1e-3


def _mesh_ref(name):
    """The one-process run a mesh case is held to: the dense or the MoE
    LM, in the case's dtype."""
    return ("ep" if name.startswith("ep") else "tp") + (
        "_f32" if _mesh_f32(name) else "")


def _mesh_cfg(tf, torch, name):
    return tf.TransformerConfig(
        dtype=None if _mesh_f32(name) else torch.bfloat16,
        **(MOE_CFG if name.startswith("ep") else {}))


def _mesh_tokens(torch, mt, cfg):
    gen = mt.random.seed(1)
    tok = torch.randint(0, cfg.vocab_size, (TF_BATCH, TF_T), generator=gen,
                        device="cuda")
    tgt = torch.randint(0, cfg.vocab_size, (TF_BATCH, TF_T), generator=gen,
                        device="cuda")
    return tok, tgt


def _mesh_resnet(torch, mt):
    """The SPMD check's net, its loss, a ``(1, MESH_SPMD_BATCH)`` batch
    whose two dp halves come from different distributions (the second
    half is ``2 u + 0.5``, so per-rank BatchNorm statistics are far from
    the global ones), and every parameter before the first step (the
    deferred shapes resolved by one inference forward, which leaves the
    running statistics as they were)."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    net = get_model("resnet50_v1", layout="NHWC")
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = torch.rand((1, MESH_SPMD_BATCH, IMG, IMG, 3), generator=gen,
                   device="cuda")
    x[:, MESH_SPMD_BATCH // 2:] = x[:, MESH_SPMD_BATCH // 2:] * 2.0 + 0.5
    y = torch.randint(0, 1000, (1, MESH_SPMD_BATCH), generator=gen,
                      device="cuda").float()
    with mt.autograd.pause(), torch.no_grad():
        net(x[0, :2])
    return net, gloss.SoftmaxCrossEntropyLoss(), x, y, _params_of(net)


def _spmd_trainer(torch, SPMDTrainer, net, lossfn, dtype, mesh=None):
    return SPMDTrainer(net, lossfn, mesh=mesh,
                       dtype=dtype and getattr(torch, dtype),
                       optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})


def _params_of(net):
    """Every parameter of ``net`` (running statistics included) by its
    structural name, f32, on the host."""
    return {k: p.tensor.detach().float().cpu().clone()
            for k, p in sorted(net._collect_params_with_prefix().items())}


def _spmd_errors(torch, got, want, start):
    """SPMDTrainer's first step against another: the largest relative L2
    error of the step's BatchNorm batch moments (``(running - m
    running0) / (1 - m)``), of the weights' updates (``w - w0``, the
    convolutions and the dense layer: a BatchNorm beta's gradient is the
    small remainder of a cancelling sum), and of the updates of the
    weights next to the loss (SPMD_TOP: backward amplifies rounding
    with depth, and there it has not yet)."""
    out = {"moments_l2": 0.0, "updates_l2": 0.0, "top_updates_l2": 0.0,
           "worst": {}}

    def keep(key, k, e):
        if e > out[key]:
            out[key], out["worst"][key] = e, k
    for k, w in want.items():
        s0 = start[k]
        if k.endswith(("running_mean", "running_var")):
            keep("moments_l2", k, _l2(torch, got[k] - BN_MOMENTUM * s0,
                                      w - BN_MOMENTUM * s0))
        elif w.dim() >= 2:
            e = _l2(torch, got[k] - s0, w - s0)
            keep("updates_l2", k, e)
            if k.startswith(SPMD_TOP):
                keep("top_updates_l2", k, e)
    return out


def mesh_rank(argv):
    """One rank of mesh_lm, started by ``python -m mxnet_tpu_torch.launch
    -n 2 python3 chip_smoke.py --mesh-rank DIR``: the LM's train steps on
    each mesh of MESH_CASES (the MoE LM on ep), the pipeline step on pp,
    then SPMDTrainer over {dp: 2} on ResNet-50 v1 bf16; rank 0 writes the
    gathered weights and every rank its numbers to DIR."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    from mxnet_tpu_torch.parallel import SPMDTrainer
    from mxnet_tpu_torch.parallel import collectives as coll
    from mxnet_tpu_torch.parallel.mesh import make_mesh
    from mxnet_tpu_torch.parallel.sharding import P, gather
    out_dir = argv[0]
    if not kvstore_server.init_distributed():
        fail("mesh_rank: no group in the environment")
    rank = coll.rank()
    rows = {}
    for name, axes in MESH_CASES:
        cfg = _mesh_cfg(tf, torch, name)
        mesh = make_mesh(axes)
        params = tf.init_params(mt.random.seed(0), cfg)
        tok, tgt = _mesh_tokens(torch, mt, cfg)
        if name.startswith("pp"):
            step, prep = tf.make_pipeline_train_step(cfg, mesh,
                                                     lr=_mesh_lr(name),
                                                     n_microbatches=2)
        else:
            step, prep = tf.make_train_step(cfg, mesh, lr=_mesh_lr(name))
        local = prep(params)
        del params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        coll.reset_wire_bytes()
        fa.reset_launches()
        losses, ms = [], []
        for _ in range(MESH_STEPS):
            t = time.perf_counter()
            loss, local = step(local, tok, tgt)
            losses.append(float(loss))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
        wire = dict(coll.wire_bytes)
        rows[name] = {"losses": losses, "step_ms": ms,
                      "step_ms_warm": sorted(ms[1:])[0],
                      "wire_bytes_per_step": {k: v / MESH_STEPS for k, v in
                                              wire.items() if v},
                      "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                      "flash_launches_per_step": {
                          str(h): n / MESH_STEPS for h, n in
                          fa.launch_heads.items()}}
        if name.startswith("pp"):
            S = mesh.axis_size("pp")
            lps = cfg.n_layers // S
            flat = {k: local[k] for k in ("embed", "ln_f_scale",
                                          "ln_f_bias")}
            for j, lp in enumerate(local["stages"]):
                for k, v in tf.flat_params(lp).items():
                    g = gather(v[None], P("pp"), mesh)
                    for s in range(S):
                        flat[f"layer{s * lps + j}/{k}"] = g[s]
        else:
            flat = tf.flat_params(tf.gather_params(local, cfg, mesh))
        if rank == 0:
            torch.save({k: v.detach().cpu() for k, v in flat.items()},
                       os.path.join(out_dir, f"{name}.pt"))
        del local, flat
        torch.cuda.empty_cache()
        coll.barrier()
    # SPMDTrainer over {dp: 2}: the main path's ResNet-50 v1 in bf16, and
    # in f32 for a tight check of the statistics and the gradients
    import contextlib
    mesh = make_mesh({"dp": 2})
    saved = {}
    for name, dtype in SPMD_CASES:
        net, lossfn, x, y, start = _mesh_resnet(torch, mt)
        tr = _spmd_trainer(torch, SPMDTrainer, net, lossfn, dtype, mesh)
        tk.reset_launches()
        coll.reset_wire_bytes()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        loss1 = tr.run_steps(x, y)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t)
        launches = dict(tk.launches)
        saved[name] = _params_of(net)
        t = time.perf_counter()
        tr.run_steps(x, y)
        torch.cuda.synchronize()
        rows[name] = {
            "loss1": float(loss1[0]), "first_ms": first_ms,
            "step_ms": 1e3 * (time.perf_counter() - t),
            "bn_wrapper_launches_per_step": launches,
            "wire_bytes_per_step": {
                k: v / 2 for k, v in coll.wire_bytes.items() if v},
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
            "run_steps_mode": tr.run_steps_mode,
            "eager_mesh_steps": tr.eager_mesh_steps}
        del net, tr
        torch.cuda.empty_cache()
    # the controls: the first step with per-rank statistics (the
    # trainer's BatchNorm all-reduce left out), which the check must refuse
    for name, dtype in SPMD_CASES:
        net, lossfn, x, y, _ = _mesh_resnet(torch, mt)
        tr = _spmd_trainer(torch, SPMDTrainer, net, lossfn, dtype, mesh)
        tr._bn_scope = contextlib.nullcontext
        tr.run_steps(x, y)
        saved["per_rank_" + name] = _params_of(net)
        del net, tr
    if rank == 0:
        torch.save(dict(saved, start=start),
                   os.path.join(out_dir, "spmd.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rows, f)
    print(f"mesh_rank {rank}: done", flush=True)


def _l2(torch, a, b):
    return float(torch.linalg.vector_norm(a - b)) / max(
        float(torch.linalg.vector_norm(b)), 1e-30)


def _mesh_close(torch, got, want, start=None, tol=None):
    """The largest relative L2 error over the tensors of ``want``: of the
    values, and, with ``start``, of the matrices' updates (``w - w0``:
    what a wrong gradient would move); with ``tol``, the largest excess of
    any element over ``tol + tol |want|`` (the bf16 parity tests' rule,
    ``tests/test_torch_transformer.py``), 0 when every element is
    within."""
    worst = {"values_l2": 0.0, "worst_tensor": None}
    if start is not None:
        worst["updates_l2"] = 0.0
    if tol is not None:
        worst["excess"] = 0.0
    for k, w in want.items():
        g, w = got[k].float(), w.float()
        e = _l2(torch, g, w)
        if e > worst["values_l2"]:
            worst["values_l2"], worst["worst_tensor"] = e, k
        if start is not None and w.dim() >= 2:
            s = start[k].float()
            worst["updates_l2"] = max(worst["updates_l2"],
                                      _l2(torch, g - s, w - s))
        if tol is not None:
            worst["excess"] = max(worst["excess"], float(
                ((g - w).abs() - tol - tol * w.abs()).max().clamp_min(0)))
    return worst


def mesh_lm(torch, mt, card):
    """The meshes at full width: ``TransformerConfig()`` at batch TF_BATCH
    x T TF_T over two ranks sharing the card over gloo, three
    ``make_train_step`` steps on {tp: 2}, {sp: 2} (ring attention),
    {dp: 2}, ``make_pipeline_train_step`` on {pp: 2} (2 microbatches), the
    MoE LM (MOE_CFG) on {ep: 2}; each mesh twice, each held to the same
    model's one-process steps on the card: in bf16 (SGD at the LM's
    default lr, 1e-3) the losses within 1e-4 relative and every element
    of every gathered weight within ``2e-2 + 2e-2 |w|`` (the rule of
    ``tests/test_torch_transformer.py``'s bf16 cases); bf16 rounds ``w -
    lr g`` to a unit in the last place of ``w``, far above most updates,
    so the gradients are held in f32 at lr 0.1 (``<mesh>_f32``): losses,
    weights and every matrix's update within 1e-4 (relative L2). Flash at
    H 4 a rank under tp and never under sp. Then SPMDTrainer(mesh={dp:
    2}) on ResNet-50 v1 NHWC, batch MESH_SPMD_BATCH/2 a rank, the two
    halves from different distributions, in bf16 and in f32, against the
    one-process step on the whole batch: the first step's BatchNorm batch
    moments, its weights' updates and those next to the loss within
    SPMD_FLOOR_X times the rounding floor (the one-process step on the
    batch with its halves swapped, measured here), its loss within
    SPMD_LOSS_TOL, while a control that leaves the statistics per rank
    must miss the moments' limit; 48 launches of each BN kernel a
    rank a step, the K steps of run_steps eager. Also the flash kernel at the tp shape (B
    TF_BATCH, T TF_T, H 4, D 64, causal, bf16) against its plain version,
    its bound and SDPA, and the recipes of the mesh examples
    (``tests/dist/torch_mesh_examples.py``: long context over {sp: 2},
    the model-parallel matrix factorization over {mp: 2}) at the examples'
    default sizes (the long-context loss down by 30 % in 20 steps)."""
    import math
    import tempfile
    import numpy as np
    import torch.nn.functional as F
    from mxnet_tpu_torch.models import transformer as tf
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.parallel import SPMDTrainer
    here = os.path.dirname(os.path.abspath(__file__))
    refs, one, starts = {}, {}, {}
    for name in ("tp", "ep", "tp_f32", "ep_f32"):  # dense, MoE; bf16, f32
        cfg = _mesh_cfg(tf, torch, name)
        params = tf.init_params(mt.random.seed(0), cfg)
        starts[name] = {k: v.detach().cpu()
                        for k, v in tf.flat_params(params).items()}
        tok, tgt = _mesh_tokens(torch, mt, cfg)
        step, _ = tf.make_train_step(cfg, lr=_mesh_lr(name))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, ms = [], []
        for _ in range(MESH_STEPS):
            t = time.perf_counter()
            loss, params = step(params, tok, tgt)
            losses.append(float(loss))
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t))
        refs[name] = {k: v.detach().cpu()
                      for k, v in tf.flat_params(params).items()}
        one[name] = {"losses": losses, "step_ms_warm": sorted(ms[1:])[0],
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del params
        torch.cuda.empty_cache()
    # the flash kernel at the tensor-parallel rank's shape
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = flash_inputs(torch, TF_BATCH, TF_T, 4, 64, torch.bfloat16,
                           "qkv", gen)
    sc = 1.0 / 8.0
    got = fa.flash_fwd(q, k, v, True, sc)
    want = fa._flash_plain(q, k, v, True, sc)
    err = (got.float() - want.float()).abs()
    tol = flash_tolerance(torch, fa.flash_route(q, k, v), want, v)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    frow = {"shape": [TF_BATCH, TF_T, 4, 64], "causal": True,
            "route": fa.flash_route(q, k, v),
            "max_abs_err": float(err.max()),
            "within_tolerance": bool((err <= tol).all())}
    _time_flash(torch, fa, frow, q, k, v, True, sc, flush, F)
    del q, k, v, got, want, err, tol, flush
    torch.cuda.empty_cache()
    # SPMDTrainer's one-process step on the whole batch, and on the batch
    # with its halves swapped (the rounding floor)
    first_one, floor = {}, {}
    half = MESH_SPMD_BATCH // 2
    swap = torch.cat([torch.arange(half, 2 * half), torch.arange(half)])
    for name, dtype in SPMD_CASES:
        net, lossfn, x, y, start_one = _mesh_resnet(torch, mt)
        tr = _spmd_trainer(torch, SPMDTrainer, net, lossfn, dtype)
        torch.cuda.reset_peak_memory_stats()
        loss1 = float(tr.step(x[0], y[0]))
        first_one[name] = _params_of(net)
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.step(x[0], y[0])
        torch.cuda.synchronize()
        one[name] = {"loss1": loss1,
                     "step_ms": 1e3 * (time.perf_counter() - t),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del net, tr
        net, lossfn, _, _, _ = _mesh_resnet(torch, mt)
        tr = _spmd_trainer(torch, SPMDTrainer, net, lossfn, dtype)
        sw = swap.to(x.device)
        loss_swap = float(tr.step(x[0][sw], y[0][sw]))
        floor[name] = _spmd_errors(torch, _params_of(net), first_one[name],
                                   start_one)
        floor[name]["loss1"] = abs(loss_swap - loss1) / abs(loss1)
        del net, tr, x, y
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=here) as out_dir:
        proc, wall = _dt_launch(
            [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
             sys.executable, os.path.abspath(__file__), "--mesh-rank",
             out_dir], 900, "mesh_lm ranks")
        ranks = []
        for r in range(2):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        errs = {}
        for name, _ in MESH_CASES:
            gotw = torch.load(os.path.join(out_dir, f"{name}.pt"))
            ref = _mesh_ref(name)
            if set(gotw) != set(refs[ref]):
                fail(f"mesh_lm {name}: parameter names differ")
            f32 = _mesh_f32(name)
            errs[name] = _mesh_close(torch, gotw, refs[ref],
                                     starts[ref] if f32 else None,
                                     None if f32 else 2e-2)
            errs[name]["losses"] = max(
                abs(a - b) / abs(b) for a, b in
                zip(ranks[0][name]["losses"], one[ref]["losses"]))
        # the mesh examples' recipes at the examples' default sizes
        examples = {}
        proc, ewall = _dt_launch(
            [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
             sys.executable, os.path.join(here, "tests", "dist",
                                          "torch_mesh_examples.py"),
             "long_context,matrix_factorization", out_dir, "--dp", "1",
             "--sp", "2", "--mp", "2"], 300, "mesh_lm examples")
        for recipe in ("long_context", "matrix_factorization"):
            losses = np.load(os.path.join(out_dir, f"{recipe}.npz"))[
                "losses"]
            examples[recipe] = {"first": float(losses[0]),
                                "last": float(losses[-1]),
                                "steps": len(losses)}
        examples["wall_s"] = ewall
        spmd = torch.load(os.path.join(out_dir, "spmd.pt"))
        if _not_bitwise(torch, spmd["start"], start_one):
            fail("mesh_lm: the SPMD nets start from different weights")
        for name, _ in SPMD_CASES:
            errs[name] = _spmd_errors(torch, spmd[name], first_one[name],
                                      start_one)
            errs[name]["loss1"] = abs(
                ranks[0][name]["loss1"] - one[name]["loss1"]) / abs(
                one[name]["loss1"])
        control = {name: _spmd_errors(torch, spmd["per_rank_" + name],
                                      first_one[name], start_one)
                   for name, _ in SPMD_CASES}
    row = {"phase": "mesh_lm", "card": card, "ranks": 2,
           "model": "TransformerConfig(dtype=bf16), B 8, T 2048; MoE: "
                    "MOE_CFG; f32 for the gradients; ResNet-50 v1 NHWC "
                    "bf16 and f32 batch 64 a rank",
           "per_rank": ranks, "one_process": one, "errors": errs,
           "spmd_floor_halves_swapped": floor,
           "spmd_per_rank_statistics_control": control,
           "flash_tp_shape": frow, "ranks_wall_s": wall,
           "examples": examples}
    emit(row)
    # the long-context task is learnable in 20 steps (CPU: 5.548 ->
    # 2.905); the factorization's 100 steps from 0.01-scale tables barely
    # move the MSE, so it is held to finite values
    if not examples["long_context"]["last"] < \
            0.7 * examples["long_context"]["first"] or not all(
            math.isfinite(examples[r]["last"]) for r in
            ("long_context", "matrix_factorization")):
        fail(f"mesh_lm: the mesh examples' recipes: {examples}")
    def over_floor(n, e):
        return [k for k in ("moments_l2", "updates_l2", "top_updates_l2")
                if e[k] > SPMD_FLOOR_X * max(floor[n][k], 1e-7)]

    def off(n, e):
        if n in floor:
            return bool(over_floor(n, e)) or e["loss1"] > SPMD_LOSS_TOL[n]
        if _mesh_f32(n):
            return max(e["values_l2"], e["updates_l2"], e["losses"]) > 1e-4
        return e["excess"] > 0 or e["losses"] > 1e-4
    bad = [n for n, e in errs.items() if off(n, e)]
    if bad:
        fail(f"mesh_lm: beyond tolerance of the one-process step: {bad} "
             f"{errs}")
    if any("moments_l2" not in over_floor(n, e) for n, e in control.items()):
        fail(f"mesh_lm: per-rank BatchNorm statistics pass the global-batch "
             f"check: {control}")
    for r in range(2):
        per = ranks[r]
        if per["tp"]["flash_launches_per_step"] != {"4": 4.0}:
            fail(f"mesh_lm: rank {r}: flash under tp "
                 f"{per['tp']['flash_launches_per_step']}, expected 4 "
                 "launches a step at H 4")
        if per["sp"]["flash_launches_per_step"]:
            fail(f"mesh_lm: rank {r}: flash launched under sp")
        for name, _ in SPMD_CASES:
            bn = per[name]["bn_wrapper_launches_per_step"]
            if any(n != 48 for n in bn.values()) or \
                    per[name]["run_steps_mode"] != "eager":
                fail(f"mesh_lm: rank {r}: SPMD dp {per[name]}")
    if not frow["within_tolerance"]:
        fail(f"mesh_lm: flash at the tp shape off its plain version: {frow}")
    return row


# ---------------------------------------------------------------------------
# A11: sparse storage and the sparse embedding plane
# ---------------------------------------------------------------------------

SP_FEATURES, SP_BATCH, SP_NNZ = 10000, 256, 32      # linear_classification
SP_TOL = 1e-6           # f32 values: relative to the output's magnitude
MF_DEFAULTS = dict(users=100000, items=50000, dim=16, batch=4096, lr=0.02,
                   true_rank=4, noise=0.1)
MF_STEPS, MF_TIMED = 3, 20
MF_TOL = 1e-5
MF_SMOKE = ["--iters", "150", "--users", "800", "--items", "400",
            "--batch-size", "1024", "--lr", "0.02"]   # the JAX smoke test's
TT = dict(users=4096, items=4096, dim=16, proj=16, batch=256, iters=400,
          lr=0.05, world=4, true_rank=4, init_scale=0.3)  # two_tower full
TT_SMOKE = dict(TT, users=128, items=128, dim=8, iters=150, batch=128)
GIANT = dict(rows=1 << 23, dim=64, world=4, users=8192, items=8192,
             steps=20, cap=16384, check_at=3)
SE_ROWS, SE_DIM, SE_IDS = 1 << 20, 64, 8192          # ShardedEmbedding
SP_RECIPE_LINEAR = "examples/sparse/linear_classification.py"
SP_RECIPE_MF = "examples/recommenders/matrix_fact_sparse.py"


def _card_device(torch):
    """Where the sparse phases compute: the card."""
    return torch.device("cuda", 0)


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _wall_ms(torch, fn, iters=20):
    """Mean host-clock ms of ``fn`` over ``iters`` calls ending in a
    synchronize: a sparse op is host-orchestrated, so its host work is
    part of a call."""
    fn()
    _sync(torch)
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(torch)
    return (time.perf_counter() - t) * 1e3 / iters


def _rel_err(torch, got, want):
    """max |got - want| over max(1, max |want|)."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    if want.numel() == 0:
        return 0.0
    return float((got - want).abs().max() / max(1.0, float(
        want.abs().max())))


def _sp_parts(x):
    """(storage type, coordinate tensors, value tensor) of an output."""
    st = getattr(x, "stype", "default")
    if st == "csr":
        return st, (x._indices.cpu(), x._indptr.cpu()), x._data
    if st == "row_sparse":
        return st, (x._indices.cpu(),), x._data
    return st, (), x._data


def _sp_compare(torch, got, want):
    """(storage and coordinates exactly equal, max relative error) of
    two outputs or tuples of them."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    same, err = len(got) == len(want), 0.0
    for g, w in zip(got, want):
        gs, gc, gv = _sp_parts(g)
        ws, wc, wv = _sp_parts(w)
        same = same and gs == ws and len(gc) == len(wc) and all(
            torch.equal(a, b) for a, b in zip(gc, wc)) and \
            tuple(gv.shape) == tuple(wv.shape)
        if tuple(gv.shape) == tuple(wv.shape):
            err = max(err, _rel_err(torch, gv, wv))
    return same, err


def _linear_data(np):
    """A batch at the linear recipe's shape: (cols, vals) of 256 rows x
    32 nonzeros over 10000 features, drawn as its synthetic_libsvm draws
    them."""
    rs = np.random.RandomState(0)
    cols = np.stack([rs.choice(SP_FEATURES, SP_NNZ, replace=False)
                     for _ in range(SP_BATCH)])
    vals = rs.randn(SP_BATCH, SP_NNZ).astype(np.float32)
    return cols, vals


def sparse_op_cases(mt, np, ctx):
    """name -> fn() giving the op's output on ``ctx``, its inputs made
    there once from the same numpy arrays: each sparse op at the linear
    recipe's shapes."""
    sp = mt.nd.sparse
    cols, vals = _linear_data(np)
    rs = np.random.RandomState(1)
    w = rs.randn(SP_FEATURES, 1).astype(np.float32) * 0.1
    h = rs.randn(SP_BATCH, 1).astype(np.float32)
    h2 = rs.randn(SP_BATCH, 1).astype(np.float32)
    keep = np.sort(rs.choice(SP_FEATURES, 2048, replace=False))
    mom = rs.randn(SP_FEATURES, 1).astype(np.float32)
    var = np.abs(rs.randn(SP_FEATURES, 1)).astype(np.float32)
    F = SP_FEATURES

    X = sp.CSRNDArray(vals.reshape(-1), cols.reshape(-1).astype(np.int32),
                      np.arange(SP_BATCH + 1) * SP_NNZ, (SP_BATCH, F),
                      ctx=ctx)
    W, H, H2, K, M, V = (mt.nd.array(a, ctx=ctx)
                         for a in (w, h, h2, keep, mom, var))
    G = sp.dot(X, H, transpose_a=True)
    G2 = sp.dot(X, H2, transpose_a=True)
    Gd = G.todense()
    dense_x = np.zeros((SP_BATCH, F), np.float32)
    np.put_along_axis(dense_x, cols, vals, axis=1)
    Xd = mt.nd.array(dense_x, ctx=ctx)
    lazy = mt.nd._internal
    return {
        "dot_csr_dense": lambda: sp.dot(X, W),
        "dot_csrT_dense_rsp": lambda: sp.dot(X, H, transpose_a=True),
        "cast_storage_dense_to_csr": lambda: mt.nd.cast_storage(
            Xd, stype="csr"),
        "cast_storage_csr_to_dense": lambda: mt.nd.cast_storage(
            X, stype="default"),
        "cast_storage_dense_to_rsp": lambda: mt.nd.cast_storage(
            Gd, stype="row_sparse"),
        "cast_storage_rsp_to_dense": lambda: mt.nd.cast_storage(
            G, stype="default"),
        "sparse_retain": lambda: mt.nd.sparse_retain(G, K),
        "add_rsp_rsp": lambda: sp.add(G, G2),
        "sum_csr": lambda: tuple(mt.nd.sum(X, axis=a)
                                 for a in (None, 0, 1)),
        "_sparse_sgd_update": lambda: lazy._sparse_sgd_update(
            W, G.data, G.indices, lr=0.5, wd=1e-4),
        "_sparse_sgd_mom_update": lambda: lazy._sparse_sgd_mom_update(
            W, G.data, G.indices, M, lr=0.5, momentum=0.9, wd=1e-4),
        "_sparse_adam_update": lambda: lazy._sparse_adam_update(
            W, G.data, G.indices, M, V, lr=0.01, wd=1e-4),
        "_sparse_adagrad_update": lambda: lazy._sparse_adagrad_update(
            W, Gd, V, lr=0.1),
    }


def sparse_ops_phase(torch, mt, card):
    """Each sparse op on the card at the linear recipe's shapes (a batch
    of 256 x 10000 features, 32 nonzeros a row), held to the port's host
    path on the same inputs (which the CPU tests hold to the JAX
    package): coordinates exactly, values within 1e-6 of the output's
    magnitude; host-clock ms a call on the card (host work included),
    and two card runs bit for bit."""
    import numpy as np
    gpu = mt.gpu(0)
    rows, bad = {}, []
    with mt.cpu():
        host = sparse_op_cases(mt, np, mt.cpu())
    with gpu:
        card_cases = sparse_op_cases(mt, np, gpu)
    for name, fn in card_cases.items():
        with mt.cpu():
            want = host[name]()
        with gpu:
            got = fn()
            again = fn()
            ms = _wall_ms(torch, fn)
        same, err = _sp_compare(torch, got, want)
        rerun_same, rerun_err = _sp_compare(torch, again, got)
        rows[name] = {"coords_exact": same, "max_rel_err": err,
                      "rerun_bitwise": rerun_same and rerun_err == 0.0,
                      "ms": ms}
        if not same or err > SP_TOL or rows[name]["rerun_bitwise"] is False:
            bad.append(name)
    emit({"phase": "sparse_ops", "card": card, "shape": {
        "batch": SP_BATCH, "features": SP_FEATURES, "nnz_a_row": SP_NNZ},
        "tolerance_rel": SP_TOL, "ops": rows})
    if bad:
        fail(f"sparse_ops: {bad} disagree with the host path")
    return rows


def _sparse_profile(prof, wall_ms):
    """Wall and device-busy ms of one profiled sparse step, the device's
    idle share and its largest kernels."""
    kern = _device_kernels(prof)
    busy = sum(ms for ms, _ in kern.values())
    top = sorted(((ms, n, name[:80]) for name, (ms, n) in kern.items()),
                 reverse=True)[:8]
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "launches": sum(n for _, n in kern.values()),
            "top_kernels": [[round(ms, 4), n, name] for ms, n, name in top]}


def mf_net(mt, users, items, dim):
    """``examples/recommenders/matrix_fact_sparse.py``'s MFNet, as it is
    written there."""
    nn = mt.gluon.nn

    class MFNet(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self.user_emb = nn.Embedding(users, dim, sparse_grad=True)
            self.item_emb = nn.Embedding(items, dim, sparse_grad=True)
            self.user_b = nn.Embedding(users, 1, sparse_grad=True)
            self.item_b = nn.Embedding(items, 1, sparse_grad=True)

        def hybrid_forward(self, F, user, item):
            p = F.sum(self.user_emb(user) * self.item_emb(item), axis=-1)
            return p + self.user_b(user).reshape((-1,)) + \
                self.item_b(item).reshape((-1,))
    return MFNet()


def _mf_batches(np, n, cfg):
    """The recipe's planted-structure batches (its sample_batch)."""
    rs = np.random.RandomState(0)
    u_true = rs.randn(cfg["users"], cfg["true_rank"]).astype(np.float32) \
        * 0.7
    i_true = rs.randn(cfg["items"], cfg["true_rank"]).astype(np.float32) \
        * 0.7
    out = []
    for _ in range(n):
        u = rs.randint(0, cfg["users"], cfg["batch"])
        i = rs.randint(0, cfg["items"], cfg["batch"])
        r = (u_true[u] * i_true[i]).sum(1) + \
            rs.randn(cfg["batch"]).astype(np.float32) * cfg["noise"]
        out.append((u, i, r.astype(np.float32)))
    return out


def _mf_build(torch, mt, ctx, cfg, start=None):
    with ctx:
        net = mf_net(mt, cfg["users"], cfg["items"], cfg["dim"])
        net.initialize(mt.init.Normal(0.1), generator=mt.random.seed(0))
        params = net._collect_params_with_prefix()
        if start is not None:
            for k, p in params.items():
                p.set_data(start[k])
        tr = mt.gluon.Trainer(net.collect_params(), "adam",
                              {"learning_rate": cfg["lr"],
                               "lazy_update": True})
    return net, params, tr


def _mf_step(mt, net, tr, batch, ctx):
    u, i, r = batch
    with ctx:
        with mt.autograd.record():
            loss = mt.gluon.loss.L2Loss()(net(mt.nd.array(u),
                                              mt.nd.array(i)),
                                          mt.nd.array(r))
        loss.backward()
        grads = {k: p.weight.grad() for k, p in
                 (("user_emb", net.user_emb), ("item_emb", net.item_emb),
                  ("user_b", net.user_b), ("item_b", net.item_b))}
        tr.step(len(u))
    return loss, grads


def _mf_state(tr, params):
    """Per structural name, (weight, mean, var) clones."""
    by_name = {p.name: i for i, p in enumerate(tr._params)}
    out = {}
    for k, p in params.items():
        st = tr._updaters[0].states.get(by_name[p.name])
        out[k] = (p.tensor.detach().clone(),) + (
            tuple(s._data.clone() for s in st) if st else ())
    return out


class _AsPort:
    """``with _AsPort(mt, aliases):`` resolves ``mxnet_tpu`` (and
    ``aliases``, more of its module names) to the port, for recipes that
    import it at the top or inside their functions."""

    def __init__(self, mt, aliases):
        self.names = {"mxnet_tpu": mt, **aliases}

    def __enter__(self):
        self.saved = {k: sys.modules.get(k) for k in self.names}
        sys.modules.update(self.names)

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v


def _recipe_module(script):
    """``script``'s globals, run as a module (not as ``__main__``)."""
    import runpy
    here = os.path.dirname(os.path.abspath(__file__))
    return runpy.run_path(os.path.join(here, script), run_name="recipe")


def _run_recipe(mt, script, argv, aliases):
    """Run ``script``'s ``main()`` with ``mxnet_tpu`` (and ``aliases``)
    resolved to the port; returns (main's return, its stdout)."""
    import contextlib
    import io
    here = os.path.dirname(os.path.abspath(__file__))
    argv0 = sys.argv
    buf = io.StringIO()
    try:
        sys.argv = [os.path.join(here, script)] + list(argv)
        with _AsPort(mt, aliases), contextlib.redirect_stdout(buf):
            ret = _recipe_module(script)["main"]()
    finally:
        sys.argv = argv0
    print(buf.getvalue()[-2000:], end="", flush=True)
    return ret, buf.getvalue()


def sparse_mf(torch, mt, card):
    """``examples/recommenders/matrix_fact_sparse.py`` against the port at
    its defaults (100000 users x 50000 items, dim 16, batch 4096, lazy
    Adam lr 0.02, f32): every embedding gradient row_sparse with exactly
    the batch's unique rows; across a step every row outside the batch
    keeps its weight and both Adam moments bit for bit; 3 card steps
    within 1e-5 of the same 3 steps on the host from one start; ms a
    step, unique rows and gradient bytes a step, host syncs a step. Then
    the recipe file itself on the card: at the JAX smoke test's config
    (held-out RMSE < 0.3) and at its defaults."""
    import numpy as np
    from mxnet_tpu_torch.ndarray import sparse as tsp
    from mxnet_tpu_torch.telemetry.memory import nd_bytes
    cfg = MF_DEFAULTS
    gpu = mt.gpu(0)
    batches = _mf_batches(np, MF_STEPS + MF_TIMED + 1, cfg)
    net_h, params_h, tr_h = _mf_build(torch, mt, mt.cpu(), cfg)
    start = {k: p.data().asnumpy() for k, p in params_h.items()}
    net_c, params_c, tr_c = _mf_build(torch, mt, gpu, cfg, start)
    rows_ok, untouched_ok, uniq = True, True, []
    for s in range(MF_STEPS):
        u, i, _ = batches[s]
        before = _mf_state(tr_c, params_c) if s else None
        _mf_step(mt, net_h, tr_h, batches[s], mt.cpu())
        _, grads = _mf_step(mt, net_c, tr_c, batches[s], gpu)
        for name, g in grads.items():
            ids = u if name.startswith("user") else i
            want = np.unique(ids)
            rows_ok = rows_ok and g.stype == "row_sparse" and \
                g._data.shape[0] == len(want) and \
                np.array_equal(g.indices.asnumpy(), want)
        if before is not None:
            after = _mf_state(tr_c, params_c)
            for k, tensors in after.items():
                ids = u if k.startswith("user") else i
                keep = torch.ones(tensors[0].shape[0], dtype=torch.bool,
                                  device=tensors[0].device)
                keep[torch.from_numpy(np.unique(ids)).to(keep.device)] = \
                    False
                for a, b in zip(tensors, before[k]):
                    untouched_ok = untouched_ok and torch.equal(a[keep],
                                                                b[keep])
    err = max(_rel_err(torch, params_c[k].tensor, params_h[k].tensor)
              for k in params_c)
    # timed warm steps, and the host syncs of one
    ms, grad_bytes = [], []
    for s in range(MF_STEPS, MF_STEPS + MF_TIMED):
        _sync(torch)
        tsp.reset_host_syncs()
        t = time.perf_counter()
        _, grads = _mf_step(mt, net_c, tr_c, batches[s], gpu)
        _sync(torch)
        ms.append((time.perf_counter() - t) * 1e3)
        syncs = dict(tsp.host_syncs)
        uniq.append(int(grads["user_emb"]._data.shape[0]) +
                    int(grads["item_emb"]._data.shape[0]))
        grad_bytes.append(sum(nd_bytes(g) for g in grads.values()))
    dense_bytes = (cfg["users"] + cfg["items"]) * cfg["dim"] * 4
    prof, wall = _profiled(torch, lambda: _mf_step(mt, net_c, tr_c,
                                                   batches[-1], gpu))
    row = {"card": card, "config": cfg, "profiled_step": _sparse_profile(
        prof, wall), "grads_row_sparse_batch_rows":
           rows_ok, "untouched_rows_bitwise": untouched_ok,
           "card_vs_host_max_rel_err_3_steps": err, "tolerance": MF_TOL,
           "ms_a_step_median": sorted(ms)[len(ms) // 2],
           "ms_a_step_mean": sum(ms) / len(ms),
           "unique_rows_a_step": sum(uniq) / len(uniq),
           "grad_bytes_a_step": sum(grad_bytes) / len(grad_bytes),
           "dense_table_grad_bytes": dense_bytes,
           "host_syncs_a_step": syncs,
           "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    del net_c, net_h, tr_c, tr_h
    aliases = {"mxnet_tpu.gluon": mt.gluon, "mxnet_tpu.gluon.nn": mt.gluon.nn}
    with gpu:
        t = time.perf_counter()
        rmse, out = _run_recipe(mt, SP_RECIPE_MF, MF_SMOKE, aliases)
        row["recipe_smoke"] = {"args": MF_SMOKE, "rmse": rmse,
                               "grad_stype_line": "grad stype=row_sparse"
                               in out,
                               "seconds": time.perf_counter() - t}
        t = time.perf_counter()
        rmse_d, out_d = _run_recipe(mt, SP_RECIPE_MF, [], aliases)
        row["recipe_defaults"] = {"rmse": rmse_d,
                                  "grad_stype_line": "grad stype=row_sparse"
                                  in out_d,
                                  "seconds": time.perf_counter() - t}
    emit({"phase": "sparse_mf", **row})
    if not (rows_ok and untouched_ok and err <= MF_TOL):
        fail(f"sparse_mf: rows {rows_ok} untouched {untouched_ok} "
             f"err {err}")
    if not (rmse < 0.3 and row["recipe_smoke"]["grad_stype_line"] and
            row["recipe_defaults"]["grad_stype_line"]):
        fail(f"sparse_mf: recipe RMSE {rmse} (needs < 0.3)")
    return row


def sparse_rank(argv):
    """One rank of sparse_dist, started by ``python -m
    mxnet_tpu_torch.launch -n 2 python3 chip_smoke.py --sparse-rank DIR``:
    ``examples/sparse/linear_classification.py`` at its defaults with
    ``mxnet_tpu`` resolved to the port and every push recorded (its rows,
    values, wire and touched bytes, time); then ShardedEmbedding on
    {mp: 2}: a 2^20 x 64 f32 table, a lookup and a scatter-add of 8192
    ids with repeats. Results to DIR/rank<r>.pt."""
    import numpy as np
    import torch
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch import kvstore_server
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel import sharded_embedding as se
    out_dir = argv[0]
    if not kvstore_server.init_distributed():
        fail("sparse_rank: no group in the environment")
    rank = kvstore_server.group_info()["rank"]
    stores, pushes = [], []
    create = mt.kvstore.create

    def recording_create(name="local"):
        kv = create(name)
        push = kv.push

        def rec(key, value, priority=0):
            push(key, value, priority)
            _sync(torch)
            pushes.append({"ids": value._indices.cpu(),
                           "rows": value._data.cpu(),
                           "wire": kv.last_rsp_wire_bytes,
                           "touched": kv.last_rsp_touched_bytes,
                           "t": time.perf_counter()})
        kv.push = rec
        stores.append(kv)
        return kv
    mt.kvstore.create = recording_create
    try:
        _, out = _run_recipe(mt, SP_RECIPE_LINEAR, [], {
            "mxnet_tpu.ndarray": mt.ndarray,
            "mxnet_tpu.ndarray.sparse": mt.ndarray.sparse,
            "mxnet_tpu.kvstore": mt.kvstore})
    finally:
        mt.kvstore.create = create
    table = mt.nd.zeros((SP_FEATURES, 1))
    stores[0].pull("weight", out=table)
    acc = [float(m) for m in re.findall(r"accuracy ([0-9.]+)", out)]
    # ShardedEmbedding over {mp: 2}
    mesh = make_mesh({"mp": 2})
    emb = se.ShardedEmbedding(SE_ROWS, SE_DIM, mesh, axis="mp", seed=5)
    ids_c, rows_c = _se_inputs(torch)
    looked = emb(ids_c)
    _sync(torch)
    lookup_ms = _wall_ms(torch, lambda: emb(ids_c), 10)
    se.sharded_scatter_add(emb.weight, ids_c, rows_c, mesh, "mp")
    after = emb(ids_c)
    _sync(torch)
    t = time.perf_counter()
    se.sharded_scatter_add(emb.weight.clone(), ids_c, rows_c, mesh, "mp")
    _sync(torch)
    scatter_ms = (time.perf_counter() - t) * 1e3
    torch.save({"table": table._data.cpu(), "accuracy": acc,
                "pushes": pushes, "lookup": looked.cpu(),
                "after": after.cpu(), "block": emb.weight.cpu(),
                "lookup_ms": lookup_ms, "scatter_ms": scatter_ms},
               os.path.join(out_dir, f"rank{rank}.pt"))
    stores[0].barrier()


def _se_inputs(torch):
    """ShardedEmbedding's ids (every one twice) and rows, on the card."""
    gen = torch.Generator().manual_seed(7)
    half = torch.randint(0, SE_ROWS, (SE_IDS // 2,), generator=gen)
    ids = torch.cat([half, half])
    rows = torch.randn(SE_IDS, SE_DIM, generator=gen)
    return ids.to(_card_device(torch)), rows.to(_card_device(torch))


def _se_reference(torch, mt):
    """ShardedEmbedding's one-process table on the card ({mp: 1}): the
    same seed, ids and rows as sparse_rank's."""
    from mxnet_tpu_torch.parallel import make_mesh
    from mxnet_tpu_torch.parallel import sharded_embedding as se
    mesh = make_mesh({"mp": 1})
    with mt.gpu(0):
        emb = se.ShardedEmbedding(SE_ROWS, SE_DIM, mesh, axis="mp", seed=5)
    ids, rows = _se_inputs(torch)
    looked = emb(ids).cpu()
    se.sharded_scatter_add(emb.weight, ids, rows, mesh, "mp")
    return looked, emb(ids).cpu(), emb.weight.cpu()


def sparse_dist(torch, mt, card):
    """``examples/sparse/linear_classification.py`` as two ranks sharing
    the card over gloo (``python -m mxnet_tpu_torch.launch -n 2``,
    ``--kvstore dist_tpu_sync``, its defaults: 10000 features, batch 256,
    3 epochs, lr 0.5): accuracy rising from the first epoch to the last on
    both ranks, both ranks' final tables alike and bit for bit a
    one-process replay that pushes both ranks' recorded row-sparse
    gradients, in the same order, into a local store with the same lazy
    SGD; the recipe in one process on the card too. ShardedEmbedding on
    {mp: 2} (2^20 x 64 f32, 8192 ids with repeats): lookup and
    scatter-add bit for bit the one-process table's. ms a step a rank,
    wire and touched bytes a push."""
    import tempfile
    import numpy as np
    from mxnet_tpu_torch.ndarray import sparse as tsp
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as out_dir:
        _, wall = _dt_launch(
            [sys.executable, "-m", "mxnet_tpu_torch.launch", "-n", "2",
             sys.executable, os.path.abspath(__file__), "--sparse-rank",
             out_dir], 600, "sparse_dist ranks")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                            weights_only=False) for r in range(2)]
    gpu = mt.gpu(0)
    with gpu:
        kv = mt.kvstore.create("local")
        kv.init("weight", mt.nd.zeros((SP_FEATURES, 1)))
        kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.5,
                                          lazy_update=True))
        for p0, p1 in zip(ranks[0]["pushes"], ranks[1]["pushes"]):
            kv.push("weight", [tsp.RowSparseNDArray(
                p["rows"].to(_card_device(torch)), p["ids"].to(_card_device(torch)), (SP_FEATURES, 1))
                for p in (p0, p1)])
        replay = mt.nd.zeros((SP_FEATURES, 1))
        kv.pull("weight", out=replay)
        _, one_out = _run_recipe(mt, SP_RECIPE_LINEAR, [], {
            "mxnet_tpu.ndarray": mt.ndarray,
            "mxnet_tpu.ndarray.sparse": mt.ndarray.sparse,
            "mxnet_tpu.kvstore": mt.kvstore})
    one_acc = [float(m) for m in re.findall(r"accuracy ([0-9.]+)", one_out)]
    ref_lookup, ref_after, ref_table = _se_reference(torch, mt)
    r0, r1 = ranks
    tables_alike = torch.equal(r0["table"], r1["table"])
    replay_bitwise = torch.equal(r0["table"], replay._data.cpu())
    rising = [r["accuracy"][-1] > r["accuracy"][0] for r in ranks]
    pushes = r0["pushes"]
    steps = len(pushes)
    per_epoch = steps // 3
    times = [p["t"] for p in pushes[per_epoch:]]
    ms_step = (times[-1] - times[0]) * 1e3 / max(len(times) - 1, 1)
    se_ok = {
        "lookup_bitwise": all(torch.equal(r["lookup"], ref_lookup)
                              for r in ranks),
        "after_scatter_lookup_bitwise": all(torch.equal(r["after"],
                                                        ref_after)
                                            for r in ranks),
        "blocks_bitwise": torch.equal(torch.cat([r0["block"],
                                                 r1["block"]]), ref_table)}
    row = {"card": card, "launch_s": wall, "accuracy_rank0": r0["accuracy"],
           "accuracy_rank1": r1["accuracy"],
           "accuracy_one_process": one_acc, "accuracy_rises": rising,
           "tables_alike": tables_alike, "replay_bitwise": replay_bitwise,
           "pushes_a_rank": steps, "ms_a_step_a_rank": ms_step,
           "wire_bytes_a_push": float(np.mean([p["wire"] for p in pushes])),
           "touched_bytes_a_push": float(np.mean([p["touched"]
                                                  for p in pushes])),
           "sharded_embedding": {"rows": SE_ROWS, "dim": SE_DIM,
                                 "ids": SE_IDS, **se_ok,
                                 "lookup_ms_a_rank": [r["lookup_ms"]
                                                      for r in ranks],
                                 "scatter_ms_a_rank": [r["scatter_ms"]
                                                       for r in ranks]}}
    emit({"phase": "sparse_dist", **row})
    if not (all(rising) and tables_alike and replay_bitwise and
            all(se_ok.values())):
        fail(f"sparse_dist: {row}")
    return row


def _tt_tower(mt, dim, proj):
    """``examples/recsys/two_tower.py``'s TwoTower, as written there."""
    nn = mt.gluon.nn

    class TwoTower(nn.HybridBlock):
        def __init__(self):
            super().__init__()
            self._dim = dim
            self.u = nn.Dense(proj, in_units=dim)
            self.i = nn.Dense(proj, in_units=dim)

        def hybrid_forward(self, F, x):
            uv = F.slice_axis(x, axis=1, begin=0, end=self._dim)
            iv = F.slice_axis(x, axis=1, begin=self._dim,
                              end=2 * self._dim)
            return F.sum(self.u(uv) * self.i(iv), axis=-1)
    return TwoTower()


def _plane_snapshot(torch, plane):
    return ([s.clone() for s in plane._shards],
            [None if st is None else tuple(a.clone() for a in st)
             for st in plane._state])


def _plane_equal(torch, plane, snap):
    shards, states = snap
    same = all(torch.equal(a, b) for a, b in zip(plane._shards, shards))
    for st, old in zip(plane._state, states):
        if st is not None and old is None:    # created by the step
            same = same and not any(bool(a.any()) for a in st)
        elif st is not None:
            same = same and all(torch.equal(a, b) for a, b in zip(st, old))
    return same


def _plane_reference_step(torch, mt, plane, snap, ids, grad, t_count):
    """The dense-gather reference of one Adam plane step on the full
    table: the same packed rows, the same rule kernel on the gathered
    touched rows (JAX ``grouped.py:791-793``); bit for bit the plane?"""
    import math
    import numpy as np
    from mxnet_tpu_torch.ndarray.sparse import segment_sum
    from mxnet_tpu_torch.optimizer import grouped
    opt = plane.optimizer
    full = torch.cat(snap[0])
    state = [torch.cat([st[k] if st is not None else torch.zeros_like(s)
                        for st, s in zip(snap[1], snap[0])])
             for k in range(2)]
    _, summed, uids = segment_sum(grad, ids)
    lr = opt._get_lr(0) * math.sqrt(1 - opt.beta2 ** t_count) / \
        (1 - opt.beta1 ** t_count)
    kernel = grouped._rule_for(opt).make_kernel(opt, True)
    u = torch.from_numpy(uids).to(full.device)
    nw, ns = kernel([full[u]], [summed], [[s[u]] for s in state], [lr],
                    [opt._get_wd(0)], float(opt.rescale_grad))
    full[u] = nw[0]
    for s, n in zip(state, ns):
        s[u] = n[0]
    got = torch.cat(plane._shards)
    got_state = [torch.cat([st[k] if st is not None else
                            torch.zeros_like(s)
                            for st, s in zip(plane._state, plane._shards)])
                 for k in range(2)]
    return torch.equal(got, full) and all(
        torch.equal(a, b) for a, b in zip(got_state, state))


def _two_tower(torch, mt, c, checks):
    """The training half of ``examples/recsys/two_tower.py`` (its code up
    to the eval, on the card) at config ``c``; with ``checks`` also the
    plane's gates: step 0 against the dense-gather reference, a step
    under a false flag and its rollback, timing and host syncs."""
    import numpy as np
    from mxnet_tpu_torch.ndarray import sparse as tsp
    from mxnet_tpu_torch.parallel.embedding_plane import EmbeddingPlane
    rs = np.random.RandomState(0)
    mt.random.seed(0)
    vocab = c["users"] + c["items"]
    rows = ((vocab + c["world"] - 1) // c["world"]) * c["world"]
    plane = EmbeddingPlane(
        "two_tower", rows=rows, dim=c["dim"], world=c["world"],
        optimizer=mt.optimizer.Adam(learning_rate=c["lr"]),
        init_scale=c["init_scale"])
    u_true = rs.randn(c["users"], c["true_rank"]).astype(np.float32) * 0.7
    i_true = rs.randn(c["items"], c["true_rank"]).astype(np.float32) * 0.7

    def sample_batch(n):
        u = rs.randint(0, c["users"], n)
        i = rs.randint(0, c["items"], n)
        return u, i, (u_true[u] * i_true[i]).sum(1).astype(np.float32)

    tower = _tt_tower(mt, c["dim"], c["proj"])
    tower.initialize(mt.init.Xavier())
    trainer = mt.gluon.Trainer(tower.collect_params(), "adam",
                               {"learning_rate": c["lr"]})
    l2 = mt.gluon.loss.L2Loss()
    eu, ei, er = sample_batch(512)

    def eval_loss():
        with mt.autograd.pause():
            x = mt.nd.concat(plane.lookup(eu),
                             plane.lookup(ei + c["users"]), dim=1)
            return float(l2(tower(x), mt.nd.array(er)).mean().asnumpy())

    eval_first = eval_loss()
    out = {"config": c}
    ms, uniq = [], []
    for k in range(c["iters"]):
        u, i, r = sample_batch(c["batch"])
        ids = np.concatenate([u, i + c["users"]])
        uvec = plane.lookup(u)
        ivec = plane.lookup(i + c["users"])
        uvec.attach_grad()
        ivec.attach_grad()
        with mt.autograd.record():
            pred = tower(mt.nd.concat(uvec, ivec, dim=1))
            loss = l2(pred, mt.nd.array(r)).mean()
        loss.backward()
        trainer.step(c["batch"])
        grad = mt.nd.concat(uvec.grad, ivec.grad, dim=0)
        if checks and k == 0:
            snap = _plane_snapshot(torch, plane)
            plane.step(ids, grad)
            out["step0_dense_gather_bitwise"] = _plane_reference_step(
                torch, mt, plane, snap, ids, grad._data,
                plane.optimizer._index_update_count[0])
            continue
        if checks and k == c["iters"] // 2:
            # a non-finite step: nothing on the card changes, and the
            # rollback restores the update count
            snap = _plane_snapshot(torch, plane)
            count = plane.optimizer._index_update_count[0]
            plane.step(ids, grad, flag=torch.tensor(
                False, device=_card_device(torch)))
            out["nonfinite_step_untouched_bitwise"] = _plane_equal(
                torch, plane, snap)
            plane.rollback_step()
            out["rollback_restores_count"] = \
                plane.optimizer._index_update_count[0] == count
        _sync(torch)
        tsp.reset_host_syncs()
        t = time.perf_counter()
        plane.step(ids, grad)
        _sync(torch)
        ms.append((time.perf_counter() - t) * 1e3)
        uniq.append(plane.last_unique_rows)
    out.update(host_syncs_a_plane_step=dict(tsp.host_syncs),
               eval_first=eval_first, eval_last=eval_loss(),
               plane_ms_a_step_median=sorted(ms)[len(ms) // 2],
               unique_rows_a_step=sum(uniq) / len(uniq),
               per_rank_bytes=[plane.rank_bytes(r)
                               for r in range(c["world"])],
               want_per_rank_bytes=[3 * rows * c["dim"] * 4 // c["world"]]
               * c["world"])
    out["learns"] = out["eval_last"] < 0.6 * out["eval_first"]
    out["one_world_bytes"] = out["per_rank_bytes"] == \
        out["want_per_rank_bytes"]
    plane.close()
    return out


def recsys_plane(torch, mt, card):
    """(a) the training half of ``examples/recsys/two_tower.py`` on the
    card (one table for both vocabularies through EmbeddingPlane at a
    simulated world 4 with plane Adam lr 0.05, the dense tower through a
    Trainer): at its ``full`` config (4096 + 4096 rows, dim 16, batch 256,
    400 iterations) per-rank bytes exactly 3 * rows * dim * 4 / world
    each, step 0 bit for bit the dense-gather reference update, a step
    under a false finiteness flag leaving every shard and state bit for
    bit and rollback_step restoring the host half, and the eval loss
    reported; the recipe's own learning assert (eval loss below 0.6 x its
    start) at its ``--smoke`` config, where its test runs it (at the full
    config 400 iterations do not meet it in the JAX package either). (b)
    a giant table: 2^23 x 64 f32, world 4, 8192 users + 8192 items a
    step, MXTPU_SPARSE_MAX_ROWS=16384, 20 steps: after 3 steps the
    world-4 table bit for bit the world-1 table's, per-rank bytes 1/4 of
    the unsharded bytes; ms a step, unique rows a step, peak memory, host
    syncs a step."""
    prev = {k: os.environ.get(k) for k in ("MXTPU_SPARSE_PLANE",
                                           "MXTPU_SPARSE_MAX_ROWS")}
    os.environ["MXTPU_SPARSE_PLANE"] = "on"
    try:
        with mt.gpu(0):
            full = _two_tower(torch, mt, TT, True)
            smoke = _two_tower(torch, mt, TT_SMOKE, False)
        row = {"card": card, "full": full,
               "smoke": {k: smoke[k] for k in ("config", "eval_first",
                                               "eval_last", "learns",
                                               "one_world_bytes")}}
        emit({"phase": "recsys_plane", "what": "two_tower", **row})
        if not (smoke["learns"] and full["one_world_bytes"] and
                smoke["one_world_bytes"] and
                full["step0_dense_gather_bitwise"] and
                full["nonfinite_step_untouched_bitwise"] and
                full["rollback_restores_count"]):
            fail(f"recsys_plane (a): {row}")
        giant = _giant_plane(torch, mt, card)
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return row, giant


def _giant_plane(torch, mt, card):
    """recsys_plane (b): the 2^23 x 64 table at world 4 against world 1."""
    import numpy as np
    from mxnet_tpu_torch.ndarray import sparse as tsp
    from mxnet_tpu_torch.parallel.embedding_plane import EmbeddingPlane
    g = GIANT
    os.environ["MXTPU_SPARSE_MAX_ROWS"] = str(g["cap"])
    half = g["rows"] // 2
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with mt.gpu(0):
        planes = {w: EmbeddingPlane(
            f"giant{w}", rows=g["rows"], dim=g["dim"], world=w,
            optimizer=mt.optimizer.Adam(learning_rate=0.01), seed=3)
            for w in (g["world"], 1)}
        init_same = torch.equal(torch.cat(planes[1]._shards),
                                torch.cat(planes[g["world"]]._shards))
        gen = torch.Generator(device=_card_device(torch)).manual_seed(11)
        rs = np.random.RandomState(11)
        ms, uniq, same_at = [], [], None
        for s in range(g["steps"]):
            ids = np.concatenate([rs.randint(0, half, g["users"]),
                                  half + rs.randint(0, half, g["items"])])
            grad = torch.randn((len(ids), g["dim"]), generator=gen,
                               device=_card_device(torch))
            _sync(torch)
            tsp.reset_host_syncs()
            t = time.perf_counter()
            planes[g["world"]].step(ids, grad)
            _sync(torch)
            ms.append((time.perf_counter() - t) * 1e3)
            syncs = dict(tsp.host_syncs)
            uniq.append(planes[g["world"]].last_unique_rows)
            if s < g["check_at"]:
                planes[1].step(ids, grad)
            if s == g["check_at"] - 1:
                same_at = torch.equal(torch.cat(planes[1]._shards),
                                      torch.cat(planes[g["world"]]._shards))
        p = planes[g["world"]]
        prof, wall = _profiled(torch, lambda: p.step(ids, grad))
        per_rank = [p.rank_bytes(r) for r in range(g["world"])]
        unsharded = planes[1].rank_bytes(0)
        lookup_ms = _wall_ms(torch, lambda: p.lookup(ids), 10)
        for pl in planes.values():
            pl.close()
        del planes, p
    row = {"card": card, "config": g, "init_world_invariant": init_same,
           f"world{g['world']}_vs_world1_bitwise_after_{g['check_at']}":
           same_at, "per_rank_bytes": per_rank,
           "world1_bytes_after_3_steps": unsharded,
           "per_rank_quarter_of_unsharded": all(
               4 * b == 3 * g["rows"] * g["dim"] * 4 for b in per_rank),
           "ms_a_step_median": sorted(ms)[len(ms) // 2],
           "ms_a_step_first": ms[0], "unique_rows_a_step":
           sum(uniq) / len(uniq), "host_syncs_a_step": syncs,
           "lookup_ms_16384_ids": lookup_ms,
           "profiled_step": _sparse_profile(prof, wall),
           "peak_mib": torch.cuda.max_memory_allocated() / 2 ** 20}
    emit({"phase": "recsys_plane", "what": "giant_table", **row})
    torch.cuda.empty_cache()
    if not (init_same and same_at and row["per_rank_quarter_of_unsharded"]):
        fail(f"recsys_plane (b): {row}")
    return row


A11_PHASES = ("sparse_ops", "sparse_mf", "sparse_dist", "recsys_plane")


def a11_phases(torch, mt, card, timed):
    """The sparse phases, in order."""
    out = {}
    for name, fn in zip(A11_PHASES, (sparse_ops_phase, sparse_mf,
                                     sparse_dist, recsys_plane)):
        out[name] = timed(name, fn, torch, mt, card)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# int8 quantization and the symbolic graph (A13 and A14's symbol/)
# ---------------------------------------------------------------------------

A13_PHASES = ("int8_ops", "int8_resnet50", "resid8_train", "symbol_export",
              "quant_recipes")
Q_BATCH, Q_CALIB, Q_WARM_BN = 32, 4, 3   # images a batch, calib batches
Q_HOST_ROWS = 8                          # rows of a batch held to the host
Q_TIMED = 10                             # timed forwards a variant
Q_CONV_CHECK_ROWS = 4                    # images of each conv site on host
R8_RUNS = (("unset", {}), ("fp8", {"MXNET_RESID_DTYPE": "fp8"}),
           ("int8", {"MXNET_CONV_COMPUTE": "int8"}),
           ("fp8_composed", {"MXNET_RESID_DTYPE": "fp8",
                             "MXTPU_FUSED_EPILOGUE": "0"}))
A13_STATE = {}      # what a later A13 phase reuses from an earlier one
Q_RECIPES = ("examples/quantization/quantize_model.py",
             "examples/quantization/quantize_gluon.py",
             "examples/quantization/quantize_resnet.py")


def _q_op_cases(np):
    """One case of each of the 22 quantization registry names (int8 data,
    f32 ranges), the shapes of tests/test_torch_quantization.py scaled
    up."""
    rs = np.random.RandomState(3)

    def i8(*shape):
        return rs.randint(-127, 128, shape).astype(np.int8)

    def f32(*shape, scale=1.0):
        return ((rs.rand(*shape) - 0.5) * 2 * scale).astype(np.float32)

    def s(v):
        return np.asarray(v, np.float32)

    x = f32(64, 256, scale=3)
    acc = rs.randint(-40000, 40000, (64, 96)).astype(np.int32)
    d8, w8, b8 = i8(64, 256), i8(96, 256), i8(96)
    c8, k8 = i8(8, 32, 28, 28), i8(96, 32, 3, 3)
    r = [s(-1.5), s(2.0)]
    wr = [s(-0.4), s(0.5), s(-0.1), s(0.2)]
    return [
        ("_contrib_quantize_v2", [x], {}),
        ("quantize_v2", [x], {"min_calib_range": -1.0,
                              "max_calib_range": 2.0}),
        ("_contrib_dequantize", [i8(64, 96), s(-0.7), s(1.3)], {}),
        ("dequantize", [i8(4096), s(-3.0), s(3.0)], {}),
        ("_contrib_requantize", [acc, s(-20.0), s(20.0)], {}),
        ("requantize", [acc, s(-20.0), s(20.0)],
         {"min_calib_range": -0.5, "max_calib_range": 0.25}),
        ("_contrib_quantized_fully_connected", [d8, w8, b8] + r + wr,
         {"num_hidden": 96}),
        ("quantized_fully_connected", [i8(64, 16, 16), w8, b8] + r + wr[:2],
         {"num_hidden": 96, "no_bias": True}),
        ("_contrib_quantized_conv", [c8, k8, b8] + r + wr,
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
          "num_filter": 96}),
        ("quantized_conv", [c8, i8(96, 16, 3, 3), b8] + r + wr[:2],
         {"kernel": (3, 3), "dilate": (2, 2), "num_filter": 96,
          "num_group": 2, "no_bias": True}),
        ("_quantized_fc_static", [d8, s(-1.0), s(1.5), w8, f32(96)],
         {"w_min": -0.3, "w_max": 0.7, "num_hidden": 96}),
        ("_contrib_quantized_pooling", [c8] + r,
         {"kernel": (2, 2), "stride": (2, 2), "pool_type": "max"}),
        ("quantized_pooling", [c8] + r,
         {"kernel": (3, 3), "pool_type": "avg", "pad": (1, 1),
          "pooling_convention": "full"}),
        ("_contrib_quantized_flatten", [c8] + r, {}),
        ("quantized_flatten", [i8(16, 8, 8)] + r, {}),
        ("_contrib_quantize", [x, s([-2.5]), s([2.9])],
         {"out_type": "uint8"}),
        ("quantize", [x, s([-2.5]), s([2.9])], {"out_type": "int8"}),
        ("_quantize_static", [x], {"scale": 3.0 / 127}),
        ("_quantized_conv_v2",
         [i8(8, 28, 28, 64), i8(96, 3, 3, 32), np.abs(f32(96)) + 1e-3,
          f32(96)],
         {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1),
          "num_filter": 96, "num_group": 2, "in_scale": 0.02,
          "no_bias": False}),
        ("_quantized_dense_v2",
         [i8(64, 16, 16), w8, np.abs(f32(96)) + 1e-3, f32(96)],
         {"num_hidden": 96, "in_scale": 0.05, "no_bias": False}),
        ("_contrib_quantized_concat",
         [i8(64, 30), i8(64, 50), s(-1.0), s(-0.5), s(2.0), s(0.25)],
         {"dim": 1, "num_args": 2}),
        ("quantized_concat",
         [i8(2, 300), i8(7, 300), i8(3, 300), s(-1.0), s(-4.0), s(0.0),
          s(1.0), s(0.1), s(0.3)], {"dim": 0, "num_args": 3}),
    ]


def _q_conv_sites(torch, mt):
    """The distinct convolutions of ResNet-50 v1 NHWC (s2d stem) at batch
    Q_BATCH, 224x224: {(input NHWC, weight OHWI, stride, pad): count}, read
    by forward pre-hooks on a batch-1 forward."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.gluon.nn.conv_layers import _Conv
    net = resnet50_v1(layout="NHWC", stem_s2d=True)
    net.initialize(generator=mt.random.seed(0))
    sites = {}

    def hook_of(conv):
        def hook(_m, args):
            k = ((Q_BATCH,) + tuple(args[0].shape[1:]),
                 tuple(conv.weight.shape), tuple(conv._kwargs["stride"]),
                 tuple(conv._kwargs["pad"]))
            sites[k] = sites.get(k, 0) + 1
        return hook

    handles = [m.register_forward_pre_hook(hook_of(m))
               for m in net.modules() if isinstance(m, _Conv)]
    with torch.no_grad(), mt.autograd.pause():
        net(torch.zeros((1, IMG, IMG, 3), device="cuda"))
    for h in handles:
        h.remove()
    del net
    return sites


def _q_compare(torch, got, want):
    """Worst error of ``got`` against ``want``: 0 / 1 for integer outputs
    (bit for bit or not), max |diff| over the largest |want| for floats."""
    if not want.is_floating_point():
        return 0.0 if torch.equal(got.cpu(), want) else 1.0
    got, want = got.float().cpu(), want.float()
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def int8_ops_phase(torch, mt, card):
    """Each of the 22 quantization ops card against host (int8 / int32
    bit for bit, f32 within 1e-6 of the largest); then every distinct
    convolution of ResNet-50 v1 NHWC at batch 32, 224x224, as the int8
    product the card runs (``ops/quantization.int_conv``: an NHWC im2col
    and ``torch._int_mm``), its int32 accumulators bit for bit with the
    host's for the first Q_CONV_CHECK_ROWS images; per site the device ms
    of the whole int8 route, of ``_int_mm`` alone on the columns, and of
    cuDNN's bf16 convolution of the same shapes (channels-last), and
    their totals over one forward's 53 convolutions."""
    import numpy as np
    import torch.nn.functional as F
    from mxnet_tpu_torch.ops import quantization as q
    from mxnet_tpu_torch.ops import registry as reg
    bad, ops = [], {}
    for name, arrays, params in _q_op_cases(np):
        fn = reg.get_op(name).fn
        host = fn(*[torch.from_numpy(a) for a in arrays], **params)
        got = fn(*[torch.from_numpy(a).cuda() for a in arrays], **params)
        host = host if isinstance(host, tuple) else (host,)
        got = got if isinstance(got, tuple) else (got,)
        errs = [_q_compare(torch, g, h) for g, h in zip(got, host)]
        ops[name] = {"outputs": len(errs), "worst": max(errs),
                     "dtypes": [str(g.dtype)[6:] for g in got]}
        for g, h, e in zip(got, host, errs):
            limit = 1e-6 if h.is_floating_point() else 0.0
            if e > limit or g.dtype != h.dtype or g.shape != h.shape:
                bad.append(f"{name}: {e} ({g.dtype} {tuple(g.shape)})")
    emit({"phase": "int8_ops", "what": "ops card vs host", "ops": ops,
          "card": card})
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    rows, totals = [], {"int8_route_ms": 0.0, "int_mm_ms": 0.0,
                        "cudnn_bf16_ms": 0.0, "convs": 0}
    for (xs, ws, stride, pad), count in sorted(_q_conv_sites(torch,
                                                            mt).items()):
        x = torch.randint(-127, 128, xs, generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-127, 128, ws, generator=gen, device="cuda",
                          dtype=torch.int8)
        q.launches["int_mm"] = 0
        acc = q.int_conv(x, w, stride, pad, (1, 1), 1, channel_last=True)
        torch.cuda.synchronize()
        launched = q.launches["int_mm"]
        n = Q_CONV_CHECK_ROWS
        host = q.int_conv(x[:n].cpu(), w.cpu(), stride, pad, (1, 1), 1,
                          channel_last=True)
        exact = acc.dtype == torch.int32 and torch.equal(acc[:n].cpu(),
                                                         host)
        win, out = q._windows(x, ws[1:3], stride, pad, (1, 1))
        cols = win.reshape(-1, ws[1] * ws[2] * ws[3])
        wm = w.reshape(ws[0], -1)
        xf = x.to(torch.bfloat16).permute(0, 3, 1, 2)
        wf = w.to(torch.bfloat16).permute(0, 3, 1, 2)
        t_route = time_ms(torch, lambda: q.int_conv(
            x, w, stride, pad, (1, 1), 1, channel_last=True), flush, 5)
        t_mm = time_ms(torch, lambda: q._int_mm(cols, wm), flush, 5)
        t_bf16 = time_ms(torch, lambda: F.conv2d(xf, wf, None, stride,
                                                 pad), flush, 5)
        k = ws[1] * ws[2] * ws[3]
        row = {"input": list(xs), "weight": list(ws), "stride": stride,
               "pad": pad, "count": count, "gemm_mnk": [
                   xs[0] * out[0] * out[1], ws[0], k],
               "int_mm_launches": launched, "bit_for_bit_rows": n,
               "exact": exact, "int8_route_ms": t_route,
               "int_mm_ms": t_mm, "cudnn_bf16_ms": t_bf16,
               "int8_tops": 2 * xs[0] * out[0] * out[1] * ws[0] * k
               / (t_mm * 1e9)}
        rows.append(row)
        totals["int8_route_ms"] += count * t_route
        totals["int_mm_ms"] += count * t_mm
        totals["cudnn_bf16_ms"] += count * t_bf16
        totals["convs"] += count
        if not exact or launched != 1:
            bad.append(f"conv site {xs} x {ws}: exact {exact}, "
                       f"{launched} _int_mm launches")
        del x, w, acc, win, cols, xf, wf
    del flush
    emit({"phase": "int8_ops", "what": "ResNet-50 v1 conv sites, batch "
          f"{Q_BATCH}, int8 im2col + _int_mm vs cuDNN bf16", "sites": rows,
          "per_forward": totals, "card": card})
    if totals["convs"] != 53:
        bad.append(f"{totals['convs']} convolutions in a forward, not 53")
    if bad:
        fail(f"int8_ops: {bad}")
    return totals


def _q_forward_ms(torch, net, x, iters=Q_TIMED):
    """Host ms a batch of ``iters`` synchronised forwards (after two warm
    ones), and the last output."""
    with torch.no_grad():
        for _ in range(2):
            out = net(x)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            out = net(x)
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t) / iters, out


def _q_resnet(torch, mt, seed=0):
    """Full-width ResNet-50 v1 NHWC (s2d stem), f32, seeded weights, its
    running statistics moved by Q_WARM_BN training-mode forwards."""
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    net = resnet50_v1(layout="NHWC", stem_s2d=True)
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(seed))
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    with torch.no_grad(), mt.autograd.train_mode():
        for _ in range(Q_WARM_BN):
            net(torch.rand((Q_BATCH, IMG, IMG, 3), generator=gen,
                           device="cuda"))
    return net


def int8_resnet50(torch, mt, card, tmp):
    """Full-width ResNet-50 v1 NHWC f32 at batch 32: the float net
    hybridized (one CUDA graph a signature), timed; ``quantize_net`` with
    entropy calibration over Q_CALIB batches (BN folded into 53 int8
    convolutions and the int8 Dense); the int8 net hybridized, timed, and
    held to a host run of the same quantized net (its exported graph
    through ``SymbolBlock`` on the CPU) on Q_HOST_ROWS images: within 1e-3
    of the largest logit, top-1 agreement >= 0.99; int8 against float
    top-1 agreement printed; bf16 timed (the same weights cast); then the
    int8 net behind ModelServer: img/s and p50 / p99 under 8 closed-loop
    clients, every response against an eager forward of its batch."""
    import numpy as np
    from mxnet_tpu_torch.contrib import quantization as tq
    from mxnet_tpu_torch.serving import ModelServer
    from mxnet_tpu_torch.ops import quantization as q
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    bad, row = [], {"model": "resnet50_v1 NHWC stem_s2d", "batch": Q_BATCH,
                    "image": IMG, "card": card}
    try:
        net = _q_resnet(torch, mt)
        gen = torch.Generator(device="cuda").manual_seed(30)
        calib = [torch.rand((Q_BATCH, IMG, IMG, 3), generator=gen,
                            device="cuda") for _ in range(Q_CALIB)]
        x = torch.rand((Q_BATCH, IMG, IMG, 3), generator=gen, device="cuda")
        net.save_parameters(os.path.join(tmp, "r50.params"))
        net.hybridize()
        ms, out_f = _q_forward_ms(torch, net, x)
        row["f32"] = {"ms_per_batch": ms, "img_per_s": Q_BATCH * 1e3 / ms}
        out_f = out_f.float().cpu()
        torch.cuda.synchronize()
        t = time.perf_counter()
        tq.quantize_net(net, calib, calib_mode="entropy")
        torch.cuda.synchronize()
        row["quantize_net_s"] = time.perf_counter() - t
        qb = [b for b in net.modules() if isinstance(b, tq._QuantizedLayer)]
        row["quantized_layers"] = len(qb)
        if len(qb) != 54 or not net._active:
            bad.append(f"{len(qb)} int8 layers (54 expected), hybridized "
                       f"{net._active}")
        q.launches["int_mm"] = 0
        with torch.no_grad():
            net(x)
        torch.cuda.synchronize()
        row["int_mm_launches_first_call"] = q.launches["int_mm"]
        q.launches["int_mm"] = 0
        ms, out_q = _q_forward_ms(torch, net, x)
        row["int8"] = {"ms_per_batch": ms, "img_per_s": Q_BATCH * 1e3 / ms,
                       "int_mm_wrapper_launches_in_replays":
                       q.launches["int_mm"]}
        out_q = out_q.float().cpu()
        row["int8_vs_f32_top1_agreement"] = float(
            (out_q.argmax(1) == out_f.argmax(1)).float().mean())
        # the host run of the same quantized net
        prefix = os.path.join(tmp, "r50_int8")
        net.export(prefix)
        host = mt.gluon.SymbolBlock.imports(
            prefix + "-symbol.json", ["data"], prefix + "-0000.params",
            ctx=mt.cpu())
        with torch.no_grad():
            want = host(x[:Q_HOST_ROWS].cpu())
        got = out_q[:Q_HOST_ROWS]
        err = float((got - want).abs().max()) / float(want.abs().max())
        agree = float((got.argmax(1) == want.argmax(1)).float().mean())
        row["card_vs_host"] = {"rows": Q_HOST_ROWS, "worst_of_max": err,
                               "top1_agreement": agree}
        if err > 1e-3 or agree < 0.99:
            bad.append(f"int8 card vs host: {err} of the largest logit, "
                       f"top-1 agreement {agree}")
        A13_STATE["int8_net"] = net
        A13_STATE["int8_x"] = x
        # bf16: the float weights cast
        from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
        net16 = resnet50_v1(layout="NHWC", stem_s2d=True)
        net16.load_parameters(os.path.join(tmp, "r50.params"))
        net16.cast("bfloat16")
        net16.hybridize()
        ms, _ = _q_forward_ms(torch, net16, x.to(torch.bfloat16))
        row["bf16"] = {"ms_per_batch": ms, "img_per_s": Q_BATCH * 1e3 / ms}
        del net16
        torch.cuda.empty_cache()
        # the int8 net behind the serving core
        n_img = SERVE_CLIENTS * SERVE_PER_CLIENT
        images = torch.rand((n_img, IMG, IMG, 3),
                            generator=torch.Generator().manual_seed(17)
                            ).numpy()
        srv = ModelServer(net, bucket_shapes=[(IMG, IMG, 3)],
                          name="resnet50_v1-int8")
        srv.start()
        try:
            built = srv.warmup()
            wall, done, errors = _serve_load(torch, srv, images, "int8")
            m = srv.metrics_json()
            worst, n_batches, exact = _serve_check_rows(
                torch, mt, net, srv, images, done)
        finally:
            srv.stop()
        row["serving"] = {"clients": SERVE_CLIENTS, "requests": len(done),
                          "responses": m["responses_total"],
                          "warmup_signatures": built, "wall_s": wall,
                          "img_per_s": m["responses_total"] / wall,
                          "latency_ms": m["latency_ms"]["total"],
                          "mean_batch": m["batch_size"]["mean"],
                          "rows_vs_eager_worst": worst,
                          "batches_checked": n_batches,
                          "batches_bit_for_bit": exact,
                          "errors": errors[:4]}
        if errors or m["responses_total"] != n_img or worst > 1e-3:
            bad.append(f"int8 serving: {errors[:4]}, "
                       f"{m['responses_total']} responses, worst {worst}")
        del images
    finally:
        torch.backends.cudnn.deterministic = prev_det
    emit({"phase": "int8_resnet50", **row})
    if bad:
        fail(f"int8_resnet50: {bad}")
    return row


def _r8_saved_bytes(torch, step):
    """Bytes of the distinct storages autograd saves during ``step()``
    (saved-tensor hooks), in all and the fp8 / int8 share."""
    seen = {}

    def pack(t):
        s = t.untyped_storage()
        seen[s.data_ptr()] = (s.nbytes(), t.dtype)
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        step()
    torch.cuda.synchronize()
    small = (torch.float8_e4m3fn, torch.float8_e5m2, torch.int8)
    return {"all": sum(n for n, _ in seen.values()),
            "fp8_int8": sum(n for n, d in seen.values() if d in small)}


def resid8_train(torch, mt, card):
    """ResNet-50 v1 NHWC bf16 (f32 masters), batch 128, 224x224, SGD
    momentum, ``SPMDTrainer.run_steps`` with K = 4 (the main path), under
    each of R8_RUNS: flags unset, ``MXNET_RESID_DTYPE=fp8``,
    ``MXNET_CONV_COMPUTE=int8``, and fp8 with ``MXTPU_FUSED_EPILOGUE=0``.
    Each run: the first call (K eager steps, counted wrapper launches of
    the four BN kernels: 48 x K each where the epilogue is fused, as
    unset) and a timed replay; a second trainer from the same start takes
    2 K eager steps, against which the replay's losses and weights must
    agree (bit for bit, or within 1e-3 where cuDNN picked other algorithms
    under capture); one more eager step under saved-tensor hooks gives
    the bytes saved for backward and ``max_memory_allocated``. Gates:
    finite losses, step-1 loss within 2e-2 of the unset run's."""
    from mxnet_tpu_torch.base import env
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    gen = torch.Generator(device="cuda").manual_seed(40)
    data = torch.rand((K_STEPS, B, IMG, IMG, 3), generator=gen,
                      device="cuda")
    label = torch.randint(0, 1000, (K_STEPS, B), generator=gen,
                          device="cuda").float()
    src = resnet50_v1(layout="NHWC", stem_s2d=True)
    src.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
    start = {k: p.tensor.detach().clone()
             for k, p in src._collect_params_with_prefix().items()}
    del src
    gib = 2.0 ** 30
    rows, bad = {}, []

    def trainer():
        net = resnet50_v1(layout="NHWC", stem_s2d=True)
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(start[k])
        tr = mt.parallel.SPMDTrainer(
            net, gloss.SoftmaxCrossEntropyLoss(), optimizer="sgd",
            optimizer_params={"learning_rate": 0.05, "momentum": 0.9},
            dtype=torch.bfloat16)
        return tr, net

    try:
        for name, flags in R8_RUNS:
            saved_env = {k: env.raw(k) for k in flags}
            for k, v in flags.items():
                env.set(k, v)
            try:
                tr, net = trainer()
                tk.reset_launches()
                warm = tr.run_steps(data, label).float().cpu()
                launches = dict(tk.launches)
                torch.cuda.synchronize()
                t = time.perf_counter()
                replay = tr.run_steps(data, label).float().cpu()
                step_ms = 1e3 * (time.perf_counter() - t) / K_STEPS
                got = _trainer_state(tr, net)
                del tr, net
                torch.cuda.empty_cache()
                tr, net = trainer()
                eager = [tr.step(data[k % K_STEPS], label[k % K_STEPS])
                         for k in range(2 * K_STEPS)]
                eager = torch.stack(eager).float().cpu()
                want = _trainer_state(tr, net)
                agree, worst = _agreement(
                    torch, {**got, "losses": torch.cat([warm, replay])},
                    {**want, "losses": eager})
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                saved = _r8_saved_bytes(torch, lambda: tr.step(data[0],
                                                                label[0]))
                peak = torch.cuda.max_memory_allocated() / gib
                del tr, net
                torch.cuda.empty_cache()
            finally:
                for k, v in saved_env.items():
                    env.set(k, v)
            row = {"flags": flags, "first_call_losses": warm.tolist(),
                   "replay_losses": replay.tolist(),
                   "replay_step_ms": step_ms,
                   "img_per_s": B * 1e3 / step_ms,
                   "replay_vs_eager": agree, "worst_of_max": worst,
                   "first_call_bn_wrapper_launches": launches,
                   "eager_step_max_memory_allocated_gib": peak,
                   "saved_for_backward_bytes": saved}
            rows[name] = row
            emit({"phase": "resid8_train", "run": name, "batch": B,
                  "k_steps": K_STEPS, "dtype": "bf16 compute, f32 masters",
                  "card": card, **row})
            if not (torch.isfinite(warm).all() and
                    torch.isfinite(replay).all()):
                bad.append(f"{name}: non-finite loss")
            if agree is None:
                bad.append(f"{name}: replay vs eager {worst}")
            fused = env.get("MXTPU_FUSED_EPILOGUE") and \
                flags.get("MXTPU_FUSED_EPILOGUE", "1") != "0"
            if fused and any(v != 48 * K_STEPS for v in launches.values()):
                bad.append(f"{name}: BN launches {launches}")
            if not fused and any(launches.values()):
                bad.append(f"{name}: the composed epilogue launched "
                           f"{launches}")
    finally:
        torch.backends.cudnn.deterministic = prev_det
    base = rows["unset"]["first_call_losses"][0]
    for name, row in rows.items():
        d = abs(row["first_call_losses"][0] - base)
        row["step1_vs_unset"] = d
        if d > 2e-2:
            bad.append(f"{name}: step-1 loss {d} from the unset run's")
    emit({"phase": "resid8_train", "what": "summary", "card": card,
          "step_ms": {k: r["replay_step_ms"] for k, r in rows.items()},
          "saved_bytes": {k: r["saved_for_backward_bytes"]["all"]
                          for k, r in rows.items()},
          "peak_gib": {k: r["eager_step_max_memory_allocated_gib"]
                       for k, r in rows.items()},
          "step1_vs_unset": {k: r["step1_vs_unset"] for k, r in
                             rows.items()}})
    if bad:
        fail(f"resid8_train: {bad}")
    return rows


def _sx_mlp(mt, hidden=512, classes=10):
    data = mt.sym.var("data")
    x = mt.sym.FullyConnected(data, name="fc1", num_hidden=hidden)
    x = mt.sym.Activation(x, name="relu1", act_type="relu")
    x = mt.sym.FullyConnected(x, name="fc2", num_hidden=classes)
    return mt.sym.SoftmaxOutput(x, mt.sym.var("softmax_label"),
                                name="softmax")


def _sx_roundtrip(torch, mt, net, x, prefix):
    """``net`` exported and imported on the card: its outputs against the
    block's, eager and hybridized."""
    was = net._active
    net.hybridize(False)
    with torch.no_grad():
        eager = net(x)
    net.export(prefix)
    back = mt.gluon.SymbolBlock.imports(prefix + "-symbol.json", ["data"],
                                        prefix + "-0000.params")
    with torch.no_grad():
        b_eager = back(x)
        net.hybridize()
        back.hybridize()
        hyb = [net(x) for _ in range(2)][-1]
        b_hyb = [back(x) for _ in range(2)][-1]
    net.hybridize(was)
    torch.cuda.synchronize()
    return {"eager_bit_for_bit": bool(torch.equal(b_eager, eager)),
            "hybridized_bit_for_bit": bool(torch.equal(b_hyb, hyb)),
            "eager_vs_hybridized_worst": float((hyb - eager).abs().max())
            / max(float(eager.abs().max()), 1e-30)}, back


def symbol_export(torch, mt, card, tmp):
    """``export`` of the full-width ResNet-50 v1 (f32, batch 32) and of its
    int8 twin, each imported on the card through ``SymbolBlock.imports``:
    outputs bit for bit with the block's, eager and hybridized;
    ``ModelServer.load`` of the exported float files answers requests
    (every response against an eager forward of its batch); an Executor
    forward / backward of an MLP symbol card against host within 1e-4;
    ``quantize_model`` of it with entropy calibration, card against
    host."""
    import numpy as np
    from mxnet_tpu_torch.contrib import quantization as tq
    from mxnet_tpu_torch.serving import ModelServer
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    bad, row = [], {"card": card}
    try:
        net = _q_resnet(torch, mt, seed=2)
        gen = torch.Generator(device="cuda").manual_seed(50)
        x = torch.rand((Q_BATCH, IMG, IMG, 3), generator=gen, device="cuda")
        t = time.perf_counter()
        row["float"], _ = _sx_roundtrip(torch, mt, net,
                                        x, os.path.join(tmp, "sx_f32"))
        row["float"]["seconds"] = time.perf_counter() - t
        qnet = A13_STATE.get("int8_net")
        if qnet is None:
            qnet = net
            tq.quantize_net(qnet, [x], calib_mode="naive")
        xq = A13_STATE.get("int8_x", x)
        row["int8"], _ = _sx_roundtrip(torch, mt, qnet, xq,
                                       os.path.join(tmp, "sx_int8"))
        for what in ("float", "int8"):
            r = row[what]
            if not (r["eager_bit_for_bit"] and r["hybridized_bit_for_bit"]):
                bad.append(f"{what} round trip: {r}")
        # ModelServer.load of the exported float files
        prefix = os.path.join(tmp, "sx_f32")
        srv = ModelServer.load(prefix, bucket_shapes=[(IMG, IMG, 3)],
                               max_batch_size=8, name="resnet50_v1-loaded")
        images = x[:16].cpu().numpy()
        ref = mt.gluon.SymbolBlock.imports(
            prefix + "-symbol.json", ["data"], prefix + "-0000.params")
        try:
            futs = [(j, srv.submit(images[j])) for j in range(len(images))]
            for _, f in futs:
                f.result(timeout=120)
            worst, n_batches, exact = _serve_check_rows(
                torch, mt, ref, srv, images, futs)
        finally:
            srv.stop()
        row["model_server_load"] = {"requests": len(futs),
                                    "rows_vs_eager_worst": worst,
                                    "batches": n_batches,
                                    "batches_bit_for_bit": exact}
        if worst > 1e-3:
            bad.append(f"ModelServer.load: responses {worst} off")
        del net, ref
        A13_STATE.clear()
        torch.cuda.empty_cache()
        # an Executor MLP and quantize_model, card against host
        sym = _sx_mlp(mt)
        rs = np.random.RandomState(7)
        shapes = {"data": (256, 784), "softmax_label": (256,)}
        arg_shapes, _, _ = sym.infer_shape(**shapes)
        args = {n: (rs.rand(*s).astype(np.float32) - 0.5) * 0.1
                for n, s in zip(sym.list_arguments(), arg_shapes)}
        args["softmax_label"] = rs.randint(0, 10, 256).astype(np.float32)
        res = {}
        for dev in ("cpu", "gpu"):
            ctx = getattr(mt, dev)()
            with ctx:
                ex = sym.bind(ctx, {k: mt.nd.array(v) for k, v in
                                    args.items()})
                out = ex.forward(is_train=True)[0].asnumpy()
                ex.backward()
                grads = {k: g.asnumpy() for k, g in ex.grad_dict.items()}
                params = {k: mt.nd.array(v) for k, v in args.items()
                          if k not in shapes}
                calib = [{"data": mt.nd.array(np.random.RandomState(s)
                                              .rand(64, 784)
                                              .astype(np.float32)),
                          "softmax_label": mt.nd.zeros((64,))}
                         for s in (8, 9)]
                qsym, qargs, _ = tq.quantize_model(
                    sym, params, {}, calib_mode="entropy",
                    calib_data=calib)
            res[dev] = (out, grads, qsym, qargs)
        (o0, g0, qs0, qa0), (o1, g1, qs1, qa1) = res["cpu"], res["gpu"]
        worst = max([float(np.abs(o1 - o0).max() / np.abs(o0).max())] +
                    [float(np.abs(g1[k] - g0[k]).max()
                           / max(np.abs(g0[k]).max(), 1e-30)) for k in g0])
        # the calibrated ranges each device chose, and the host's int8
        # graph run on both
        ranges = {}
        for qs in (qs0, qs1):
            for n in qs._topo():
                for k, v in n.attrs.items():
                    if k.endswith("calib_range"):
                        ranges.setdefault((n.name, k), []).append(float(v))
        rworst = max(abs(a - b) / max(abs(a), 1e-30)
                     for a, b in ranges.values())
        qout = {}
        for dev in ("cpu", "gpu"):
            ctx = getattr(mt, dev)()
            with ctx:
                qout[dev] = qs0.bind(ctx, {
                    "data": mt.nd.array(args["data"]),
                    "softmax_label": mt.nd.array(args["softmax_label"]),
                    **{k: v.as_in_context(ctx) for k, v in qa0.items()}}
                ).forward()[0].asnumpy()
        qworst = float(np.abs(qout["gpu"] - qout["cpu"]).max()
                       / np.abs(qout["cpu"]).max())
        row["executor_mlp"] = {"shape": "256 x 784 -> 512 -> 10",
                               "worst_of_max": worst}
        row["quantize_model"] = {
            "calib_mode": "entropy", "int8_weights_bit_for_bit": all(
                np.array_equal(qa0[k].asnumpy(), qa1[k].asnumpy())
                for k in qa0),
            "calib_ranges_worst_rel": rworst,
            "outputs_worst_of_max": qworst,
            "top1_agreement_vs_float": float(
                (qout["gpu"].argmax(1) == o1.argmax(1)).mean())}
        if worst > 1e-4:
            bad.append(f"Executor card vs host: {worst}")
        if qworst > 1e-4 or rworst > 1e-4 or not \
                row["quantize_model"]["int8_weights_bit_for_bit"]:
            bad.append(f"quantize_model card vs host: {row}")
    finally:
        torch.backends.cudnn.deterministic = prev_det
    emit({"phase": "symbol_export", **row})
    if bad:
        fail(f"symbol_export: {bad}")
    return row


def quant_recipes(torch, mt, card):
    """The quantization recipes against the port (``mxnet_tpu`` aliased):
    quantize_model.py and quantize_gluon.py with their own asserts, and
    quantize_resnet.py at its defaults (resnet18_v1, 150 iterations):
    float and int8 top-1."""
    import re
    aliases = {"mxnet_tpu.gluon": mt.gluon, "mxnet_tpu.gluon.nn": mt.gluon.nn,
               "mxnet_tpu.gluon.model_zoo": mt.gluon.model_zoo,
               "mxnet_tpu.gluon.model_zoo.vision":
               mt.gluon.model_zoo.vision,
               "mxnet_tpu.contrib": mt.contrib,
               "mxnet_tpu.contrib.quantization": mt.contrib.quantization,
               "mxnet_tpu.symbol": mt.symbol,
               "mxnet_tpu.symbol.executor": mt.symbol.executor}
    rows = {}
    for script in Q_RECIPES:
        t = time.perf_counter()
        _, out = _run_recipe(mt, script, [], aliases)
        rows[os.path.basename(script)] = {
            "seconds": time.perf_counter() - t,
            "last_lines": out.strip().splitlines()[-3:]}
    m = re.search(r"top1 float ([0-9.]+) int8 ([0-9.]+) delta ([-0-9.]+)",
                  rows["quantize_resnet.py"]["last_lines"][-1])
    if m is None:
        fail(f"quantize_resnet.py printed no top-1 line: {rows}")
    rows["quantize_resnet.py"].update(
        {"top1_float": float(m.group(1)), "top1_int8": float(m.group(2)),
         "delta": float(m.group(3))})
    emit({"phase": "quant_recipes", "recipes": rows, "card": card})
    return rows


def a13_phases(torch, mt, card, timed, names=A13_PHASES):
    """The int8 / symbol phases, in order, with a scratch directory."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="mxt_a13_")
    fns = {"int8_ops": lambda: int8_ops_phase(torch, mt, card),
           "int8_resnet50": lambda: int8_resnet50(torch, mt, card, tmp),
           "resid8_train": lambda: resid8_train(torch, mt, card),
           "symbol_export": lambda: symbol_export(torch, mt, card, tmp),
           "quant_recipes": lambda: quant_recipes(torch, mt, card)}
    try:
        for name in names:
            timed(name, fns[name])
            torch.cuda.empty_cache()
    finally:
        A13_STATE.clear()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# the serving fleet (A23): registry, hot-swap, router over replica
# processes, the attention model, the scanned forward, the lookup tier
# ---------------------------------------------------------------------------

SF_MODEL = "resnet50_v1"
SF_DRILL = "resnet50_v1_drill"   # (b)'s copy of the versions
SF_MAX_BATCH = 8           # buckets 1, 2, 4, 8
SF_CLIENTS = 8             # client threads of (a) and the router load
SF_IMAGES = 16             # distinct images; eager references per version
SF_SWAP_S = 0.5            # load before and after the deploy in (a)
SF_KILL_BURST = 24         # requests in flight at the SIGKILL of (b)
SF_ROUTER_PER_CLIENT = 16  # serial requests per client in (b)'s load
SF_ATT = dict(units=512, heads=8, t=2048, max_batch=4, items=4,
              requests=16)
SF_ATT_REPLAYS = 3         # replays of the bucket-4 graph profiled
SF_PROFILE_TRIES = 3       # profile windows until one records kernels
SF_SCAN_K, SF_SCAN_B, SF_TIMED = 4, 8, 10


def _sf_resnet(torch, mt, seed):
    from mxnet_tpu_torch.gluon.model_zoo.vision import get_model
    net = get_model(SF_MODEL, layout="NHWC")
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(seed))
    with mt.autograd.pause():
        net(mt.nd.from_torch(torch.zeros((1, IMG, IMG, 3), device="cuda")))
    return net


def _sf_rel(np, got, want):
    """Largest difference over the largest logit of the reference."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _sf_monotone(tags):
    """Version tags in dispatch order: every v1 before every v2."""
    nums = [int(v[1:]) for v in tags]
    return nums == sorted(nums)


def _sf_hot_swap(torch, mt, np, reg, images, refs, card, bad):
    """(a) FleetServer: warm v1, publish_aot(v2), deploy(v2) under load
    from SF_CLIENTS threads, rollback, a foreign-fingerprint bundle."""
    import pickle
    import threading
    from mxnet_tpu_torch.serving import FleetServer
    srv = FleetServer(reg, SF_MODEL, version="v1",
                      max_batch_size=SF_MAX_BATCH, name="fleet-a").start()
    row = {"cold_start": dict(srv.cold_start_stats)}
    try:
        row["aot_exported"] = srv.publish_aot(version="v2")
        tags, errors = [], []
        lock = threading.Lock()
        stop = threading.Event()

        def client(c):
            i = c
            while not stop.is_set():
                idx = i % SF_IMAGES
                i += SF_CLIENTS
                try:
                    fut = srv.submit(images[idx])
                    out = fut.result(timeout=120)
                    with lock:
                        tags.append((fut.dispatch_seq, fut.version, idx,
                                     out))
                except Exception as e:
                    with lock:
                        errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(SF_CLIENTS)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        time.sleep(SF_SWAP_S)
        report = srv.deploy("v2")
        time.sleep(SF_SWAP_S)
        stop.set()
        for th in threads:
            th.join(120)
        wall = time.perf_counter() - t0
        if any(th.is_alive() for th in threads):
            fail("serving_fleet (a): clients still waiting after 120 s")
        tags.sort(key=lambda r: r[0])
        versions = [v for _, v, _, _ in tags]
        worst = max(_sf_rel(np, out, refs[v][idx])
                    for _, v, idx, out in tags)
        row["deploy"] = dict(report)
        row["load"] = {"requests": len(tags), "errors": errors[:4],
                       "wall_s": wall, "img_per_s": len(tags) / wall,
                       "v1": versions.count("v1"),
                       "v2": versions.count("v2"),
                       "monotone": _sf_monotone(versions),
                       "rows_vs_eager_worst": worst}
        if errors or not row["load"]["monotone"] or \
                not versions.count("v1") or not versions.count("v2"):
            bad.append(f"(a) hot swap: {row['load']}")
        if worst > 1e-3:
            bad.append(f"(a) responses {worst} off their version's eager "
                       "forward")
        if report["aot_loaded"] != row["aot_exported"] or \
                report["compiles"] != 0 or report["captures"] < 1:
            bad.append(f"(a) deploy report {dict(report)}")
        # rollback: CURRENT (v1 here) deployed again, with misses (no bundle)
        back = srv.rollback("v1")
        out = srv.predict(images[0], timeout=120)
        row["rollback"] = dict(back, serves_v1=_sf_rel(np, out,
                                                       refs["v1"][0]))
        if back["version"] != "v1" or row["rollback"]["serves_v1"] > 1e-3:
            bad.append(f"(a) rollback {row['rollback']}")
        # a bundle of another runtime: 0 loaded, misses, still serving
        v3 = reg.publish(SF_MODEL, prefix=reg.resolve(SF_MODEL, "v2").prefix,
                         signature=reg.resolve(SF_MODEL, "v2").signature,
                         set_current=False)
        srv.publish_aot(version=v3)
        aot = reg.resolve(SF_MODEL, v3).aot_path
        with open(aot, "rb") as f:
            bundle = pickle.load(f)
        bundle["fingerprint"] = dict(bundle["fingerprint"], device="mars")
        with open(aot, "wb") as f:
            pickle.dump(bundle, f)
        reg.attach(SF_MODEL, v3, "aot.bin", aot)
        foreign = srv.deploy(v3)
        out = srv.predict(images[1], timeout=120)
        row["foreign_fingerprint"] = dict(
            foreign, serves=_sf_rel(np, out, refs["v2"][1]))
        if foreign["aot_loaded"] != 0 or foreign["compiles"] < 1 or \
                row["foreign_fingerprint"]["serves"] > 1e-3:
            bad.append(f"(a) foreign fingerprint {foreign}")
    finally:
        srv.stop()
    emit({"phase": "serving_fleet", "what": "(a) hot swap", "card": card,
          **row})
    return row


def _sf_seed_cache(tmp):
    """A kernel-build cache holding this run's builds (same file names:
    the libraries are keyed by their source and flags)."""
    import shutil
    from mxnet_tpu_torch.ops import _build
    from mxnet_tpu_torch.serving import fingerprint_token
    cache = os.path.join(tmp, "kcache")
    eff = os.path.join(cache, fingerprint_token())
    os.makedirs(eff, exist_ok=True)
    for n in _build.SOURCES:
        shutil.copy2(_build._lib_path(n), eff)
    return cache


_SF_CACHE_PROBE = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.serving import enable_compile_cache
from mxnet_tpu_torch.telemetry import default_registry
eff = enable_compile_cache()
for n in _build.SOURCES:
    _build.load(n)
by = default_registry().render_json().get("mxtpu_compile_total", {}).get(
    "by_label", {})
print("PROBE " + json.dumps({"cache": eff, "loaded": sorted(_build._loaded),
                             "nvcc": by.get("nvcc", 0),
                             "nvrtc": by.get("nvrtc", 0)}))
"""


def _sf_drill_start(reg, tmp):
    """(b), first part: r1 (it publishes the bundle of what it serves) and
    r2 start as processes beside (a), each in a thread of its own, on the
    SF_DRILL copy of the model (so their bundle and (a)'s never meet)."""
    import threading
    from mxnet_tpu_torch.serving.serve_fleet import spawn_replica
    cache = _sf_seed_cache(tmp)
    # NVIDIA_TF32_OVERRIDE=0: the replicas' convolutions in f32, as the
    # eager references'; their buckets (1, 2, 4, 8) are the bundles'
    env = {"MXTPU_COMPILE_CACHE": cache, "NVIDIA_TF32_OVERRIDE": "0",
           "MXTPU_SERVE_MAX_BATCH": str(SF_MAX_BATCH)}
    st = {"cache": cache, "procs": {}, "row": {"replicas": {}},
          "threads": {}, "errors": [], "router": None, "probe": None}

    def spawn(name, publish_aot=False):
        t = time.perf_counter()
        try:
            rp = spawn_replica(reg.root, SF_DRILL, publish_aot=publish_aot,
                               timeout=300, env_extra=env)
        except Exception as e:
            st["errors"].append(f"{name}: {e!r}")
            return
        st["procs"][name] = rp
        st["row"]["replicas"][name] = dict(
            rp.info, ready_s=time.perf_counter() - t)

    st["spawn"] = spawn
    for name, aot in (("r1", True), ("r2", False)):
        th = threading.Thread(target=spawn, args=(name, aot), daemon=True)
        th.start()
        st["threads"][name] = th
    return st


def _sf_join(st, names):
    for name in names:
        st["threads"][name].join(330)
        if name not in st["procs"]:
            fail(f"serving_fleet (b): replica {name} did not start: "
                 f"{st['errors']}")


def _sf_drill_kill(torch, mt, np, st, images, refs, bad):
    """(b), second part: the router over r1 and r2, its load, the SIGKILL
    of r1 with SF_KILL_BURST requests in flight; then r3 and a cold
    process on the kernel cache start in the background."""
    import signal
    import threading
    from mxnet_tpu_torch.serving import FleetRouter
    here = os.path.dirname(os.path.abspath(__file__))
    _sf_join(st, ("r1", "r2"))
    procs, row = st["procs"], st["row"]
    router = st["router"] = FleetRouter(heartbeat_ms=100)
    for name in ("r1", "r2"):
        router.add_replica(name, procs[name].addr,
                           pid=procs[name].info["pid"])
    router.predict(images[0], timeout=120)
    # the router's load: SF_CLIENTS serial clients
    lat, errs = [], []
    lock = threading.Lock()

    def client(c):
        for j in range(SF_ROUTER_PER_CLIENT):
            idx = (c + j * SF_CLIENTS) % SF_IMAGES
            t = time.perf_counter()
            try:
                out = router.predict(images[idx], timeout=120)
                ok = _sf_rel(np, out, refs["v1"][idx])
            except Exception as e:
                with lock:
                    errs.append(repr(e))
                continue
            with lock:
                lat.append((1e3 * (time.perf_counter() - t), ok))

    ths = [threading.Thread(target=client, args=(c,))
           for c in range(SF_CLIENTS)]
    t0 = time.perf_counter()
    for th in ths:
        th.start()
    for th in ths:
        th.join(300)
    wall = time.perf_counter() - t0
    ms = sorted(m for m, _ in lat) or [0.0]
    row["router_load"] = {
        "requests": len(lat), "errors": errs[:4], "wall_s": wall,
        "img_per_s": len(lat) / wall, "p50_ms": ms[len(ms) // 2],
        "p99_ms": ms[min(len(ms) - 1, int(0.99 * len(ms)))],
        "rows_vs_eager_worst": max((w for _, w in lat), default=1.0)}
    if errs or len(lat) != SF_CLIENTS * SF_ROUTER_PER_CLIENT or \
            row["router_load"]["rows_vs_eager_worst"] > 1e-3:
        bad.append(f"(b) router load: {row['router_load']}")
    # SIGKILL r1 with SF_KILL_BURST requests in flight
    futs = [(i % SF_IMAGES, router.submit(images[i % SF_IMAGES]))
            for i in range(SF_KILL_BURST)]
    os.kill(procs["r1"].info["pid"], signal.SIGKILL)
    answered, worst, kill_errs = 0, 0.0, []
    for idx, f in futs:
        try:
            worst = max(worst, _sf_rel(np, f.result(timeout=120),
                                       refs["v1"][idx]))
            answered += 1
        except Exception as e:
            kill_errs.append(repr(e))
    procs["r1"].proc.wait(60)
    t = time.perf_counter()
    while router.live_count() > 1 and time.perf_counter() - t < 10:
        time.sleep(0.02)
    row["kill"] = {"in_flight": SF_KILL_BURST, "answered": answered,
                   "errors": kill_errs[:4],
                   "retried": sum(f.retries > 0 for _, f in futs),
                   "live_after": router.live_count(),
                   "rows_vs_eager_worst": worst}
    if answered != SF_KILL_BURST or worst > 1e-3 or \
            router.live_count() != 1:
        bad.append(f"(b) SIGKILL drill: {row['kill']}")
    # scale up: r3 from the bundle and the cache, and beside it a cold
    # process that loads every kernel library from the same cache
    st["probe"] = subprocess.Popen(
        [sys.executable, "-c", _SF_CACHE_PROBE, here],
        stdout=subprocess.PIPE, text=True,
        env=dict(os.environ, MXTPU_COMPILE_CACHE=st["cache"]))
    th = threading.Thread(target=st["spawn"], args=("r3",), daemon=True)
    th.start()
    st["threads"]["r3"] = th


def _sf_drill_finish(torch, mt, np, st, images, refs, card, bad):
    """(b), last part: r3 joins (0 builds, 0 misses), the rolling deploy
    to v2 under load, stop_fleet and the survivors' exit codes."""
    import threading
    procs, row, router = st["procs"], st["row"], st["router"]
    out, _ = st["probe"].communicate(timeout=300)
    lines = [ln for ln in out.splitlines() if ln.startswith("PROBE ")]
    row["cache_probe"] = json.loads(lines[-1][6:]) if lines else \
        {"rc": st["probe"].returncode}
    _sf_join(st, ("r3",))
    i3 = procs["r3"].info
    if i3["nvcc_builds"] or i3["nvrtc_builds"] or \
            i3["warm"]["aot_loaded"] < 1 or i3["warm"]["compiles"]:
        bad.append(f"(b) r3 cold start: {i3}")
    if row["cache_probe"].get("nvcc") != 0 or \
            len(row["cache_probe"].get("loaded", ())) != 3:
        bad.append(f"(b) cache probe: {row['cache_probe']}")
    router.add_replica("r3", procs["r3"].addr, pid=i3["pid"])
    # rolling deploy to v2 under load: each serial client's tags are
    # monotone; every answer is its version's model
    stop = threading.Event()
    seen, roll_errs = {}, []

    def roller(c):
        tags = seen.setdefault(c, [])
        j = 0
        while not stop.is_set():
            idx = (c + j) % SF_IMAGES
            j += 1
            try:
                fut = router.submit(images[idx])
                out = fut.result(timeout=120)
                tags.append((fut.version,
                             _sf_rel(np, out, refs[fut.version][idx])))
            except Exception as e:
                roll_errs.append(repr(e))

    ths = [threading.Thread(target=roller, args=(c,)) for c in range(4)]
    for th in ths:
        th.start()
    time.sleep(0.3)
    t = time.perf_counter()
    reports = router.rolling_deploy("v2")
    roll_s = time.perf_counter() - t
    time.sleep(0.3)
    stop.set()
    for th in ths:
        th.join(120)
    mono = all(_sf_monotone([v for v, _ in s]) for s in seen.values())
    worst = max((w for s in seen.values() for _, w in s), default=1.0)
    row["rolling_deploy"] = {
        "seconds": roll_s, "reports": reports, "errors": roll_errs[:4],
        "requests": sum(len(s) for s in seen.values()),
        "monotone_per_client": mono, "rows_vs_eager_worst": worst,
        "version_floor": router.metrics_json()["version_floor"]}
    if roll_errs or not mono or worst > 1e-3 or \
            row["rolling_deploy"]["version_floor"] != "v2" or \
            any(r.get("compiles") for r in reports):
        bad.append(f"(b) rolling deploy: {row['rolling_deploy']}")
    router.stop_fleet(drain=True)
    row["exit_codes"] = {n: procs[n].proc.wait(60) for n in ("r2", "r3")}
    if row["exit_codes"] != {"r2": 75, "r3": 75}:
        bad.append(f"(b) exit codes {row['exit_codes']}")
    emit({"phase": "serving_fleet", "what": "(b) router drill",
          "card": card, **row})
    return row


def _sf_drill_stop(st):
    """Close the router, kill what is still running."""
    if st.get("router") is not None:
        st["router"].close()
    for th in st.get("threads", {}).values():
        th.join(330)
    for rp in st.get("procs", {}).values():
        if rp.proc.poll() is None:
            rp.proc.kill()
            rp.proc.wait(60)
    if st.get("probe") is not None and st["probe"].poll() is None:
        st["probe"].kill()
        st["probe"].wait(60)


def _sf_graph_seen(prof):
    """Whether a profile recorded the attention graph's kernels (its
    GEMMs or the flash kernel)."""
    return any(k in name.lower() for name in _device_kernels(prof)
               for k in ("gemm", "nvjet", "cutlass", "flash_fwd"))


def _sf_attention_block(mt):
    """A causal self-attention block (fused QKV Dense, flash attention,
    output Dense) whose symbol exports: no shape is read."""
    heads = SF_ATT["heads"]

    class CausalSelfAttention(mt.gluon.HybridBlock):
        def __init__(self, units, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.qkv = mt.gluon.nn.Dense(3 * units, flatten=False,
                                             in_units=units)
                self.proj = mt.gluon.nn.Dense(units, flatten=False,
                                              in_units=units)

        def hybrid_forward(self, F, x):
            qkv = F.reshape(self.qkv(x), shape=(0, 0, 3, heads, -1))
            q, k, v = F.split(qkv, num_outputs=3, axis=2, squeeze_axis=True)
            o = F.contrib.flash_attention(q, k, v, causal=True)
            return self.proj(F.reshape(o, shape=(0, 0, -1)))

    return CausalSelfAttention(SF_ATT["units"], prefix="fleet_att_")


def _sf_attention(torch, mt, np, reg, card, bad):
    """(c) the attention model served by a FleetServer, f16, on the
    tensor-core flash route, held to the host run of the same version."""
    import threading
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.gluon import SymbolBlock
    from mxnet_tpu_torch.ops import flash_attention as fa
    from mxnet_tpu_torch.serving import FleetServer
    c = SF_ATT
    prev = torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    for k in fa.launches:
        fa.launches[k] = 0
    try:
        net = _sf_attention_block(mt)
        net.initialize(mt.init.Xavier(), generator=mt.random.seed(5))
        net.cast("float16")
        v = reg.publish("attention", net=net, signature={
            "bucket_shapes": [[c["t"], c["units"]]], "dtype": "float16"})
        gen = torch.Generator().manual_seed(23)
        items = (torch.randn((c["items"], c["t"], c["units"]),
                             generator=gen) * 0.5).half().numpy()
        res = reg.resolve("attention", v)
        host = SymbolBlock.imports(f"{res.prefix}-symbol.json", ["data"],
                                   f"{res.prefix}-0000.params", ctx=mt.cpu())
        want = host(mt.nd.array(items, ctx=mt.cpu())).asnumpy()
        srv = FleetServer(reg, "attention", max_batch_size=c["max_batch"],
                          name="fleet-att").start()
        try:
            warm = dict(srv.cold_start_stats)
            wrapper = dict(fa.launches)
            srv.reset_metrics()
            outs, errs = {}, []
            lock = threading.Lock()

            def client(cl):
                for j in range(cl, c["requests"], 4):
                    try:
                        o = srv.predict(items[j % c["items"]], timeout=120)
                        with lock:
                            outs[j] = o
                    except Exception as e:
                        with lock:
                            errs.append(repr(e))

            ths = [threading.Thread(target=client, args=(cl,))
                   for cl in range(4)]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for th in ths:
                    th.start()
                for th in ths:
                    th.join(120)
                torch.cuda.synchronize()
            batches = srv.metrics_json()["batches_total"]
            # the same graphs replayed from this thread, as the profile
            # phases count a replay's kernels. A window of graph replays
            # sometimes records none of the graph's kernels (CUPTI; either
            # window, in either order, in the whole run): such a window,
            # without the graph's GEMMs, measured nothing and is taken
            # again, up to SF_PROFILE_TRIES times
            xb = srv.cache.batch(items[:c["max_batch"]])
            for tries in range(1, SF_PROFILE_TRIES + 1):
                replay, _ = _profiled(torch, lambda: [
                    srv.cache(xb) for _ in range(SF_ATT_REPLAYS)])
                if _sf_graph_seen(replay):
                    break
        finally:
            srv.stop()

        def flash_count(p):
            return sum(n for name, (_, n) in _device_kernels(p).items()
                       if "flash_fwd" in name)

        device, device_replays = flash_count(prof), flash_count(replay)
        tol_ok, worst = True, 0.0
        for j, o in outs.items():
            w = want[j % c["items"]].astype(np.float32)
            err = np.abs(o.astype(np.float32) - w)
            lim = 2e-5 + 2.0 ** -10 * np.abs(w) + 2.0 ** -8 * np.abs(w).max()
            tol_ok = tol_ok and bool((err <= lim).all())
            worst = max(worst, float(err.max() / np.abs(w).max()))
        # the attention op itself at row 5's f16 tolerance: the served
        # version's q, k, v on the card against the plain version on the
        # host
        card_net = SymbolBlock.imports(f"{res.prefix}-symbol.json", ["data"],
                                       f"{res.prefix}-0000.params")
        x = torch.from_numpy(items[:1]).cuda()
        by_shape = {tuple(p.tensor.shape): p.tensor.detach() for p in
                    card_net.collect_params().values()}
        three = 3 * c["units"]
        qkv = torch.nn.functional.linear(x, by_shape[(three, c["units"])],
                                         by_shape[(three,)])
        qkv = qkv.reshape(1, c["t"], 3, c["heads"], -1)
        q, k_, v_ = (qkv[:, :, i] for i in range(3))
        route = fa.flash_route(q, k_, v_)
        with torch.no_grad():
            got = fa.flash_fwd(q, k_, v_, True, 1.0 / 8.0).float().cpu()
        ref = fa._flash_plain(q.cpu(), k_.cpu(), v_.cpu(), True,
                              1.0 / 8.0).float()
        lim = 2e-5 + 2.0 ** -10 * ref.abs() + 2.0 ** -11 * \
            v_.float().abs().max().cpu()
        op_ok = bool(((got - ref).abs() <= lim).all())
        row = {"version": v, "items": [c["t"], c["units"]],
               "dtype": "float16", "heads": c["heads"],
               "buckets": [1, 2, 4], "warm": warm,
               "requests": len(outs), "errors": errs[:4],
               "batches": batches, "device_flash_launches": device,
               "replays_profiled": SF_ATT_REPLAYS,
               "replay_windows_taken": tries,
               "request_window_saw_the_graph": _sf_graph_seen(prof),
               "device_flash_launches_replays": device_replays,
               "wrapper_launches_warmup": wrapper,
               "wrapper_launches_phase": dict(fa.launches),
               "outputs_vs_host_worst_over_max": worst,
               "outputs_within_tolerance": tol_ok,
               "tolerance": "2e-5 + 2^-10 |want| + 2^-8 max|want| (two "
                            "f16 GEMMs around the attention)",
               "op_route": route, "op_within_row5_tolerance": op_ok,
               "op_max_abs_err": float((got - ref).abs().max())}
    finally:
        torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = \
            prev
    emit({"phase": "serving_fleet", "what": "(c) attention", "card": card,
          **row})
    if errs or len(outs) != c["requests"] or not tol_ok or not op_ok or \
            route != "tc" or device_replays != SF_ATT_REPLAYS or \
            device > batches or wrapper["flash_fwd_tc"] < 1 or \
            wrapper["flash_fwd_general"]:
        bad.append(f"(c) attention: {row}")
    return row


def _sf_scan(torch, mt, np, net, images, card, bad):
    """(d) make_scan_forward: K batches as one graph replay."""
    from mxnet_tpu_torch.cached_op import CachedOp, make_scan_forward
    k, b = SF_SCAN_K, SF_SCAN_B
    idx = np.arange(k * b) % SF_IMAGES
    xs = torch.from_numpy(images[idx].reshape((k, b, IMG, IMG, 3))).cuda()
    fn = make_scan_forward(net)
    out = fn(xs)
    r0 = fn.replays
    out = fn(xs).cpu().numpy()
    one_replay = fn.replays - r0 == 1 and fn.captures == 1
    with mt.autograd.pause():
        eager = [net(mt.nd.from_torch(xs[i])).asnumpy() for i in range(k)]
    worst = max(_sf_rel(np, out[i], eager[i]) for i in range(k))
    co = CachedOp(net)
    xb = [mt.nd.from_torch(xs[i]) for i in range(k)]

    def four():
        for x in xb:
            co(x)

    def scan():
        fn(xs)

    row = {"k": k, "batch": b, "one_replay_a_call": one_replay,
           "captures": fn.captures, "vs_eager_worst": worst,
           "scan_median_ms": _sf_median_ms(torch, scan),
           "cached_op_4_calls_median_ms": _sf_median_ms(torch, four)}
    emit({"phase": "serving_fleet", "what": "(d) make_scan_forward",
          "card": card, **row})
    if not one_replay or worst > 1e-3:
        bad.append(f"(d) scan forward: {row}")
    return row


def _sf_median_ms(torch, fn, iters=SF_TIMED):
    """Median host-clock ms of ``fn`` ending in a synchronize, after one
    untimed call."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t))
    return sorted(ms)[len(ms) // 2]


def _sf_recipes(torch, mt, card, bad):
    """(e) examples/recsys/two_tower.py (--smoke: its training half, then
    the serving half: publish_embedding, a LookupFleet against the
    plane's dense table, lookup QPS) and (f) examples/serving/
    fleet_demo.py (--smoke), both under the port's names."""
    from importlib import import_module
    names = ("gluon", "gluon.nn", "optimizer", "parallel.embedding_plane",
             "serving", "serving.lookup")
    aliases = {f"mxnet_tpu.{n}": import_module(f"mxnet_tpu_torch.{n}")
               for n in names}
    prev = os.environ.get("MXTPU_SPARSE_PLANE")
    os.environ["MXTPU_SPARSE_PLANE"] = "on"
    row = {}
    try:
        for key, script in (("two_tower", "examples/recsys/two_tower.py"),
                            ("fleet_demo", "examples/serving/fleet_demo.py")):
            t = time.perf_counter()
            with mt.gpu(0):
                _, text = _run_recipe(mt, script, ["--smoke"], aliases)
            lines = [ln for ln in text.splitlines() if ln.startswith(
                ("lookup QPS", "served-table", "deploy:", "timeline",
                 "rolled back", "TWO_TOWER", "SMOKE"))]
            ok = ("TWO_TOWER OK" if key == "two_tower" else "SMOKE OK") \
                in text
            row[key] = {"ok": ok, "wall_s": time.perf_counter() - t,
                        "lines": lines}
            if not ok:
                bad.append(f"({'e' if key == 'two_tower' else 'f'}) "
                           f"{script}: {lines}")
    finally:
        if prev is None:
            os.environ.pop("MXTPU_SPARSE_PLANE", None)
        else:
            os.environ["MXTPU_SPARSE_PLANE"] = prev
    emit({"phase": "serving_fleet", "what": "(e) two_tower, (f) fleet_demo",
          "card": card, **row})
    return row


def serving_fleet(torch, mt, card):
    """The serving fleet (A23) on the card, at full width.
    (a) get_model("resnet50_v1", layout="NHWC") at the published widths,
    224x224x3 f32 items, TF32 off, deterministic cuDNN: v1 and v2 (seeds
    0 and 1) published to a registry; a FleetServer warms v1 (buckets 1,
    2, 4, 8), publish_aot(v2), deploy(v2) under load from 8 client
    threads: aot_loaded, compiles (0), captures, capture_ms, warm_s,
    drain_s; version tags monotone in dispatch order, zero errors, every
    response within 1e-3 of its largest logit of its version's eager
    forward; rollback; a version whose bundle carries a foreign
    fingerprint: 0 loaded, misses, still serving. (b) FleetRouter over
    replica processes sharing the card (python -m
    mxnet_tpu_torch.serving.serve_fleet --replica, the kernel-build cache
    seeded from this run's builds; r1 and r2 start while (a) runs, on a
    copy of the versions, r3 while (c) and (d) run): r1 publishes the
    bundle, r2 beside it; the router's img/s, p50, p99; SIGKILL r1 with 24 requests in
    flight, all answered; r3 scales up with 0 nvcc / NVRTC builds,
    aot_loaded > 0 and 0 misses (a cold process beside it loads every
    kernel library from the cache with 0 builds); rolling_deploy to v2
    under load, monotone per client; stop_fleet: both survivors exit 75.
    (c) a causal self-attention block (fused QKV Dense,
    F.contrib.flash_attention, output Dense; d_model 512, 8 heads, D 64),
    (2048, 512) f16 items, published and served by a FleetServer
    (buckets 1, 2, 4): every replayed batch launches mxt_flash_fwd_tc
    once (device count in a profile of the requests), outputs against the
    host run of the same version, the attention op at row 5's f16
    tolerance. (d) make_scan_forward on ResNet-50 at K 4, B 8: one graph
    replay a call, equal to 4 eager batches within 1e-3 of the largest
    logit, median ms against 4 CachedOp calls. (e) two_tower.py's
    serving half (f) fleet_demo.py, under the port's names."""
    import shutil
    import tempfile
    import numpy as np
    from mxnet_tpu_torch.serving import ModelRegistry
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="mxt_fleet_")
    bad, row, drill = [], {}, None
    try:
        reg = ModelRegistry(os.path.join(tmp, "registry"))
        gen = torch.Generator().manual_seed(29)
        images = torch.rand((SF_IMAGES, IMG, IMG, 3), generator=gen).numpy()
        sig = {"bucket_shapes": [[IMG, IMG, 3]], "dtype": "float32"}
        refs, nets = {}, {}
        t = time.perf_counter()
        for seed, v in ((0, "v1"), (1, "v2")):
            nets[v] = _sf_resnet(torch, mt, seed)
            reg.publish(SF_MODEL, net=nets[v], signature=sig,
                        set_current=v == "v1")
            reg.publish(SF_DRILL, prefix=reg.resolve(SF_MODEL, v).prefix,
                        signature=sig, set_current=v == "v1")
            with mt.autograd.pause():
                refs[v] = nets[v](mt.nd.from_torch(
                    torch.from_numpy(images).cuda())).asnumpy()
        parts = row["part_s"] = {"publish": time.perf_counter() - t}
        del nets["v2"]

        def part(name, fn, *args):
            t = time.perf_counter()
            out = fn(*args)
            parts[name] = time.perf_counter() - t
            return out

        drill = part("b_start", _sf_drill_start, reg, tmp)
        row["a"] = part("a", _sf_hot_swap, torch, mt, np, reg, images, refs,
                        card, bad)
        # (a)'s bundle of v2 serves the drill's v2 (the same signatures)
        reg.attach(SF_DRILL, "v2", "aot.bin",
                   reg.resolve(SF_MODEL, "v2").aot_path)
        torch.cuda.empty_cache()
        part("b_kill", _sf_drill_kill, torch, mt, np, drill, images, refs,
             bad)
        row["c"] = part("c", _sf_attention, torch, mt, np, reg, card, bad)
        torch.cuda.empty_cache()
        row["d"] = part("d", _sf_scan, torch, mt, np, nets["v1"], images,
                        card, bad)
        del nets
        torch.cuda.empty_cache()
        row["b"] = part("b_finish", _sf_drill_finish, torch, mt, np, drill,
                        images, refs, card, bad)
        row["e_f"] = part("e_f", _sf_recipes, torch, mt, card, bad)
    finally:
        if drill is not None:
            _sf_drill_stop(drill)
        torch.backends.cudnn.deterministic = prev_det
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "serving_fleet", "card": card,
          "part_s": row.get("part_s"), "failures": bad})
    if bad:
        fail("serving_fleet: " + "; ".join(bad))
    return row


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

    # every source's nvcc starts now; the first phases need only the BN
    # kernels, and the flash and NVRTC libraries finish beside them (their
    # first load collects them)
    t0 = time.perf_counter()
    _build.start()
    paths = _build.build(("fused_bn_act",))
    walls["build"] = time.perf_counter() - t0
    emit({"phase": "build", "seconds": walls["build"],
          "nvcc_s": dict(_build.build_seconds),
          "libraries": {k: os.path.relpath(v, here)
                        for k, v in paths.items()},
          "building": sorted(_build._running),
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
    # a real CachedOp behind hybridize() and the serving core, after every
    # earlier phase
    co_rows = timed("cached_op", cached_op_phase, torch, mt, card)
    torch.cuda.empty_cache()
    timed("serving", serving_phase, torch, mt, card)
    torch.cuda.empty_cache()
    # data-parallel training over torch.distributed, after every earlier
    # phase
    dt_launches, _ = timed("dist_train", dist_train, torch, mt, card)
    torch.cuda.empty_cache()
    # the self-healing fleet and the meshes (A10's second half), after
    # every earlier phase
    fleet = timed("fleet_train", fleet_train, torch, mt, card)
    torch.cuda.empty_cache()
    mesh = timed("mesh_lm", mesh_lm, torch, mt, card)
    torch.cuda.empty_cache()
    # sparse storage and the sparse embedding plane (A11), after every
    # earlier phase
    a11_phases(torch, mt, card, timed)
    # int8 quantization and the symbolic graph (A13, symbol/), after every
    # earlier phase
    a13_phases(torch, mt, card, timed)
    # the serving fleet (A23), after every earlier phase
    fleet_serving = timed("serving_fleet", serving_fleet, torch, mt, card)
    torch.cuda.empty_cache()
    # the recurrent stack (A14 slice 1's first half), after every earlier
    # phase
    rnn_row = timed("rnn_lm", rnn_lm, torch, mt, card)
    torch.cuda.empty_cache()
    # the symbolic training surface and the graph features (A14 slices 1
    # and 2), after every earlier phase
    a14_module_phases(torch, mt, card, timed, gluon_row=gluon_row,
                      lm_row=rnn_row)
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
    a12 = ("cached_op", "serving")
    a10 = ("dist_train", "fleet_train", "mesh_lm")
    emit({"phase": "walls", "seconds": walls,
          "total_s": sum(walls.values()),
          "earlier_phases_s": sum(v for k, v in walls.items()
                                  if k not in v2 + gluon + fits + f16
                                  + moe_remat + a19 + a20 + a12 + a10
                                  + A11_PHASES + A13_PHASES
                                  + A14_PHASES
                                  + ("serving_fleet", "rnn_lm")),
          "a11_phases_s": sum(walls[k] for k in A11_PHASES),
          "a13_phases_s": sum(walls[k] for k in A13_PHASES),
          "a23_phases_s": walls["serving_fleet"],
          "a14_rnn_phases_s": walls["rnn_lm"],
          "a14_module_phases_s": sum(walls[k] for k in A14_PHASES),
          "a10_phases_s": sum(walls[k] for k in a10),
          "a10_second_half_s": walls["fleet_train"] + walls["mesh_lm"],
          "a12_phases_s": sum(walls[k] for k in a12),
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
                           f"sites, batch {GT_BATCH}, f32); launches: "
                           "device count in gluon_train's profiled step, "
                           "CUDA graph replays of the hybridized net's "
                           "CachedOp"},
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
                                f"epoch ({FIT_EPOCH_STEPS} steps) under "
                                "MXTPU_MEGASTEP=on, "
                                "every step one CUDA graph replay"},
            "planes": {"launches": planes_launches[name],
                       "per": "wrapper launches over telemetry_planes' "
                              f"five {FIT_STEPS}-step FitLoop runs (the "
                              "megastep "
                              "run's two eager first steps only)"},
            "data_fed": {"launches": fed_launches[name],
                         "per": f"wrapper launches over the {A20_TIMED} "
                                "timed imagenet_example steps fed by "
                                "ImageRecordIter (bf16, batch "
                                f"{B})"},
            "cached_op": {"launches": co_rows["profiled_warm_step"][
                              "epilogue_device_launches"][name],
                          "per": f"device launches in one replayed "
                                 f"training step of cached_op's "
                                 f"hybridized small ResNetV1 "
                                 f"({CO_SITES} sites)"},
            "dist_train": {"launches": dt_launches[name],
                           "per": "device launches in one profiled "
                                  "forward + backward of rank 0 of the "
                                  "two ranks sharing the card "
                                  "(dist_train; rank 1 the same), CUDA "
                                  "graph replays of the hybridized "
                                  "ResNet-50 v1, f32 batch 32"},
            "fleet_train": {"launches": fleet["numerics_zero"][
                                "device_launches_per_step"][0][name],
                            "per": "device launches in FitLoop's own "
                                   "step 2 of rank 0 of fleet_train (c) "
                                   "(profiled; rank 1 the same), two ranks "
                                   "over gloo under distributed ZeRO, "
                                   "hybridized ResNet-50 v1, f32 batch 32"},
            "mesh_dp": {"launches": mesh["per_rank"][0]["spmd_dp"][
                            "bn_wrapper_launches_per_step"][name],
                        "per": "wrapper launches a step of rank 0 of "
                               "SPMDTrainer over {dp: 2} (mesh_lm; rank 1 "
                               "the same), ResNet-50 v1 bf16 batch 64 a "
                               "rank, eager steps, global-batch "
                               "statistics"},
            "module": {"launches": A14_STATE["module_launches"][name],
                       "launches_per_step": A14_STATE["module_launches"][
                           name] / A14_STATE["module_steps"],
                       "per": "wrapper launches over module_resnet50 (c)'s "
                              "Module.fit of the exported ResNet-50 v1 "
                              f"NHWC symbol, f32 batch {MR_BATCH}, "
                              f"{A14_STATE['module_steps']} steps, counts "
                              "zeroed just before the fit and read just "
                              "after (48 device launches in (b)'s "
                              "profiled step)"}})
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
        "tp_shape": {k: mesh["flash_tp_shape"][k] for k in
                     ("shape", "route", "max_abs_err", "ms", "plain_ms",
                      "bound_ms", "bound_by", "library_ms", "tflops")},
        "launches_tp_per_rank_step": mesh["per_rank"][0]["tp"][
            "flash_launches_per_step"],
        "launches_serving_fleet": {
            "device_replays": fleet_serving["c"][
                "device_flash_launches_replays"],
            "replays": fleet_serving["c"]["replays_profiled"],
            "device_requests": fleet_serving["c"]["device_flash_launches"],
            "batches": fleet_serving["c"]["batches"],
            "wrapper_warmup": fleet_serving["c"][
                "wrapper_launches_warmup"]["flash_fwd_tc"],
            "per": "(c), f16 (B, 2048, 8, 64) causal: device launches of "
                   "mxt_flash_fwd_tc in a profile of replays of the "
                   "served bucket-4 graph from the main thread, and in the "
                   "profiled requests (replayed by the server's worker "
                   "thread; batches dispatched beside it); wrapper "
                   "launches in the FleetServer's warm-up (eager run and "
                   "capture of buckets 1, 2, 4)"},
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


# ---------------------------------------------------------------------------
# the recurrent stack (A14 slice 1's first half): phase rnn_lm
# ---------------------------------------------------------------------------

# examples/rnn/word_language_model.py at the medium configuration of the
# reference's example/rnn/word_lm (Zaremba et al. 2014, medium PTB LSTM)
LM_VOCAB, LM_EMB, LM_HID, LM_LAYERS = 10000, 650, 650, 2
LM_BPTT, LM_BATCH, LM_DROPOUT, LM_LR, LM_CLIP = 35, 32, 0.5, 1.0, 0.25
LM_EAGER_STEPS, LM_REPLAYS, LM_TIMED = 20, 3, 10
RNN_RECIPES = (("examples/rnn/word_language_model.py",
                r"epoch \d+: ppl ([0-9.]+)"),
               ("examples/rnn/bi_lstm_sort.py",
                r"iter \d+: loss ([0-9.]+)"),
               ("examples/named_entity_recognition/ner_bilstm.py",
                r"iter \d+ loss ([0-9.]+)"),
               ("examples/ctc/lstm_ocr.py", r"iter \d+ ctc-loss ([0-9.]+)"))
def _rnn_op_case(torch, mt, mode, bid, ctx, gen_seed, dtype=None):
    """``mx.nd.RNN`` at the LM's widths (T 35, N 32, 650 -> 650, 2 layers)
    with state_outputs under record(): outputs and the gradients of data,
    parameters and states, on the host as tensors; inputs drawn in f32
    from ``gen_seed`` and cast to ``dtype``."""
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size
    dtype = dtype or torch.float32
    g = torch.Generator().manual_seed(gen_seed)
    d = 2 if bid else 1
    n_st = LM_LAYERS * d
    size = rnn_param_size(LM_LAYERS, LM_EMB, LM_HID, bid, mode)
    scale = LM_HID ** -0.5
    host = [torch.randn(LM_BPTT, LM_BATCH, LM_EMB, generator=g),
            (torch.rand(size, generator=g) * 2 - 1) * scale,
            torch.randn(n_st, LM_BATCH, LM_HID, generator=g) * 0.5]
    if mode == "lstm":
        host.append(torch.randn(n_st, LM_BATCH, LM_HID, generator=g) * 0.5)
    n_out = 3 if mode == "lstm" else 2
    shapes = [(LM_BPTT, LM_BATCH, d * LM_HID)] + \
        [(n_st, LM_BATCH, LM_HID)] * (n_out - 1)
    heads = [torch.randn(s, generator=g) for s in shapes]
    with ctx:
        arrs = [mt.nd.from_torch(t.to(ctx.torch_device, dtype))
                for t in host]
        for a in arrs:
            a.attach_grad()
        with mt.autograd.record():
            outs = mt.nd.RNN(*arrs, state_size=LM_HID, num_layers=LM_LAYERS,
                             mode=mode, bidirectional=bid, state_outputs=True)
        mt.autograd.backward(list(outs), [
            mt.nd.from_torch(h.to(ctx.torch_device, dtype)) for h in heads])
        got = [o.tensor.cpu() for o in outs] + \
            [a.grad.tensor.cpu() for a in arrs]
    return got


def _rnn_lm_model(torch, mt, cls, dropout, ctx, values=None):
    """The recipe's RNNModel at the LM widths on ``ctx``, Xavier (from
    ``mx.random.seed``'s seed), or with the tensors ``values`` (in
    ``collect_params`` order) copied in."""
    with ctx:
        model = cls(LM_VOCAB, LM_EMB, LM_HID, LM_LAYERS, dropout=dropout)
        model.initialize(mt.init.Xavier())
        if values is not None:
            with torch.no_grad():
                for v, p in zip(values, model.collect_params().values()):
                    p.set_data(mt.nd.from_torch(v))
    return model


def _lm_values(model):
    return [p.tensor.detach().clone() for p in
            model.collect_params().values()]


def _rnn_lm_step(mt, model, trainer, lossfn, x, y, hidden, train_mode=True):
    """One step of the recipe's loop: record, the model, the loss,
    backward, clip_global_norm at 0.25 x batch, SGD. Returns (loss,
    hidden, logits)."""
    hidden = [h.detach() for h in hidden]
    with mt.autograd.record(train_mode=train_mode):
        out, hidden = model(x, hidden)
        loss = lossfn(out.reshape((-1, LM_VOCAB)), y)
    loss.backward()
    grads = [p.grad() for p in model.collect_params().values()
             if p.grad_req != "null"]
    mt.gluon.utils.clip_global_norm(grads, LM_CLIP * LM_BATCH)
    trainer.step(LM_BATCH)
    return loss, hidden, out


def _lm_corpus(np, n_tokens, seed=0):
    """The recipe's synthetic Markov corpus (``load_corpus`` without
    ``--data``) at vocab 10000: each token's successor one of 4."""
    rs = np.random.RandomState(seed)
    trans = rs.randint(0, LM_VOCAB, (LM_VOCAB, 4))
    pick = rs.randint(0, 4, n_tokens)
    ids = np.zeros(n_tokens + 1, np.int64)
    for i in range(n_tokens):
        ids[i + 1] = trans[ids[i], pick[i]]
    return ids.astype(np.int32)


def _rnn_lm_train(torch, mt, card, g, pool):
    """(b): the word LM on the card against the host (the host's step on
    ``pool``), trained eagerly, then hybridized."""
    import numpy as np
    gpu, cpu = mt.gpu(0), mt.cpu()
    mt.random.seed(0)
    ids = _lm_corpus(np, (LM_EAGER_STEPS + LM_TIMED + 8) * LM_BATCH
                     * LM_BPTT)
    batches = list(g["batchify"](ids, LM_BATCH, LM_BPTT))

    class LM(g["RNNModel"]):
        def forward(self, inputs, hidden):
            return self._imperative_call(inputs, hidden)

    def nd_batch(k, ctx):
        x, y = batches[k]
        return (mt.nd.array(x, ctx=ctx, dtype="int32"),
                mt.nd.array(y.reshape(-1).astype(np.float32), ctx=ctx))

    lossfn = mt.gluon.loss.SoftmaxCrossEntropyLoss()

    def first_step(model, ctx):
        """Loss and every gradient of the first batch, dropout off."""
        with ctx:
            x, y = nd_batch(0, ctx)
            hidden = model.begin_state(LM_BATCH)
            with mt.autograd.record(train_mode=False):
                out, _ = model(x, hidden)
                loss = lossfn(out.reshape((-1, LM_VOCAB)), y)
            loss.backward()
            return [loss.tensor.cpu()] + [
                p.grad().tensor.cpu() for p in
                model.collect_params().values() if p.grad_req != "null"]

    # the first step, card against host from the same weights, dropout off
    # (predict-mode record); the host's runs on the pool's thread
    card_m = _rnn_lm_model(torch, mt, LM, LM_DROPOUT, gpu)
    start = [v.cpu() for v in _lm_values(card_m)]
    host_first = pool.submit(lambda: first_step(_rnn_lm_model(
        torch, mt, LM, LM_DROPOUT, cpu, start), cpu))
    card_first = first_step(card_m, gpu)
    worst, first_ok = _close_of_max(torch, card_first, host_first.result(),
                                    1e-3)
    # 20 eager steps with dropout on
    trainer = mt.gluon.Trainer(card_m.collect_params(), "sgd",
                               {"learning_rate": LM_LR}, kvstore=None)
    hidden = card_m.begin_state(LM_BATCH)
    losses, step_s = [], []
    # peaks above what is allocated when the steps start (earlier phases
    # of the whole run may hold memory)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    for k in range(LM_EAGER_STEPS):
        x, y = nd_batch(k, gpu)
        t = time.perf_counter()
        loss, hidden, _ = _rnn_lm_step(mt, card_m, trainer, lossfn, x, y,
                                       hidden)
        losses.append(float(loss.mean().asscalar()))
        step_s.append(time.perf_counter() - t)
    eager_peak = torch.cuda.max_memory_allocated() - base
    falls = float(np.mean(losses[-5:])) < float(np.mean(losses[:5]))
    eager_prof, eager_wall = _profiled(torch, lambda: _rnn_lm_step(
        mt, card_m, trainer, lossfn, *nd_batch(0, gpu), hidden))
    # hybridize(): 3 replayed steps against 3 eager steps, dropout off
    eager_m = _rnn_lm_model(torch, mt, LM, LM_DROPOUT, gpu,
                            _lm_values(card_m))
    hyb = _rnn_lm_model(torch, mt, LM, LM_DROPOUT, gpu, _lm_values(card_m))
    del card_m, trainer
    hyb.hybridize()
    pair = [(m, mt.gluon.Trainer(m.collect_params(), "sgd",
                                 {"learning_rate": LM_LR}, kvstore=None),
             m.begin_state(LM_BATCH)) for m in (eager_m, hyb)]
    bitwise, not_bitwise = True, []
    for k in range(LM_REPLAYS):
        res = []
        for i, (m, tr, hid) in enumerate(pair):
            loss, hid, out = _rnn_lm_step(mt, m, tr, lossfn,
                                          *nd_batch(k, gpu), hid,
                                          train_mode=False)
            pair[i] = (m, tr, hid)
            res.append([loss.tensor, out.tensor] + [
                p.tensor for p in m.collect_params().values()])
        for j, (a, b) in enumerate(zip(*res)):
            if not torch.equal(a, b):
                bitwise = False
                not_bitwise.append(f"step {k} tensor {j}")
    info = tuple(hyb._cached_op.cache_info())
    # dropout on: two replays of one signature draw different masks
    x, y = nd_batch(1, gpu)
    hid = [h.detach() for h in pair[1][2]]
    outs = []
    for _ in range(3):                 # capture, then two replays
        with mt.autograd.record():
            out, _ = hyb(x, hid)
            loss = lossfn(out.reshape((-1, LM_VOCAB)), y)
        loss.backward()
        outs.append(out.tensor.clone())
    masks_differ = not torch.equal(outs[1], outs[2]) and \
        not torch.equal(outs[0], outs[1])
    # the replayed step, dropout on, timed
    _, tr, hid = pair[1]
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    replay_s = []
    for k in range(LM_TIMED):
        x, y = nd_batch(LM_EAGER_STEPS + k, gpu)
        t = time.perf_counter()
        loss, hid, _ = _rnn_lm_step(mt, hyb, tr, lossfn, x, y, hid)
        float(loss.mean().asscalar())
        replay_s.append(time.perf_counter() - t)
    replay_peak = torch.cuda.max_memory_allocated() - base
    replay_prof, replay_wall = _profiled(torch, lambda: _rnn_lm_step(
        mt, hyb, tr, lossfn, *nd_batch(0, gpu), hid))
    tokens = LM_BATCH * LM_BPTT
    out = {"first_step_card_vs_host": worst, "first_step_ok": first_ok,
           "eager_losses": losses, "loss_falls": falls,
           "eager_ms": 1e3 * float(np.median(step_s[2:])),
           "eager_tokens_per_s": tokens / float(np.median(step_s[2:])),
           "eager_peak_bytes_above_start": eager_peak,
           "replay_bitwise_vs_eager": bitwise,
           "not_bitwise": not_bitwise[:8], "cache_info": info,
           "dropout_masks_differ_per_replay": masks_differ,
           "replay_ms": 1e3 * float(np.median(replay_s)),
           "replay_tokens_per_s": tokens / float(np.median(replay_s)),
           "replay_peak_bytes_above_start": replay_peak}
    for name, prof, wall in (("eager", eager_prof, eager_wall),
                             ("replay", replay_prof, replay_wall)):
        kernels = _device_kernels(prof)
        busy = sum(ms for ms, _ in kernels.values())
        out[f"{name}_profiled_wall_ms"] = wall
        out[f"{name}_device_busy_ms"] = busy
        out[f"{name}_device_idle_share"] = 1.0 - busy / wall if busy \
            else None
        out[f"{name}_device_kernel_launches"] = sum(
            n for _, n in kernels.values())
        out[f"{name}_top_kernels"] = [
            [round(ms, 3), n, k[:70]] for k, (ms, n) in sorted(
                kernels.items(), key=lambda kv: -kv[1][0])[:5]]
    bad = []
    if not first_ok:
        bad.append(f"first step card vs host {worst}")
    if not falls:
        bad.append(f"the loss did not fall: {losses}")
    if not bitwise:
        bad.append(f"replayed steps not bit for bit: {not_bitwise[:4]}")
    if info[1] < 1 or info[0] < LM_REPLAYS - 1:
        bad.append(f"cache_info {info}: the steps did not replay")
    if not masks_differ:
        bad.append("two replays drew the same dropout masks")
    return out, bad


def _rnn_legacy(torch, mt):
    """(c): mx.rnn's FusedRNNCell and an unrolled LSTMCell bound through
    the Executor on the card and the host; BucketSentenceIter feeding one
    executor a bucket over three buckets."""
    import random
    import numpy as np
    rows, bad = {}, []

    def bind_run(sym, ctx, shapes, seed):
        with ctx:
            ex = sym.simple_bind(ctx, **shapes)
            g = torch.Generator().manual_seed(seed)
            for name in sym.list_arguments():
                arr = ex.arg_dict[name]
                arr[:] = ((torch.rand(arr.shape, generator=g) * 2 - 1)
                          * 0.08).numpy()
            outs = ex.forward(is_train=True)
            heads = [mt.nd.from_torch(torch.randn(o.shape, generator=g)
                                      .to(ctx.torch_device)) for o in outs]
            ex.backward(heads)
            return [o.tensor.cpu() for o in outs] + [
                ex.grad_dict[k].tensor.cpu() for k in sorted(ex.grad_dict)
                if ex.grad_dict[k] is not None]

    fused = mt.rnn.FusedRNNCell(LM_HID, num_layers=LM_LAYERS, mode="lstm",
                                get_next_state=True, prefix="lm_")
    f_out, f_states = fused.unroll(LM_BPTT, inputs=mt.sym.var("data"),
                                   layout="TNC")
    cell = mt.rnn.LSTMCell(LM_HID, prefix="cell_")
    c_out, _ = cell.unroll(LM_BPTT, inputs=mt.sym.var("data"),
                           layout="NTC", merge_outputs=True)
    for name, sym, shape in (
            ("fused_rnn_cell", mt.sym.Group([f_out] + f_states),
             (LM_BPTT, LM_BATCH, LM_EMB)),
            ("lstm_cell_unrolled", c_out, (LM_BATCH, LM_BPTT, LM_EMB))):
        card_r = bind_run(sym, mt.gpu(0), {"data": shape}, 7)
        host_r = bind_run(sym, mt.cpu(), {"data": shape}, 7)
        worst, ok = _close_of_max(torch, card_r, host_r, 1e-3)
        rows[name] = {"card_vs_host": worst, "tensors": len(card_r)}
        if not ok:
            bad.append(f"{name}: card vs host {worst}")
    # bucketing: one bound executor a bucket, weights shared
    rs = np.random.RandomState(3)
    buckets, width = [10, 20, 35], 200
    sentences = [list(rs.randint(1, LM_VOCAB, rs.randint(lo, hi + 1)))
                 for lo, hi in ((5, 10), (11, 20), (21, 35))
                 for _ in range(2 * LM_BATCH)]
    random.seed(0)
    np.random.seed(0)
    it = mt.rnn.BucketSentenceIter(sentences, LM_BATCH, buckets=buckets,
                                   invalid_label=0)
    data = mt.sym.var("data")
    embed = mt.sym.Embedding(data, input_dim=LM_VOCAB, output_dim=width,
                             name="embed")
    out, _ = mt.rnn.FusedRNNCell(width, num_layers=1, mode="lstm",
                                 prefix="bk_").unroll(0, inputs=embed,
                                                      layout="NTC")
    pred = mt.sym.FullyConnected(mt.sym.reshape(out, shape=(-1, width)),
                                 num_hidden=LM_VOCAB, name="pred")
    net = mt.sym.SoftmaxOutput(pred, mt.sym.reshape(
        mt.sym.var("softmax_label"), shape=(-1,)), name="softmax")
    g = torch.Generator().manual_seed(11)
    shared, execs, host_execs, losses, worst_b = {}, {}, {}, [], 0.0
    for b in it:
        key = b.bucket_key
        fresh = key not in execs
        if fresh:
            for ctx, table in ((mt.gpu(0), execs), (mt.cpu(), host_execs)):
                with ctx:
                    table[key] = net.simple_bind(
                        ctx, data=(LM_BATCH, key),
                        softmax_label=(LM_BATCH, key))
                for name, arr in table[key].arg_dict.items():
                    if name in ("data", "softmax_label"):
                        continue
                    if name not in shared:
                        shared[name] = ((torch.rand(arr.shape, generator=g)
                                         * 2 - 1) * 0.1).numpy()
                    arr[:] = shared[name]
        runs = [execs[key]] + ([host_execs[key]] if fresh else [])
        res = []
        for ex in runs:
            ex.arg_dict["data"][:] = b.data[0].asnumpy()
            ex.arg_dict["softmax_label"][:] = b.label[0].asnumpy()
            prob = ex.forward(is_train=True)[0]
            ex.backward()
            res.append([prob.tensor.cpu(),
                        ex.grad_dict["bk_parameters"].tensor.cpu()])
        lab = b.label[0].asnumpy().reshape(-1).astype(int)
        p = res[0][0].numpy()
        losses.append(float(-np.log(p[np.arange(lab.size), lab]
                                    + 1e-12).mean()))
        if fresh:
            w, ok = _close_of_max(torch, res[0], res[1], 1e-3)
            worst_b = max(worst_b, w)
            if not ok:
                bad.append(f"bucket {key}: card vs host {w}")
    rows["bucketing"] = {"buckets": sorted(execs), "batches": len(losses),
                         "losses": losses, "card_vs_host": worst_b}
    if sorted(execs) != buckets or not all(np.isfinite(losses)):
        bad.append(f"bucketing: {rows['bucketing']}")
    return rows, bad


def _rnn_recipes(mt):
    """(d): the four recurrent recipes at their defaults; each must exit
    0 (its main returns) and its loss fall."""
    import re
    aliases = {"mxnet_tpu.gluon": mt.gluon}
    rows, bad = {}, []
    for script, pattern in RNN_RECIPES:
        t = time.perf_counter()
        _, text = _run_recipe(mt, script, [], aliases)
        vals = [float(v) for v in re.findall(pattern, text)]
        name = os.path.basename(script)
        rows[name] = {"seconds": time.perf_counter() - t,
                      "first": vals[0] if vals else None,
                      "last": vals[-1] if vals else None,
                      "printed": len(vals)}
        if len(vals) < 2 or not vals[-1] < vals[0]:
            bad.append(f"{name}: the loss did not fall ({vals})")
    return rows, bad


def _rnn_ctc(torch, mt):
    """(e): gluon.loss.CTCLoss (blank last) card against host at
    lstm_ocr.py's shapes (batch 32, 20 columns, 10 digits + blank, 1-3
    labels) and 4x (batch 128, 80 columns, 4-12 labels), with and
    without label lengths: the NLL and the activations' gradient."""
    rows, bad = {}, []
    for name, b, t, lo, hi in (("ocr", 32, 20, 1, 3),
                               ("ocr_x4", 128, 80, 4, 12)):
        g = torch.Generator().manual_seed(b)
        acts = torch.randn(b, t, 11, generator=g)
        lens = torch.randint(lo, hi + 1, (b,), generator=g)
        labels = torch.full((b, hi), -1.0)
        for i in range(b):
            labels[i, :lens[i]] = torch.randint(0, 10, (int(lens[i]),),
                                                generator=g).float()
        for with_lengths in (True, False):
            res = []
            for ctx in (mt.gpu(0), mt.cpu()):
                with ctx:
                    x = mt.nd.from_torch(acts.to(ctx.torch_device))
                    x.attach_grad()
                    extra = (None, mt.nd.from_torch(
                        lens.float().to(ctx.torch_device))) \
                        if with_lengths else ()
                    with mt.autograd.record():
                        loss = mt.gluon.loss.CTCLoss()(
                            x, mt.nd.from_torch(
                                labels.to(ctx.torch_device)), *extra)
                    loss.backward()
                    res.append([loss.tensor.cpu(), x.grad.tensor.cpu()])
            worst, ok = _close_of_max(torch, res[0], res[1], 1e-3)
            key = f"{name}_{'lengths' if with_lengths else 'packed'}"
            rows[key] = {"shape": [b, t, 11], "card_vs_host": worst,
                         "mean_nll": float(res[0][0].detach().mean())}
            if not ok or not torch.isfinite(res[0][0]).all():
                bad.append(f"ctc {key}: {rows[key]}")
    return rows, bad


def _rnn_op_gate(torch, cases, card_r, host_r, bad):
    """(a)'s rows and verdicts. Every tensor within 1e-3 of its largest
    value, except rnn_relu's gradients in f32: a pre-activation within a
    rounding step of 0 flips a ReLU between card and host and moves the
    gradients by percents (``tools/rnn_relu_flip_probe.py`` shows one
    such flip among the 2.9 million units of the two-way case), so
    rnn_relu is held whole in f64 and its f32 run by its outputs and
    final states; its f32 gradient error is reported."""
    rows = {}
    for mode, bid, dt in cases:
        got, want = card_r[(mode, bid, dt)], host_r[(mode, bid, dt)]
        n_out = 2
        key = f"{mode}_{'bi' if bid else 'uni'}"
        if mode == "rnn_relu":
            key += "_f64" if dt == torch.float64 else "_f32"
        worst, ok = _close_of_max(torch, got, want, 1e-3)
        rows[key] = {"card_vs_host": worst, "tensors": len(got),
                     "dtype": str(dt).replace("torch.", "")}
        if mode == "rnn_relu" and dt == torch.float32:
            fwd, ok = _close_of_max(torch, got[:n_out], want[:n_out], 1e-3)
            rows[key].update({"card_vs_host": fwd,
                              "gated": "outputs and final states",
                              "gradients_card_vs_host": worst})
        if not ok:
            bad.append(f"(a) {key}: card vs host {rows[key]}")
    return rows


def rnn_lm(torch, mt, card):
    """The recurrent stack on the card (``--phases rnn_lm``; in the whole
    run before the A14 module phases). (a) ``mx.nd.RNN`` in modes lstm, gru, rnn_tanh and
    rnn_relu, two layers, one-way and bidirectional, with
    ``state_outputs``, at the word LM's widths (T 35, N 32, 650 -> 650):
    outputs, final states and the gradients of data, parameters and
    states card against host within 1e-3 of each tensor's largest value,
    in f32, and rnn_relu also in f64, where its gradients are gated
    (``_rnn_op_gate``); the host runs on a thread beside the card work.
    (b) ``examples/rnn/word_language_model.py``'s RNNModel at vocab
    10000, 650 / 650, 2 layers, bptt 35, batch 32, dropout 0.5, SGD lr 1
    with ``clip_global_norm`` at 0.25 x batch (the reference's medium
    word LM): the first step card against host (dropout off), 20 eager
    steps with dropout whose loss falls, then ``hybridize()``: 3 replayed
    steps bit for bit against 3 eager steps (dropout off) and two replays
    with different dropout masks; ms a step, tokens/s and peak memory,
    eager and replayed, and the idle share of one profiled step of each.
    (c) ``mx.rnn``: a FusedRNNCell and an unrolled LSTMCell symbol bound
    through the Executor, card against host; BucketSentenceIter feeding
    one executor a bucket over three buckets. (d) the four recurrent
    recipes at their defaults with ``mxnet_tpu`` aliased to the port:
    each returns and its loss falls. (e) ``gluon.loss.CTCLoss`` card
    against host. The phase adds no kernel."""
    from concurrent.futures import ThreadPoolExecutor
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    walls, bad = {}, []
    # the host references run on a thread of their own beside the card
    # work (torch's host kernels release the interpreter lock)
    pool = ThreadPoolExecutor(max_workers=1)
    try:
        t = time.perf_counter()
        cases = [(mode, bid, torch.float32 if mode != "rnn_relu"
                  else torch.float64)
                 for mode in ("lstm", "gru", "rnn_tanh", "rnn_relu")
                 for bid in (False, True)]
        cases += [("rnn_relu", bid, torch.float32) for bid in (False, True)]
        # one seed a (mode, direction): rnn_relu's f32 and f64 runs take
        # the same inputs
        seed = {c[:2]: 100 + 2 * k for k, c in enumerate(cases[:8])}
        host = {c: pool.submit(_rnn_op_case, torch, mt, c[0], c[1],
                               mt.cpu(), seed[c[:2]], c[2]) for c in cases}
        card_r = {c: _rnn_op_case(torch, mt, c[0], c[1], mt.gpu(0),
                                  seed[c[:2]], c[2]) for c in cases}
        walls["a_card"] = time.perf_counter() - t
        t = time.perf_counter()
        # the recipe's RNNModel and batchify; its globals keep the port
        with _AsPort(mt, {"mxnet_tpu.gluon": mt.gluon}):
            g = _recipe_module("examples/rnn/word_language_model.py")
        lm, lm_bad = _rnn_lm_train(torch, mt, card, g, pool)
        bad += [f"(b) {m}" for m in lm_bad]
        walls["b"] = time.perf_counter() - t
        torch.cuda.empty_cache()
        t = time.perf_counter()
        op_rows = _rnn_op_gate(torch, cases, card_r,
                               {c: f.result() for c, f in host.items()},
                               bad)
        walls["a_host_wait"] = time.perf_counter() - t
    finally:
        pool.shutdown(wait=True)
    t = time.perf_counter()
    legacy, legacy_bad = _rnn_legacy(torch, mt)
    bad += [f"(c) {m}" for m in legacy_bad]
    walls["c"] = time.perf_counter() - t
    t = time.perf_counter()
    recipes, recipe_bad = _rnn_recipes(mt)
    bad += [f"(d) {m}" for m in recipe_bad]
    walls["d"] = time.perf_counter() - t
    t = time.perf_counter()
    ctc, ctc_bad = _rnn_ctc(torch, mt)
    bad += [f"(e) {m}" for m in ctc_bad]
    walls["e"] = time.perf_counter() - t
    row = {"phase": "rnn_lm", "card": card, "op": op_rows, "lm": lm,
           "legacy": legacy, "recipes": recipes, "ctc": ctc,
           "gate_seconds": walls,
           "config": {"vocab": LM_VOCAB, "emsize": LM_EMB, "nhid": LM_HID,
                      "layers": LM_LAYERS, "bptt": LM_BPTT,
                      "batch": LM_BATCH, "dropout": LM_DROPOUT,
                      "lr": LM_LR, "clip": LM_CLIP * LM_BATCH}}
    emit(row)
    if bad:
        fail(f"rnn_lm: {bad}")
    return row


# ---------------------------------------------------------------------------
# the symbolic training surface and graph features (A14 slices 1 and 2):
# phases module_resnet50, bucketing_lm, graph_features
# ---------------------------------------------------------------------------

A14_PHASES = ("module_resnet50", "bucketing_lm", "graph_features")
A14_STATE = {}      # the exported ResNet-50 files, shared by the phases
MR_BATCH, MR_IMAGES, MR_EPOCHS, MR_TIMED = 32, 256, 2, 10
MR_OPT = {"learning_rate": 0.05, "momentum": 0.9}
MR_TOL = 1e-4
MR_WARM_SPINS = (200, 800, 3200)   # warm-up spins of each window
BK_BUCKETS, BK_STEPS, BK_LR, BK_TIMED = (10, 20, 30, 35), 40, 1.0, 5
BK_TOL = 1e-4
BK_STATES = ("lstm_state", "lstm_state_cell")
GF_TOL = 1e-4


def _mr_export(torch, mt, tmp):
    """``resnet50_v1(layout="NHWC", stem_s2d=True)`` at its published
    widths, Xavier from seed 0, exported with ``HybridBlock.export`` (one
    inference forward resolves the deferred shapes; no statistic moves):
    (net, prefix, symbol with a SoftmaxOutput head, arg and aux params as
    loaded from the files). Made once a process."""
    if "mr" in A14_STATE:
        return A14_STATE["mr"]
    from mxnet_tpu_torch.gluon.model_zoo.vision import resnet50_v1
    net = resnet50_v1(layout="NHWC", stem_s2d=True)
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(0))
    with torch.no_grad():
        net(torch.zeros((2, IMG, IMG, 3), device=mt.gpu(0).torch_device))
    prefix = os.path.join(tmp, "resnet50_v1_nhwc")
    net.export(prefix)
    body, arg, aux = mt.model.load_checkpoint(prefix, 0)
    sym = mt.sym.SoftmaxOutput(body, mt.sym.var("softmax_label"),
                               name="softmax")
    A14_STATE["mr"] = (net, prefix, sym, arg, aux)
    return A14_STATE["mr"]


def _mr_images(torch, mt, n, seed):
    """``n`` images and labels from ``seed`` (numpy, host)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return (rng.random((n, IMG, IMG, 3), dtype=np.float32),
            rng.integers(0, 1000, n).astype(np.float32))


def _mr_module(mt, sym, arg, aux):
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (MR_BATCH, IMG, IMG, 3))],
             label_shapes=[("softmax_label", (MR_BATCH,))])
    mod.init_params(arg_params=arg, aux_params=aux)
    mod.init_optimizer(optimizer="sgd", optimizer_params=dict(MR_OPT))
    return mod


def _mr_state(mod):
    """The Module's weights and aux states (tensors, copies)."""
    arg, aux = mod.get_params()
    return {**{k: v.tensor for k, v in arg.items()},
            **{k: v.tensor for k, v in aux.items()}}


def _mr_step(torch, mod, batch):
    mod.forward_backward(batch)
    mod.update()


def _mr_worst(torch, got, want):
    """(worst error as a fraction of each tensor's largest value, the
    three tensors furthest off) over the names of ``want``."""
    errs = sorted(((_close_of_max(torch, [got[n]], [want[n]], 1)[0], n)
                   for n in want), reverse=True)
    return errs[0][0] if errs else 0.0, [[n, e] for e, n in errs[:3]]


def _mr_against_gluon(torch, mt, net, mod, x, y, aux):
    """(a): one Module step (forward_backward + update) against one Gluon
    Trainer step on ``net`` from the same weights and batch: outputs
    (SoftmaxOutput's probabilities against the softmax of the logits),
    gradients, updated weights and moving statistics; and the BN
    wrappers' launches in the Module step alone."""
    from mxnet_tpu_torch.gluon import loss as gloss
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    tk.reset_launches()
    mod.forward_backward(mt.io.DataBatch([x], [y]))
    out = mod.get_outputs()[0].tensor.clone()
    grads = {n: mod._exec.grad_dict[n].tensor.clone()
             for n in mod._param_names}
    mod.update()
    torch.cuda.synchronize()
    launches = dict(tk.launches)
    state = _mr_state(mod)
    params = net.collect_params()
    trainer = mt.gluon.Trainer(params, "sgd", dict(MR_OPT))
    with mt.autograd.record():
        logits = net(x)
        loss = gloss.SoftmaxCrossEntropyLoss()(logits, y)
    loss.backward()
    g_grads = {n: params[n].grad().tensor.clone() for n in grads}
    trainer.step(MR_BATCH)
    names_aux = [n for n in state if n not in grads]
    worst, top = {}, {}
    for what, got, want in (
            ("outputs", {"out": out},
             {"out": torch.softmax(logits.tensor.detach(), -1)}),
            ("gradients", grads, g_grads),
            ("weights", {n: state[n] for n in grads},
             {n: params[n].tensor for n in grads}),
            ("moving_statistics", {n: state[n] for n in names_aux},
             {n: params[n].tensor for n in names_aux})):
        worst[what], top[what] = _mr_worst(torch, got, want)
    moved = sum(int(not torch.equal(aux[n].tensor.to(state[n].device),
                                    state[n])) for n in names_aux)
    return worst, top, len(grads), len(names_aux), moved, launches


def _median_step_ms(torch, fn, n):
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    times.sort()
    return 1e3 * times[len(times) // 2]


def module_resnet50(torch, mt, card, tmp, gluon_row=None):
    """``mx.mod.Module`` training the full-width ResNet-50 v1 NHWC symbol
    (``resnet50_v1(layout="NHWC", stem_s2d=True)``, the net of
    ``gluon_train``, exported with ``HybridBlock.export``, loaded with
    ``mx.sym.load``, a ``SoftmaxOutput`` head added), f32 batch 32, TF32
    off, deterministic cuDNN, SGD lr 0.05 momentum 0.9. (a) one Module
    step against one Gluon ``Trainer`` step from the same weights and
    batch: outputs, gradients, updated weights and moving statistics
    within 1e-4 of each tensor's largest value (the fused BN nodes'
    moving statistics moved: the JAX executor's fault, repaired). (b) a
    profiled Module step, in a window that kept both of its marks
    (``_profiled``): 48 device launches of each BN kernel, and 48
    wrapper launches. (c) ``Module.fit`` over an ``NDArrayIter`` of 256
    images from seed 3, 2 epochs, ``callback.module_checkpoint`` every
    epoch with the optimizer states (wrapper counts zeroed just before
    the fit and read just after: 48 a step of each); then
    ``Module.load(prefix, 1, load_optimizer_states=True)`` and one step on
    epoch 2's first batch: its weights, momenta and moving statistics
    bit for bit those of the run that was not interrupted; ``score`` and
    ``predict`` run. (d) median ms of 10 Module steps against 10 eager
    Gluon Trainer steps on the same net in this call (and
    ``gluon_train``'s replayed step when it ran in the call), peak
    memory above the phase's start."""
    import numpy as np
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    bad, row = [], {"phase": "module_resnet50", "card": card,
                    "batch": MR_BATCH, "image": IMG,
                    "dtype": "float32, TF32 off"}
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        net, prefix, sym, arg, aux = _mr_export(torch, mt, tmp)
        row["export_and_load_s"] = time.perf_counter() - t
        node_ops = [n.op.name for n in sym._topo() if n.op is not None]
        row["graph"] = {op: node_ops.count(op) for op in
                        ("Convolution", "_contrib_fused_bn_relu",
                         "_contrib_fused_bn_add_relu", "BatchNorm")}
        X, Y = _mr_images(torch, mt, MR_IMAGES, 3)
        x = mt.nd.array(X[:MR_BATCH], ctx=mt.gpu(0))
        y = mt.nd.array(Y[:MR_BATCH], ctx=mt.gpu(0))
        # (a)
        t = time.perf_counter()
        mod = _mr_module(mt, sym, arg, aux)
        worst, top, n_w, n_aux, moved, step_wrappers = _mr_against_gluon(
            torch, mt, net, mod, x, y, aux)
        row["a"] = {"worst_of_max": worst, "furthest": top, "weights": n_w,
                    "moving_statistics": n_aux,
                    "moving_statistics_moved": moved,
                    "module_step_wrapper_launches": step_wrappers,
                    "seconds": time.perf_counter() - t}
        if any(v > MR_TOL for v in worst.values()) or moved != n_aux:
            bad.append(f"(a) Module against Gluon: {row['a']}")
        if any(step_wrappers.get(k) != 48 for k in KERNELS):
            bad.append(f"(a) wrapper launches in a Module step: "
                       f"{step_wrappers}")
        # (b)
        # a window that lost a mark lost launches: it is taken again with
        # a longer warm-up, each window's record kept in the row
        batch = mt.io.DataBatch([x], [y])
        windows = []
        for tries, warm in enumerate(MR_WARM_SPINS, 1):
            prof, wall = _profiled(torch, lambda: _mr_step(torch, mod, batch),
                                   marks=True, warm=warm)
            whole = _window_whole(prof)
            windows.append(_window_report(prof))
            if whole:
                break
        summary = _summary("one Module step (forward_backward + update), "
                           "ResNet-50 v1 NHWC f32 b32",
                           _device_kernels(prof), wall, {})
        summary["host_top_ops"] = _host_top(torch, prof, 8)
        emit(summary)
        row["b"] = {"device_launches": summary["epilogue_device_launches"],
                    "device_idle_share": summary["device_idle_share"],
                    "profiled_wall_ms": wall, "windows_taken": tries,
                    "warm_spins": warm, "window_whole": whole,
                    "windows": windows}
        if not whole or any(summary["epilogue_device_launches"][k] != 48
                            for k in KERNELS):
            bad.append(f"(b) device launches of a Module step: "
                       f"{summary['epilogue_device_launches']}, window "
                       f"whole: {whole} after {tries} window(s)")
        # (d) before (c) frees the timed Module
        module_ms = _median_step_ms(torch, lambda: _mr_step(torch, mod,
                                                           batch), MR_TIMED)
        from mxnet_tpu_torch.gluon import loss as gloss
        trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                   dict(MR_OPT))
        lossfn = gloss.SoftmaxCrossEntropyLoss()

        def gluon_step():
            with mt.autograd.record():
                loss = lossfn(net(x), y)
            loss.backward()
            trainer.step(MR_BATCH)
        gluon_ms = _median_step_ms(torch, gluon_step, MR_TIMED)
        row["d"] = {"module_step_ms": module_ms,
                    "module_img_per_s": MR_BATCH / module_ms * 1e3,
                    "gluon_eager_step_ms": gluon_ms,
                    "gluon_train_replayed_step_ms":
                        gluon_row["step_ms"] if gluon_row else None,
                    "steps": MR_TIMED}
        del mod, trainer
        # (c)
        t = time.perf_counter()
        it = mt.io.NDArrayIter(X, Y, batch_size=MR_BATCH)
        fit_mod = mt.mod.Module(sym, context=mt.gpu(0))
        ck = os.path.join(tmp, "mr_ckpt")
        snap = {}

        def after_batch(param):
            if (param.epoch, param.nbatch) == (1, 0):
                snap.update({k: v.clone() for k, v in
                             _mr_state(fit_mod).items()})
                snap.update({f"mom:{i}": s.tensor.clone() for i, s in
                             fit_mod._updater.states.items()})
        tk.reset_launches()
        fit_mod.fit(it, num_epoch=MR_EPOCHS, optimizer="sgd",
                    optimizer_params=dict(MR_OPT), arg_params=arg,
                    aux_params=aux, eval_metric="acc",
                    batch_end_callback=after_batch,
                    epoch_end_callback=mt.callback.module_checkpoint(
                        fit_mod, ck, save_optimizer_states=True))
        torch.cuda.synchronize()
        fit_launches = dict(tk.launches)
        fit_s = time.perf_counter() - t
        steps = MR_EPOCHS * MR_IMAGES // MR_BATCH
        score = dict(fit_mod.score(it, "acc", num_batch=2))
        pred = fit_mod.predict(it, num_batch=2)
        del fit_mod
        t = time.perf_counter()
        back = mt.mod.Module.load(ck, 1, load_optimizer_states=True,
                                  context=mt.gpu(0))
        back.bind(data_shapes=it.provide_data,
                  label_shapes=it.provide_label)
        back.init_params()
        back.init_optimizer(optimizer="sgd", optimizer_params=dict(MR_OPT))
        it.reset()
        _mr_step(torch, back, next(iter(it)))
        resumed = {**_mr_state(back),
                   **{f"mom:{i}": s.tensor for i, s in
                      back._updater.states.items()}}
        not_bitwise = [k for k in snap if not torch.equal(resumed[k],
                                                          snap[k])]
        row["c"] = {"steps": steps, "fit_s": fit_s,
                    "wrapper_launches": fit_launches,
                    "files": sorted(f for f in os.listdir(tmp)
                                    if f.startswith("mr_ckpt")),
                    "resume_s": time.perf_counter() - t,
                    "resumed_tensors": len(snap),
                    "not_bitwise": not_bitwise[:8],
                    "score": score, "predict_shape": list(pred.shape)}
        if any(fit_launches.get(k) != 48 * steps for k in KERNELS):
            bad.append(f"(c) wrapper launches over Module.fit: "
                       f"{fit_launches}, want {48 * steps} each")
        if not snap or not_bitwise or len(resumed) != len(snap):
            bad.append(f"(c) resume not bit for bit: {not_bitwise[:8]}")
        if list(pred.shape) != [2 * MR_BATCH, 1000] or \
                not 0.0 <= score.get("accuracy", -1) <= 1.0 or \
                not np.isfinite(pred.asnumpy()).all():
            bad.append(f"(c) score / predict: {score} {pred.shape}")
        del back, it
        row["peak_bytes_above_start"] = torch.cuda.max_memory_allocated() \
            - base
        A14_STATE["module_launches"] = fit_launches
        A14_STATE["module_steps"] = steps
    finally:
        torch.backends.cudnn.deterministic = prev_det
    emit(row)
    if bad:
        fail(f"module_resnet50: {bad}")
    return row


def _bk_sentences(np, seed=0):
    """Sentences of the word LM's synthetic Markov language (each token's
    successor one of 4; ``_lm_corpus``'s), token ids from 1 (0 pads), 320
    for each bucket's length range: ten batches of 32 a bucket."""
    rs = np.random.RandomState(seed)
    trans = rs.randint(1, LM_VOCAB, (LM_VOCAB, 4))
    out = []
    for lo, hi in zip((1,) + BK_BUCKETS[:-1], BK_BUCKETS):
        for _ in range(10 * LM_BATCH):
            n = rs.randint(lo + 1, hi + 1)
            s = [int(rs.randint(1, LM_VOCAB))]
            for _ in range(n - 1):
                s.append(int(trans[s[-1], rs.randint(4)]))
            out.append(s)
    return out


def _bk_sym_gen(mt):
    """The bucketed word LM: Embedding, a 2-layer LSTM (``sym.RNN``), a
    FullyConnected to the vocabulary and SoftmaxOutput ignoring the pad
    label 0 (examples/rnn/bucketing.py's layout at the medium widths)."""
    S = mt.sym

    def sym_gen(seq_len):
        embed = S.Embedding(S.var("data"), S.var("embed_weight"),
                            input_dim=LM_VOCAB, output_dim=LM_EMB,
                            name="embed")
        out = S.RNN(S.transpose(embed, axes=(1, 0, 2)),
                    S.var("lstm_parameters"), S.var(BK_STATES[0]),
                    S.var(BK_STATES[1]), state_size=LM_HID,
                    num_layers=LM_LAYERS, mode="lstm", name="lstm")
        out = S.reshape(S.transpose(out, axes=(1, 0, 2)),
                        shape=(-1, LM_HID))
        pred = S.FullyConnected(out, S.var("pred_weight"),
                                S.var("pred_bias"), num_hidden=LM_VOCAB,
                                name="pred")
        label = S.reshape(S.var("softmax_label"), shape=(-1,))
        return (S.SoftmaxOutput(pred, label, use_ignore=True,
                                ignore_label=0, name="softmax"),
                ("data",), ("softmax_label",))
    return sym_gen


def _bk_module(mt, ctx, it, values):
    """The BucketingModule on ``ctx``, bound at the default bucket, its
    parameters from ``values`` (numpy), SGD."""
    bm = mt.mod.BucketingModule(_bk_sym_gen(mt),
                                default_bucket_key=it.default_bucket_key,
                                context=ctx, fixed_param_names=BK_STATES)
    bm.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    bm.init_params(arg_params={k: mt.nd.array(v, ctx=ctx)
                               for k, v in values.items()})
    bm.init_optimizer(optimizer="sgd",
                      optimizer_params={"learning_rate": BK_LR})
    return bm


def _bk_values(np, mt, it):
    """Seeded starting values of every parameter, by the default bucket's
    inferred shapes (uniform 0.1; biases and the fixed states zeros)."""
    rs = np.random.RandomState(1)
    sym, data_names, label_names = _bk_sym_gen(mt)(it.default_bucket_key)
    shapes, _, _ = sym.infer_shape(**{d.name: d.shape for d in
                                      it.provide_data + it.provide_label})
    return {k: np.zeros(s, np.float32) if k.endswith("bias")
            or k in BK_STATES else rs.uniform(-0.1, 0.1, s)
            .astype(np.float32)
            for k, s in sorted(zip(sym.list_arguments(), shapes))
            if k not in data_names + label_names}


def _bk_nll(np, prob, label):
    """Mean negative log-likelihood over the non-pad tokens."""
    p, lab = prob.asnumpy(), label.asnumpy().reshape(-1).astype(int)
    keep = lab != 0
    return float(-np.log(p[np.arange(lab.size), lab][keep] + 1e-12).mean())


def bucketing_lm(torch, mt, card, tmp, lm_row=None):
    """``mx.mod.BucketingModule`` over a ``sym_gen`` of ``sym.Embedding``,
    ``sym.RNN`` (LSTM), ``FullyConnected`` and ``SoftmaxOutput`` at PR
    23's word-LM widths (vocab 10000, embed 650, hidden 650, 2 layers,
    batch 32, f32, TF32 off), buckets 10 / 20 / 30 / 35 fed by
    ``BucketSentenceIter`` over the word LM's synthetic Markov sentences
    from seed 0, SGD lr 1. (a) each bucket's first forward / backward on
    the card against the host from the same weights: outputs and every
    gradient within 1e-4 of each tensor's largest value. (b) the four
    buckets' executors hold one storage per parameter and gradient
    (``data_ptr``). (c) 40 steps: the loss falls (the last 8 steps'
    mean below the first 8's). (d) ms a step and tokens/s per bucket
    (median of 5) against ``rnn_lm``'s eager step at T 35 when it ran in
    the call. Then ``examples/rnn/bucketing.py`` at its defaults and
    ``examples/image_classification/train_mnist.py`` at its defaults on
    the card (``--ctx gpu``), ``mxnet_tpu`` resolved to the port (in
    process, as ``_run_recipe`` runs the recipes): each runs to its end,
    LeNet's final accuracy above 0.9."""
    import logging
    import random
    import re
    import numpy as np
    bad, row = [], {"phase": "bucketing_lm", "card": card,
                    "config": {"vocab": LM_VOCAB, "embed": LM_EMB,
                               "hidden": LM_HID, "layers": LM_LAYERS,
                               "batch": LM_BATCH, "buckets": BK_BUCKETS,
                               "lr": BK_LR}}
    random.seed(0)
    np.random.seed(0)
    it = mt.rnn.BucketSentenceIter(_bk_sentences(np), LM_BATCH,
                                   buckets=list(BK_BUCKETS),
                                   invalid_label=0)
    batches = list(it)
    first = {}
    for b in batches:
        first.setdefault(b.bucket_key, b)
    gpu, cpu = mt.gpu(0), mt.cpu()
    values = _bk_values(np, mt, it)
    with gpu:
        card_bm = _bk_module(mt, gpu, it, values)
    with cpu:
        host_bm = _bk_module(mt, cpu, it, values)
    # (a)
    t = time.perf_counter()
    rows_a = {}
    for key in BK_BUCKETS:
        res = []
        for bm, ctx in ((card_bm, gpu), (host_bm, cpu)):
            b = first[key]
            with ctx:
                bm.forward(mt.io.DataBatch(
                    [d.as_in_context(ctx) for d in b.data],
                    [l.as_in_context(ctx) for l in b.label],
                    bucket_key=key), is_train=True)
                bm.backward()
                ex = bm._curr_module._exec
                res.append([bm.get_outputs()[0].tensor] + [
                    ex.grad_dict[n].tensor for n in sorted(ex.grad_dict)])
        worst, ok = _close_of_max(torch, res[0], res[1], BK_TOL)
        rows_a[key] = {"card_vs_host": worst, "tensors": len(res[0])}
        if not ok:
            bad.append(f"(a) bucket {key}: card vs host {worst}")
    row["a"] = {"buckets": rows_a, "seconds": time.perf_counter() - t}
    del host_bm
    # (b)
    mods = [card_bm._buckets[k] for k in BK_BUCKETS]
    unshared = [n for n in mods[0]._exec.arg_dict
                if n not in ("data", "softmax_label") and len(
                    {m._exec.arg_dict[n].tensor.data_ptr() for m in mods})
                != 1]
    unshared += [f"grad:{n}" for n in mods[0]._exec.grad_dict if len(
        {m._exec.grad_dict[n].tensor.data_ptr() for m in mods}) != 1]
    row["b"] = {"buckets": sorted(card_bm._buckets),
                "parameters": len(mods[0]._param_names),
                "unshared": unshared}
    if sorted(card_bm._buckets) != list(BK_BUCKETS) or unshared:
        bad.append(f"(b) storage shared: {row['b']}")
    # (c)
    t = time.perf_counter()
    losses, keys = [], []
    order = batches * (1 + BK_STEPS // len(batches))
    for b in order[:BK_STEPS]:
        card_bm.forward(b, is_train=True)
        card_bm.backward()
        card_bm.update()
        losses.append(_bk_nll(np, card_bm.get_outputs()[0], b.label[0]))
        keys.append(b.bucket_key)
    falls = float(np.mean(losses[-8:])) < float(np.mean(losses[:8]))
    row["c"] = {"steps": BK_STEPS, "losses": losses, "bucket_keys": keys,
                "loss_falls": falls, "seconds": time.perf_counter() - t}
    if not (falls and np.isfinite(losses).all()):
        bad.append(f"(c) the loss did not fall: {losses}")
    # (d)
    per = {}
    for key in BK_BUCKETS:
        b = first[key]

        def step():
            card_bm.forward(b, is_train=True)
            card_bm.backward()
            card_bm.update()
        step()
        ms = _median_step_ms(torch, step, BK_TIMED)
        per[key] = {"step_ms": ms,
                    "tokens_per_s": LM_BATCH * key / ms * 1e3}
    row["d"] = {"per_bucket": per,
                "rnn_lm_eager_step_ms_t35":
                    lm_row["lm"]["eager_ms"] if lm_row else None,
                "rnn_lm_replayed_step_ms_t35":
                    lm_row["lm"]["replay_ms"] if lm_row else None}
    del card_bm, mods
    torch.cuda.empty_cache()
    # the recipes, on the card
    level = logging.getLogger().level
    handlers = list(logging.getLogger().handlers)
    recipes = {}
    try:
        for script, argv, aliases, pattern in (
                ("examples/rnn/bucketing.py", [],
                 {"mxnet_tpu.rnn": mt.rnn, "mxnet_tpu.module": mt.module,
                  "mxnet_tpu.ops": mt.ops,
                  "mxnet_tpu.ops.rnn_op": mt.ops.rnn_op},
                 r"bucketing training done"),
                ("examples/image_classification/train_mnist.py",
                 ["--ctx", "gpu"],
                 {"mxnet_tpu.io": mt.io, "mxnet_tpu.module": mt.module},
                 r"final accuracy: \{'accuracy': ([0-9.]+)\}")):
            t = time.perf_counter()
            _, text = _run_recipe(mt, script, argv, aliases)
            found = re.findall(pattern, text)
            name = os.path.basename(script)
            recipes[name] = {"argv": argv, "printed": found,
                             "seconds": time.perf_counter() - t}
            if not found or (name == "train_mnist.py"
                             and not float(found[-1]) > 0.9):
                bad.append(f"recipe {name}: {found} {text[-300:]}")
    finally:
        root = logging.getLogger()
        root.setLevel(level)
        root.handlers[:] = handlers
    row["recipes"] = recipes
    emit(row)
    if bad:
        fail(f"bucketing_lm: {bad}")
    return row


def _gf_lstm_graphs(mt):
    """(foreach over an LSTM cell, the fused RNN op), one layer at the
    word LM's widths, with the same weights as separate variables and as
    the op's flat vector [W, R, bW, bR] (gates i, f, g, o)."""
    S = mt.sym
    w, r = S.var("i2h_weight"), S.var("h2h_weight")
    bw, br = S.var("i2h_bias"), S.var("h2h_bias")

    def body(x, states):
        h, c = states
        gates = S.FullyConnected(x, w, bw, num_hidden=4 * LM_HID) + \
            S.FullyConnected(h, r, br, num_hidden=4 * LM_HID)
        i, f, g, o = S.split(gates, num_outputs=4, axis=1)
        c2 = S.sigmoid(f) * c + S.sigmoid(i) * S.tanh(g)
        h2 = S.sigmoid(o) * S.tanh(c2)
        return h2, [h2, c2]
    outs, (h_t, c_t) = S.contrib.foreach(body, S.var("data"),
                                         [S.var("h0"), S.var("c0")])
    fused = S.RNN(S.var("data"), S.var("parameters"), S.var("state"),
                  S.var("state_cell"), state_size=LM_HID, num_layers=1,
                  mode="lstm", state_outputs=True, name="lstm")
    return S.Group([outs, h_t, c_t]), fused


def _gf_foreach_lstm(torch, mt):
    """(a): forward and every gradient of the foreach LSTM against the
    fused RNN op, T 35, N 32, 650 -> 650, on the card."""
    g = torch.Generator().manual_seed(21)

    def u(*shape):
        return (torch.rand(shape, generator=g) * 0.16 - 0.08)
    T, N, H = LM_BPTT, LM_BATCH, LM_HID
    v = {"data": u(T, N, LM_EMB) * 10, "h0": u(N, H) * 5, "c0": u(N, H) * 5,
         "i2h_weight": u(4 * H, LM_EMB), "h2h_weight": u(4 * H, H),
         "i2h_bias": u(4 * H), "h2h_bias": u(4 * H)}
    heads = [torch.randn(s, generator=g) for s in ((T, N, H), (N, H),
                                                   (N, H))]
    loop, fused = _gf_lstm_graphs(mt)
    gpu = mt.gpu(0)

    def run(sym, args, heads):
        nd = {k: mt.nd.array(a.numpy(), ctx=gpu) for k, a in args.items()}
        ex = sym.bind(gpu, nd, args_grad={k: mt.nd.zeros(a.shape, ctx=gpu)
                                          for k, a in args.items()})
        outs = [o.tensor.clone() for o in ex.forward(is_train=True)]
        ex.backward([mt.nd.from_torch(h.to(gpu.torch_device))
                     for h in heads])
        return outs, {k: ex.grad_dict[k].tensor for k in args}
    t = time.perf_counter()
    lo, lg = run(loop, v, heads)
    flat = torch.cat([v["i2h_weight"].reshape(-1),
                      v["h2h_weight"].reshape(-1), v["i2h_bias"],
                      v["h2h_bias"]])
    fo, fg = run(fused, {"data": v["data"], "parameters": flat,
                         "state": v["h0"][None], "state_cell":
                         v["c0"][None]}, heads[:1] + [h[None] for h in
                                                       heads[1:]])
    n = [w.numel() for w in (v["i2h_weight"], v["h2h_weight"],
                             v["i2h_bias"], v["h2h_bias"])]
    parts = torch.split(fg["parameters"], n)
    got = lo + [lg[k] for k in ("data", "h0", "c0", "i2h_weight",
                                "h2h_weight", "i2h_bias", "h2h_bias")]
    want = [fo[0], fo[1][0], fo[2][0], fg["data"], fg["state"][0],
            fg["state_cell"][0]] + [
        p.reshape(v[k].shape) for p, k in zip(parts, (
            "i2h_weight", "h2h_weight", "i2h_bias", "h2h_bias"))]
    worst, ok = _close_of_max(torch, got, want, GF_TOL)
    return {"shape": [T, N, LM_EMB, H], "worst_of_max": worst,
            "tensors": len(got), "seconds": time.perf_counter() - t}, ok


def _gf_nd_cases(torch, mt, ctx):
    """(b): ``mx.nd.contrib`` foreach / while_loop / cond with their
    gradients, on ``ctx``."""
    import numpy as np
    rs = np.random.RandomState(22)
    out = []
    with ctx:
        x = mt.nd.array(rs.randn(12, 64, 128).astype(np.float32))
        w = mt.nd.array(rs.randn(128, 128).astype(np.float32) * 0.1)
        h0 = mt.nd.zeros((64, 128))
        for a in (x, w):
            a.attach_grad()
        with mt.autograd.record():
            outs, h = mt.nd.contrib.foreach(
                lambda xt, h: [mt.nd.tanh(xt + mt.nd.dot(h, w))] * 2, x, h0)
            wl, (i, s) = mt.nd.contrib.while_loop(
                lambda i, s: i < 5, lambda i, s: (s * 2, [i + 1, s * w[0]]),
                [mt.nd.array([0.0]), h[0]], max_iterations=8)
            c = mt.nd.contrib.cond(s.sum() > 0, lambda: s * 3,
                                   lambda: s - 1)
            loss = outs.sum() + (wl * wl).sum() + c.sum()
        loss.backward()
        out = [outs, h, wl, s, c, x.grad, w.grad]
    return [o.tensor.detach().cpu() for o in out]


def _gf_custom_block(torch, mt, ctx):
    """(c): a registered Custom op inside a hybridized block, 3 Trainer
    steps on ``ctx`` from seeded numpy weights: outputs, gradients of the
    input and the updated weights."""
    import numpy as np
    rs = np.random.RandomState(23)
    with ctx:
        class Net(mt.gluon.HybridBlock):
            def __init__(self):
                super().__init__(prefix="cnet_")
                self.fc1 = mt.gluon.nn.Dense(256, in_units=128)
                self.fc2 = mt.gluon.nn.Dense(10, in_units=256)

            def hybrid_forward(self, F, x):
                h = F.Custom(self.fc1(x), op_type="gf_scaled_sqr",
                             scale=0.5)
                return self.fc2(h)
        net = Net()
        net.initialize()
        for p in net.collect_params().values():
            p.set_data(mt.nd.array(rs.uniform(-0.1, 0.1, p.shape)
                                   .astype(np.float32)))
        net.hybridize()
        tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                              {"learning_rate": 0.05, "momentum": 0.9})
        res = []
        for k in range(3):
            x = mt.nd.array(rs.randn(64, 128).astype(np.float32))
            x.attach_grad()
            with mt.autograd.record():
                y = net(x)
                loss = (y * y).mean()
            loss.backward()
            res += [y.tensor.detach(), x.grad.tensor]
            tr.step(64)
        res += [p.tensor for p in net.collect_params().values()]
        info = tuple(net._cached_op.cache_info())
    return [r.detach().cpu() for r in res], info


def _gf_register_custom(mt):
    if "gf_scaled_sqr" in mt.operator.get_all_registered():
        return

    @mt.operator.register("gf_scaled_sqr")
    class ScaledSqrProp(mt.operator.CustomOpProp):
        def __init__(self, scale="1.0"):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def create_operator(self, ctx, shapes, dtypes):
            return ScaledSqr(self.scale)

    class ScaledSqr(mt.operator.CustomOp):
        def __init__(self, scale):
            self.scale = scale

        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        in_data[0] * in_data[0] * self.scale)

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            self.assign(in_grad[0], req[0],
                        2 * self.scale * in_data[0] * out_grad[0])


def _gf_partitioned(torch, mt, tmp):
    """(d): the full-width ResNet-50 symbol and its
    ``optimize_for("XLA")`` partition, bound on the card from the same
    weights: a training forward and backward of each on one batch, the
    outputs, every gradient and the moving statistics bit for bit (the
    region walks the same ops in the same order, with deterministic
    cuDNN); the BN wrappers' launches in the partitioned step."""
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    _, _, sym, arg, aux = _mr_export(torch, mt, tmp)
    part = sym.optimize_for("XLA")
    kinds = sorted({n.op.name for n in part._topo() if n.op is not None})
    X, Y = _mr_images(torch, mt, MR_BATCH, 4)
    gpu = mt.gpu(0)
    res, launches = [], None
    for s in (sym, part):
        ex = s.simple_bind(gpu, data=(MR_BATCH, IMG, IMG, 3),
                           softmax_label=(MR_BATCH,))
        ex.copy_params_from(arg, aux)
        tk.reset_launches()
        out = ex.forward(is_train=True, data=mt.nd.array(X, ctx=gpu),
                         softmax_label=mt.nd.array(Y, ctx=gpu))[0]
        ex.backward()
        torch.cuda.synchronize()
        launches = dict(tk.launches)
        res.append([out.tensor.clone()] + [
            ex.grad_dict[k].tensor.clone() for k in sorted(ex.grad_dict)]
            + [ex.aux_dict[k].tensor.clone() for k in sorted(ex.aux_dict)])
        del ex
    bitwise = len(res[0]) == len(res[1]) and all(
        torch.equal(a, b) for a, b in zip(*res))
    worst, _ = _close_of_max(torch, res[1], res[0], 0.0)
    return {"node_kinds": kinds, "tensors": len(res[0]),
            "bit_for_bit": bitwise, "worst_of_max": worst,
            "partitioned_step_wrapper_launches": launches}


def graph_features(torch, mt, card, tmp):
    """The graph features on the card. (a) ``sym.contrib.foreach`` over an
    LSTM-cell body (FullyConnected, split, sigmoid / tanh) at the word
    LM's widths (T 35, batch 32, 650 -> 650) against the fused ``RNN`` op
    with the same weights: outputs, final states and every gradient within
    1e-4 of each tensor's largest value. (b) ``mx.nd.contrib.foreach`` /
    ``while_loop`` / ``cond`` under ``record()``: values and gradients
    card against host within 1e-4. (c) a registered ``Custom`` op inside
    a hybridized block (its CachedOp captures the op into the graphs), 3
    Trainer steps: outputs, the input's gradients and the updated weights
    card against host within 1e-4, the graphs replayed. (d)
    ``optimize_for("XLA")`` on the full-width ResNet-50 symbol (one
    ``_subgraph`` region): a training forward and backward bit for bit
    the unpartitioned graph's (the region walks the same ops in the same
    order; deterministic cuDNN), 48 wrapper launches of each BN kernel
    in the partitioned step."""
    prev_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    bad, row = [], {"phase": "graph_features", "card": card}
    try:
        row["a"], ok = _gf_foreach_lstm(torch, mt)
        if not ok:
            bad.append(f"(a) foreach LSTM against the RNN op: {row['a']}")
        t = time.perf_counter()
        worst, ok = _close_of_max(torch, _gf_nd_cases(torch, mt, mt.gpu(0)),
                                  _gf_nd_cases(torch, mt, mt.cpu()), GF_TOL)
        row["b"] = {"worst_of_max": worst,
                    "seconds": time.perf_counter() - t}
        if not ok:
            bad.append(f"(b) mx.nd.contrib card vs host: {worst}")
        _gf_register_custom(mt)
        t = time.perf_counter()
        (card_r, info), (host_r, _) = (_gf_custom_block(torch, mt, c)
                                       for c in (mt.gpu(0), mt.cpu()))
        worst, ok = _close_of_max(torch, card_r, host_r, GF_TOL)
        row["c"] = {"worst_of_max": worst, "cache_info": info,
                    "seconds": time.perf_counter() - t}
        if not ok or info[0] < 2:
            bad.append(f"(c) Custom op in a hybridized block: {row['c']}")
        t = time.perf_counter()
        row["d"] = _gf_partitioned(torch, mt, tmp)
        row["d"]["seconds"] = time.perf_counter() - t
        if not row["d"]["bit_for_bit"] or \
                row["d"]["node_kinds"] != ["_subgraph"] or any(
                    row["d"]["partitioned_step_wrapper_launches"].get(k)
                    != 48 for k in KERNELS):
            bad.append(f"(d) optimize_for: {row['d']}")
    finally:
        torch.backends.cudnn.deterministic = prev_det
    emit(row)
    if bad:
        fail(f"graph_features: {bad}")
    return row


def a14_module_phases(torch, mt, card, timed, names=A14_PHASES,
                      gluon_row=None, lm_row=None):
    """The A14 slice 1 and 2 phases, in order, with a scratch
    directory."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="mxt_a14_")
    fns = {"module_resnet50": lambda: module_resnet50(torch, mt, card, tmp,
                                                      gluon_row),
           "bucketing_lm": lambda: bucketing_lm(torch, mt, card, tmp,
                                                lm_row),
           "graph_features": lambda: graph_features(torch, mt, card, tmp)}
    rows = {}
    try:
        for name in names:
            rows[name] = timed(name, fns[name])
            torch.cuda.empty_cache()
    finally:
        A14_STATE.pop("mr", None)
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


def run_phases(argv):
    """``chip_smoke.py --phases NAME [NAME ...]``: build the kernels and run
    only the named phases of A10's second half (``fleet_train``,
    ``mesh_lm``), of A11 (``sparse_ops``, ``sparse_mf``, ``sparse_dist``,
    ``recsys_plane``), of A23 (``serving_fleet``), of A14's recurrent
    stack (``rnn_lm``), of A13 (``int8_ops``, ``int8_resnet50``,
    ``resid8_train``, ``symbol_export``, ``quant_recipes``) and of A14's
    symbolic training surface (``module_resnet50``, ``bucketing_lm``,
    ``graph_features``); the A13 and then the A14 ones after the others,
    each group in its own order, with their ``wall`` lines and a last
    ``walls`` line. Any failure exits non-zero."""
    phases = {"fleet_train": fleet_train, "mesh_lm": mesh_lm,
              "sparse_ops": sparse_ops_phase, "sparse_mf": sparse_mf,
              "sparse_dist": sparse_dist, "recsys_plane": recsys_plane,
              "serving_fleet": serving_fleet, "rnn_lm": rnn_lm}
    phases.update({n: None for n in A13_PHASES + A14_PHASES})
    unknown = sorted(set(argv) - set(phases))
    if not argv or unknown:
        fail(f"name phases from {', '.join(phases)} (unknown: {unknown})")
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import mxnet_tpu_torch as mt
    from mxnet_tpu_torch.ops import _build
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    walls, rows = {}, {}
    t = time.perf_counter()
    _build.build()
    walls["build"] = time.perf_counter() - t

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t
        emit({"phase": "wall", "of": name, "seconds": walls[name]})
        return out

    for name in argv:
        if name not in A13_PHASES + A14_PHASES:
            rows[name] = timed(name, phases[name], torch, mt, card)
            torch.cuda.empty_cache()
    a13 = [n for n in argv if n in A13_PHASES]
    if a13:
        a13_phases(torch, mt, card, timed, a13)
    a14 = [n for n in argv if n in A14_PHASES]
    if a14:
        a14_module_phases(torch, mt, card, timed, a14,
                          lm_row=rows.get("rnn_lm"))
    emit({"phase": "walls", "seconds": walls})


SUBCOMMANDS = {"--dist-rank": dist_rank, "--nccl-check": nccl_check,
               "--example-rank": example_rank, "--fleet-rank": fleet_rank,
               "--mesh-rank": mesh_rank, "--sparse-rank": sparse_rank,
               "--phases": run_phases}

if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] in SUBCOMMANDS:
        SUBCOMMANDS[sys.argv[1]](sys.argv[2:])
    else:
        main()
