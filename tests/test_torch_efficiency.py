"""The port's efficiency plane (``MXTPU_EFFICIENCY``) and its program
costs against the JAX package's: the summary's keys, FLOPs equal to the
analytic matmul count, FLOPs within 2 % of XLA's count on a
matmul-dominated MLP (batch 64, widths 512), the hand-written kernels'
reported cost against their plain versions' counted cost, the
``MXTPU_DEVICE_PEAK`` grammar's messages, and ``estimate`` on the CPU."""
import numpy as np
import pytest
import torch

import torch_planes_common as C

import mxnet_tpu as mx
from mxnet_tpu.telemetry import efficiency as jeff

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import flash_attention as fa
from mxnet_tpu_torch.ops import fused_bn_act as tk
from mxnet_tpu_torch.ops import kernel_cost
from mxnet_tpu_torch.telemetry import efficiency as teff
from mxnet_tpu_torch.telemetry import memory as tmem


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    monkeypatch.setenv("MXTPU_EFFICIENCY", "on")
    for k in ("MXTPU_MEGASTEP", "MXTPU_NUMERICS", "MXTPU_DEVICE_PEAK"):
        monkeypatch.delenv(k, raising=False)


def _mlp_flops(dims, batch):
    """Forward + backward matmul FLOPs of a Dense stack (the input
    needs no gradient): 2*b*i*o forward, twice that backward except the
    first layer's input gradient."""
    f = 0
    for li, (i, o) in enumerate(zip(dims, dims[1:])):
        f += 2 * batch * i * o * (3 if li else 2)
    return f


def test_summary_keys_and_flops_equal_the_analytic_count():
    res = {pkg: C.fit(pkg, "mlp", epochs=1, hybridize=True)[2]
           for pkg in ("jax", "port")}
    t, j = res["port"].efficiency, res["jax"].efficiency
    assert sorted(t) == sorted(j)
    assert sorted(t["recent"][0]) == sorted(j["recent"][0])
    assert sorted(t["per_program"][0]) == sorted(j["per_program"][0])
    assert t["steps"] == 4 and t["unattributed_dispatches"] == 0
    assert t["flops_per_step"] == _mlp_flops((6, 16, 16, 4), C.BATCH)
    assert t["estimate"] is True and t["peak"]["source"] == "default:cpu"
    kinds = {(p["kind"], p["label"].split(":")[-1]) for p in
             t["per_program"]}
    assert ("cached_op", "fwd") in kinds and ("cached_op", "bwd") in kinds
    labels = " ".join(p["label"] for p in t["per_program"])
    assert "SGD:bucket" in labels and "finite_flag:6" in labels
    assert all(p["dispatches"] == 4 for p in t["per_program"])


def test_megastep_flops_equal_composed(monkeypatch):
    comp = C.fit("port", "conv", epochs=1, hybridize=True)[2].efficiency
    monkeypatch.setenv("MXTPU_MEGASTEP", "on")
    mega = C.fit("port", "conv", epochs=1)[2].efficiency
    assert mega["flops_per_step"] == comp["flops_per_step"] > 0
    assert [p["kind"] for p in mega["per_program"]] == ["megastep"]


def _wide_mlp(m):
    net = m.gluon.nn.HybridSequential(prefix="wide_")
    with net.name_scope():
        for i in range(3):
            net.add(m.gluon.nn.Dense(512, activation="relu",
                                     prefix=f"w{i}_"))
    return net


def test_flops_within_two_percent_of_xla_on_a_wide_mlp():
    """Batch 64, widths 512, one fused training step (SPMDTrainer, plain
    SGD): the port's count (the matmuls) against XLA's cost model of the
    JAX package's step program (the matmuls and the elementwise work of
    the activations, the loss and the update)."""
    from mxnet_tpu.parallel.spmd import SPMDTrainer as JTrainer
    from mxnet_tpu_torch.parallel.spmd import SPMDTrainer as TTrainer
    rs = np.random.RandomState(0)
    x = rs.randn(1, 64, 512).astype(np.float32)
    y = rs.randn(1, 64, 512).astype(np.float32)
    out = {}
    for pkg, trainer in (("jax", JTrainer), ("port", TTrainer)):
        m = C.PKGS[pkg][0]
        ctx = mt.cpu() if pkg == "port" else C.contextlib.nullcontext()
        with ctx:
            net = _wide_mlp(m)
            net.initialize(m.init.Xavier())
            tr = trainer(net, m.gluon.loss.L2Loss(), optimizer="sgd",
                         optimizer_params={"learning_rate": 0.01})
            tr.run_steps(x, y)
            out[pkg] = tr.program_stats()["flops"]
    assert out["port"] == _mlp_flops((512,) * 4, 64)
    assert abs(out["port"] - out["jax"]) <= 0.02 * out["jax"], out


def _bn_case(r, c, has_res, dtype=torch.float32):
    """Each BatchNorm kernel's wrapper and its arguments at (r, c)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(r, c, generator=g).to(dtype)
    res = torch.randn(r, c, generator=g).to(dtype) if has_res else None
    dy = torch.randn(r, c, generator=g).to(dtype)
    coef2 = torch.stack([torch.rand(c, generator=g),
                         torch.rand(c, generator=g) + 0.5])
    coef5 = torch.rand(5, c, generator=g)
    out = torch.relu(x)
    return {"bn_stats": (tk.bn_stats, (x,)),
            "bn_apply": (tk.bn_apply, (x, res, coef2)),
            "bn_bwd_stats": (tk.bn_bwd_stats, (dy, out, x, coef2)),
            "bn_bwd_apply": (tk.bn_bwd_apply, (dy, out, x, coef5,
                                               has_res))}


def _moved(*trees):
    """Bytes of every distinct tensor in ``trees``: each read or written
    once."""
    return sum(t.numel() * t.element_size() for t in teff._tensors(trees))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("has_res", [False, True])
def test_bn_kernels_report_their_plain_versions_cost(has_res, dtype):
    """FLOPs exactly (the plane's convention: elementwise work is 0).
    Bytes: the reported count is the bytes of the call's own input and
    output tensors (each read or written once, as a kernel moves them),
    and the plain version's count, an unfused sum over its aten ops,
    bounds it from above."""
    r, c = 96, 24
    isz = torch.empty((), dtype=dtype).element_size()
    for name, (fn, args) in _bn_case(r, c, has_res, dtype).items():
        with teff.counting() as cnt:
            out = fn(*args)
        flops, nbytes = kernel_cost.bn_report(name, r, c, isz, has_res)
        assert flops == cnt.flops == 0.0, name
        assert nbytes == _moved(args, out), name
        assert cnt.bytes_accessed >= nbytes, name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_reports_its_plain_versions_cost(causal, dtype):
    b, t, h, d = 2, 16, 2, 8
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn(b, t, h, d, generator=g).to(dtype)
               for _ in range(3))
    with teff.counting() as cnt:
        o = fa.flash_fwd(q, k, v, causal, 0.3)
    flops, nbytes = kernel_cost.flash_report(b, t, h, d, q.element_size())
    assert flops == cnt.flops == 4 * b * h * t * t * d
    assert nbytes == _moved((q, k, v), o)
    assert cnt.bytes_accessed >= nbytes


@pytest.mark.parametrize("has_res", [False, True])
def test_wrappers_report_a_launch_to_the_open_scope(monkeypatch, has_res):
    """The wrappers' report path as a launch on the card takes it (the
    kernel returned 0, no graph capture): inside a counting scope each
    launch adds its formula's cost under its name and counts as a launch;
    outside one it reports nothing."""
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    monkeypatch.setattr(tk, "launches", dict.fromkeys(tk.launches, 0))
    monkeypatch.setattr(fa, "launches", dict.fromkeys(fa.launches, 0))
    r, c = 96, 24
    x = torch.zeros(r, c, dtype=torch.bfloat16)
    q = torch.zeros(2, 16, 2, 8, dtype=torch.bfloat16)
    names = ("bn_stats", "bn_apply", "bn_bwd_stats", "bn_bwd_apply")
    tk._ok("bn_stats", 0, x, has_res)
    with teff.counting() as cnt:
        for name in names:
            tk._ok(name, 0, x, has_res)
        fa._ok("tc", 0, q)
    want = {name: kernel_cost.bn_report(name, r, c, 2, has_res)
            for name in names}
    want["flash_fwd_tc"] = kernel_cost.flash_report(2, 16, 2, 8, 2)
    assert cnt.stats()["kernels"] == {
        k: {"launches": 1, "flops": f, "bytes": n}
        for k, (f, n) in want.items()}
    assert cnt.kernels == 5 and cnt.bytes_accessed == sum(
        n for _f, n in want.values())
    assert tk.launches["bn_stats"] == 2 and fa.launches["flash_fwd_tc"] == 1
    with pytest.raises(MXNetError, match="launch failed"):
        tk._ok("bn_apply", 1, x)


def test_report_kernel_reaches_every_open_scope():
    teff.report_kernel(7, 9)       # no scope: nothing, one flag check
    with teff.counting() as outer:
        with teff.counting() as inner:
            teff.report_kernel(10, 100, "bn_stats")
        teff.report_kernel(1, 1)
    assert (inner.flops, inner.bytes_accessed, inner.kernels) == \
        (10, 100, 1)
    assert (outer.flops, outer.bytes_accessed, outer.kernels) == \
        (11, 101, 2)
    assert inner.stats()["kernels"] == {
        "bn_stats": {"launches": 1, "flops": 10.0, "bytes": 100.0}}
    assert sorted(outer.stats()["kernels"]) == ["bn_stats", "kernel"]
    assert teff.OPEN[0] == 0


@pytest.mark.parametrize("raw", [
    "flops=1e12", "flops=x,bw=1", "flops=-1,bw=1", "peak=3", "bw=0,flops=1",
    "flops"])
def test_device_peak_errors_match_jax(monkeypatch, raw):
    monkeypatch.setenv("MXTPU_DEVICE_PEAK", raw)
    msgs = []
    for mod, err in ((jeff, mx.base.MXNetError), (teff, MXNetError)):
        with pytest.raises(err) as e:
            mod.device_peak()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_peaks_and_estimate(monkeypatch):
    p = teff.device_peak()
    assert p["estimate"] is True and p["source"] == "default:cpu"
    assert p == jeff.device_peak()
    monkeypatch.setenv("MXTPU_DEVICE_PEAK", "flops=2e12,bw=1e11")
    assert teff.device_peak() == {"flops": 2e12, "bw": 1e11,
                                  "source": "env", "estimate": False}
    monkeypatch.setenv("MXTPU_EFFICIENCY", "onn")
    with pytest.raises(MXNetError, match="unknown token"):
        teff.reset_run()


def test_warm_steps_run_no_counting_scope(monkeypatch):
    """Programs are counted the first time they run; later steps open no
    counting scope, so their launches are the plane-off launches."""
    from mxnet_tpu_torch.optimizer import grouped
    monkeypatch.setattr(tmem, "_PROGRAMS", {})     # nothing counted yet
    monkeypatch.setattr(grouped, "_COUNTED", set())
    opened = []
    real = teff.CostCounter.__enter__

    def enter(self):
        opened.append(1)
        return real(self)
    monkeypatch.setattr(teff.CostCounter, "__enter__", enter)
    C.fit("port", "mlp", epochs=1, hybridize=True)
    first = len(opened)
    assert first > 0
    opened.clear()
    C.fit("port", "mlp", epochs=1, hybridize=True)
    assert opened == []


@pytest.mark.parametrize("plane", ["on", "off"])
def test_warm_steps_build_no_signature(monkeypatch, plane):
    """A bucket's and the finiteness flag's signature (every tensor's
    shape and dtype) is built on the first step only: warm steps find the
    program's label by the tensors' identity, with the plane on or
    off."""
    from mxnet_tpu_torch.optimizer import grouped
    monkeypatch.setenv("MXTPU_EFFICIENCY", plane)
    built = []
    real = grouped._digest
    monkeypatch.setattr(grouped, "_digest",
                        lambda sig: built.append(sig) or real(sig))
    per_run = []
    for epochs in (1, 2):
        built.clear()
        C.fit("port", "mlp", epochs=epochs, hybridize=True)
        per_run.append(len(built))
    assert per_run[0] == per_run[1] > 0


def _dense_stack(widths, prefix="stack_"):
    nn = mt.gluon.nn
    net = nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        for i, w in enumerate(widths):
            net.add(nn.Dense(w, activation="relu" if i + 1 < len(widths)
                             else None, prefix=f"d{i}_"))
    return net


STACKS = ((16, 16, 4), (32, 4), (16, 16, 4))


def test_two_architectures_never_share_a_program():
    """Two HybridSequential nets of one prefix on the same input shape
    are two programs with their own FLOPs; a third instance of the first
    architecture is the first's program again."""
    x, y = C.data("mlp")
    effs, labels = [], []
    with mt.cpu():
        for widths in STACKS:
            net = _dense_stack(widths)
            net.initialize(mt.init.Xavier())
            net.hybridize()
            tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                                  {"learning_rate": 0.05}, kvstore=None)
            loop = mt.fit.FitLoop(
                net, tr, mt.gluon.loss.SoftmaxCrossEntropyLoss(),
                mt.io.NDArrayIter(x, y, batch_size=C.BATCH),
                heartbeat=False)
            eff = loop.fit(epochs=1).efficiency
            effs.append(eff["flops_per_step"])
            labels.append({p["label"] for p in eff["per_program"]
                           if p["kind"] == "cached_op"})
    assert effs == [_mlp_flops((6, *w), C.BATCH) for w in STACKS]
    assert labels[0] == labels[2] and not labels[0] & labels[1]


def test_spmd_program_stats_stay_the_trainers_own():
    """Two SPMDTrainers over different nets on the same data shapes: each
    reads its own program's cost, the registry holds two K-step programs
    and no record of a first step (it is part of its program)."""
    from mxnet_tpu_torch.parallel.spmd import SPMDTrainer
    x, y = C.data("mlp")
    trainers = []
    with mt.cpu():
        for widths in STACKS[:2]:
            net = _dense_stack(widths)
            net.initialize(mt.init.Xavier())
            trn = SPMDTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(),
                              optimizer="sgd",
                              optimizer_params={"learning_rate": 0.1})
            trn.run_steps(x[:24].reshape(3, 8, 6), y[:24].reshape(3, 8))
            trainers.append(trn)
    for trn, widths in zip(trainers, STACKS):
        one = _mlp_flops((6, *widths), 8)
        assert trn.program_stats(step=True)["flops"] == one
        assert trn.program_stats()["flops"] == 3 * one
        label = trn._programs[trn._last_program][0]
        assert tmem.get_program("spmd", label)["flops"] == 3 * one
    assert len({t._programs[t._last_program][0] for t in trainers}) == 2
    assert not [r for r in tmem.program_report()
                if r["kind"] == "spmd" and r["label"].endswith(":step")]


def test_nested_programs_are_counted_once(monkeypatch):
    """Under the megastep the buckets, the finiteness flag and the
    hybridized block run inside the megastep's program: the registry
    holds that program alone, so the program totals count each op
    once."""
    from mxnet_tpu_torch.optimizer import grouped
    monkeypatch.setattr(tmem, "_PROGRAMS", {})
    monkeypatch.setattr(grouped, "_COUNTED", set())
    monkeypatch.setenv("MXTPU_MEGASTEP", "on")
    C.fit("port", "conv", epochs=1, hybridize=True)
    rows = tmem.program_report()
    assert [r["kind"] for r in rows] == ["megastep"]
    for field in ("flops", "bytes_accessed"):
        assert tmem.program_total(field) == int(rows[0][field]) > 0


def test_program_registry_and_spmd_program_stats():
    from mxnet_tpu_torch.parallel.spmd import SPMDTrainer
    from mxnet_tpu_torch.optimizer import grouped
    C.fit("port", "conv", epochs=1, hybridize=True)
    mem = grouped.program_memory()
    assert mem and all("temp_bytes" in v and "flops" in v
                       for v in mem.values())
    rows = tmem.program_report()
    assert {"cached_op", "optimizer"} <= {r["kind"] for r in rows}
    assert tmem.program_total("argument_bytes") > 0
    assert teff.cost_report(3)[0]["flops"] > 0
    with mt.cpu():
        net = C.net("port", "mlp")
        trn = SPMDTrainer(net, mt.gluon.loss.SoftmaxCrossEntropyLoss(),
                          optimizer="sgd",
                          optimizer_params={"learning_rate": 0.1})
        with pytest.raises(MXNetError, match="run_steps"):
            trn.program_stats()
        x, y = C.data("mlp")
        trn.run_steps(x[:24].reshape(3, 8, 6), y[:24].reshape(3, 8))
    ps, one = trn.program_stats(), trn.program_stats(step=True)
    assert sorted(ps) == ["argument_bytes", "bytes_accessed", "flops",
                          "temp_bytes"]
    assert ps["flops"] == 3 * one["flops"] == \
        3 * _mlp_flops((6, 16, 16, 4), 8)
    stats = teff.compiled_program_stats(None)
    assert stats is None
    with teff.counting() as c:
        torch.ones(4, 4) @ torch.ones(4, 4)
    st = teff.compiled_program_stats(c)
    assert sorted(st) == sorted(teff.COST_FIELDS + teff.MEMORY_FIELDS
                               + ("held_bytes",))
    assert tmem.compiled_memory_stats(c)["generated_code_bytes"] == 0
