"""``gluon.Trainer`` of the port against the JAX package's, on the CPU.

The same numpy weights and gradients go into both packages' Trainers
(``kvstore=None``), parameters named alike so both order them the same:

- the six optimizer configurations of
  ``tests/test_optimizer_aggregation.py`` (``OPTS``): in the port,
  aggregation 4 equals aggregation 0 bit for bit (weights and state),
  in 2 update calls against 6; the port equals the JAX package after 3
  steps, weights and state, at 1e-5 relative, 1e-6 absolute (that file's
  tolerance);
- multi-precision SGD on bf16 weights: aggregation on and off bit for
  bit, and the JAX package's masters at 1e-6, its bf16 weights bit for
  bit;
- the finiteness sentinel: a poisoned middle step is a no-op in both
  flows and in both packages (Adam's counter included), a skipped first
  step leaves no state, a stale NaN gradient still skips the step;
- a stale gradient raises before anything is updated;
- ``save_states`` / ``load_states`` resume exactly;
- ``learning_rate`` follows a scheduler as the JAX Trainer's does;
- what is not ported raises ``NotPortedError``;
- ``megastep_plan`` (the megastep's host half) returns the JAX
  package's layout, f32 and multi-precision bf16;
- a thin ResNet-18 v1 NHWC (the fused BN+ReLU blocks) trained 3 steps
  with ``autograd.record()`` / ``backward()`` / ``Trainer.step`` in both
  packages: losses at 1e-4 relative (``tests/test_torch_gluon.py``),
  every weight, momentum and running statistic within 1e-3 of its
  tensor's largest value (``tests/test_torch_spmd.py``'s f32 state).
"""

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd, gluon, nd
from mxnet_tpu.gluon import loss as jloss
from mxnet_tpu.gluon.model_zoo.vision import resnet as jres
from mxnet_tpu.optimizer import grouped as jgrouped

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.gluon import loss as tloss
from mxnet_tpu_torch.gluon.model_zoo.vision import resnet as tres
from mxnet_tpu_torch.ops.registry import NotPortedError
from mxnet_tpu_torch.optimizer import grouped as tgrouped

CPU = mt.cpu()
OPTS = [
    ("sgd", {"learning_rate": 0.1, "wd": 0.01}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.01}),
    ("nag", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01, "wd": 0.001}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
]
TOL = dict(rtol=1e-5, atol=1e-6)


def _values(seed, n, shapes, steps, poison=None):
    """Initial weights and per-step gradients, from one numpy seed."""
    rs = np.random.RandomState(seed)
    shapes = shapes or [(3, j + 2) for j in range(n)]
    ws = [rs.randn(*s).astype(np.float32) for s in shapes]
    gs = []
    for step in range(steps):
        g = [rs.randn(*s).astype(np.float32) for s in shapes]
        if poison is not None and poison[0] == step:
            g[poison[1]][0, 0] = np.nan
        gs.append(g)
    return ws, gs


class _Port:
    """Bare parameters of the port: one holder block, a parameter each."""

    def __init__(self, ws, dtype):
        dt = getattr(torch, dtype)
        self.block = mt.gluon.HybridBlock(prefix="", device="cpu")
        self.params = []
        for j, w in enumerate(ws):
            p = self.block._new_param(f"p{j}", w.shape, dtype=dt)
            p.set_data(w)
            self.params.append(p)

    def set_grads(self, gs):
        for p, g in zip(self.params, gs):
            p.grad()._data.copy_(torch.from_numpy(g))
            p._fresh_grad = True

    def weights(self):
        return [p.tensor.detach().clone() for p in self.params]


class _Jax:
    def __init__(self, ws, dtype):
        self.params = []
        for j, w in enumerate(ws):
            p = gluon.Parameter(f"p{j}", shape=w.shape, dtype=dtype)
            p.initialize(mx.init.Constant(0.0))
            p.set_data(nd.array(w))
            self.params.append(p)

    def set_grads(self, gs):
        for p, g in zip(self.params, gs):
            garr = nd.array(g)
            if str(p.data().dtype) != "float32":
                garr = garr.astype(p.data().dtype)
            p._grad._rebind(garr._data)
            p._fresh_grad = True

    def weights(self):
        return [p.data().astype("float32").asnumpy() for p in self.params]


def _states(tr):
    """Every state tensor of a trainer, by index, as float32 numpy."""
    flat = tgrouped._flatten_inner if isinstance(tr, mt.gluon.Trainer) \
        else jgrouped._flatten_inner
    out = {}
    for i, s in sorted(tr._updaters[0].states.items()):
        parts = []
        for x in flat(s):
            parts += flat(x) if isinstance(x, (tuple, list)) else [x]
        out[i] = [np.asarray(x.astype("float32").asnumpy()) for x in parts]
    return out


def _run(pkg, opt, kw, agg, monkeypatch, steps=3, dtype="float32", n=6,
         seed=0, shapes=None):
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", str(agg))
    ws, gs = _values(seed, n, shapes, steps)
    ps = (_Port if pkg == "port" else _Jax)(ws, dtype)
    tr = (mt.gluon.Trainer if pkg == "port" else gluon.Trainer)(
        ps.params, opt, dict(kw), kvstore=None)
    for step in range(steps):
        ps.set_grads(gs[step])
        tr.step(4)
    return ps, tr


@pytest.mark.parametrize("opt,kw", OPTS,
                         ids=[f"{o}-{'-'.join(k)}" for o, k in OPTS])
def test_aggregated_equals_per_param_and_jax(opt, kw, monkeypatch):
    ref, tr_ref = _run("port", opt, kw, 0, monkeypatch)
    got, tr_got = _run("port", opt, kw, 4, monkeypatch)
    jax_ps, tr_jax = _run("jax", opt, kw, 4, monkeypatch)
    assert tr_ref.last_update_dispatches == 6
    assert tr_got.last_update_dispatches == 2       # ceil(6 / 4) buckets
    for a, b in zip(ref.weights(), got.weights()):
        assert torch.equal(a, b)
    s_ref, s_got, s_jax = _states(tr_ref), _states(tr_got), _states(tr_jax)
    assert sorted(s_ref) == sorted(s_got) == sorted(s_jax)
    for i in s_ref:
        assert len(s_ref[i]) == len(s_got[i]) == len(s_jax[i])
        for a, b, c in zip(s_ref[i], s_got[i], s_jax[i]):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(b, c, **TOL)
    for a, b in zip(got.weights(), jax_ps.weights()):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    assert tr_got._optimizer.num_update == tr_jax._optimizer.num_update


def test_multi_precision_parity_bit_for_bit(monkeypatch):
    kw = {"learning_rate": 0.05, "momentum": 0.9, "multi_precision": True}
    ref, tr_ref = _run("port", "sgd", kw, 0, monkeypatch, dtype="bfloat16")
    got, tr_got = _run("port", "sgd", kw, 3, monkeypatch, dtype="bfloat16")
    jps, tr_jax = _run("jax", "sgd", kw, 3, monkeypatch, dtype="bfloat16")
    assert tr_got.last_update_dispatches == 2
    for i in range(6):
        w32_ref = tr_ref._updaters[0].states[i][1].tensor
        w32_got = tr_got._updaters[0].states[i][1].tensor
        assert w32_got.dtype == torch.float32
        assert torch.equal(w32_ref, w32_got)
        np.testing.assert_allclose(
            w32_got.numpy(), tr_jax._updaters[0].states[i][1].asnumpy(),
            rtol=1e-6)
    for a, b, c in zip(ref.weights(), got.weights(), jps.weights()):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        np.testing.assert_array_equal(b.float().numpy(), c)


def _sentinel_run(pkg, agg, monkeypatch, opt="adam", n=5, seed=3):
    """Three steps, the middle one with a NaN gradient: the fused flow
    (update_with_sentinel, rollback on a False flag) or, when it declines,
    the classic host check then update."""
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", str(agg))
    ws, gs = _values(seed, n, None, 3, poison=(1, 2))
    ps = (_Port if pkg == "port" else _Jax)(ws, "float32")
    tr = (mt.gluon.Trainer if pkg == "port" else gluon.Trainer)(
        ps.params, opt, {"learning_rate": 0.01}, kvstore=None)
    fused = []
    for step in range(3):
        ps.set_grads(gs[step])
        flag = tr.update_with_sentinel(4)
        fused.append(flag is not None)
        if flag is not None:
            if not bool(flag if pkg == "port" else np.asarray(flag)):
                tr.rollback_step()
                for p in ps.params:
                    p.zero_grad()
        elif all(np.isfinite(p.grad().asnumpy()).all() for p in ps.params):
            tr.update(4)
        else:
            for p in ps.params:
                p.zero_grad()
    return ps, tr, fused


def test_loss_scale_skip_step_parity(monkeypatch):
    ref, tr_ref, f_ref = _sentinel_run("port", 0, monkeypatch)
    got, tr_got, f_got = _sentinel_run("port", 4, monkeypatch)
    jps, tr_jax, _ = _sentinel_run("jax", 4, monkeypatch)
    assert f_ref == [False] * 3 and f_got == [True] * 3
    assert tr_got.last_update_dispatches == 2 + 1    # buckets + the flag
    assert tr_ref._optimizer.num_update == tr_got._optimizer.num_update \
        == tr_jax._optimizer.num_update == 2
    for a, b, c in zip(ref.weights(), got.weights(), jps.weights()):
        assert torch.equal(a, b)
        np.testing.assert_allclose(b.numpy(), c, rtol=1e-5, atol=1e-7)


def test_skipped_fused_step_creates_no_state(monkeypatch):
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    ws, gs = _values(0, 3, None, 1, poison=(0, 0))
    ps = _Port(ws, "float32")
    tr = mt.gluon.Trainer(ps.params, "sgd", {"learning_rate": 0.1,
                                             "momentum": 0.9}, kvstore=None)
    before = ps.weights()
    ps.set_grads(gs[0])
    flag = tr.update_with_sentinel(2)
    assert flag is not None and flag.dtype == torch.bool and not bool(flag)
    tr.rollback_step()
    assert not tr._updaters[0].states
    assert tr._optimizer.num_update == 0
    for a, b in zip(before, ps.weights()):
        assert torch.equal(a, b)


def test_stale_nan_gradient_still_skips_the_step(monkeypatch):
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    ws, gs = _values(0, 3, None, 1)
    ps = _Port(ws, "float32")
    tr = mt.gluon.Trainer(ps.params, "sgd", {"learning_rate": 0.1},
                          kvstore=None)
    ps.set_grads(gs[0])
    ps.params[2].grad()._data.fill_(float("nan"))
    ps.params[2]._fresh_grad = False
    before = ps.weights()
    flag = tr.update_with_sentinel(2, ignore_stale_grad=True)
    assert flag is not None and not bool(flag)
    tr.rollback_step()
    for a, b in zip(before, ps.weights()):
        assert torch.equal(a, b)
    # a stale gradient without ignore_stale_grad: the sentinel declines
    ps.set_grads(gs[0])
    ps.params[1]._fresh_grad = False
    assert tr.update_with_sentinel(2) is None
    assert ps.params[0]._fresh_grad


def test_stale_gradient_raises_before_any_update(monkeypatch):
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    ws, gs = _values(1, 3, None, 1)
    ps = _Port(ws, "float32")
    tr = mt.gluon.Trainer(ps.params, "adam", {"learning_rate": 0.1},
                          kvstore=None)
    ps.set_grads(gs[0])
    ps.params[1]._fresh_grad = False
    before = ps.weights()
    with pytest.raises(mt.MXNetError, match="stale") as e:
        tr.step(2)
    assert "p1" in str(e.value) and "No update was applied" in str(e.value)
    for a, b in zip(before, ps.weights()):
        assert torch.equal(a, b)
    assert not tr._updaters[0].states and tr._optimizer.num_update == 0
    tr.step(2, ignore_stale_grad=True)        # the fresh ones move
    after = ps.weights()
    assert torch.equal(after[1], before[1])
    assert not torch.equal(after[0], before[0])
    assert not any(p._fresh_grad for p in ps.params)
    with pytest.raises(mt.MXNetError, match="stale"):
        tr.step(2)                            # step twice per backward


def test_backward_marks_gradients_fresh_and_step_consumes_them():
    net = mt.gluon.nn.Dense(3, in_units=4, device="cpu")
    net.initialize()
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1})
    params = list(net.collect_params().values())
    weight = net.weight
    assert not any(p._fresh_grad for p in params)
    x = mt.nd.array(np.ones((2, 4), np.float32), ctx=CPU)
    with mt.autograd.record():
        y = net(x)
    y.backward()
    assert all(p._fresh_grad for p in params)
    tr.step(2)
    assert not any(p._fresh_grad for p in params)
    assert net.weight is weight              # written in place
    params[0].zero_grad()
    assert not params[0]._fresh_grad


def test_save_and_load_states_resume_exactly(tmp_path, monkeypatch):
    kw = {"learning_rate": 0.01, "wd": 0.001}

    def run(stop):
        monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
        ws, gs = _values(5, 6, None, 4)
        ps = _Port(ws, "float32")
        tr = mt.gluon.Trainer(ps.params, "adam", dict(kw), kvstore=None)
        for step in range(4):
            if step == stop:
                fname = str(tmp_path / "adam.states")
                tr.save_states(fname)
                tr = mt.gluon.Trainer(ps.params, "adam", dict(kw),
                                      kvstore=None)
                tr.load_states(fname)
                assert tr._optimizer.num_update == stop
            ps.set_grads(gs[step])
            tr.step(4)
        return ps, tr

    (ref, tr_ref), (got, tr_got) = run(None), run(2)
    for a, b in zip(ref.weights(), got.weights()):
        assert torch.equal(a, b)
    s_ref, s_got = _states(tr_ref), _states(tr_got)
    for i in s_ref:
        for a, b in zip(s_ref[i], s_got[i]):
            np.testing.assert_array_equal(a, b)
    assert tr_got._optimizer._index_update_count == \
        tr_ref._optimizer._index_update_count


def test_learning_rate_follows_a_scheduler_as_in_jax(monkeypatch):
    lrs = {}
    for pkg in ("port", "jax"):
        m = mt if pkg == "port" else mx
        sched = m.lr_scheduler.FactorScheduler(step=2, factor=0.5,
                                               warmup_steps=1,
                                               warmup_begin_lr=0.01)
        ws, gs = _values(2, 2, None, 5)
        ps = (_Port if pkg == "port" else _Jax)(ws, "float32")
        tr = (mt.gluon.Trainer if pkg == "port" else gluon.Trainer)(
            ps.params, "sgd", {"learning_rate": 0.2, "lr_scheduler": sched},
            kvstore=None)
        seen = [tr.learning_rate]
        for step in range(5):
            ps.set_grads(gs[step])
            tr.step(1)
            seen.append(tr.learning_rate)
        lrs[pkg] = (seen, ps.weights())
        with pytest.raises(Exception, match="lr_scheduler"):
            tr.set_learning_rate(0.1)
    assert lrs["port"][0] == lrs["jax"][0]
    assert len(set(lrs["port"][0])) > 2
    for a, b in zip(*(lrs[k][1] for k in ("port", "jax"))):
        np.testing.assert_allclose(a.numpy(), b, **TOL)
    ws, _ = _values(2, 2, None, 1)
    tr = mt.gluon.Trainer(_Port(ws, "float32").params, "sgd",
                          {"learning_rate": 0.2})
    tr.set_learning_rate(0.05)
    assert tr.learning_rate == 0.05


def test_dispatch_counts(monkeypatch):
    def one(agg, sentinel=False):
        monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", str(agg))
        ws, gs = _values(0, 50, [(4, 4)] * 50, 1)
        ps = _Port(ws, "float32")
        tr = mt.gluon.Trainer(ps.params, "sgd", {"learning_rate": 0.1,
                                                 "momentum": 0.9},
                              kvstore=None)
        ps.set_grads(gs[0])
        if sentinel:
            assert tr.update_with_sentinel(8) is not None
        else:
            tr.step(8)
        return tr.last_update_dispatches

    assert one(0) == 50
    assert one(4) == 13
    assert one(64) == 1
    assert one(1) == 50
    assert one(4, sentinel=True) == 14       # + the finiteness flag


def test_bucket_kernels_are_reused_across_lr_and_batch_changes(monkeypatch):
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "8")
    tgrouped.clear_cache()
    ws, gs = _values(0, 6, None, 5)
    ps = _Port(ws, "float32")
    tr = mt.gluon.Trainer(ps.params, "sgd", {"learning_rate": 0.1,
                                             "momentum": 0.9}, kvstore=None)
    ps.set_grads(gs[0])
    tr.step(4)
    misses = tgrouped.cache_info().misses
    assert misses >= 1
    for step in range(4):
        tr.set_learning_rate(0.1 / (step + 2))
        ps.set_grads(gs[step + 1])
        tr.step(4 + step)
    info = tgrouped.cache_info()
    assert info.misses == misses and info.hits >= 4


def test_ungrouped_optimizer_declines_the_sentinel(monkeypatch):
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    ws, gs = _values(0, 2, None, 1)
    ps = _Port(ws, "float32")
    tr = mt.gluon.Trainer(ps.params, "ftrl", {"learning_rate": 0.1},
                          kvstore=None)
    ps.set_grads(gs[0])
    before = ps.weights()
    assert tr.update_with_sentinel(2) is None
    for a, b in zip(before, ps.weights()):
        assert torch.equal(a, b)
    assert all(p._fresh_grad for p in ps.params)
    tr.step(2)                                 # the per-parameter loop
    assert tr.last_update_dispatches == 2


def test_not_ported_halves_raise(monkeypatch):
    """A10's Trainer halves are ported (the name is kept from when they
    raised): compression_params turns on the store's 2-bit compression,
    MXTPU_ZERO=on builds the plane at the first step (no store: the JAX
    package's refusal), MXTPU_COMM_OVERLAP=on opens an active scope, and
    a dist store by name is one worker outside a group (dropped)."""
    ws, gs = _values(0, 2, None, 1)
    params = _Port(ws, "float32").params
    kv = mt.kv.create("local")
    tr = mt.gluon.Trainer(params, "sgd", compression_params={
        "type": "2bit", "threshold": 0.25}, kvstore=kv)
    tr._init_kvstore()
    assert kv._compressor.threshold == 0.25
    monkeypatch.setenv("MXTPU_ZERO", "on")
    jp = _Jax(ws, "float32")
    for ps, pkg in ((_Port(ws, "float32"), mt), (jp, mx)):
        t = pkg.gluon.Trainer(ps.params, "sgd", kvstore=None)
        ps.set_grads(gs[0])
        with pytest.raises(pkg.base.MXNetError, match="requires a kvstore"):
            t.step(1)
    monkeypatch.delenv("MXTPU_ZERO")
    # the numerics plane is ported: the Trainer takes the flag, as the
    # JAX package's does, and strict-parses it
    monkeypatch.setenv("MXTPU_NUMERICS", "on")
    assert mt.gluon.Trainer(params, "sgd").last_numerics_stats is None
    monkeypatch.setenv("MXTPU_NUMERICS", "on,stats=nope")
    with pytest.raises(mt.MXNetError, match="unknown stat"):
        mt.gluon.Trainer(params, "sgd")
    monkeypatch.delenv("MXTPU_NUMERICS")
    monkeypatch.setenv("MXTPU_ZERO", "onn")
    with pytest.raises(mt.MXNetError, match="unknown value"):
        mt.gluon.Trainer(params, "sgd")
    monkeypatch.delenv("MXTPU_ZERO")
    tr = mt.gluon.Trainer(params, "sgd")
    with tr.overlap_scope():                   # off: a no-op scope
        pass
    with tr.overlap_scope(chaos_step=3):       # chaos clock: a no-op too
        pass
    monkeypatch.setenv("MXTPU_COMM_OVERLAP", "on")
    with mt.gluon.Trainer(params, "sgd", kvstore=None).overlap_scope() \
            as scope:                          # no store: inactive
        assert not scope.active
    with tr.overlap_scope() as scope:          # "device": active, as in
        assert scope.active                    # the JAX package; its
    tr.allreduce_grads()                       # finalize finds no store
    kvt = mt.gluon.Trainer(params, "sgd", kvstore=mt.kv.create("local"))
    with kvt.overlap_scope() as scope:
        assert scope.active
    monkeypatch.setenv("MXTPU_COMM_OVERLAP", "sometimes")
    with pytest.raises(mt.MXNetError, match="unknown value"):
        tr.overlap_scope()
    monkeypatch.delenv("MXTPU_COMM_OVERLAP")
    ps = _Port(ws, "float32")
    dt = mt.gluon.Trainer(ps.params, "sgd", kvstore="dist_sync")
    ps.set_grads(gs[0])
    dt.step(1)
    assert dt._kvstore is None
    # the bucket programs' attribution: every signature that ran, counted
    # on its first execution, with the JAX package's memory fields
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    ps = _Port(ws, "float32")
    tr = mt.gluon.Trainer(ps.params, "sgd", {"learning_rate": 0.1},
                          kvstore=None)
    ps.set_grads(gs[0])
    tr.step(2)
    mem = tgrouped.program_memory()
    assert mem and sum(v["params"] for v in mem.values()) >= 2
    assert all({"argument_bytes", "output_bytes", "temp_bytes",
                "alias_bytes", "generated_code_bytes", "flops",
                "bytes_accessed", "signature", "params"} <= set(v)
               for v in mem.values())
    # sparse_rows_update is ported (tests/test_torch_embedding_plane.py):
    # an optimizer without a rule is refused, as in the JAX package
    with pytest.raises(mt.MXNetError, match="no grouped-update rule"):
        tgrouped.sparse_rows_update(None, None, (), None, None, None, 0, 0)


def _megastep_plan(pkg, opt, kw, monkeypatch, dtype):
    """Two megastep plans (step 1, then step 2 after a rollback of one)
    of ``pkg``'s Trainer over the same six bare parameters, one frozen,
    in the comparable layout: per chunk the indices, mp flags and state
    handles' shapes, then the lr and wd lists."""
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "4")
    ws, _ = _values(0, 6, None, 1)
    ps = (_Port if pkg == "port" else _Jax)(ws, dtype)
    ps.params[2].grad_req = "null"
    kw = dict(kw, multi_precision=dtype == "bfloat16")
    tr = (mt.gluon.Trainer if pkg == "port" else gluon.Trainer)(
        ps.params, opt, kw, kvstore=None)
    plans = []
    for _ in range(2):
        live, rank_chunks, lrs, wds = tr.megastep_plan(4)
        plans.append((
            [i for i, _p in live],
            [[[(e[0], e[3], [tuple(h.shape) for h in e[2]]) for e in chunk]
              for chunk in chunks] for chunks in rank_chunks],
            lrs, wds, list(tr._last_fused_indices),
            sorted(tr._last_fused_created)))
    tr.rollback_step()
    plans.append(dict(tr._optimizer._index_update_count))
    return plans


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt,kw", OPTS,
                         ids=[f"{o}-{'-'.join(k)}" for o, k in OPTS])
def test_megastep_plan_matches_jax(opt, kw, dtype, monkeypatch):
    """``Trainer.megastep_plan``, the megastep's host half, returns the
    JAX package's layout: live indices, chunks of at most the
    aggregation size with their multi-precision flags and state
    handles, the (Adam: bias-corrected) lr and wd lists in chunk order,
    and the rollback arming (the second plan creates no state and
    ``rollback_step`` takes its counts back)."""
    port = _megastep_plan("port", opt, kw, monkeypatch, dtype)
    jax_ = _megastep_plan("jax", opt, kw, monkeypatch, dtype)
    assert port[0][0] == [0, 1, 3, 4, 5]
    assert port[0][5] == [0, 1, 3, 4, 5] and port[1][5] == []
    for got, want in zip(port[:2], jax_[:2]):
        assert got[0] == want[0] and got[1] == want[1]
        assert got[4] == want[4] and got[5] == want[5]
        np.testing.assert_allclose(got[2], want[2], rtol=1e-12)
        assert got[3] == want[3]
    assert port[2] == jax_[2]


def test_natural_key_orders_parameters_as_in_jax():
    from mxnet_tpu.gluon.trainer import _natural_key as jkey
    from mxnet_tpu_torch.gluon.trainer import _natural_key as tkey
    names = ["dense10_weight", "dense9_weight", "dense9_bias", "conv2_w",
             "conv10_w", "a"]
    assert sorted(names, key=tkey) == sorted(names, key=jkey)
    assert sorted(names, key=tkey)[:2] == ["a", "conv2_w"]


def test_cast_swaps_storage_in_place():
    net = mt.gluon.nn.Dense(3, in_units=4, device="cpu")
    net.initialize()
    w = net.weight
    p = net.collect_params()[net.prefix + "weight"]
    nd_w = p.data()
    net.cast("bfloat16")
    assert net.weight is w and w.dtype == torch.bfloat16
    assert p.data() is nd_w and p.grad().dtype == torch.bfloat16
    x = mt.nd.array(np.ones((2, 4), np.float32), ctx=CPU).astype("bfloat16")
    with mt.autograd.record():
        y = net(x)
    y.backward()
    assert p._fresh_grad and p.grad().asnumpy().any()


# ---------------------------------------------------------------------------
# a thin ResNet-18 v1 NHWC, three imperative Trainer steps
# ---------------------------------------------------------------------------

THIN = ([2, 2, 2, 2], [8, 8, 16, 32, 64])
SIZE, BATCH, STEPS = 48, 4, 3


def _thin_nets():
    mx.random.seed(0)
    jnet = jres.ResNetV1(jres.BasicBlockV1, *THIN, classes=10, layout="NHWC")
    jnet.initialize(mx.init.Xavier())
    with autograd.pause():
        jnet(nd.array(np.zeros((1, SIZE, SIZE, 3), np.float32)))
    tnet = tres.ResNetV1(tres.BasicBlockV1, *THIN, classes=10, layout="NHWC",
                         device="cpu")
    convert.from_mxnet_tpu_params(
        tnet, {k: p.data().asnumpy()
               for k, p in jnet.collect_params().items()},
        prefix=jnet.prefix)
    return jnet, tnet


def test_thin_resnet18_v1_trainer_steps_match_jax():
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    jnet, tnet = _thin_nets()
    opt = {"learning_rate": 0.05, "momentum": 0.9}
    jtr = gluon.Trainer(jnet.collect_params(), "sgd", dict(opt),
                        kvstore="device")
    ttr = mt.gluon.Trainer(tnet.collect_params(), "sgd", dict(opt),
                           kvstore="device")
    jl, tl = jloss.SoftmaxCrossEntropyLoss(), tloss.SoftmaxCrossEntropyLoss()
    rs = np.random.RandomState(1)
    from mxnet_tpu_torch.ops import fused_bn_act as tk
    tk.reset_launches()
    for _ in range(STEPS):
        x = rs.rand(BATCH, SIZE, SIZE, 3).astype(np.float32)
        label = rs.randint(0, 10, (BATCH,)).astype(np.float32)
        with autograd.record():
            jloss_v = jl(jnet(nd.array(x)), nd.array(label))
        jloss_v.backward()
        jtr.step(BATCH)
        with mt.autograd.record():
            tloss_v = tl(tnet(mt.nd.array(x, ctx=CPU)),
                         mt.nd.array(label, ctx=CPU))
        tloss_v.backward()
        ttr.step(BATCH)
        np.testing.assert_allclose(tloss_v.asnumpy(), jloss_v.asnumpy(),
                                   rtol=1e-4, atol=1e-5)
    live = [p for p in tnet.collect_params().values()
            if p.grad_req != "null"]
    assert ttr.last_update_dispatches == -(-len(live) // 4)
    assert not any(tk.launches.values())           # host: plain versions
    strip_j, strip_t = len(jnet.prefix), len(tnet.prefix)
    tparams = tnet.collect_params()
    n = 0
    for k, jp in jnet.collect_params().items():
        tp = tparams[tnet.prefix + k[strip_j:]]
        want, got = jp.data().asnumpy(), tp.data().asnumpy()
        scale = max(float(np.abs(want).max()), 1e-6)
        assert float(np.abs(got - want).max()) <= 1e-3 * scale, k
        n += 1
    assert n == len(tparams)
    jst, tst = jtr._updaters[0].states, ttr._updaters[0].states
    assert sorted(jst) == sorted(tst) and len(tst) > 40
    for i in tst:
        want, got = jst[i].asnumpy(), tst[i].asnumpy()
        scale = max(float(np.abs(want).max()), 1e-6)
        assert float(np.abs(got - want).max()) <= 1e-3 * scale, i
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = prev
