"""The port's megastep (``mxnet_tpu_torch/megastep.py``) on the CPU.

``MXTPU_MEGASTEP=on`` runs one FitLoop step (forward, backward, the
chaos poison site, the finiteness sentinel, the guarded grouped update,
the loss mean) as one replay of a CUDA graph per input signature on the
card; on the CPU the same body runs eagerly over the same static
buffers, with the same host half. The acceptance bar is the JAX
package's (``tests/test_megastep.py``): the megastep equals the composed
path bit for bit. Here, on ``tests/test_megastep.py``'s MLP (Dense 16
ReLU, Dense 4, L2 loss, batch 4, aggregation 8):

- the strict parse and every knob it refuses, each as the JAX package
  refuses it (the port refuses compression and sparse parameters where
  they are built, naming A10 / A11);
- megastep against the port's composed path, bit for bit, for the six
  ``tests/test_zero.py`` OPTS, and against the JAX package's megastep on
  the same numpy data and weights within ``RTOL`` (1e-5, the JAX tests'
  rtol, as in ``test_torch_fit.py``: each loss, and each weight tensor
  in L2 norm, see ``_assert_close_to_jax``);
- ``nan_grad@1,inf_grad@2`` at loss scale 128: steps 1 and 2 skipped,
  the scale backed off to 32, bit for bit against the composed path and
  within RTOL of the JAX megastep;
- the signature cache (one miss, then hits, while Adam's lr moves), a
  stale parameter (raises, rolled back), the breakdown's one ``megastep``
  segment, ``data_ptr()`` of every parameter, gradient and state held
  across steps, optimizer state rebound by ``set_states_bytes`` adopted
  by the next step, and a checkpoint, kill and resume equal to the
  fault-free run;
- the composed grouped update bit for bit before and after
  ``apply_chunk`` learnt to take device-tensor scalars.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import fit as jfit
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import megastep as jmegastep
from mxnet_tpu.base import MXNetError as JMXNetError
from mxnet_tpu.contrib import chaos as jchaos
from mxnet_tpu.io import NDArrayIter as JNDArrayIter

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import megastep as tmegastep
from mxnet_tpu_torch.contrib import chaos as tchaos
from mxnet_tpu_torch.ops.registry import NotPortedError
from mxnet_tpu_torch.optimizer import grouped as tgrouped

from test_zero import OPTS

RTOL = 1e-5
ADAM = ("adam", {"learning_rate": 1e-3})


@pytest.fixture(autouse=True)
def _host(monkeypatch):
    monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "8")
    for flag in ("MXTPU_COMM_OVERLAP", "MXTPU_ZERO", "MXTPU_ZERO_WORLD",
                 "MXTPU_EFFICIENCY", "MXTPU_NUMERICS",
                 "MXTPU_RUN_REPORT_DIR"):
        monkeypatch.delenv(flag, raising=False)
    jchaos.install("")
    tchaos.uninstall()
    with mt.cpu():
        yield
    jchaos.install("")
    tchaos.uninstall()


def _mega(monkeypatch, on):
    monkeypatch.setenv("MXTPU_MEGASTEP", "on" if on else "off")


def _data(steps):
    rs = np.random.RandomState(0)
    return (rs.rand(steps * 4, 16).astype(np.float32),
            rs.rand(steps * 4, 4).astype(np.float32))


_JAX_INIT = {}


def _jax_net():
    """``tests/test_megastep.py``'s _build_net, with explicit prefixes so
    the JAX package's name counter is left alone."""
    mx.random.seed(0)
    net = jgluon.nn.Sequential(prefix="mlp_")
    net.add(jgluon.nn.Dense(16, activation="relu", prefix="d0_"),
            jgluon.nn.Dense(4, prefix="d1_"))
    net.initialize(mx.init.Xavier())
    return net


def _jax_init():
    """The JAX net's initial weights by structural name."""
    if not _JAX_INIT:
        net = _jax_net()
        with mx.autograd.pause():
            net(mx.nd.ones((1, 16)))
        _JAX_INIT.update({k: p.data().asnumpy().copy() for k, p in
                          net._collect_params_with_prefix().items()})
    return _JAX_INIT


def _port_net(jax_weights=False):
    """The same MLP in the port. Deferred (in_units=0) with Xavier from a
    seeded generator, so the megastep's deferred-init priming runs; or,
    with ``jax_weights``, resolved and set to the JAX net's weights."""
    net = mt.gluon.nn.Sequential()
    net.add(mt.gluon.nn.Dense(16, activation="relu"),
            mt.gluon.nn.Dense(4))
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(0, "cpu"))
    if jax_weights:
        with mt.autograd.pause():
            net(mt.nd.ones((1, 16)))
        init = _jax_init()
        for k, p in net._collect_params_with_prefix().items():
            p.set_data(mt.nd.array(init[k]))
    return net


def _states(tr):
    """Every optimizer state tensor, in index and slot order."""
    out = []
    for _i, st in sorted(tr._updaters[0].states.items()):
        flat = st if isinstance(st, (tuple, list)) else [st]
        for s in flat:
            if isinstance(s, (tuple, list)):
                out += [x for x in s if x is not None]
            elif s is not None:
                out.append(s)
    return out


def _fit(monkeypatch, mega, opt=ADAM, steps=4, chaos_spec=None,
         loss_scale=1.0, net=None, on_step_end=None, **kw):
    """One port FitLoop run; the megastep switch is the only delta."""
    _mega(monkeypatch, mega)
    name, okw = opt
    net = net if net is not None else _port_net()
    tr = mt.gluon.Trainer(net.collect_params(), name, dict(okw))
    X, Y = _data(steps)
    loop = mt.fit.FitLoop(net, tr, mt.gluon.loss.L2Loss(),
                          mt.io.NDArrayIter(X, Y, batch_size=4),
                          loss_scale=loss_scale, heartbeat=False,
                          on_step_end=on_step_end, **kw)
    if chaos_spec:
        tchaos.install(chaos_spec)
    try:
        res = loop.fit(epochs=1)
    finally:
        tchaos.uninstall()
    res._net, res._trainer, res._loop = net, tr, loop
    res._weights = {k: p.data().asnumpy().copy() for k, p in
                    net._collect_params_with_prefix().items()}
    res._states = [s.asnumpy().copy() for s in _states(tr)]
    return res


def _jax_fit(monkeypatch, opt=ADAM, steps=4, chaos_spec=None,
             loss_scale=1.0):
    """The JAX package's megastep on the same data and weights."""
    _mega(monkeypatch, True)
    name, okw = opt
    net = _jax_net()
    with mx.autograd.pause():
        net(mx.nd.ones((1, 16)))
    for k, p in net._collect_params_with_prefix().items():
        p.set_data(mx.nd.array(_jax_init()[k]))
    tr = jgluon.Trainer(net.collect_params(), name, dict(okw))
    X, Y = _data(steps)
    loop = jfit.FitLoop(net, tr, jgluon.loss.L2Loss(prefix="l2_"),
                        JNDArrayIter(X, Y, batch_size=4), ckpt_dir=None,
                        loss_scale=loss_scale)
    if chaos_spec:
        jchaos.install(chaos_spec)
    try:
        res = loop.fit(epochs=1)
    finally:
        jchaos.install("")
    res._weights = {k: p.data().asnumpy().copy() for k, p in
                    net._collect_params_with_prefix().items()}
    return res


def _assert_bitwise(a, b):
    assert a.losses == b.losses, np.subtract(a.losses, b.losses)
    assert a.skipped_steps == b.skipped_steps
    assert a.loss_scale == b.loss_scale
    assert sorted(a._weights) == sorted(b._weights)
    for k in a._weights:
        np.testing.assert_array_equal(a._weights[k], b._weights[k],
                                      err_msg=k)
    assert len(a._states) == len(b._states)
    for x, y in zip(a._states, b._states):
        np.testing.assert_array_equal(x, y)


def _assert_close_to_jax(port, jax_):
    """Losses within RTOL each; each weight tensor within RTOL of its L2
    norm. Element by element would not do: RMSProp divides by sqrt(n +
    eps) with eps 1e-8, so on an element whose gradient is near 0 it
    multiplies the packages' rounding differences (matmul order) by up to
    lr / sqrt(eps) = 100, and later steps carry them on (measured: one
    0.bias element of the centered configuration 2.6e-5 off after 4
    steps, with every element of that tensor within 1.5e-8 after 3; the
    composed paths of the two packages differ the same way)."""
    np.testing.assert_allclose(port.losses, jax_.losses, rtol=RTOL)
    assert port.skipped_steps == jax_.skipped_steps
    assert port.loss_scale == jax_.loss_scale
    assert sorted(port._weights) == sorted(jax_._weights)
    for k in jax_._weights:
        err = np.linalg.norm(port._weights[k] - jax_._weights[k])
        assert err <= RTOL * np.linalg.norm(jax_._weights[k]), (k, err)


# -- the knob ------------------------------------------------------------

@pytest.mark.parametrize("raw,want", [
    ("on", True), ("1", True), ("true", True), ("off", False),
    ("0", False), ("false", False), ("", False), (None, False),
    (" ON ", True), ("fused", None), ("onn", None)])
def test_megastep_env_strict_parse(monkeypatch, raw, want):
    """As in the JAX package: a typo'd MXTPU_MEGASTEP raises."""
    if raw is None:
        monkeypatch.delenv("MXTPU_MEGASTEP", raising=False)
    else:
        monkeypatch.setenv("MXTPU_MEGASTEP", raw)
    for requested, err in ((tmegastep.megastep_requested, mt.MXNetError),
                           (jmegastep.megastep_requested, JMXNetError)):
        if want is None:
            with pytest.raises(err, match="MXTPU_MEGASTEP"):
                requested()
        else:
            assert requested() is want


def _refusal(pkg, knob, monkeypatch):
    """Build the net and trainer in ``pkg`` and construct a Megastep with
    ``knob``; returns the exception raised."""
    m, ms = (mx, jmegastep) if pkg == "jax" else (mt, tmegastep)
    net = _jax_net() if pkg == "jax" else _port_net()
    opt = "adagrad" if knob == "no_rule" else "adam"
    tr = m.gluon.Trainer(net.collect_params(), opt, {"learning_rate": 1e-3})
    kw = {"skip_nonfinite": knob != "skip_nonfinite",
          "ignore_stale_grad": knob == "ignore_stale_grad"}
    if knob == "aggregation":
        monkeypatch.setenv("MXTPU_OPTIMIZER_AGGREGATION", "0")
    with pytest.raises(Exception) as info:
        ms.Megastep(net, tr, m.gluon.loss.L2Loss(prefix="l2_"), **kw)
    return info.value


@pytest.mark.parametrize("knob,match", [
    ("skip_nonfinite", "skip_nonfinite"),
    ("ignore_stale_grad", "ignore_stale_grad"),
    ("no_rule", "no grouped-update rule"),
    ("aggregation", "AGGREGATION")])
def test_megastep_incompatible_knobs_raise_as_in_jax(monkeypatch, knob,
                                                     match):
    """Every statically checkable incompatibility raises at construction,
    with the JAX package's message."""
    got = _refusal("port", knob, monkeypatch)
    want = _refusal("jax", knob, monkeypatch)
    assert isinstance(got, mt.MXNetError) and match in str(got)
    assert isinstance(want, JMXNetError) and str(got) == str(want)


def test_megastep_refusals_the_port_raises_earlier(monkeypatch):
    """Compression and sparse parameters cannot be built in the port
    (A10, A11); simulated ZeRO worlds under the megastep raise naming
    A10. The efficiency and numerics planes run under the megastep: one
    dispatch note a step, the stats variant on sampled steps, and the
    trajectory of the plane-off run."""
    _mega(monkeypatch, True)
    net = _port_net()
    with pytest.raises(NotPortedError, match="A10"):
        mt.gluon.Trainer(net.collect_params(), "adam",
                         compression_params={"type": "2bit"})
    with pytest.raises(NotPortedError, match="A11"):
        mt.gluon.nn.Embedding(10, 4, sparse_grad=True)
    tr = mt.gluon.Trainer(net.collect_params(), "adam")
    monkeypatch.setenv("MXTPU_ZERO_WORLD", "4")
    with pytest.raises(NotPortedError, match="A10"):
        tmegastep.Megastep(net, tr, mt.gluon.loss.L2Loss())
    monkeypatch.delenv("MXTPU_ZERO_WORLD")
    off = _fit(monkeypatch, True)
    for flag, value in (("MXTPU_EFFICIENCY", "on"),
                        ("MXTPU_NUMERICS", "on,every=2")):
        monkeypatch.setenv(flag, value)
        res = _fit(monkeypatch, True)
        assert res.losses == off.losses
        if flag == "MXTPU_EFFICIENCY":
            eff = res.efficiency
            assert eff["steps"] == 4 and eff["flops_per_step"] > 0
            assert [p["kind"] for p in eff["per_program"]] == ["megastep"]
            assert eff["per_program"][0]["dispatches"] == 4
        else:
            assert [r["step"] for r in res.numerics["recent"]] == [0, 2]
            assert tmegastep.cache_info(res._net).currsize == 2
        monkeypatch.delenv(flag)
    assert tmegastep.donation_supported() is True


# -- bit for bit against the composed path, and against JAX ---------------

@pytest.mark.parametrize("opt,kw", OPTS)
def test_megastep_bitwise_parity(opt, kw, monkeypatch):
    """megastep == composed, bit for bit: losses, weights, optimizer
    state, for the six grouped optimizer configurations."""
    res_c = _fit(monkeypatch, False, opt=(opt, kw))
    res_m = _fit(monkeypatch, True, opt=(opt, kw))
    _assert_bitwise(res_c, res_m)
    assert res_m._trainer.last_update_dispatches == 1


@pytest.mark.parametrize("opt,kw", OPTS)
def test_megastep_matches_jax_megastep(opt, kw, monkeypatch):
    """The port's megastep against the JAX package's on the same numpy
    data and weights."""
    res_t = _fit(monkeypatch, True, opt=(opt, kw),
                 net=_port_net(jax_weights=True))
    res_j = _jax_fit(monkeypatch, opt=(opt, kw))
    _assert_close_to_jax(res_t, res_j)


def test_megastep_sentinel_skip_and_backoff(monkeypatch):
    """nan_grad@1 then inf_grad@2: both skipped inside the step, the loss
    scale backed off 128 -> 64 -> 32, the whole trajectory bit for bit
    against the composed path and within RTOL of the JAX megastep."""
    spec = "nan_grad@1,inf_grad@2"
    res_c = _fit(monkeypatch, False, chaos_spec=spec, loss_scale=128.0,
                 steps=5)
    res_m = _fit(monkeypatch, True, chaos_spec=spec, loss_scale=128.0,
                 steps=5)
    assert res_c.skipped_steps == res_m.skipped_steps == [1, 2]
    assert res_m.loss_scale == 32.0
    _assert_bitwise(res_c, res_m)
    res_t = _fit(monkeypatch, True, chaos_spec=spec, loss_scale=128.0,
                 steps=5, net=_port_net(jax_weights=True))
    res_j = _jax_fit(monkeypatch, chaos_spec=spec, loss_scale=128.0,
                     steps=5)
    _assert_close_to_jax(res_t, res_j)


# -- the cache, staleness, breakdown, buffers ------------------------------

def test_megastep_cache_one_miss_while_lr_moves(monkeypatch):
    """One capture, then hits: lr / wd / rescale / scale / poison are
    inputs, not keys. Adam's bias-corrected lr differs at every step."""
    steps = 6
    lrs = []

    def grab(step, _loss):
        entry = cache.snapshot_items()[0][1]
        lrs.append(float(entry.scal[0]))

    net = _port_net()
    cache = net._mxtpu_megastep_cache = mt.cached_op.SignatureLRU()
    res = _fit(monkeypatch, True, steps=steps, net=net, on_step_end=grab)
    info = tmegastep.cache_info(res._net)
    assert (info.misses, info.hits, info.currsize) == (1, steps - 1, 1)
    assert len(set(lrs)) == steps, lrs


def test_megastep_stale_parameter_raises_and_rolls_back(monkeypatch):
    """A live parameter the loss never reaches raises at the first step
    (the eager one), and that step's host half is rolled back."""
    _mega(monkeypatch, True)

    class TwoHead(mt.gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="two_")
            self.used = mt.gluon.nn.Dense(4, in_units=16, prefix="used_")
            self.unused = mt.gluon.nn.Dense(4, in_units=16,
                                            prefix="unused_")

        def forward(self, x):
            return self.used(x)

    net = TwoHead()
    net.initialize(mt.init.Xavier(), generator=mt.random.seed(0, "cpu"))
    tr = mt.gluon.Trainer(net.collect_params(), "adam")
    X, Y = _data(2)
    loop = mt.fit.FitLoop(net, tr, mt.gluon.loss.L2Loss(),
                          mt.io.NDArrayIter(X, Y, batch_size=4),
                          heartbeat=False)
    with pytest.raises(mt.MXNetError, match="receive no gradient"):
        loop.fit(epochs=1)
    assert not tr._updaters[0].states
    assert not any(tr._optimizer._index_update_count.values())


def test_megastep_breakdown_one_segment(monkeypatch):
    """The step breakdown charges the whole step to 'megastep'."""
    res = _fit(monkeypatch, True, steps=6)
    shares = res.step_breakdown["shares"]
    assert shares.get("megastep", 0.0) > 0.0, shares
    for seg in ("compute", "optimizer", "comm"):
        assert shares.get(seg, 0.0) == 0.0, shares
    assert res.step_breakdown["accounted_frac"] >= 0.8


def test_megastep_updates_buffers_in_place(monkeypatch):
    """No second copy: every parameter, gradient and optimizer state
    keeps its storage (data_ptr) from the first step to the last."""
    seen = []

    def grab(step, _loss):
        tr = holder["tr"]
        seen.append([p.tensor.data_ptr() for p in tr._params] +
                    [p.grad()._data.data_ptr() for p in tr._params
                     if p.grad_req != "null"] +
                    [s._data.data_ptr() for s in _states(tr)])

    holder = {}
    real = mt.gluon.Trainer.megastep_plan

    def plan(self, bs):
        holder["tr"] = self
        return real(self, bs)

    monkeypatch.setattr(mt.gluon.Trainer, "megastep_plan", plan)
    _fit(monkeypatch, True, opt=OPTS[5], steps=5, on_step_end=grab)
    assert len(seen) == 5 and all(s == seen[0] for s in seen)
    assert len(seen[0]) == 4 + 4 + 4 * 3


def test_megastep_adopts_rebound_optimizer_state(monkeypatch):
    """set_states_bytes rebinds the optimizer state to new tensors; the
    next megastep copies them into the tensors it captured and rebinds
    the handles there, and trains on as the composed path does."""
    out = {}
    for mega in (False, True):
        res = _fit(monkeypatch, mega, opt=OPTS[1], steps=3)
        tr, loop = res._trainer, res._loop
        before = [s._data for s in _states(tr)]
        tr.set_states_bytes(tr.get_states_bytes())
        assert all(a is not s._data for a, s in zip(before, _states(tr)))
        loop._iter.reset()
        res2 = loop.fit(epochs=1, resume=False)
        if mega:
            assert all(a is s._data for a, s in zip(before, _states(tr)))
        out[mega] = (res.losses + res2.losses,
                     [p.tensor.detach().clone() for p in tr._params],
                     [s._data.clone() for s in _states(tr)])
    assert out[False][0] == out[True][0]
    for a, b in zip(out[False][1] + out[False][2],
                    out[True][1] + out[True][2]):
        assert torch.equal(a, b)


def test_megastep_kill_and_resume_is_the_fault_free_run(monkeypatch,
                                                       tmp_path):
    """Checkpoints every 2 steps under the megastep; a run killed at step
    5 and relaunched with fresh objects resumes from ckpt-4, and its
    losses and final weights and states equal the fault-free run's."""
    ff = _fit(monkeypatch, True, steps=8, ckpt_dir=str(tmp_path / "ff"),
              ckpt_every=2, async_ckpt=False)
    d = str(tmp_path / "kill")
    with pytest.raises(tchaos.ChaosKilled):
        _fit(monkeypatch, True, steps=8, ckpt_dir=d, ckpt_every=2,
             async_ckpt=False, chaos_spec="kill@5")
    res = _fit(monkeypatch, True, steps=8, ckpt_dir=d, ckpt_every=2,
               async_ckpt=False)
    assert res.resumed_from == 4
    assert res.losses == ff.losses[4:]
    for k in ff._weights:
        np.testing.assert_array_equal(res._weights[k], ff._weights[k])
    for a, b in zip(res._states, ff._states):
        np.testing.assert_array_equal(a, b)


# -- the signature cache and the capture lock -----------------------------

def test_signature_lru_bound_and_threads(monkeypatch):
    """The LRU evicts past MXTPU_CACHEDOP_CACHE_SIZE, and under threads
    that race on the same keys each key is created once and every lookup
    counted once."""
    import sys
    import threading
    monkeypatch.setenv("MXTPU_CACHEDOP_CACHE_SIZE", "2")
    lru = mt.cached_op.SignatureLRU()
    for k in ("a", "b", "a", "c"):
        lru.get_or_insert(k, object)
    assert lru.cache_info() == mt.cached_op.CacheInfo(1, 3, 1, 2, 2)
    assert [k for k, _ in lru.snapshot_items()] == ["a", "c"]
    monkeypatch.setenv("MXTPU_CACHEDOP_CACHE_SIZE", "0")
    lru, made = mt.cached_op.SignatureLRU(), []

    def factory():
        made.append(1)
        return object()

    def work():
        for i in range(300):
            lru.get_or_insert(i % 4, factory)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    info = lru.cache_info()
    assert len(made) == info.misses == 4 and info.currsize == 4
    assert info.hits == 8 * 300 - 4 and info.maxsize is None


def test_capture_lock_excludes_writers():
    """trace_rw_for: one lock per block; a writer never overlaps a reader
    or another writer, under threads."""
    import sys
    import threading
    net = _port_net()
    rw = mt.cached_op.trace_rw_for(net)
    assert mt.cached_op.trace_rw_for(net) is rw
    state = {"readers": 0, "writers": 0, "bad": 0}
    guard = threading.Lock()

    def enter(kind):
        with guard:
            state[kind] += 1
            if state["writers"] > 1 or (state["writers"] and
                                        state["readers"]):
                state["bad"] += 1

    def leave(kind):
        with guard:
            state[kind] -= 1

    def reader():
        for _ in range(200):
            rw.acquire_read()
            enter("readers")
            leave("readers")
            rw.release_read()

    def writer():
        for _ in range(50):
            rw.acquire_write()
            enter("writers")
            leave("writers")
            rw.release_write()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=f)
                   for f in (reader,) * 6 + (writer,) * 2]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert state == {"readers": 0, "writers": 0, "bad": 0}


# -- the grouped update's scalars ------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt,kw", OPTS)
def test_apply_chunk_scalars_bitwise(opt, kw, dtype):
    """The composed grouped update (host floats) is the update as it was
    before device-tensor scalars existed (the rule called with lists of
    floats, written in place), and the same chunks with float32 device
    tensors for lr, wd and rescale give the same bits: f32, and bf16
    with f32 masters (multi-precision)."""
    rs = np.random.RandomState(3)
    dt = getattr(torch, dtype)
    shapes = [(5, 3), (7,), (2, 2, 2)]
    kw = dict(kw, multi_precision=dtype == "bfloat16", rescale_grad=0.25)
    outs = []
    for mode in ("legacy", "floats", "tensors"):
        rs.seed(3)
        holder = mt.gluon.HybridBlock(prefix="", device="cpu")
        params = []
        for j, shape in enumerate(shapes):
            p = holder._new_param(f"p{j}", shape, dtype=dt)
            p.set_data(rs.randn(*shape).astype(np.float32))
            params.append(p)
        tr = mt.gluon.Trainer(params, opt, dict(kw))
        updater = tr._updaters[0]
        rule = tgrouped._rule_for(updater.optimizer)
        for _ in range(3):
            for p in params:
                p.grad()._data.copy_(torch.from_numpy(
                    rs.randn(*p.shape).astype(np.float32)).to(dt))
            items = list(enumerate(params))
            prepared, _ = tgrouped.prepare_update(updater, items)
            for chunk in tgrouped.chunk_prepared(prepared, 2):
                lrs = [e[4] for e in chunk]
                wds = [e[5] for e in chunk]
                rescale = updater.optimizer.rescale_grad
                if mode == "legacy":
                    _legacy_apply(updater, rule, chunk, lrs, wds, rescale)
                elif mode == "floats":
                    tgrouped.apply_chunk(updater, rule, chunk, lrs, wds,
                                         rescale)
                else:
                    tgrouped.apply_chunk(
                        updater, rule, chunk,
                        torch.tensor(lrs, dtype=torch.float32),
                        torch.tensor(wds, dtype=torch.float32),
                        torch.tensor(rescale, dtype=torch.float32))
        outs.append([p.tensor.detach().clone() for p in params] +
                    [s._data.clone() for s in _states(tr)])
    for other in outs[1:]:
        assert len(other) == len(outs[0])
        for a, b in zip(outs[0], other):
            assert a.dtype == b.dtype and torch.equal(a, b)


def _legacy_apply(updater, rule, chunk, lrs, wds, rescale):
    """``grouped.apply_chunk`` as it was before it took device tensors:
    the bucket kernel called with a list of floats and a float."""
    from mxnet_tpu_torch.ops import optimizer_ops as ops
    opt = updater.optimizer
    ws = [e[1].tensor for e in chunk]
    gs = [tgrouped._grad_nd(e[1])._data for e in chunk]
    n_slots = len(chunk[0][2])
    states = [[e[2][k]._data for e in chunk] for k in range(n_slots)]
    mp = chunk[0][3]
    kernel = rule.make_kernel(opt, n_slots - (1 if mp else 0) > 0)
    kernel = ops.mp(kernel) if mp else kernel
    with torch.no_grad():
        nw, ns = kernel(ws, gs, states, list(lrs), list(wds), float(rescale))
        ops.commit(ws + [s for slot in states for s in slot],
                   list(nw) + [s for slot in ns for s in slot])
