"""MXNet-style user blocks in the port (mxnet_tpu_torch/gluon/block.py,
parameter.py, utils.py) against the JAX package.

Each block is written once, as a function of the package module
(``make(mx)``), and built under both packages, as MXNet user code is
written against ``mx``:

- ``capsnet``: ``examples/capsnet/capsnet.py``'s CapsNet with its own
  widths (``params.get`` kept in ``self.W``, received as ``caps_weight``
  by ``hybrid_forward``; ``F.batch_dot`` / ``softmax`` / ``sqrt`` ...);
- ``block``: a plain ``gluon.Block`` whose ``forward`` runs ``mx.nd`` ops
  on NDArrays and reads its own parameter through ``data()``;
- ``constant``: a ``hybrid_forward`` block with a ``get_constant``;
- ``shared``: two blocks sharing one weight through ``params=``.

The JAX initial weights are carried across by their structural names
(``_collect_params_with_prefix``), which do not depend on either
package's name counters. Compared at f32 2e-5 (summation order only):
the forward, the loss, every gradient after ``record()`` / ``backward()``
and three ``gluon.Trainer`` steps. In the port, ``SPMDTrainer.step``'s
gradients (read where it applies them) are nonzero for every trained
parameter and equal the recorded ones at 2e-5 (mean of per-sample losses
against ``mx.nd``'s mean of the same). ``save_parameters`` files load
across the packages both ways, bit for bit.
"""
import itertools

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ops.registry import NotPortedError

CPU = tmx.cpu()
TOL = 2e-5
_ids = itertools.count()

# examples/capsnet/capsnet.py
SIZE, N_CLS, PRIM_CAPS, PRIM_DIM, DIGIT_DIM, ROUTING_ITERS = \
    16, 10, 4 * 4 * 8, 8, 16, 3


def make_capsnet(mx):
    nn = mx.gluon.nn

    class CapsNet(nn.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.conv1 = nn.Conv2D(32, 5, layout="NHWC", in_channels=1,
                                       activation="relu")
                self.prim = nn.Conv2D(PRIM_DIM * 8, 5, strides=2,
                                      layout="NHWC", in_channels=32)
            self.W = self.params.get(
                "caps_weight", shape=(PRIM_CAPS, N_CLS * DIGIT_DIM,
                                      PRIM_DIM))

        @staticmethod
        def squash(F, s, axis):
            n2 = F.sum(F.square(s), axis=axis, keepdims=True)
            return F.broadcast_mul(
                s, n2 / (1.0 + n2) / F.sqrt(n2 + 1e-9))

        def hybrid_forward(self, F, x, caps_weight):
            h = self.prim(self.conv1(x))
            u = F.reshape(h, shape=(0, -1, PRIM_DIM))
            u = self.squash(F, u, axis=2)
            uT = F.transpose(u, axes=(1, 2, 0))
            uh = F.batch_dot(caps_weight, uT)
            uh = F.transpose(uh, axes=(2, 0, 1))
            u_hat = F.reshape(uh, shape=(0, PRIM_CAPS, N_CLS, DIGIT_DIM))
            b = F.sum(u_hat * 0.0, axis=3)
            for it in range(ROUTING_ITERS):
                c = F.softmax(b, axis=2)
                s = F.sum(F.broadcast_mul(
                    u_hat, F.expand_dims(c, axis=3)), axis=1)
                v = self.squash(F, s, axis=2)
                if it < ROUTING_ITERS - 1:
                    b = b + F.sum(F.broadcast_mul(
                        u_hat, F.expand_dims(v, axis=1)), axis=3)
            return F.sqrt(F.sum(F.square(v), axis=2) + 1e-9)

    return CapsNet


def make_block(mx):
    class Scaled(mx.gluon.Block):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = mx.gluon.nn.Dense(8, in_units=6)
            self.scale = self.params.get("scale", shape=(8,))

        def forward(self, x):
            h = mx.nd.tanh(self.dense(x))
            return mx.nd.broadcast_mul(h, self.scale.data())

    return Scaled


def make_constant(mx):
    class Shifted(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = mx.gluon.nn.Dense(4, in_units=6)
            self.shift = self.params.get_constant(
                "shift", np.arange(4, dtype=np.float32) * 0.25)

        def hybrid_forward(self, F, x, shift):
            return F.broadcast_add(F.tanh(self.dense(x)), shift)

    return Shifted


def make_shared(mx):
    class Tied(mx.gluon.HybridBlock):
        def __init__(self, prefix, params=None):
            super().__init__(prefix=prefix, params=params)
            self.w = self.params.get("w", shape=(6, 6))

        def hybrid_forward(self, F, x, w):
            return F.tanh(F.dot(x, w))

    class Pair(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            tied = self.prefix + "tied_"
            self.a = Tied(tied)
            self.b = Tied(tied, params=self.a.params)

        def hybrid_forward(self, F, x):
            return self.b(self.a(x)) + self.a(x)

    return Pair


def margin_loss(nd, lengths, y_onehot):
    pos = nd.op.relu(0.9 - lengths) ** 2
    neg = nd.op.relu(lengths - 0.1) ** 2
    L = y_onehot * pos + 0.5 * (1.0 - y_onehot) * neg
    return L.sum(axis=1).mean()


def squared_loss(nd, out, target):
    return ((out - target) ** 2).sum(axis=1).mean()


# kind -> (maker, input shape, output width, loss)
SPECS = {"capsnet": (make_capsnet, (4, SIZE, SIZE, 1), N_CLS, margin_loss),
         "block": (make_block, (5, 6), 8, squared_loss),
         "constant": (make_constant, (5, 6), 4, squared_loss),
         "shared": (make_shared, (5, 6), 6, squared_loss)}
KINDS = sorted(SPECS)


def _data(kind, seed=0):
    _, shape, width, _ = SPECS[kind]
    rs = np.random.RandomState(seed)
    x = rs.randn(*shape).astype(np.float32)
    if kind == "capsnet":
        y = np.eye(N_CLS, dtype=np.float32)[rs.randint(0, N_CLS, shape[0])]
    else:
        y = rs.randn(shape[0], width).astype(np.float32)
    return x, y


def _build(kind):
    """(JAX net, port net) with the JAX net's initial weights, both under
    one fresh prefix; the weights (nonzero everywhere) as numpy by
    structural name."""
    make = SPECS[kind][0]
    prefix = f"{kind}{next(_ids)}_"
    jmx.random.seed(0)
    jnet = make(jmx)(prefix=prefix)
    jnet.initialize(jmx.init.Xavier())
    weights = {k: p.data().asnumpy() for k, p in
               jnet._collect_params_with_prefix().items()}
    rs = np.random.RandomState(5)
    for k, p in jnet._collect_params_with_prefix().items():
        if p.grad_req != "null" and not weights[k].any():   # biases, scale
            weights[k] = rs.uniform(0.5, 1.5, weights[k].shape).astype(
                np.float32)
            p.set_data(jmx.nd.array(weights[k]))
    with tmx.cpu():
        tnet = make(tmx)(prefix=prefix)
        tnet.initialize()
    tparams = tnet._collect_params_with_prefix()
    assert tparams.keys() == weights.keys()
    for k, v in weights.items():
        tparams[k].set_data(v)
    return jnet, tnet, weights


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol, err_msg=what)


def _trained(net):
    return {k: p for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


@pytest.mark.parametrize("kind", KINDS)
def test_forward_loss_and_gradients_match_jax(kind):
    jnet, tnet, _ = _build(kind)
    loss = SPECS[kind][3]
    x, y = _data(kind)
    with jmx.autograd.record():
        jout = jnet(jmx.nd.array(x))
        jl = loss(jmx.nd, jout, jmx.nd.array(y))
    jl.backward()
    with tmx.autograd.record():
        tout = tnet(tmx.nd.array(x, ctx=CPU))
        tl = loss(tmx.nd, tout, tmx.nd.array(y, ctx=CPU))
    tl.backward()
    assert isinstance(tout, tmx.nd.NDArray)
    _close(tout.asnumpy(), jout.asnumpy(), what="out")
    _close(tl.asnumpy(), jl.asnumpy(), what="loss")
    jp, tp = _trained(jnet), _trained(tnet)
    assert jp.keys() == tp.keys() and jp
    for k in jp:
        g = tp[k].grad().asnumpy()
        assert np.abs(g).sum() > 0, k
        _close(g, jp[k].grad().asnumpy(), what=k)


@pytest.mark.parametrize("kind", KINDS)
def test_three_trainer_steps_match_jax(kind):
    jnet, tnet, _ = _build(kind)
    loss = SPECS[kind][3]
    opt = ("sgd", {"learning_rate": 0.1, "momentum": 0.9})
    jtr = jmx.gluon.Trainer(jnet.collect_params(), *opt)
    ttr = tmx.gluon.Trainer(tnet.collect_params(), *opt)
    for step in range(3):
        x, y = _data(kind, seed=step)
        with jmx.autograd.record():
            jl = loss(jmx.nd, jnet(jmx.nd.array(x)), jmx.nd.array(y))
        jl.backward()
        jtr.step(x.shape[0])
        with tmx.autograd.record():
            tl = loss(tmx.nd, tnet(tmx.nd.array(x, ctx=CPU)),
                      tmx.nd.array(y, ctx=CPU))
        tl.backward()
        ttr.step(x.shape[0])
        _close(tl.asnumpy(), jl.asnumpy(), what=f"loss {step}")
    jw = jnet._collect_params_with_prefix()
    for k, p in tnet._collect_params_with_prefix().items():
        _close(p.data().asnumpy(), jw[k].data().asnumpy(), what=k)


def _spmd_grads(net, x, y, **kw):
    """The gradients ``SPMDTrainer.step`` applies, by parameter name."""
    def per_sample(out, target):
        return ((out - target) ** 2).sum(dim=1)

    tr = tmx.parallel.SPMDTrainer(net, per_sample, optimizer="sgd",
                                  optimizer_params={"learning_rate": 0.1},
                                  **kw)
    got = {}

    def capture(weights, grads):
        got.update({n: g.float().clone() for (n, _, _), g in
                    zip(tr._trainable, grads)})
    tr._update = capture
    tr.step(torch.from_numpy(x), torch.from_numpy(y))
    return got


@pytest.mark.parametrize("kind", KINDS)
def test_spmd_trainer_gradients_equal_the_recorded_ones(kind):
    """hybrid_forward and Block.forward run their mx.nd ops recorded under
    the trainer's forward: every trained parameter gets its gradient, the
    one record() / backward() gives (same loss, f32)."""
    _, tnet, _ = _build(kind)
    x, y = _data(kind)
    with tmx.autograd.record():
        tl = squared_loss(tmx.nd, tnet(tmx.nd.array(x, ctx=CPU)),
                          tmx.nd.array(y[:, :SPECS[kind][2]], ctx=CPU))
    tl.backward()
    recorded = {p.name: p.grad().asnumpy()
                for p in tnet.collect_params().values()
                if p.grad_req != "null"}
    got = _spmd_grads(tnet, x, y[:, :SPECS[kind][2]])
    assert got.keys() == recorded.keys()
    for name, g in got.items():
        assert g.abs().sum() > 0, name
        _close(g.numpy(), recorded[name], what=name)


@pytest.mark.parametrize("kind", ["block", "constant", "shared"])
def test_spmd_trainer_bf16_replicas_reach_user_blocks(kind):
    """With dtype=bfloat16 the trainer binds 16-bit replicas through
    functional_call; the user block's mx.nd ops see them and every f32
    master gets a gradient near the f32 one (2e-2 of its largest
    value)."""
    _, tnet, _ = _build(kind)
    x, y = _data(kind)
    want = _spmd_grads(tnet, x, y)
    got = _spmd_grads(tnet, x, y, dtype=torch.bfloat16)
    assert got.keys() == want.keys()
    for name, g in got.items():
        assert g.abs().sum() > 0, name
        scale = float(want[name].abs().max())
        assert float((g - want[name]).abs().max()) <= 2e-2 * scale, name


def test_shared_weight_is_one_tensor_in_both_blocks():
    _, tnet, _ = _build("shared")
    assert tnet.a.w is tnet.b.w            # one Parameter record
    assert tnet.a._parameters["w"] is tnet.b._parameters["w"]
    assert len(list(tnet.parameters())) == 1
    assert list(tnet.collect_params()) == [tnet.a.w.name]


def test_capsnet_weight_is_bound_under_its_short_name():
    _, tnet, _ = _build("capsnet")
    assert isinstance(tnet.W, tmx.gluon.Parameter)
    assert tnet.W.name.endswith("_caps_weight")
    assert tnet._parameters["caps_weight"] is tnet.W.tensor
    assert tuple(tnet.W.shape) == (PRIM_CAPS, N_CLS * DIGIT_DIM, PRIM_DIM)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", KINDS)
def test_save_parameters_loads_across_packages(kind, direction, tmp_path):
    jnet, tnet, _ = _build(kind)
    rs = np.random.RandomState(9)
    src, dst = (jnet, tnet) if direction == "jax_to_port" else (tnet, jnet)
    new, seen = {}, {}
    for k, p in src._collect_params_with_prefix().items():
        if id(p) not in seen:        # a shared weight: one value, two names
            seen[id(p)] = rs.randn(*p.shape).astype(np.float32)
            p.set_data(seen[id(p)] if src is tnet
                       else jmx.nd.array(seen[id(p)]))
        new[k] = seen[id(p)]
    path = str(tmp_path / "net.params")
    src.save_parameters(path)
    dst.load_parameters(path)
    loaded = dst._collect_params_with_prefix()
    assert loaded.keys() == new.keys()
    for k, v in new.items():
        np.testing.assert_array_equal(loaded[k].data().asnumpy(), v,
                                      err_msg=k)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_load_parameters_missing_and_extra_names(pkg, tmp_path):
    """A name of the block missing from the file, or one of the file
    missing from the block, raises in both packages; allow_missing /
    ignore_extra let each through."""
    jnet, tnet, weights = _build("block")
    net, mx = (jnet, jmx) if pkg == "jax" else (tnet, tmx)
    ctx = mx.cpu()
    arrays = {k: mx.nd.array(v, ctx=ctx) for k, v in weights.items()}
    missing = str(tmp_path / "missing.params")
    extra = str(tmp_path / "extra.params")
    mx.nd.save(missing, {k: v for k, v in arrays.items()
                         if k != "dense.weight"})
    mx.nd.save(extra, dict(arrays, bogus=mx.nd.array(np.zeros(3), ctx=ctx)))
    with pytest.raises(mx.MXNetError, match="dense.weight"):
        net.load_parameters(missing)
    with pytest.raises(mx.MXNetError, match="bogus"):
        net.load_parameters(extra)
    net.load_parameters(missing, allow_missing=True)
    net.load_parameters(extra, ignore_extra=True)
    got = net._collect_params_with_prefix()
    for k, v in weights.items():
        np.testing.assert_array_equal(got[k].data().asnumpy(), v)


def test_parameter_dict_save_and_load_across_packages(tmp_path):
    jnet, tnet, weights = _build("constant")
    path = str(tmp_path / "dict.params")
    jnet.collect_params().save(path, strip_prefix=jnet.prefix)
    saved = tmx.nd.load(path, ctx=CPU)
    assert sorted(saved) == sorted(k[len(jnet.prefix):]
                                   for k in jnet.collect_params())
    for p in tnet.collect_params().values():
        p.set_data(np.zeros(p.shape, np.float32))
    tnet.collect_params().load(path, restore_prefix=tnet.prefix)
    got = tnet._collect_params_with_prefix()
    for k, v in weights.items():
        np.testing.assert_array_equal(got[k].data().asnumpy(), v, err_msg=k)
    back = str(tmp_path / "back.params")
    tnet.collect_params().save(back)
    jnet.collect_params().load(back, allow_missing=False)
    with pytest.raises(tmx.MXNetError):
        tnet.collect_params().load(path)        # names lack the prefix


def test_name_summary_and_infer_shape_match_jax(capsys):
    jnet, tnet, _ = _build("capsnet")
    assert tnet.name == jnet.name == tnet.prefix[:-1]
    x, _ = _data("capsnet")
    jnet.summary(jmx.nd.array(x))
    want = capsys.readouterr().out
    tnet.summary(tmx.nd.array(x, ctx=CPU))
    assert capsys.readouterr().out == want
    assert want.startswith("CapsNet: ")

    def make(mx):
        class Lazy(mx.gluon.HybridBlock):
            def __init__(self, **kw):
                super().__init__(**kw)
                with self.name_scope():
                    self.dense = mx.gluon.nn.Dense(3)

            def hybrid_forward(self, F, x):
                return F.relu(self.dense(x))
        return Lazy

    prefix = f"lazy{next(_ids)}_"
    jlazy = make(jmx)(prefix=prefix)
    jlazy.initialize()
    with tmx.cpu():
        tlazy = make(tmx)(prefix=prefix)
        tlazy.initialize()
    assert tlazy.dense.weight is None
    x = np.ones((2, 7), np.float32)
    jlazy.infer_shape(jmx.nd.array(x))
    tlazy.infer_shape(tmx.nd.array(x, ctx=CPU))
    jp = jlazy._collect_params_with_prefix()
    tp = tlazy._collect_params_with_prefix()
    assert {k: tuple(p.shape) for k, p in tp.items()} == \
        {k: tuple(p.shape) for k, p in jp.items()} == \
        {"dense.weight": (3, 7), "dense.bias": (3,)}


def test_free_standing_parameter_and_constant():
    p = tmx.gluon.Parameter("w", shape=(3, 4), init=tmx.init.One())
    assert p.tensor is None and p.list_ctx() == []
    with pytest.raises(tmx.MXNetError, match="not initialized"):
        p.data()
    p.initialize(ctx=CPU)
    np.testing.assert_array_equal(p.data().asnumpy(), np.ones((3, 4)))
    assert p.list_ctx() == [CPU] and p.grad().shape == (3, 4)
    p.reset_ctx(CPU)
    with pytest.raises(NotPortedError, match="A14"):
        p.var()
    c = tmx.gluon.Constant("c", [1.0, 2.0])
    c.initialize(ctx=CPU)
    jc = jmx.gluon.Constant("c", [1.0, 2.0])
    jc.initialize()
    np.testing.assert_array_equal(c.data().asnumpy(), jc.data().asnumpy())
    assert c.grad_req == jc.grad_req == "null"

    class Holder(tmx.gluon.Block):
        pass

    with tmx.cpu():
        h = Holder(prefix="holder_")
    q = tmx.gluon.Parameter("holder_v", shape=(2,))
    q.initialize(init=tmx.init.Zero(), ctx=CPU)
    h.v = q                              # adopted: bound under its short name
    assert h.v is q and h._parameters["v"] is q.tensor
    assert q.block is h and "holder_v" in h.params


def test_unported_block_parts_raise():
    with pytest.raises(NotPortedError, match="A14"):
        tmx.gluon.SymbolBlock(None, None)
    with tmx.cpu():
        net = make_constant(tmx)(prefix=f"exp{next(_ids)}_")
    with pytest.raises(NotPortedError, match="A14"):
        net.export("model")
    assert tmx.gluon.nn.Block is tmx.gluon.Block
    assert tmx.gluon.nn_block_scope is tmx.gluon.block.name_scope
    for name in ("data", "rnn", "contrib"):
        assert not hasattr(tmx.gluon, name)


def test_split_and_load_and_clip_global_norm_match_jax():
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    jparts = jmx.gluon.utils.split_and_load(x, [jmx.cpu(), jmx.cpu()])
    tparts = tmx.gluon.utils.split_and_load(x, [CPU, CPU])
    assert len(tparts) == len(jparts) == 2
    for t, j in zip(tparts, jparts):
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    with pytest.raises(tmx.MXNetError):
        tmx.gluon.utils.split_data(tmx.nd.array(x, ctx=CPU), 4)
    rs = np.random.RandomState(1)
    arrays = [rs.randn(5, 3).astype(np.float32) * 3,
              rs.randn(7).astype(np.float32)]
    ja = [jmx.nd.array(a) for a in arrays]
    ta = [tmx.nd.array(a, ctx=CPU) for a in arrays]
    jn = jmx.gluon.utils.clip_global_norm(ja, 1.0)
    tn = tmx.gluon.utils.clip_global_norm(ta, 1.0)
    assert abs(tn - jn) <= TOL * jn
    for t, j in zip(ta, ja):
        _close(t.asnumpy(), j.asnumpy())
    assert tmx.gluon.utils.clip_global_norm(ta, 100.0) == pytest.approx(
        1.0, rel=1e-5)
    with pytest.raises(tmx.MXNetError):
        tmx.gluon.utils.download("http://localhost/none")
