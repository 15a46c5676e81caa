"""The port's imperative front end (``mxnet_tpu_torch.nd``) against the JAX
package's on the CPU: every op of the four ported op modules that has a
case in ``op_cases.py`` (forward, and gradients through ``record`` /
``backward`` where the case has them), then NDArray semantics: indexing
and assignment, in-place operators, ``out=``, ``astype``, bfloat16
``asnumpy``, save in one package and load in the other, DLPack, contexts,
and the error for names not ported yet.

Both packages get the same numpy inputs. Tolerances are the case's own
``rtol``/``atol`` (forward and gradient alike)."""
import numpy as np
import pytest
import torch

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.ops import registry as jreg

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError

from op_cases import CASES

PORTED = set(mt.ops.registry.list_ops())
OPS = sorted(n for n in CASES if n in PORTED)


def _gradable(name, case):
    """The JAX sweep's rule (test_op_sweep._gradable)."""
    return (case.grad is not False and jreg.get_op(name).differentiable
            and len(case.inputs) > 0
            and all(np.issubdtype(a.dtype, np.floating)
                    for a in case.inputs))


GRAD_OPS = [n for n in OPS if any(_gradable(n, c) for c in CASES[n])]


def _first(out, idx=0):
    return out[idx] if isinstance(out, (tuple, list)) else out


def _jax_run(name, inputs, params, out_index):
    nds = tuple(jnd.array(a, dtype=a.dtype) for a in inputs)
    return _first(jnd.imperative_invoke(name, nds, dict(params)),
                  out_index).asnumpy()


def _port_run(name, inputs, params, out_index):
    with mt.cpu():
        nds = tuple(tnd.array(a, dtype=a.dtype) for a in inputs)
        return _first(tnd.imperative_invoke(name, nds, dict(params)),
                      out_index).asnumpy()


def _close(got, want, rtol, atol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    np.testing.assert_allclose(got.astype(np.float64),
                               want.astype(np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def test_the_four_op_modules_are_ported_whole():
    mods = ("mxnet_tpu.ops.elemwise", "mxnet_tpu.ops.broadcast",
            "mxnet_tpu.ops.reduce", "mxnet_tpu.ops.matrix")
    jax_names = {n for n in jreg.list_ops()
                 if getattr(jreg.get_op(n).fn, "__module__", "") in mods}
    assert jax_names <= PORTED
    assert len(OPS) >= 170
    for n in jax_names:
        assert mt.ops.registry.get_op(n).differentiable == \
            jreg.get_op(n).differentiable, n


@pytest.mark.parametrize("name", OPS)
def test_op_forward_matches_jax(name):
    for i, case in enumerate(CASES[name]):
        want = _jax_run(name, case.inputs, case.params, case.out_index)
        got = _port_run(name, case.inputs, case.params, case.out_index)
        _close(got, want, case.rtol, case.atol, f"{name} case {i}")
        if not case.edge:
            continue
        rank = max(a.ndim for a in case.inputs)
        for shape in [(0,) + (2,) * (rank - 1), (1,) * rank,
                      (2,) * (rank - 1) + (0,)]:
            ins = tuple(np.ones(shape, a.dtype) for a in case.inputs)
            _close(_port_run(name, ins, case.params, case.out_index),
                   _jax_run(name, ins, case.params, case.out_index),
                   case.rtol, case.atol, f"{name} case {i} shape {shape}")


def _grads(nd, ag, name, case, head):
    arrs = [nd.array(a, dtype=a.dtype) for a in case.inputs]
    diff = list(case.grad_only) if case.grad_only is not None \
        else list(range(len(arrs)))
    for i in diff:
        arrs[i].attach_grad()
    with ag.record():
        out = _first(nd.imperative_invoke(name, tuple(arrs),
                                          dict(case.params)),
                     case.out_index)
    out.backward(nd.array(head.reshape(out.shape)))
    return [arrs[i].grad.asnumpy() for i in diff]


@pytest.mark.parametrize("name", GRAD_OPS)
def test_op_gradient_matches_jax(name):
    for i, case in enumerate(CASES[name]):
        if not _gradable(name, case):
            continue
        shape = _jax_run(name, case.inputs, case.params,
                         case.out_index).shape
        head = np.asarray(np.random.RandomState(i).randn(*shape),
                          np.float32)
        want = _grads(jnd, jag, name, case, head)
        with mt.cpu():
            got = _grads(tnd, tag, name, case, head)
        for k, (g, w) in enumerate(zip(got, want)):
            _close(g, w, case.rtol, case.atol,
                   f"{name} case {i} gradient {k}")


# ---------------------------------------------------------------------------
# NDArray semantics, against the JAX package
# ---------------------------------------------------------------------------

A = np.arange(60, dtype=np.float32).reshape(3, 4, 5) / 7.0

_KEYS = [1, -1, (1, 2), (slice(None), 1), (slice(0, 2), slice(1, 4)),
         (Ellipsis, 2), (slice(None, None, 2),), (slice(None, None, -1),),
         (1, slice(3, None, -2)), (np.array([0, 2]),),
         (slice(None), [0, 3]), (None, 1)]


@pytest.mark.parametrize("key", _KEYS, ids=[repr(k) for k in _KEYS])
def test_getitem_matches_jax(key):
    with mt.cpu():
        got = tnd.array(A)[key].asnumpy()
    np.testing.assert_array_equal(got, jnd.array(A)[key].asnumpy())
    np.testing.assert_array_equal(got, A[key])


def test_getitem_raises_index_error_and_iterates():
    with mt.cpu():
        x = tnd.array(A)
        with pytest.raises(IndexError):
            x[3]
        assert [r.shape for r in x] == [(4, 5)] * 3


@pytest.mark.parametrize("key,value", [
    ((1,), 5.0), ((slice(None), 2), np.arange(5, dtype=np.float32)),
    ((Ellipsis,), 0.5), ((slice(0, 2), slice(1, 3), 0), -1.0),
    ((slice(None, None, -1), 0), np.arange(5, dtype=np.float32))])
def test_setitem_matches_jax(key, value):
    j = jnd.array(A)
    j[key] = value
    with mt.cpu():
        t = tnd.array(A)
        t[key] = value
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_setitem_with_an_array_and_under_record():
    with mt.cpu():
        x = tnd.array(A)
        x[0] = tnd.array(np.ones((4, 5), np.float32))
        assert (x.asnumpy()[0] == 1).all()
        w = tnd.array(np.ones((3,), np.float32))
        w.attach_grad()
        with tag.record():
            y = tnd.zeros((2, 3))
            y[1] = w * 3.0
            loss = y.sum()
        loss.backward()
    np.testing.assert_array_equal(w.grad.asnumpy(), [3.0, 3.0, 3.0])


def test_inplace_operators_match_jax():
    b = np.linspace(1, 2, 60, dtype=np.float32).reshape(3, 4, 5)
    j, jb = jnd.array(A), jnd.array(b)
    with mt.cpu():
        t, tb = tnd.array(A), tnd.array(b)
        storage = t.tensor.data_ptr()
        for x, y in ((j, jb), (t, tb)):
            x += y
            x -= 0.5
            x *= y
            x /= 2.0
        np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=1e-6)
        assert t.tensor.data_ptr() == storage   # written in place


def test_outputs_never_alias_inputs():
    with mt.cpu():
        x = tnd.array(A)
        views = [x.reshape((12, 5)), x[1], x.T, x.expand_dims(0),
                 tnd.copy(x), x.flatten(), tnd.broadcast_to(x[0:1], (2, 4, 5))]
        for v in views:
            v += 100.0
        np.testing.assert_array_equal(x.asnumpy(), A)


def test_out_argument_matches_jax():
    b = np.full((3, 4, 5), 2.0, np.float32)
    jo = jnd.zeros((3, 4, 5))
    jr = jnd.elemwise_mul(jnd.array(A), jnd.array(b), out=jo)
    with mt.cpu():
        to = tnd.zeros((3, 4, 5))
        ptr = to.tensor.data_ptr()
        tr = tnd.elemwise_mul(tnd.array(A), tnd.array(b), out=to)
        assert tr is to and to.tensor.data_ptr() == ptr
    assert jr is jo
    np.testing.assert_array_equal(to.asnumpy(), jo.asnumpy())


@pytest.mark.parametrize("dtype", ["float16", "float64", "int32", "uint8",
                                   "bfloat16"])
def test_astype_matches_jax(dtype):
    src = (A * 3.0).astype(np.float32)
    jv = np.asarray(jnd.array(src).astype(dtype).asnumpy(), np.float64)
    with mt.cpu():
        t = tnd.array(src).astype(dtype)
    np.testing.assert_array_equal(t.asnumpy().astype(np.float64), jv)
    if dtype != "bfloat16":
        assert t.dtype == np.dtype(dtype)


def test_bfloat16_asnumpy_is_the_exact_float32_widening():
    """numpy has no bfloat16 (ml_dtypes is not used): the port returns
    float32 arrays holding exactly the bfloat16 values."""
    with mt.cpu():
        x = tnd.array(A).astype("bfloat16")
        got = x.asnumpy()
    assert x.dtype == torch.bfloat16
    assert got.dtype == np.float32
    want = torch.from_numpy(A).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, np.asarray(jnd.array(A).astype("bfloat16").asnumpy(),
                        np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_in_one_package_load_in_the_other(tmp_path, dtype, writer):
    arrays = {"w": A, "b": np.arange(4, dtype=np.float32) - 1.5}
    fname = str(tmp_path / "arrays.npz")
    with mt.cpu():
        if writer == "port":
            tnd.save(fname, {k: tnd.array(v).astype(dtype)
                             for k, v in arrays.items()})
            loaded = jnd.load(fname)
        else:
            jnd.save(fname, {k: jnd.array(v).astype(dtype)
                             for k, v in arrays.items()})
            loaded = tnd.load(fname)
    assert sorted(loaded) == ["b", "w"]
    for k, v in arrays.items():
        want = torch.from_numpy(v).to(getattr(torch, dtype)).float().numpy()
        np.testing.assert_array_equal(
            np.asarray(loaded[k].asnumpy(), np.float32), want)
        assert str(loaded[k].dtype).replace("torch.", "") == dtype


def test_save_load_list_keeps_order(tmp_path):
    fname = str(tmp_path / "list.npz")
    with mt.cpu():
        tnd.save(fname, [tnd.array(A), tnd.array(A[0]), tnd.array(A[1])])
        got = tnd.load(fname)
    want = jnd.load(fname)
    assert [g.shape for g in got] == [w.shape for w in want] == \
        [(3, 4, 5), (4, 5), (4, 5)]
    with pytest.raises(MXNetError):
        tnd.save(fname, {"x": A})


def test_dlpack_shares_memory_both_ways():
    t = torch.arange(6, dtype=torch.float32)
    with mt.cpu():
        x = tnd.from_dlpack(t)
        x[0] = 10.0
        assert t[0].item() == 10.0
        back = torch.from_dlpack(x)
        back[1] = 20.0
        assert x.asnumpy()[1] == 20.0
        cap = x.to_dlpack_for_read()
        assert torch.utils.dlpack.from_dlpack(cap)[1].item() == 20.0


def test_creation_functions_match_jax():
    with mt.cpu():
        pairs = [
            (tnd.zeros((2, 3)), jnd.zeros((2, 3))),
            (tnd.ones(4, dtype="int32"), jnd.ones(4, dtype="int32")),
            (tnd.full((2, 2), 7.5), jnd.full((2, 2), 7.5)),
            (tnd.arange(0, 5, 0.5), jnd.arange(0, 5, 0.5)),
            (tnd.arange(3, repeat=2), jnd.arange(3, repeat=2)),
            (tnd.linspace(0, 1, 5), jnd.linspace(0, 1, 5)),
            (tnd.eye(3, 4, 1), jnd.eye(3, 4, 1)),
            (tnd.array([1, 2, 3]), jnd.array([1, 2, 3])),
        ]
        assert tnd.empty((2, 3)).shape == (2, 3)
        parts = tnd.split_v2(tnd.array(A), (1, 3), axis=2)
    jparts = jnd.split_v2(jnd.array(A), (1, 3), axis=2)
    for t, j in pairs + list(zip(parts, jparts)):
        assert t.shape == j.shape
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    assert pairs[-1][0].dtype == np.int32


def test_methods_and_dunders_match_jax():
    b = np.random.RandomState(3).uniform(1, 2, (3, 4, 5)).astype(np.float32)

    def run(nd):
        x, y = nd.array(A), nd.array(b)
        return [x + y, 2 - x, x * 3, y / x.clip(0.5, 5), x % 2, 2 ** y,
                x @ nd.array(b[0].T), -x, abs(x - 4), (x > y), (x == 1.0),
                x.sum(axis=1), x.mean(), x.max(axis=(0, 2), keepdims=True),
                x.argmax(axis=2), x.transpose((2, 0, 1)), x.swapaxes(0, 1),
                x.reshape((-1, 5)), x.flip(axis=1), x.tile((1, 2, 1)),
                x.repeat(2, axis=0), x.slice_axis(2, 1, 3), x.squeeze(),
                x.take(nd.array(np.array([0, 2])), axis=1),
                x.sqrt(), y.log(), x.sigmoid(), x.relu(), x.norm(),
                x.zeros_like(), x.ones_like(), x.T, x.one_hot(3)]

    with mt.cpu():
        got = [g.asnumpy() for g in run(tnd)]
    want = [w.asnumpy() for w in run(jnd)]
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, 1e-5, 1e-5, f"expression {i}")


def test_context_maps_to_torch_devices():
    assert mt.gpu(1) == torch.device("cuda", 1)
    assert torch.device("cuda", 1) == mt.gpu(1)
    assert mt.cpu() == torch.device("cpu") and mt.cpu() != mt.gpu(0)
    assert mt.context.resolve_device(mt.cpu()) == torch.device("cpu")
    assert mt.Context(torch.device("cuda", 2)) == mt.gpu(2)
    assert repr(mt.gpu(3)) == "gpu(3)"
    assert mt.current_context() == mt.gpu(0)   # the port's default
    with mt.cpu():
        assert mt.current_context() == mt.cpu()
        with mt.gpu(1):
            assert mt.current_context() == mt.gpu(1)
        assert mt.current_context() == mt.cpu()
        assert tnd.zeros((1,)).context == mt.cpu()
    assert mt.current_context() == mt.gpu(0)


def test_default_context_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(MXNetError, match="CUDA"):
        tnd.zeros((2,))
    with pytest.raises(MXNetError, match="CUDA"):
        tnd.array(A)
    with pytest.raises(MXNetError, match="CUDA"):
        tnd.array(A, ctx=mt.gpu(0))
    assert mt.num_gpus() == 0


def test_names_not_ported_raise():
    for get in (lambda: tnd.Proposal, lambda: tnd.random.no_such_sampler,
                lambda: tnd.linalg.no_such_op, lambda: tnd.op.Correlation,
                lambda: tnd.contrib.fft, lambda: tnd._internal._foo):
        with pytest.raises(MXNetError, match="not ported yet"):
            get()
    assert not hasattr(tnd, "PSROIPooling")
    with mt.cpu():
        # sparse storage is ported (tests/test_torch_sparse.py)
        assert tnd.array(A).tostype("row_sparse").stype == "row_sparse"
        if A.ndim != 2:
            with pytest.raises(MXNetError, match="csr requires 2-D"):
                tnd.array(A).tostype("csr")
        with pytest.raises(MXNetError, match="not ported yet"):
            tnd.imperative_invoke("Proposal", (tnd.array(A),), {})


@pytest.mark.parametrize("value", ["(2, 3)", "[1, 2]", "True", "0", "None",
                                   "float32", "1e-3", (4, 5), [6, 7], 2.5])
def test_param_coercion_matches_jax(value):
    from mxnet_tpu.base import coerce_param as jcoerce
    from mxnet_tpu.base import hashable_params as jhash
    from mxnet_tpu_torch.base import coerce_param, hashable_params
    assert coerce_param(value) == jcoerce(value)
    params = {"b": value, "a": [value, "3"]}
    assert hashable_params(params) == jhash(params)


def test_string_params_are_coerced():
    with mt.cpu():
        x = tnd.array(A)
        got = tnd.reshape(x, shape="(5, -1)").shape
        assert got == (5, 12)
        assert tnd.sum(x, axis="(0, 2)", keepdims="True").shape == (1, 4, 1)


INT_DTYPES = ["int8", "int16", "int32", "uint8", "uint16", "bool"]


@pytest.mark.parametrize("scalar", [2.5, 11], ids=["float", "int"])
@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_rmod_scalar_dtype_and_value_match_jax(dtype, scalar):
    """``scalar % x`` on integer and bool arrays against the JAX package,
    value and dtype: ``mx.nd``'s ``%`` (which passes the scalar as a
    float: float32) and the op called with the scalar as given (a float
    gives float32; an int the array's integer dtype, int32 for bool).
    Divisors are nonzero. The two paths use different values, because
    the JAX package's jit cache keys 13 and 13.0 alike."""
    a = (np.arange(1, 9).reshape(2, 4) % 7 + 1).astype(dtype)
    want = jnd.array(a, dtype=a.dtype)
    with mt.cpu():
        got = tnd.array(a, dtype=a.dtype)
        dunder = 2.5 if isinstance(scalar, float) else 13
        pairs = [(dunder % got, dunder % want)]
        pairs.append((tnd.imperative_invoke(
            "_rmod_scalar", (got,), {"scalar": scalar, "reverse": True}),
            jnd.imperative_invoke("_rmod_scalar", (want,),
                                  {"scalar": scalar, "reverse": True})))
        for mine, ref in pairs:
            assert mine.dtype == ref.dtype, (mine.dtype, ref.dtype)
            np.testing.assert_array_equal(mine.asnumpy(), ref.asnumpy())


@pytest.mark.parametrize("op", ["sum", "prod", "nansum", "nanprod"])
@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_integer_reductions_widen_as_jax(dtype, op):
    """Integer and bool sums and products take the JAX package's dtype
    (8- and 16-bit integers widen to 32 bits, bool to int32) and value,
    over one axis and over all (products wrap as 32-bit products do)."""
    a = np.full((2, 150), 3).astype(dtype)
    want_in = jnd.array(a, dtype=a.dtype)
    with mt.cpu():
        got_in = tnd.array(a, dtype=a.dtype)
        for kw in ({"axis": 1}, {}):
            mine = getattr(tnd, op)(got_in, **kw)
            ref = getattr(jnd, op)(want_in, **kw)
            assert mine.dtype == ref.dtype, (kw, mine.dtype, ref.dtype)
            np.testing.assert_array_equal(mine.asnumpy(), ref.asnumpy())
