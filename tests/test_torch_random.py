"""The port's random streams and samplers against the JAX package's.

- ``mx.random.seed`` re-seeds the default streams and the default weight
  initialisation, as in the JAX package: ``seed(1)`` changes the weights
  and the draws, ``seed(s)`` twice repeats them, and the default
  ``initialize()`` weights before any ``seed`` (and after ``seed(0)``) are
  the ones drawn from a generator seeded with 0, as before.
- Every rng op gives the JAX op's shapes and dtypes and broadcasts its
  parameter arrays as the JAX op does.
- The distributions: moments within 5 standard errors and the
  Kolmogorov–Smirnov test at fixed seeds (deterministic, not flaky);
  ``shuffle`` is a permutation; ``multinomial`` passes a chi-square test.
- ``sample_unique_zipfian``'s rows are distinct and ``num_tries`` counts
  the trials; ``np_rng`` raises before ``seed`` under
  ``MXNET_ENFORCE_DETERMINISM``.

The two packages draw different numbers from one seed, so only shapes,
dtypes and distributions are compared across packages.
"""
import numpy as np
import pytest
import torch
from scipy import stats

from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import random as trandom
from mxnet_tpu_torch.base import MXNetError

CPU = mt.cpu()


def _seed(s):
    """``mx.random.seed(s)`` in the CPU context (without a card, the
    default context raises)."""
    with CPU:
        return trandom.seed(s)


@pytest.fixture(autouse=True)
def _restore_the_recorded_seed(monkeypatch):
    """Later tests in this process keep the default initialisation of a
    process that never called seed()."""
    monkeypatch.setattr(trandom, "_seed_value", trandom._seed_value)


def _dense_weights(init=None):
    with CPU:
        net = mt.gluon.nn.Dense(5, in_units=4)
        net.initialize(init)
        return _weight(net)


def _weight(net):
    (p,) = [p for n, p in net.collect_params().items()
            if n.endswith("weight")]
    return p.data().asnumpy()


# ------------------------------------------------------------------- C10

def test_seed_changes_the_default_initialization_and_the_draws():
    _seed(0)
    w0 = _dense_weights()
    d0 = trandom.uniform(shape=(6,), ctx=CPU).asnumpy()
    _seed(1)
    w1 = _dense_weights()
    d1 = trandom.uniform(shape=(6,), ctx=CPU).asnumpy()
    assert not np.array_equal(w0, w1)
    assert not np.array_equal(d0, d1)
    _seed(0)
    np.testing.assert_array_equal(_dense_weights(), w0)
    np.testing.assert_array_equal(
        trandom.uniform(shape=(6,), ctx=CPU).asnumpy(), d0)


def test_seed_twice_repeats_every_stream_op_and_dropout():
    def draws():
        with CPU:
            x = tnd.ones((64,))
            out = [tnd._internal._random_normal(shape=(5,)),
                   tnd.random.exponential(x),
                   tnd._internal._random_gamma_like(x, alpha=2.0),
                   trandom.shuffle(tnd.arange(10)),
                   tnd.Dropout(x, p=0.5, _training=True)]
            return [o.asnumpy() for o in out]
    _seed(7)
    a = draws()
    _seed(7)
    b = draws()
    _seed(8)
    c = draws()
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        assert not np.array_equal(x, z)


def test_default_initialization_is_unchanged(monkeypatch):
    """Before any seed the default weights are those of a generator
    seeded with 0, as they were before seed() reached them."""
    want = _dense_weights_with(torch.Generator().manual_seed(0))
    monkeypatch.setattr(trandom, "_seed_value", None)
    np.testing.assert_array_equal(_dense_weights(), want)
    _seed(0)
    np.testing.assert_array_equal(_dense_weights(), want)


def _dense_weights_with(gen):
    with CPU:
        net = mt.gluon.nn.Dense(5, in_units=4)
        net.initialize(generator=gen)
        return _weight(net)


def test_seed_returns_a_generator_and_seeds_one_context():
    gen = trandom.seed(3, "cpu")
    assert isinstance(gen, torch.Generator)
    np.testing.assert_array_equal(
        torch.rand(4, generator=gen).numpy(),
        torch.rand(4, generator=torch.Generator().manual_seed(3)).numpy())
    np.testing.assert_array_equal(
        torch.rand(4).numpy(),
        torch.rand(4, generator=torch.Generator().manual_seed(3)).numpy())


# ---------------------------------------------- shapes, dtypes, broadcasting

A2 = np.array([1.0, 3.0], np.float32)
B2 = np.array([2.0, 5.0], np.float32)
P24 = np.array([[0.1, 0.2, 0.3, 0.4], [0.7, 0.1, 0.1, 0.1]], np.float32)
D53 = np.arange(15, dtype=np.float32).reshape(5, 3)

# (op, array inputs, params)
CASES = [
    ("_random_uniform", (), {"low": -1.0, "high": 2.0, "shape": (2, 3)}),
    ("_random_uniform", (), {"shape": (4,), "dtype": "float16"}),
    ("_random_normal", (), {"loc": 1.0, "scale": 2.0, "shape": (3, 2)}),
    ("_random_normal", (), {"shape": (5,), "dtype": "float16"}),
    ("_random_gamma", (), {"alpha": 2.0, "beta": 0.5, "shape": (2, 2)}),
    ("_random_exponential", (), {"lam": 2.0, "shape": (6,)}),
    ("_random_poisson", (), {"lam": 3.0, "shape": (2, 3)}),
    ("_random_negative_binomial", (), {"k": 3, "p": 0.4, "shape": (4,)}),
    ("_random_generalized_negative_binomial", (),
     {"mu": 2.0, "alpha": 0.5, "shape": (2, 2)}),
    ("_random_randint", (), {"low": 0, "high": 10, "shape": (3, 3)}),
    ("_random_randint", (), {"low": -5, "high": 5, "shape": (4,),
                             "dtype": "int32"}),
    ("_sample_uniform", (A2, B2), {"shape": (3,)}),
    ("_sample_uniform", (A2, B2), {}),
    ("_sample_normal", (A2, B2), {"shape": (2, 2)}),
    ("_sample_gamma", (A2, B2), {"shape": (3,)}),
    ("_sample_gamma", (A2, B2), {}),
    ("_sample_exponential", (B2,), {"shape": (4,)}),
    ("_sample_poisson", (B2,), {"shape": (3,)}),
    ("_sample_multinomial", (P24,), {"shape": 3}),
    ("_sample_multinomial", (P24,), {}),
    ("_sample_multinomial", (P24[0],), {"shape": (2, 2)}),
    ("_sample_multinomial", (P24,), {"shape": 3, "get_prob": True}),
    ("_shuffle", (D53,), {}),
    ("_random_uniform_like", (D53,), {"low": 1.0, "high": 2.0}),
    ("_random_normal_like", (D53,), {}),
    ("_random_exponential_like", (D53,), {"lam": 3.0}),
    ("_random_gamma_like", (D53,), {"alpha": 2.0}),
    ("_random_poisson_like", (D53,), {"lam": 2.0}),
    ("_random_negative_binomial_like", (D53,), {"k": 2, "p": 0.5}),
    ("_random_generalized_negative_binomial_like", (D53,),
     {"mu": 2.0, "alpha": 0.3}),
    ("sample_unique_zipfian", (), {"range_max": 50, "shape": (2, 6)}),
]


def _outs(r):
    return r if isinstance(r, (tuple, list)) else (r,)


@pytest.mark.parametrize("op,inputs,params", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_shapes_and_dtypes_match_jax(op, inputs, params):
    want = _outs(getattr(jnd.op, op)(*[jnd.array(a) for a in inputs],
                                     **params))
    with CPU:
        got = _outs(getattr(tnd.op, op)(*[tnd.array(a) for a in inputs],
                                        **params))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.dtype(g.dtype) == np.dtype(w.dtype), (g.dtype, w.dtype)
        assert g.context == CPU


def test_sample_ops_broadcast_their_parameters():
    gen = torch.Generator().manual_seed(0)
    with CPU:
        low = tnd.array(np.array([0.0, 10.0], np.float32))
        high = tnd.array(np.array([1.0, 11.0], np.float32))
        u = tnd.op._sample_uniform(low, high, shape=(1000,),
                                   generator=gen).asnumpy()
        mu = tnd.array(np.array([-5.0, 5.0], np.float32))
        sd = tnd.array(np.array([0.1, 0.1], np.float32))
        z = tnd.op._sample_normal(mu, sd, shape=(1000,),
                                  generator=gen).asnumpy()
    assert (u[0] >= 0).all() and (u[0] < 1).all()
    assert (u[1] >= 10).all() and (u[1] < 11).all()
    assert abs(z[0].mean() + 5) < 0.05 and abs(z[1].mean() - 5) < 0.05


# ----------------------------------------------------------- distributions

N_DRAWS = 200_000


def _draw(op, **params):
    with CPU:
        return getattr(tnd.op, op)(
            shape=(N_DRAWS,), generator=torch.Generator().manual_seed(11),
            **params).asnumpy().astype(np.float64)


# (op, params, mean, variance, scipy distribution for KS or None)
DISTRIBUTIONS = [
    ("_random_uniform", {"low": -1.0, "high": 3.0}, 1.0, 16 / 12,
     stats.uniform(-1, 4)),
    ("_random_normal", {"loc": 2.0, "scale": 3.0}, 2.0, 9.0,
     stats.norm(2, 3)),
    ("_random_gamma", {"alpha": 2.5, "beta": 2.0}, 5.0, 10.0,
     stats.gamma(2.5, scale=2.0)),
    ("_random_exponential", {"lam": 4.0}, 0.25, 1 / 16,
     stats.expon(scale=0.25)),
    ("_random_poisson", {"lam": 3.5}, 3.5, 3.5, None),
    ("_random_negative_binomial", {"k": 3, "p": 0.4}, 4.5, 11.25, None),
    ("_random_generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5},
     2.0, 4.0, None),
    ("_random_randint", {"low": -3, "high": 7}, 1.5, 8.25, None),
]


@pytest.mark.parametrize("op,params,mean,var,dist", DISTRIBUTIONS,
                         ids=[d[0] for d in DISTRIBUTIONS])
def test_moments_and_ks(op, params, mean, var, dist):
    x = _draw(op, **params)
    n = x.size
    se_mean = np.sqrt(var / n)
    m4 = np.mean((x - x.mean()) ** 4)
    se_var = np.sqrt((m4 - x.var() ** 2) / n)
    assert abs(x.mean() - mean) < 5 * se_mean, (x.mean(), mean)
    assert abs(x.var() - var) < 5 * se_var, (x.var(), var)
    if dist is not None:
        assert stats.kstest(x, dist.cdf).pvalue > 1e-3


def test_shuffle_is_a_permutation():
    with CPU:
        x = tnd.arange(1000).reshape((500, 2))
        y = trandom.shuffle(x).asnumpy()
    assert not np.array_equal(y, x.asnumpy())
    np.testing.assert_array_equal(np.sort(y[:, 0]), x.asnumpy()[:, 0])
    np.testing.assert_array_equal(y[:, 1], y[:, 0] + 1)


def test_multinomial_frequencies_pass_chi_square():
    p = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    with CPU:
        idx = tnd.op._sample_multinomial(
            tnd.array(p), shape=(N_DRAWS,),
            generator=torch.Generator().manual_seed(5)).asnumpy()
    counts = np.bincount(idx, minlength=4)
    want = p.astype(np.float64) / p.astype(np.float64).sum() * N_DRAWS
    assert stats.chisquare(counts, want).pvalue > 1e-3


def test_multinomial_get_prob_is_the_log_probability():
    with CPU:
        idx, lp = tnd.op._sample_multinomial(
            tnd.array(P24), shape=5, get_prob=True,
            generator=torch.Generator().manual_seed(2))
    idx, lp = idx.asnumpy(), lp.asnumpy()
    np.testing.assert_allclose(
        lp, np.log(np.take_along_axis(P24, idx, axis=1)), rtol=1e-6)


def test_unique_zipfian_rows_are_distinct_and_count_tries():
    with CPU:
        s, tries = tnd.op.sample_unique_zipfian(
            range_max=20, shape=(50, 8),
            generator=torch.Generator().manual_seed(0))
    s, tries = s.asnumpy(), tries.asnumpy()
    assert s.dtype == np.int32 and tries.shape == (50,)
    assert ((s >= 0) & (s < 20)).all()
    for row, t in zip(s, tries):
        assert len(set(row)) == 8
        assert t >= 8
    assert (tries > 8).any()    # some rows needed rejections
    with pytest.raises(MXNetError, match="unique"):
        tnd.op.sample_unique_zipfian(range_max=4, shape=(5,), ctx=CPU)


def test_generator_argument_makes_the_draws_repeatable():
    def draw(seed):
        return trandom.normal(shape=(5,), ctx=CPU,
                              generator=torch.Generator().manual_seed(seed)
                              ).asnumpy()
    np.testing.assert_array_equal(draw(1), draw(1))
    assert not np.array_equal(draw(1), draw(2))


def test_np_rng_under_enforce_determinism(monkeypatch):
    monkeypatch.setattr(trandom, "_seed_value", None)
    monkeypatch.setenv("MXNET_ENFORCE_DETERMINISM", "1")
    with pytest.raises(MXNetError, match="ENFORCE_DETERMINISM"):
        trandom.np_rng()
    _seed(3)
    a = trandom.np_rng().random(4)
    _seed(3)
    np.testing.assert_array_equal(trandom.np_rng().random(4), a)
    monkeypatch.delenv("MXNET_ENFORCE_DETERMINISM")
    monkeypatch.setattr(trandom, "_seed_value", None)
    assert trandom.np_rng().random(2).shape == (2,)
