"""The port's sparse embedding plane (``parallel/embedding_plane.py``,
``optimizer/grouped.sparse_rows_update``, the memory ledger's plane
owners) against the JAX package's, on the CPU (the cases of
``tests/test_embedding_plane.py``).

Both packages start from one table (the JAX plane's ``save_npz`` arrays
through ``convert.load_embedding_plane``: the JAX plane draws its table
with ``jax.random``) and take the same steps: tables and Adam state
within 2e-5. Inside the port, bit for bit: every world size the same
table, a step equal to the dense-gather reference update on the touched
rows, rows outside the batch untouched, a sentinel-skipped step leaving
every shard and state as it was, and a skipped-then-rolled-back run equal
to one that never saw the step. Per-rank ledger bytes are exactly 1/world
of the unsharded plane's; state is created per rank when first touched.
The env flags parse strictly, the plane needs ``MXTPU_SPARSE_PLANE=on``,
and a step over ``MXTPU_SPARSE_MAX_ROWS`` unique rows raises.
"""
import math

import numpy as np
import pytest
import torch

from mxnet_tpu import nd as jnd
from mxnet_tpu import optimizer as jopt
from mxnet_tpu.parallel import embedding_plane as jep

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import convert
from mxnet_tpu_torch import optimizer as topt
from mxnet_tpu_torch.contrib import chaos
from mxnet_tpu_torch.optimizer import grouped as tgrouped
from mxnet_tpu_torch.parallel import embedding_plane as ep
from mxnet_tpu_torch.telemetry import memory as mem

CPU = mt.cpu()
STEP_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def plane_on(monkeypatch):
    monkeypatch.setenv("MXTPU_SPARSE_PLANE", "on")
    with CPU:
        yield


def _plane(name, rows=32, dim=4, world=4, opt=None, seed=0, **kw):
    opt = opt or topt.Adam(learning_rate=0.05)
    return ep.EmbeddingPlane(name, rows=rows, dim=dim, world=world,
                             optimizer=opt, seed=seed, **kw), opt


def _batches(n=4, rows=32, batch=6, dim=4, seed=1):
    rs = np.random.RandomState(seed)
    return [(rs.randint(0, rows, size=batch),
             rs.randn(batch, dim).astype(np.float32)) for _ in range(n)]


def _steps(plane, batches):
    for ids, g in batches:
        plane.step(ids, mt.nd.array(g))


# ---------------------------------------------------------------------------
# flags and the pure helpers
# ---------------------------------------------------------------------------

def test_flags_parse_strictly_like_jax(monkeypatch):
    for raw, want in (("on", True), ("1", True), ("true", True),
                      ("off", False), ("0", False), ("", False)):
        monkeypatch.setenv("MXTPU_SPARSE_PLANE", raw)
        assert ep.sparse_plane_requested() is want
        assert jep.sparse_plane_requested() is want
    monkeypatch.setenv("MXTPU_SPARSE_PLANE", "yes please")
    with pytest.raises(mt.MXNetError, match="unknown value"):
        ep.sparse_plane_requested()
    for raw in ("lots", "0"):
        monkeypatch.setenv("MXTPU_SPARSE_MAX_ROWS", raw)
        with pytest.raises(mt.MXNetError, match="MXTPU_SPARSE_MAX_ROWS"):
            ep.sparse_max_rows()
    monkeypatch.setenv("MXTPU_SPARSE_MAX_ROWS", "64")
    assert ep.sparse_max_rows() == 64
    assert ep.row_bucket(33) == jep.row_bucket(33) == 64
    with pytest.raises(mt.MXNetError, match="MXTPU_SPARSE_MAX_ROWS"):
        ep.row_bucket(65)
    monkeypatch.delenv("MXTPU_SPARSE_PLANE")
    with pytest.raises(mt.MXNetError, match="MXTPU_SPARSE_PLANE=on"):
        _plane("t_off")


def test_partition_and_bucket_match_jax():
    for rows, world in ((32, 4), (8, 1), (12, 3)):
        assert ep.row_partition(rows, world) == \
            jep.row_partition(rows, world)
    with pytest.raises(mt.MXNetError, match="must divide"):
        ep.row_partition(10, 4)
    for n in (0, 1, 7, 8, 9, 100):
        assert ep.row_bucket(n, cap=4096) == jep.row_bucket(n, cap=4096)


def test_step_over_the_row_cap_raises(monkeypatch):
    monkeypatch.setenv("MXTPU_SPARSE_MAX_ROWS", "4")
    plane, _ = _plane("t_cap")
    try:
        with pytest.raises(mt.MXNetError, match="above the "
                                                "MXTPU_SPARSE_MAX_ROWS"):
            plane.step(np.arange(5), mt.nd.array(np.ones((5, 4),
                                                         np.float32)))
        plane.step(np.array([1, 1, 2, 3, 9]),
                   mt.nd.array(np.ones((5, 4), np.float32)))
        assert plane.last_unique_rows == 4 and plane.last_bucket == 4
    finally:
        plane.close()


# ---------------------------------------------------------------------------
# against the JAX package, from one table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["adam", "sgd_mom", "sgd_wd"])
def test_plane_steps_match_jax_from_one_table(kind, tmp_path):
    mk = {"adam": lambda o: o.Adam(learning_rate=0.05, wd=0.01),
          "sgd_mom": lambda o: o.SGD(learning_rate=0.1, momentum=0.9),
          "sgd_wd": lambda o: o.SGD(learning_rate=0.1, wd=0.01)}[kind]
    jplane = jep.EmbeddingPlane(f"j_{kind}", rows=32, dim=4, world=4,
                                optimizer=mk(jopt), seed=0)
    tplane, _ = _plane(f"t_{kind}", opt=mk(topt))
    try:
        path = str(tmp_path / "plane.npz")
        jplane.save_npz(path)
        convert.load_embedding_plane(tplane, path)
        np.testing.assert_array_equal(tplane.todense(), jplane.todense())
        batches = _batches(n=4)
        for ids, g in batches:
            jplane.step(ids, jnd.array(g))
            tplane.step(ids, mt.nd.array(g))
        np.testing.assert_allclose(tplane.todense(), jplane.todense(),
                                   **STEP_TOL)
        for r in range(4):
            js, ts = jplane._state[r], tplane._state[r]
            assert (js is None) == (ts is None)
            for a, b in zip(ts or (), js or ()):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           **STEP_TOL)
        np.testing.assert_array_equal(tplane.lookup(batches[0][0]).asnumpy(),
                                      tplane.todense()[batches[0][0]])
    finally:
        jplane.close()
        tplane.close()


def test_load_carries_state_across():
    """Shards and per-rank state carried across, then one more step in
    each package: the same tables."""
    jplane = jep.EmbeddingPlane("j_state", rows=16, dim=4, world=2,
                                optimizer=jopt.Adam(learning_rate=0.05))
    tplane, topt_ = _plane("t_state", rows=16, world=2)
    try:
        jplane.step(np.array([1, 2, 3]), jnd.array(np.ones((3, 4),
                                                           np.float32)))
        arrays = {"meta": np.array([16, 4, 2]),
                  **{f"shard_{r}": np.asarray(s)
                     for r, s in enumerate(jplane._shards)}}
        states = [None if s is None else tuple(np.asarray(a) for a in s)
                  for s in jplane._state]
        convert.load_embedding_plane(tplane, arrays, states)
        topt_._update_count(0)         # the step the JAX plane took
        ids, g = np.array([2, 9]), np.ones((2, 4), np.float32) * 0.5
        jplane.step(ids, jnd.array(g))
        tplane.step(ids, mt.nd.array(g))
        np.testing.assert_allclose(tplane.todense(), jplane.todense(),
                                   **STEP_TOL)
        with pytest.raises(mt.MXNetError, match="does not match"):
            convert.load_embedding_plane(
                tplane, dict(arrays, meta=np.array([16, 4, 4])))
    finally:
        jplane.close()
        tplane.close()


# ---------------------------------------------------------------------------
# the port's invariants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["adam", "sgd_mom", "sgd"])
def test_training_is_world_invariant_bitwise(kind):
    tables = []
    for world in (1, 2, 4):
        opt = {"adam": topt.Adam(learning_rate=0.05, wd=0.01),
               "sgd_mom": topt.SGD(learning_rate=0.1, momentum=0.9),
               "sgd": topt.SGD(learning_rate=0.1, wd=0.01)}[kind]
        plane, _ = _plane(f"t_w{kind}{world}", world=world, opt=opt)
        _steps(plane, _batches(n=4))
        tables.append(plane.todense())
        plane.close()
    for t in tables[1:]:
        np.testing.assert_array_equal(tables[0], t)


def test_step_is_the_dense_gather_reference_bitwise():
    """The full table stepped by the same rule kernel on the gathered
    touched rows (no plane, no sharding): bit for bit."""
    rows, dim = 32, 4
    plane, _ = _plane("t_ref", world=4)
    ref_opt = topt.Adam(learning_rate=0.05)
    kernel = tgrouped._rule_for(ref_opt).make_kernel(ref_opt, True)
    ref = torch.from_numpy(plane.todense().copy())
    state = (torch.zeros(rows, dim), torch.zeros(rows, dim))
    try:
        for ids, g in _batches(n=4):
            plane.step(ids, mt.nd.array(g))
            uids = np.unique(ids)
            from mxnet_tpu_torch.ndarray.sparse import segment_sum
            _, summed, _ = segment_sum(torch.from_numpy(g), ids)
            ref_opt._update_count(0)
            t = ref_opt._index_update_count[0]
            lr = ref_opt._get_lr(0) * math.sqrt(
                1 - ref_opt.beta2 ** t) / (1 - ref_opt.beta1 ** t)
            u = torch.from_numpy(uids)
            nw, ns = kernel([ref[u]], [summed], [[s[u]] for s in state],
                            [lr], [ref_opt._get_wd(0)], 1.0)
            ref[u] = nw[0]
            for s, n in zip(state, ns):
                s[u] = n[0]
        np.testing.assert_array_equal(plane.todense(), ref.numpy())
    finally:
        plane.close()


def test_step_touches_only_touched_rows_and_state_is_lazy():
    plane, _ = _plane("t_lazy", rows=64, dim=8, world=4)
    try:
        shard = 64 // 4 * 8 * 4
        assert [plane.rank_bytes(r) for r in range(4)] == [shard] * 4
        before = plane.todense().copy()
        ids = np.array([0, 40])              # ranks 0 and 2 only
        plane.step(ids, mt.nd.array(np.ones((2, 8), np.float32)))
        after = plane.todense()
        untouched = [i for i in range(64) if i not in (0, 40)]
        np.testing.assert_array_equal(after[untouched], before[untouched])
        assert not np.allclose(after[ids], before[ids])
        assert [plane.rank_bytes(r) for r in range(4)] == \
            [3 * shard, shard, 3 * shard, shard]
        assert plane.describe()["ranks_with_state"] == 2
    finally:
        plane.close()


def test_rank_bytes_are_exactly_one_world():
    rows, dim = 64, 8
    cover = [(np.arange(i, rows, 4),
              np.ones((rows // 4, dim), np.float32)) for i in range(4)]
    p1, _ = _plane("t_b1", rows=rows, dim=dim, world=1)
    _steps(p1, cover)
    unsharded = p1.rank_bytes(0)
    p1.close()
    assert unsharded == 3 * rows * dim * 4
    p4, _ = _plane("t_b4", rows=rows, dim=dim, world=4)
    try:
        _steps(p4, cover)
        per_rank = [p4.rank_bytes(r) for r in range(4)]
        assert per_rank == [unsharded // 4] * 4
    finally:
        p4.close()


def test_sentinel_false_then_rollback_and_skip_equivalence():
    plane, opt = _plane("t_sent")
    led = mem.ledger()
    try:
        w0 = plane.todense().copy()
        base = led.live_bytes("optimizer", owner_prefix="state:emb")
        plane.step(np.array([1, 20]), mt.nd.array(np.ones((2, 4),
                                                          np.float32)),
                   flag=torch.tensor(False))
        np.testing.assert_array_equal(plane.todense(), w0)
        for r in (0, 2):
            for s in plane._state[r]:
                assert not s.any()
        assert led.live_bytes("optimizer", owner_prefix="state:emb") > base
        assert opt._index_update_count[0] == 1
        plane.rollback_step()
        assert led.live_bytes("optimizer", owner_prefix="state:emb") == base
        assert opt._index_update_count[0] == 0
        plane.step(np.array([1, 20]), mt.nd.array(np.ones((2, 4),
                                                          np.float32)),
                   flag=torch.tensor(True))
        assert not np.allclose(plane.todense(), w0)
    finally:
        plane.close()

    def run(name, skip):
        p, _ = _plane(name)
        for s, (ids, g) in enumerate(_batches(n=3, seed=5)):
            if s == 1:
                if skip:
                    p.step(ids, mt.nd.array(g), flag=torch.tensor(False))
                    p.rollback_step()
                continue
            p.step(ids, mt.nd.array(g))
        out = p.todense()
        p.close()
        return out
    np.testing.assert_array_equal(run("t_sk", True), run("t_nk", False))


def test_kv_flake_retry_never_double_applies(monkeypatch):
    monkeypatch.setenv("MXNET_KV_RETRY_BASE_MS", "1")

    def run(name, spec):
        plan = chaos.install(chaos.ChaosPlan(spec, seed=7)) if spec \
            else None
        try:
            p, _ = _plane(name)
            _steps(p, _batches(n=4))
            out = p.todense()
            p.close()
        finally:
            if spec:
                chaos.uninstall()
        return out, plan

    clean, _ = run("t_cl", "")
    flaky, plan = run("t_fl", "kv_flake:0.3")
    assert plan.injected["kv_flake"] > 0
    np.testing.assert_array_equal(clean, flaky)


def test_refusals_and_hygiene():
    class Weird(topt.Optimizer):
        def update(self, index, weight, grad, state):
            pass
    with pytest.raises(mt.MXNetError, match="no grouped-update rule"):
        ep.EmbeddingPlane("t_weird", rows=8, dim=2, world=2,
                          optimizer=Weird())
    plane, _ = _plane("t_shape", rows=16, world=2)
    led = mem.ledger()
    try:
        with pytest.raises(mt.MXNetError, match="gradient rows"):
            plane.step(np.array([1, 2, 3]),
                       mt.nd.array(np.ones((2, 4), np.float32)))
        with pytest.raises(mt.MXNetError, match="lookup ids outside"):
            plane.lookup(np.array([16]))
        plane.step(np.array([1]), mt.nd.array(np.ones((1, 4), np.float32)))
    finally:
        plane.close()
    for state in (False, True):
        assert led.live_bytes("optimizer" if state else "params",
                              owner_prefix=mem.plane_owner(
                                  0, 2, "t_shape", state=state)) == 0


def test_two_tower_training_slice_matches_jax(tmp_path):
    """The training half of ``examples/recsys/two_tower.py`` at small size:
    one table for both vocabularies through the plane, the dense tower
    through a Trainer, 3 steps from one table and one tower."""
    from mxnet_tpu import autograd as jag, gluon as jgluon, nd as jnd_
    users, items, dim, proj, batch, world = 16, 16, 4, 4, 8, 2
    rows = users + items
    rs = np.random.RandomState(0)
    u_true = rs.randn(users, 2).astype(np.float32)
    i_true = rs.randn(items, 2).astype(np.float32)

    def tower(g, pkg_kw):
        class TwoTower(g.nn.HybridBlock):
            def __init__(self):
                super().__init__()
                self.u = g.nn.Dense(proj, in_units=dim, **pkg_kw)
                self.i = g.nn.Dense(proj, in_units=dim, **pkg_kw)

            def hybrid_forward(self, F, x):
                uv = F.slice_axis(x, axis=1, begin=0, end=dim)
                iv = F.slice_axis(x, axis=1, begin=dim, end=2 * dim)
                return F.sum(self.u(uv) * self.i(iv), axis=-1)
        return TwoTower()

    jt, tt = tower(jgluon, {}), tower(mt.gluon, {"device": "cpu"})
    jt.initialize()
    tt.initialize()
    jp, tp = jt._collect_params_with_prefix(), tt._collect_params_with_prefix()
    for k, p in tp.items():
        p.set_data(jp[k].data().asnumpy())
    jplane = jep.EmbeddingPlane("j_tt", rows=rows, dim=dim, world=world,
                                optimizer=jopt.Adam(learning_rate=0.05),
                                init_scale=0.3)
    tplane, _ = _plane("t_tt", rows=rows, dim=dim, world=world,
                       opt=topt.Adam(learning_rate=0.05), init_scale=0.3)
    path = str(tmp_path / "tt.npz")
    jplane.save_npz(path)
    convert.load_embedding_plane(tplane, path)
    trs = [jgluon.Trainer(jt.collect_params(), "adam",
                          {"learning_rate": 0.05}),
           mt.gluon.Trainer(tt.collect_params(), "adam",
                            {"learning_rate": 0.05})]
    try:
        for _ in range(3):
            u = rs.randint(0, users, batch)
            i = rs.randint(0, items, batch)
            r = (u_true[u] * i_true[i]).sum(1).astype(np.float32)
            losses = []
            for (pkg_nd, ag, g, net, plane), tr in zip(
                    ((jnd_, jag, jgluon, jt, jplane),
                     (mt.nd, mt.autograd, mt.gluon, tt, tplane)), trs):
                uvec, ivec = plane.lookup(u), plane.lookup(i + users)
                uvec.attach_grad()
                ivec.attach_grad()
                with ag.record():
                    pred = net(pkg_nd.concat(uvec, ivec, dim=1))
                    loss = g.loss.L2Loss()(pred, pkg_nd.array(r)).mean()
                loss.backward()
                tr.step(batch)
                plane.step(np.concatenate([u, i + users]),
                           pkg_nd.concat(uvec.grad, ivec.grad, dim=0))
                losses.append(float(loss.asnumpy()))
            np.testing.assert_allclose(losses[1], losses[0], **STEP_TOL)
        np.testing.assert_allclose(tplane.todense(), jplane.todense(),
                                   **STEP_TOL)
        for k, p in tp.items():
            np.testing.assert_allclose(p.data().asnumpy(),
                                       jp[k].data().asnumpy(), **STEP_TOL)
    finally:
        jplane.close()
        tplane.close()
