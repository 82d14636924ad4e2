"""The port's batched multi-problem training (``repro_torch.core.multi``)
and its union serving engine, on the CPU at small sizes.

* the ``smo.*_multi`` twins against the reference's, bitwise, on random
  (K, M) inputs with ties and at-bound alphas; ``box_thresholds`` against
  ``bounds`` per lane;
* port vs reference per problem (K 3, dense / ELL x wss1 / wss2): the
  outcome contract (verdict, dual objective within 5e-4 relative, labels
  on >= 99.5% of the points, fp64 Eq. 9 gap <= 2 eps);
* inside the port, batched == loop bitwise per problem (alpha bits,
  iterations, reconstructions; beta within 1e-6): a problem's trajectory
  depends only on (X, y, C) — not on its batch-mates, K, the shared row
  cache or dispatch fusion — so one loop fit per (format, selection) over
  the C grid is the oracle of every K (the grids are nested prefixes);
* the multi-problem FLOP bill (production once per row produced, the
  epilogue once per problem-iteration);
* one-vs-rest: the union engine against the per-model host oracle, the
  port's union engine on the reference's trained models
  (``convert.ovr_model``) against the reference's scores, ``train_ovr``,
  ``fit_grid`` and class-order invariance;
* the guards.

The inputs are the reference's own (``tests/test_multi.py``): N 384 x D 24
and an 8-point C grid, made from a seed with numpy. The reference runs
its bitwise grid at K 1, 3 and 8 with fuse 1 and 8, cache on and off (48
cases); here K 1 and 4 with (cache, fuse) (off, 1) and (on, 4), plus one
K 8 case (17), to keep the file near two minutes on one CPU worker.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import MultiProblemDriver as JDriver
from repro.core import SVMConfig as JConfig
from repro.core import smo as jsmo
from repro.core import train_ovr as jtrain_ovr

from repro_torch import convert
from repro_torch.core import (MultiProblemDriver, SVMConfig, ovr_tasks,
                              smo as tsmo, train_ovr)

torch.set_num_threads(1)

N, D = 384, 24
CS = np.geomspace(0.5, 8.0, 8)
EPS = 1e-3
# ell_lane 16 (the reference tests' default is 128): these rows hold ~12
# nonzeros, and the narrower lane budget cuts the plain ELL passes' work by
# 8x; ELL bits do not depend on the lane budget
BASE = dict(C=1.0, sigma2=4.0, eps=EPS, heuristic="multi5pc", chunk_iters=64,
            min_buffer=64, row_cache_slots=128, ell_lane=16)


def cfg(fmt="dense", sel="wss1", rc=False, fuse=1, **kw):
    return SVMConfig(**dict(BASE, fuse_iters=fuse, format=fmt, selection=sel,
                            row_cache=rc, device="cpu", **kw))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(N, D)).astype(np.float32)
    X[rng.random(X.shape) < 0.5] = 0.0
    w = rng.normal(size=D)
    s = X @ w + 0.4 * rng.normal(size=N)
    y = np.where(s > np.median(s), 1.0, -1.0).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def mdata():
    """3-class OvR dataset (integer labels)."""
    rng = np.random.default_rng(11)
    X = rng.normal(size=(180, 12)).astype(np.float32)
    w = rng.normal(size=(12, 3))
    y = np.argmax(X @ w + 0.5 * rng.normal(size=(180, 3)), axis=1)
    return X, y.astype(np.int32)


_ORACLE: dict = {}


def oracle(data, fmt, sel, K):
    """The port's loop fits over CS[:K] for (fmt, sel), made once per
    module at the largest K any test asks of them."""
    X, y = data
    want = 8 if (fmt, sel) == ("dense", "wss1") else 4
    if (fmt, sel) not in _ORACLE:
        _ORACLE[(fmt, sel)] = MultiProblemDriver(
            cfg(fmt, sel), backend="loop").fit_tasks(
                X, np.broadcast_to(y, (want, N)).copy(), C=CS[:want])
    assert K <= want
    return _ORACLE[(fmt, sel)]


def rbf64(A, B, s2):
    A, B = A.astype(np.float64), B.astype(np.float64)
    d2 = (A * A).sum(1)[:, None] - 2.0 * A @ B.T + (B * B).sum(1)[None, :]
    return np.exp(-np.maximum(d2, 0.0) / (2.0 * s2))


def eq9_gap(X, y, alpha, C, s2):
    """beta_low - beta_up over ALL samples, gamma recomputed in fp64, the
    solver's relative at-bound rule."""
    gamma = rbf64(X, X, s2) @ (alpha.astype(np.float64) * y) - y
    thr0, thr1 = tsmo.bounds(C)
    pos, at0, atc = y > 0, alpha <= thr0, alpha >= thr1
    i0 = ~at0 & ~atc
    return (gamma[i0 | (pos & atc) | (~pos & at0)].max()
            - gamma[i0 | (pos & at0) | (~pos & atc)].min())


# -- the *_multi twins, bitwise --------------------------------------------

def _multi_inputs(seed, K=5, M=97):
    """(K, M) state with ties in gamma, alphas at 0, at C and within the
    at-bound band, and per-problem C."""
    r = np.random.default_rng(seed)
    Cs = r.choice([0.5, 1.0, 3.0, 32.0], K)
    alpha = (r.random((K, M)) * Cs[:, None]).astype(np.float32)
    pick = r.random((K, M))
    alpha[pick < 0.2] = 0.0
    alpha[(pick >= 0.2) & (pick < 0.35)] = np.float32(Cs[:, None] * np.ones(
        (K, M)))[(pick >= 0.2) & (pick < 0.35)]
    band = (pick >= 0.35) & (pick < 0.4)
    alpha[band] = np.float32((Cs[:, None] * 5e-7) * np.ones((K, M)))[band]
    gamma = np.round(r.normal(size=(K, M)), 1).astype(np.float32)  # ties
    y = r.choice([-1.0, 1.0], (K, M)).astype(np.float32)
    active = r.random((K, M)) < 0.9
    return Cs, alpha, gamma, y, active


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multi_twins_match_reference_bitwise(seed):
    Cs, alpha, gamma, y, active = _multi_inputs(seed)
    K, M = alpha.shape
    jthr = jsmo.box_thresholds(Cs)
    tthr = tsmo.box_thresholds(Cs)
    for a, b in zip(jthr, tthr):
        np.testing.assert_array_equal(np.asarray(a), b)
    for k in range(K):      # each lane's cuts are bounds(C_k)
        assert (float(tthr[0][k]), float(tthr[1][k])) == tsmo.bounds(Cs[k])
        assert float(tthr[2][k]) == tsmo.f32(Cs[k])
    t = torch.as_tensor
    J = jnp.asarray
    th = [t(a) for a in tthr]
    tj = [J(a) for a in jthr]
    got = tsmo.select_pair_multi(t(gamma), t(alpha), t(y), t(active),
                                 th[0], th[1])
    want = jsmo.select_pair_multi(J(gamma), J(alpha), J(y), J(active),
                                  tj[0], tj[1])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # each lane equals the 1-D selection on its own
    for k in range(K):
        one = tsmo.select_pair(t(gamma[k]), t(alpha[k]), t(y[k]),
                               t(active[k]), Cs[k])
        assert [float(v) for v in one] == [float(g[k]) for g in got]
    b_up, b_low = got[0], got[2]
    np.testing.assert_array_equal(
        tsmo.shrink_rule_multi(t(gamma), t(alpha), t(y), t(active), b_up,
                               b_low, th[0], th[1]).numpy(),
        np.asarray(jsmo.shrink_rule_multi(J(gamma), J(alpha), J(y),
                                          J(active), J(b_up.numpy()),
                                          J(b_low.numpy()), tj[0], tj[1])))
    r = np.random.default_rng(seed + 10)
    rows = r.random((K, M)).astype(np.float32)
    kdiag = np.ones((M,), np.float32)
    k_uu = np.ones((K,), np.float32)
    np.testing.assert_array_equal(
        tsmo.wss2_scores_multi(t(gamma), t(alpha), t(y), t(active), th[0],
                               th[1], b_up, t(rows), t(kdiag),
                               t(k_uu)).numpy(),
        np.asarray(jsmo.wss2_scores_multi(
            J(gamma), J(alpha), J(y), J(active), tj[0], tj[1],
            J(b_up.numpy()), J(rows), J(kdiag), J(k_uu))))
    # the (K,) pair update against the reference's per-lane calls
    v = lambda: r.random(K).astype(np.float32)
    a_up, a_low, g_up, g_low = v() * Cs, v() * Cs, -v(), v()
    a_up[0] = 0.0
    a_low[1] = np.float32(Cs[1])
    k_ul = v()
    y_up, y_low = y[:, 0], y[:, 1]
    one = np.ones((K,), np.float32)
    tu, tl = tsmo.pair_update_multi(*(t(np.float32(a)) for a in (
        a_up, a_low, y_up, y_low, g_up, g_low, k_ul, one, one)),
        th[2])
    for k in range(K):
        ju, jl = jsmo.pair_update_multi(
            *(jnp.float32(a[k]) for a in (a_up, a_low, y_up, y_low, g_up,
                                          g_low, k_ul, one, one)),
            tj[2][k])
        assert float(tu[k]) == float(ju) and float(tl[k]) == float(jl), k


# -- port vs reference -------------------------------------------------------

@pytest.mark.parametrize("fmt", ["dense", "ell"])
@pytest.mark.parametrize("sel", ["wss1", "wss2"])
def test_outcome_matches_reference_per_problem(data, fmt, sel):
    X, y = data
    K = 3
    Y = np.broadcast_to(y, (K, N)).copy()
    mj = JDriver(JConfig(**dict(BASE, format=fmt, selection=sel))) \
        .fit_tasks(X, Y, C=CS[:K])
    mt = MultiProblemDriver(cfg(fmt, sel)).fit_tasks(X, Y, C=CS[:K])
    assert mt[0].stats.n_problems == K
    for k in range(K):
        pt, pj = mt[0].stats.per_problem[k], mj[0].stats.per_problem[k]
        assert pt["converged"] == pj["converged"], k
        oj = mj[k].dual_objective()
        assert abs(mt[k].dual_objective() - oj) / abs(oj) < 5e-4, k
        assert (mt[k].predict(X) == np.asarray(mj[k].predict(X))).mean() \
            >= 0.995, k
        assert eq9_gap(X, y, mt[k].alpha, CS[k], 4.0) <= 2 * EPS, k


# -- inside the port: batched == loop, bitwise -----------------------------

CASES = [(fmt, sel, K, rc, fuse)
         for fmt in ("dense", "ell") for sel in ("wss1", "wss2")
         for K in (1, 4) for rc, fuse in ((False, 1), (True, 4))]
CASES.append(("dense", "wss1", 8, False, 1))


@pytest.mark.parametrize("fmt,sel,K,rc,fuse", CASES)
def test_batched_equals_loop_bitwise(data, fmt, sel, K, rc, fuse):
    X, y = data
    ms = oracle(data, fmt, sel, K)
    mb = MultiProblemDriver(cfg(fmt, sel, rc=rc, fuse=fuse)).fit_tasks(
        X, np.broadcast_to(y, (K, N)).copy(), C=CS[:K])
    st = mb[0].stats
    assert st.n_problems == K and len(st.per_problem) == K
    its = [r["iterations"] for r in st.per_problem]
    assert st.iterations == sum(its)
    assert max(its) <= st.joint_iters <= sum(its)
    assert st.converged and st.mirror == "host"
    for k in range(K):
        # shrink-event counts are not compared: a union compaction re-arms
        # a lane's countdown at another step than its solo run's own
        # compaction would, an extra Eq. 10 application that drops nothing
        rec, solo = st.per_problem[k], ms[k].stats
        assert rec["iterations"] == solo.iterations, (k, rec)
        assert rec["reconstructions"] == solo.reconstructions, (k, rec)
        assert rec["eq9_rechecks"] == solo.eq9_rechecks, (k, rec)
        assert np.array_equal(mb[k].alpha.view(np.int32),
                              ms[k].alpha.view(np.int32)), k
        assert mb[k].beta == pytest.approx(ms[k].beta, abs=1e-6), k
        assert rec["final_gap"] == solo.final_gap, k
    if rc:
        assert st.cache_hits > 0
    if fmt == "ell":
        assert st.buffer_K and len(st.buffer_K) == len(st.buffer_sizes)


def test_flop_accounting_production_once_epilogue_k_times(data):
    """Two identical problems on the shared cache: the second lane's rows
    are the first lane's hits, so production comes in under 2x the single
    fit's while the epilogue is billed exactly per problem-iteration."""
    X, y = data
    base = cfg(rc=True, heuristic="original")    # no shrink: m constant
    m1 = MultiProblemDriver(base).fit_tasks(X, y[None].copy())
    m2 = MultiProblemDriver(base).fit_tasks(X, np.stack([y, y]))
    s1, s2 = m1[0].stats, m2[0].stats
    it1 = s1.per_problem[0]["iterations"]
    assert [r["iterations"] for r in s2.per_problem] == [it1, it1]
    assert s2.flops_est == pytest.approx(
        s2.flops_production + s2.flops_epilogue, rel=1e-12)
    assert s2.flops_epilogue == 2 * s1.flops_epilogue
    assert s2.flops_production < 2 * s1.flops_production
    assert s2.cache_hit_rate > s1.cache_hit_rate
    # cache off bills two rows per lane and joint iteration: an upper
    # bound the cached run undercuts
    off = dataclasses.replace(base, row_cache=False)
    s1off = MultiProblemDriver(off).fit_tasks(X, y[None].copy())[0].stats
    s2off = MultiProblemDriver(off).fit_tasks(X, np.stack([y, y]))[0].stats
    assert s2off.flops_epilogue == s2.flops_epilogue
    assert s2off.flops_production == 2 * s1off.flops_production
    assert s2.flops_production < s2off.flops_production


# -- one-vs-rest -----------------------------------------------------------

@pytest.mark.parametrize("fmt", ["dense", "ell"])
def test_ovr_union_engine_matches_per_model_oracle(mdata, fmt):
    X, y = mdata
    mdl = MultiProblemDriver(cfg(fmt)).fit_ovr(X, y)
    assert mdl._union is not None
    eng = mdl.union_engine()
    assert eng.multi and eng.n_out == len(mdl.classes) == 3
    assert eng.describe()["n_out"] == 3
    got = eng.decision_function(X)
    ref = mdl.decision_matrix_host(X)
    assert got.shape == ref.shape == (len(X), 3)
    np.testing.assert_allclose(got, ref, atol=1e-4)
    # column k is problem k's own engine
    for k, m in enumerate(mdl.models):
        np.testing.assert_allclose(got[:, k], m.decision_function(X),
                                   atol=1e-5)
    pred = mdl.predict(X)
    assert pred.shape == (len(X),)
    assert (pred == mdl.classes[np.argmax(ref, axis=1)]).all()
    with pytest.raises(ValueError, match="multi-coef"):
        eng.predict(X)


@pytest.mark.parametrize("fmt", ["dense", "ell"])
def test_union_engine_scores_reference_models(mdata, fmt):
    """The reference's trained OvR model, carried across by
    ``convert.ovr_model``, scores through the port's union engine as the
    reference's own union engine scores it."""
    X, y = mdata
    jm = jtrain_ovr(X, y, C=1.0, sigma2=4.0, eps=EPS, heuristic="multi5pc",
                    chunk_iters=64, min_buffer=64, format=fmt)

    def fields(m):
        f = dict(sv_coef=np.asarray(m.sv_coef), beta=float(m.beta),
                 alpha=np.asarray(m.alpha),
                 config=dataclasses.asdict(m.config))
        if m.sv_vals is not None:
            f.update(sv_vals=np.asarray(m.sv_vals),
                     sv_cols=np.asarray(m.sv_cols), n_features=m.n_features)
        else:
            f["sv_x"] = np.asarray(m.sv_x)
        return f

    tm = convert.ovr_model(jm.classes, [fields(m) for m in jm.models],
                           device="cpu")
    want = np.asarray(jm.decision_matrix(X))
    got = tm.decision_matrix(X)
    assert got.shape == want.shape == (len(X), 3)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert (tm.predict(X) == np.asarray(jm.predict(X))).all()


def test_train_ovr_wrapper_and_grid(mdata):
    X, y = mdata
    mdl = train_ovr(X, y, C=1.0, sigma2=4.0, eps=EPS, heuristic="multi5pc",
                    chunk_iters=64, min_buffer=64, device="cpu")
    assert (mdl.predict(X) == y).mean() > 0.8
    classes, Y = ovr_tasks(y)
    assert classes.tolist() == [0, 1, 2] and Y.shape == (3, len(X))
    assert set(np.unique(Y).tolist()) == {-1.0, 1.0}
    # a grid with two sigma2 groups trains one batch per sigma2 and
    # returns the models in grid order, each with its point's C and sigma2
    yb = np.where(y[:120] == 0, 1.0, -1.0).astype(np.float32)
    models = MultiProblemDriver(cfg()).fit_grid(
        X[:120], yb, Cs=[0.5, 4.0, 0.5, 4.0], sigma2s=[4.0, 4.0, 8.0, 8.0])
    assert [m.config.C for m in models] == [0.5, 4.0, 0.5, 4.0]
    assert [m.config.sigma2 for m in models] == [4.0, 4.0, 8.0, 8.0]
    # each grid point is the single fit of that point, bit for bit
    solo = MultiProblemDriver(
        dataclasses.replace(cfg(), sigma2=8.0), backend="loop").fit_tasks(
            X[:120], yb[None], C=[4.0])[0]
    assert np.array_equal(models[3].alpha, solo.alpha)


def test_ovr_vote_permutation_invariant(mdata):
    """One-vs-rest binarization and argmax voting do not depend on class
    order: relabeling the classes through a permutation permutes the
    predicted labels through the same map."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    X, y = mdata
    kw = dict(C=1.0, sigma2=4.0, eps=EPS, heuristic="multi5pc",
              chunk_iters=64, min_buffer=64, device="cpu")
    pred0 = train_ovr(X, y, **kw).predict(X)

    @given(perm=st.permutations(range(3)))
    @settings(max_examples=4, deadline=None)
    def check(perm):
        p = np.asarray(perm)
        assert np.array_equal(train_ovr(X, p[y], **kw).predict(X), p[pred0])

    check()


# -- guards ------------------------------------------------------------------

def test_guards(tmp_path):
    # the checkpoint fields, once refused, are accepted by both backends
    for backend in ("batched", "loop"):
        drv = MultiProblemDriver(cfg(checkpoint_dir=str(tmp_path / backend),
                                     resume=True), backend=backend)
        assert drv.cfg.checkpoint_dir.endswith(backend) and drv.cfg.resume
    with pytest.raises(ValueError, match="backend"):
        MultiProblemDriver(cfg(), backend="vmap")
    with pytest.raises(ValueError, match="batched"):
        MultiProblemDriver(cfg(), backend="loop", parallel=True)
    with pytest.raises(NotImplementedError, match="wss1"):
        MultiProblemDriver(cfg(sel="wss2"), parallel=True)
    with pytest.raises(NotImplementedError, match="cache"):
        MultiProblemDriver(cfg(rc=True), parallel=True)
    with pytest.raises(RuntimeError, match="process group"):
        MultiProblemDriver(cfg(), parallel=True)
    X = np.zeros((8, 2), np.float32)
    with pytest.raises(ValueError, match="labels"):
        MultiProblemDriver(cfg()).fit_tasks(X, np.zeros((2, 8), np.float32))
    with pytest.raises(ValueError, match=r"\(K, n\)"):
        MultiProblemDriver(cfg()).fit_tasks(X, np.ones((8,), np.float32))
