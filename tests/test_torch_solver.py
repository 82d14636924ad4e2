"""The port's SMO solver: against an independent QP oracle, against the JAX
reference on the same inputs (the outcome contract), and its own bitwise
contracts (device == host compaction, mirror == host reconstruction,
fused == unfused epochs). All on the CPU at small sizes."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from scipy import optimize

from repro.core import dataplane as jdp
from repro.core import smo as jsmo
from repro.core import train as jtrain

from repro_torch import convert
from repro_torch.core import TABLE3, SVMConfig, SMOSolver, smo as tsmo
from repro_torch.core import driver as tdriver
from repro_torch.core import train as ttrain

from conftest import make_blobs

torch.set_num_threads(1)


def fit(X, y, **kw):
    return ttrain(X, y, device="cpu", **kw)


def rbf64(A, B, s2):
    d2 = (A * A).sum(1)[:, None] - 2.0 * A @ B.T + (B * B).sum(1)[None, :]
    return np.exp(-np.maximum(d2, 0.0) / (2.0 * s2))


def eq9_gap(X, y, alpha, C, s2):
    """beta_low - beta_up over ALL samples with gamma recomputed in fp64 and
    the solver's relative at-bound rule (C*1e-6, smo.py:74-77)."""
    X64 = X.astype(np.float64)
    gamma = rbf64(X64, X64, s2) @ (alpha.astype(np.float64) * y) - y
    thr0, thr1 = tsmo.bounds(C)
    pos, at0, atc = y > 0, alpha <= thr0, alpha >= thr1
    i0 = ~at0 & ~atc
    b_up = gamma[i0 | (pos & at0) | (~pos & atc)].min()
    b_low = gamma[i0 | (pos & atc) | (~pos & at0)].max()
    return b_low - b_up


def _qp_oracle(X, y, C, s2, kernel):
    n = len(y)
    X64 = X.astype(np.float64)
    K = rbf64(X64, X64, s2) if kernel == "rbf" else X64 @ X64.T
    Q = (y[:, None] * y[None, :]) * K
    res = optimize.minimize(
        lambda a: -(a.sum() - 0.5 * a @ Q @ a),
        np.zeros(n), jac=lambda a: -(np.ones(n) - Q @ a),
        bounds=[(0, C)] * n,
        constraints=[{"type": "eq", "fun": lambda a: a @ y,
                      "jac": lambda a: y}],
        method="SLSQP", options={"maxiter": 800, "ftol": 1e-12})
    return -res.fun


@pytest.mark.parametrize("kernel,C,s2", [("rbf", 2.0, 1.5), ("rbf", 8.0, 4.0),
                                         ("linear", 1.0, 1.0)])
def test_dual_objective_matches_qp(kernel, C, s2):
    X, y = make_blobs(n=70, d=3, sep=0.8, seed=3)
    ref = _qp_oracle(X, y, C, s2, kernel)
    m = fit(X, y, C=C, kernel=kernel, sigma2=s2, eps=1e-4)
    assert m.stats.converged
    assert abs(m.dual_objective() - ref) / abs(ref) < 5e-4


@pytest.mark.parametrize("heuristic", sorted(TABLE3))
def test_all_heuristics_reach_same_solution(heuristic):
    X, y = make_blobs(n=240, d=4, sep=0.9, seed=2)
    base = fit(X, y, C=4.0, sigma2=2.0, eps=1e-3, heuristic="original")
    m = fit(X, y, C=4.0, sigma2=2.0, eps=1e-3, heuristic=heuristic,
            chunk_iters=128)
    assert m.stats.converged
    rel = abs(m.dual_objective() - base.dual_objective()) \
        / abs(base.dual_objective())
    assert rel < 2e-3, (heuristic, rel)
    assert (m.predict(X) == base.predict(X)).mean() > 0.995


@pytest.mark.parametrize("heuristic", ["original", "single1000", "multi5pc"])
@pytest.mark.parametrize("selection", ["wss1", "wss2"])
def test_outcome_matches_reference(heuristic, selection):
    X, y = make_blobs(n=300, d=5, seed=1)
    C, s2, eps = 4.0, 4.0, 1e-3
    kw = dict(C=C, sigma2=s2, eps=eps, heuristic=heuristic,
              selection=selection, chunk_iters=64)
    mt = fit(X, y, **kw)
    mj = jtrain(X, y, **kw)
    assert mt.stats.converged == mj.stats.converged
    assert abs(mt.dual_objective() - mj.dual_objective()) \
        / abs(mj.dual_objective()) < 5e-4
    assert (mt.predict(X) == np.asarray(mj.predict(X))).mean() >= 0.995
    assert eq9_gap(X, y, mt.alpha, C, s2) <= 2 * eps


def test_kkt_conditions_hold_with_solver_bound_rule():
    X, y = make_blobs(n=300, d=5, seed=1)
    C = 4.0
    m = fit(X, y, C=C, sigma2=4.0, eps=1e-3)
    a = m.alpha
    assert (a >= 0).all() and (a <= C).all()
    assert abs(float((a.astype(np.float64) * y).sum())) < 1e-4
    assert eq9_gap(X, y, a, C, 4.0) <= 2e-3


def test_one_segment_from_a_shared_state_reports_first_divergence(
        record_property):
    """Both packages take the same mid-fit state (through ``convert``) and
    run one segment one iteration at a time; the first iteration whose
    selected pair differs is reported, not asserted (XLA and PyTorch
    reduce in different orders)."""
    X, y = make_blobs(n=300, d=5, seed=4)
    C, s2, iters = 4.0, 4.0, 64
    r = np.random.default_rng(0)
    alpha = np.zeros(300, np.float32)
    gamma = (-y).astype(np.float32)
    active = r.random(300) < 0.95
    sq = (X * X).sum(1).astype(np.float32)
    jdata = jdp.DenseData(jnp.asarray(X), jnp.asarray(sq))
    jstate = jsmo.init_state(jnp.asarray(alpha), jnp.asarray(gamma),
                             jnp.asarray(active))
    jrun = jsmo.make_chunk_runner("rbf", C, 1 / (2 * s2), 0)
    tdata, ty, tstate = convert.solver_state(alpha, gamma, active, X, y, sq,
                                             device="cpu")
    trun = tsmo.make_chunk_runner("rbf", C, 1 / (2 * s2), 0)
    first = None
    for it in range(iters):
        jstate, _, _ = jrun(jdata, jnp.asarray(y), jstate, None,
                            jnp.float32(2e-3), jnp.int32(1), jnp.int32(1),
                            jnp.int32(10 ** 6), jnp.int32(0), jnp.int32(8))
        tstate, _, summ = trun(tdata, ty, tstate, None, 2e-3, 1, 1, 10 ** 6,
                               0, 8)
        pj = (int(jstate.i_up), int(jstate.i_low))
        pt = (int(tstate.i_up), int(tstate.i_low))
        if first is None and pj != pt:
            first = it
    print(f"first iteration with a different pair: {first} (of {iters})")
    record_property("first_pair_divergence", first)
    assert int(tstate.step) == int(jstate.step) == iters


@pytest.mark.parametrize("selection", ["wss1", "wss2"])
def test_device_compaction_equals_host_bitwise(selection):
    X, y = make_blobs(n=800, d=5, sep=2.0, seed=6)
    kw = dict(C=2.0, sigma2=2.0, heuristic="single5pc", chunk_iters=64,
              min_buffer=64, selection=selection)
    md = fit(X, y, compact_backend="device", **kw)
    mh = fit(X, y, compact_backend="host", **kw)
    assert md.stats.compactions >= 1
    assert md.stats.compactions == mh.stats.compactions
    assert md.stats.iterations == mh.stats.iterations
    assert md.stats.buffer_sizes == mh.stats.buffer_sizes
    np.testing.assert_array_equal(md.alpha, mh.alpha)
    assert md.beta == mh.beta


@pytest.mark.parametrize("selection", ["wss1", "wss2"])
def test_mirror_reconstruction_equals_host_bitwise(selection):
    X, y = make_blobs(n=800, d=6, sep=1.5, seed=5)
    kw = dict(C=4.0, sigma2=4.0, heuristic="multi5pc", chunk_iters=64,
              min_buffer=64, selection=selection, recon_block=256)
    md = fit(X, y, mirror="device", **kw)
    mh = fit(X, y, mirror="host", **kw)
    assert (md.stats.mirror, mh.stats.mirror) == ("device", "host")
    assert md.stats.reconstructions >= 1
    assert md.stats.reconstructions == mh.stats.reconstructions
    assert md.stats.iterations == mh.stats.iterations
    np.testing.assert_array_equal(md.alpha, mh.alpha)
    assert md.beta == mh.beta
    assert md.stats.final_gap == mh.stats.final_gap


@pytest.mark.parametrize("heuristic", ["multi5pc", "original"])
def test_fused_epoch_equals_unfused_bitwise(heuristic):
    X, y = make_blobs(n=800, d=6, sep=1.5, seed=5)
    kw = dict(C=4.0, sigma2=4.0, heuristic=heuristic, chunk_iters=16,
              min_buffer=64)
    m1 = fit(X, y, fuse_iters=1, **kw)
    m4 = fit(X, y, fuse_iters=4, **kw)
    assert m4.stats.dispatches < m1.stats.dispatches
    assert m4.stats.iterations == m1.stats.iterations
    assert m4.stats.compactions == m1.stats.compactions
    assert m4.stats.reconstructions == m1.stats.reconstructions
    np.testing.assert_array_equal(m4.alpha, m1.alpha)
    assert m4.beta == m1.beta


def test_shrinking_actually_shrinks_and_reconstructs():
    X, y = make_blobs(n=800, d=6, sep=1.5, seed=5)
    m = fit(X, y, C=4.0, sigma2=4.0, heuristic="multi5pc", chunk_iters=64)
    assert m.stats.shrink_events > 0
    assert m.stats.reconstructions >= 1
    assert m.stats.min_active < 800
    assert m.stats.converged


@pytest.mark.parametrize("heuristic", ["original", "single5pc"])
def test_verdict_is_rechecked_on_recomputed_gamma(heuristic):
    """A fit whose last phase ends without an Alg. 6 reconstruction
    recomputes every gamma and takes its Eq. 9 verdict on those values."""
    X, y = make_blobs(n=300, d=5, seed=1)
    m = fit(X, y, C=4.0, sigma2=4.0, eps=1e-3, heuristic=heuristic,
            chunk_iters=64)
    assert m.stats.converged and m.stats.eq9_rechecks == 1
    assert m.stats.reconstructions == (0 if heuristic == "original" else 1)
    assert abs(m.stats.final_gap - eq9_gap(X, y, m.alpha, 4.0, 4.0)) < 1e-7


@pytest.mark.parametrize("heuristic,forced", [("original", 1),
                                              ("single5pc", 2),
                                              ("original", 99)])
def test_failed_recheck_optimises_on(heuristic, forced, monkeypatch):
    """The first ``forced`` Eq. 9 checks fail, as drifted fp32 gamma can
    make them: the driver rebuilds the buffer from recomputed gamma and
    optimises on; a recheck after no progress ends the fit."""
    X, y = make_blobs(n=300, d=5, seed=1)
    kw = dict(C=4.0, sigma2=4.0, eps=1e-3, heuristic=heuristic,
              chunk_iters=64)
    base = fit(X, y, **kw)
    real = tdriver.EpochDriver._eq9_on_recomputed_gamma
    calls = []

    def check(self):
        calls.append(1)
        return real(self) and len(calls) > forced

    monkeypatch.setattr(tdriver.EpochDriver, "_eq9_on_recomputed_gamma",
                        check)
    m = fit(X, y, **kw)
    assert m.stats.eq9_rechecks == 2
    assert m.stats.reconstructions == (1 if heuristic == "single5pc" else 0)
    assert m.stats.converged and eq9_gap(X, y, m.alpha, 4.0, 4.0) <= 2e-3
    assert abs(m.dual_objective() - base.dual_objective()) \
        / abs(base.dual_objective()) < 5e-4


def test_max_iters_cap_stops_at_the_cap():
    X, y = make_blobs(n=300, d=5, seed=1)
    m = fit(X, y, C=4.0, sigma2=4.0, max_iters=100, chunk_iters=64)
    assert m.stats.iterations == 100
    assert not m.stats.converged


def test_wss2_second_order_selection():
    X, y = make_blobs(n=500, d=6, sep=0.8, seed=9)
    m1 = fit(X, y, C=4.0, sigma2=4.0, heuristic="multi10pc",
             selection="wss1")
    m2 = fit(X, y, C=4.0, sigma2=4.0, heuristic="multi10pc",
             selection="wss2")
    assert m2.stats.converged
    assert m2.stats.iterations <= m1.stats.iterations
    assert abs(m1.dual_objective() - m2.dual_objective()) \
        / abs(m1.dual_objective()) < 5e-3


@pytest.mark.parametrize("heuristic,selection,fmt", [
    ("original", "wss1", "dense"), ("multi5pc", "wss1", "dense"),
    ("single5pc", "wss2", "dense"), ("multi5pc", "wss1", "ell")])
def test_dispatch_times_and_flops_match_reference(heuristic, selection, fmt):
    """``FitStats`` carries the reference's per-dispatch wall times and
    model FLOP counters: one time per dispatch, ``flops_est`` the sum of
    its production and epilogue parts, and, on a fit whose iterations and
    buffer trajectory equal the reference's, the reference's ``flops_est``
    (two row passes an iteration, no row cache; 2d + 5 or 4K + 5 flops a
    row pass, 4 or 12 under wss2 a row of epilogue — integers, so the sums
    are exact in any order)."""
    if fmt == "dense":
        X, y = make_blobs(n=300, d=5, seed=1)
        kw = dict(C=4.0, sigma2=4.0)
    else:
        from repro_torch.data import make_sparse
        X, y = make_sparse(300, 40, 0.2, seed=3, noise=0.05,
                           label_noise=0.0, margin=0.5)
        kw = dict(C=2.0, sigma2=8.0, format="ell")
    kw.update(eps=1e-3, heuristic=heuristic, selection=selection,
              chunk_iters=64)
    st, sj = fit(X, y, **kw).stats, jtrain(X, y, **kw).stats
    assert len(st.dispatch_times) == st.dispatches > 0
    assert all(t > 0.0 for t in st.dispatch_times)
    assert st.flops_est == st.flops_production + st.flops_epilogue > 0.0
    assert (st.iterations, st.buffer_sizes, st.buffer_K) \
        == (sj.iterations, sj.buffer_sizes, sj.buffer_K)
    assert st.flops_est == sj.flops_est
    assert st.flops_production == sj.flops_production
    assert st.flops_epilogue == sj.flops_epilogue


def test_solver_rejects_bad_input():
    X, y = make_blobs(n=50, d=3, seed=0)
    with pytest.raises(ValueError, match="labels"):
        fit(X, y * 2, C=1.0)
    with pytest.raises(ValueError, match="compact_backend"):
        fit(X, y, compact_backend="disk")
    with pytest.raises(ValueError, match="mirror"):
        fit(X, y, mirror="nowhere", heuristic="multi5pc")
    with pytest.raises(ValueError, match="mirror='device'"):
        fit(X, y, mirror="device", mirror_budget_bytes=16,
            heuristic="multi5pc")
    with pytest.raises(ValueError, match="selection"):
        SMOSolver(SVMConfig(selection="wss3", device="cpu")).fit(X, y)
