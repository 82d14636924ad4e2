"""Checkpoints, resume, the straggler watchdog and the chaos harness in the
port's drivers (``core/driver.py``, ``core/multi.py``), on the reference's
chaos data (``make_sparse(600, 400, 0.04, seed=0)``, C 4, sigma2 4,
chunk_iters 64, multi5pc) and, for the batched multi driver, on the
reference's multi-problem set (``tests/test_multi.py``: N 384 x D 24).

Inside the port every contract is bitwise — equal alpha bits, equal
iterations, equal dual objective — against the uninterrupted fit:

* killed at a dispatch, killed at a save (resuming from the save before);
* the newest step truncated, bit-flipped or its manifest torn (the walk
  falls back to the step before);
* one dispatch delayed past the watchdog's threshold (a forced save, the
  segment budget halved);
* a refuted 2*eps phase (its tolerance cut, its recheck step) resumed
  after the refutation;
* the batched multi fit killed mid-sweep (dense, ELL, row cache, wss2),
  the loop backend's per-problem step trees, and a corrupt newest
  generation (the ``.prev`` one takes over);
* the reference's Single / Multi resume cases (``tests/test_resume.py``).

Across packages (the reference run in this process on the CPU): a
reference fit killed by the reference's chaos harness resumes in the port
from the reference's step dir and lands within the outcome contract of
the reference's uninterrupted fit (dense and ELL), a port step resumes in
the reference, a reference ``multi_masters.npz`` resumes in the port's
batched driver and a port one in the reference's, and a configuration
mismatch raises ``ValueError`` in either direction.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jck
from repro.core import MultiProblemDriver as JMulti
from repro.core import SMOSolver as JSolver
from repro.core import SVMConfig as JConfig
from repro.launch import chaos as jchaos

from repro_torch.ckpt import checkpoint as ck
from repro_torch.core import (MultiProblemDriver, SMOSolver, SVMConfig,
                              driver, smo as tsmo)
from repro_torch.data import make_sparse
from repro_torch.launch import chaos

torch.set_num_threads(1)

# ell_lane 16 for both packages: these rows hold ~16 nonzeros, ELL bits do
# not depend on the lane budget, and the narrower one keeps the ELL passes
# of the plain kernels quick
KW = dict(C=4.0, sigma2=4.0, chunk_iters=64, eps=1e-3, heuristic="multi5pc",
          ell_lane=16)
FMTS = ("dense", "ell")


def cfg(fmt="dense", **kw):
    return SVMConfig(**{**KW, "format": fmt, "device": "cpu", **kw})


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def same_fit(got, want):
    """The bitwise contract: alpha bits, iterations, dual objective; and
    the same shrink count and buffer geometry, the resumed fit's buffers
    being the tail of the uncut fit's."""
    assert got.stats.iterations == want.stats.iterations
    assert np.array_equal(bits(got.alpha), bits(want.alpha))
    assert got.dual_objective() == want.dual_objective()
    assert got.stats.shrink_events == want.stats.shrink_events
    sizes = got.stats.buffer_sizes
    assert sizes == want.stats.buffer_sizes[-len(sizes):]


@pytest.fixture(scope="module")
def data():
    return make_sparse(600, 400, 0.04, seed=0)


_FULL: dict = {}


def full(data, fmt, heuristic="multi5pc"):
    """The uninterrupted port fit, made once per module."""
    key = (fmt, heuristic)
    if key not in _FULL:
        X, y = data
        m = SMOSolver(cfg(fmt, heuristic=heuristic)).fit(X, y)
        assert m.stats.converged and m.stats.resumed_from == -1
        _FULL[key] = m
    return _FULL[key]


def kill_fit(X, y, c, **plan):
    with chaos.inject(chaos.FaultPlan(**plan)) as p:
        with pytest.raises(chaos.InjectedKill):
            SMOSolver(c).fit(X, y)
    return p


# -- kill and resume ---------------------------------------------------------

@pytest.mark.parametrize("fmt", FMTS)
def test_kill_at_dispatch_resumes_bitwise(tmp_path, data, fmt):
    X, y = data
    ref = full(data, fmt)
    c = cfg(fmt, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    kill = ref.stats.dispatches // 2
    plan = kill_fit(X, y, c, kill_at_dispatch=kill)
    assert plan.dispatches == kill + 1              # died AT the boundary
    steps = ck.complete_steps(str(tmp_path))
    assert steps and steps[-1] < ref.stats.iterations
    m = SMOSolver(dataclasses.replace(c, resume=True)).fit(X, y)
    assert m.stats.resumed_from == steps[-1]
    same_fit(m, ref)


@pytest.mark.parametrize("fmt", FMTS)
def test_kill_at_save_resumes_from_the_save_before(tmp_path, data, fmt):
    X, y = data
    ref = full(data, fmt)
    c = cfg(fmt, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    plan = kill_fit(X, y, c, kill_at_save=2)   # saves 0 and 1 complete
    assert plan.saves == 3
    steps = ck.complete_steps(str(tmp_path))
    assert len(steps) == 2
    m = SMOSolver(dataclasses.replace(c, resume=True)).fit(X, y)
    assert m.stats.resumed_from == steps[-1]
    same_fit(m, ref)


# the shrink-heavy set of tests/test_torch_parallel.py: each fit compacts
# and reconstructs, so a resume must restore the compacted membership, the
# active flags and the shrink anchor to keep its bits
SHRINKY = dict(C=2.0, sigma2=40.0, chunk_iters=64, eps=1e-3, min_buffer=64,
               ell_lane=16)


@pytest.mark.parametrize("fmt,heur", [("dense", "multi5pc"),
                                      ("ell", "single5pc")])
def test_kill_at_every_dispatch_of_a_shrink_heavy_fit(tmp_path, fmt, heur):
    X, y = make_sparse(400, 300, 0.05, seed=3, noise=0.05, label_noise=0.0,
                       margin=0.5)
    c = cfg(fmt, heuristic=heur, **SHRINKY)
    ref = SMOSolver(c).fit(X, y)
    assert ref.stats.compactions >= 1 and ref.stats.reconstructions >= 1
    for kill in range(2, ref.stats.dispatches):
        d = str(tmp_path / f"kill{kill}")
        kc = dataclasses.replace(c, checkpoint_dir=d)
        kill_fit(X, y, kc, kill_at_dispatch=kill)
        last = ck.complete_steps(d)[-1]
        m = SMOSolver(dataclasses.replace(kc, resume=True)).fit(X, y)
        assert m.stats.resumed_from == last, kill
        same_fit(m, ref)


_KILLED: dict = {}


def killed_dir(data, fmt, tmp_path_factory):
    """A step tree left by a fit killed at 3/4 of its dispatches, saving
    at every segment; made once per format, copied by each test."""
    if fmt not in _KILLED:
        X, y = data
        d = str(tmp_path_factory.mktemp(f"killed_{fmt}"))
        kill_fit(X, y, cfg(fmt, checkpoint_dir=d),
                 kill_at_dispatch=3 * full(data, fmt).stats.dispatches // 4)
        _KILLED[fmt] = d
    return _KILLED[fmt]


@pytest.mark.parametrize("fmt", FMTS)
@pytest.mark.parametrize("mode", ["truncate", "flip", "manifest"])
def test_corrupt_newest_step_falls_back(tmp_path, tmp_path_factory, data,
                                        fmt, mode):
    X, y = data
    d = str(tmp_path / "ckpt")
    shutil.copytree(killed_dir(data, fmt, tmp_path_factory), d)
    steps = ck.complete_steps(d)
    assert len(steps) >= 2
    chaos.corrupt_step(d, mode=mode)
    assert ck.complete_steps(d) == steps[:-1]
    m = SMOSolver(cfg(fmt, checkpoint_dir=d, resume=True)).fit(X, y)
    assert m.stats.resumed_from == steps[-2]
    same_fit(m, full(data, fmt))


@pytest.mark.parametrize("fmt", FMTS)
def test_watchdog_forces_a_save_and_keeps_the_trajectory(tmp_path, data,
                                                         fmt):
    """The cadence never saves (every 10^6 segments): only the watchdog's
    forced save can write a step. One dispatch is delayed by 8x the
    uncut fit's median dispatch (at fuse 1; 2 here), against a threshold
    of 3x; the delay moves wall time only. The fit starts at fuse 2, so
    the halved budget is exercised too."""
    X, y = data
    d = str(tmp_path)
    c = cfg(fmt, checkpoint_dir=d, checkpoint_every=10**6, fuse_iters=2,
            watchdog_threshold=3.0, watchdog_warmup=2)
    delay = 8.0 * float(np.median(full(data, fmt).stats.dispatch_times)) \
        + 0.5
    with chaos.inject(chaos.FaultPlan(delay_dispatch=4,
                                      delay_seconds=delay)):
        m = SMOSolver(c).fit(X, y)
    assert m.stats.straggle_events >= 1
    assert ck.complete_steps(d), "the straggle did not force a save"
    same_fit(m, full(data, fmt))
    # the forced step is a resume point like any other
    r = SMOSolver(dataclasses.replace(c, resume=True,
                                      watchdog_threshold=0.0)).fit(X, y)
    assert r.stats.resumed_from == ck.complete_steps(d)[-1]
    same_fit(r, full(data, fmt))


def test_resume_after_a_refuted_phase_keeps_its_state(tmp_path, data,
                                                     monkeypatch):
    """The port's own phase state (the cut tol2, the recheck step, the
    recheck count) rides in the step's extra. An Eq. 9 recheck refuted
    once at the fit's last step (by a patched verdict) cuts the tolerance
    and arms the recheck step; the dispatch after it converges at once and
    saves, and its recheck at the same step ends the fit. A resume from
    that step must restore all three: with the recheck step lost it would
    recheck once more."""
    X, y = data
    stop = full(data, "dense", "original").stats.iterations
    real = driver.EpochDriver._eq9_on_recomputed_gamma

    def refute_at_stop(self):
        return real(self) and int(self.state.step) != stop

    monkeypatch.setattr(driver.EpochDriver, "_eq9_on_recomputed_gamma",
                        refute_at_stop)
    d = str(tmp_path)
    c = cfg(heuristic="original", checkpoint_dir=d)
    ref = SMOSolver(c).fit(X, y)
    assert (ref.stats.iterations, ref.stats.eq9_rechecks) == (stop, 2)
    step = ck.complete_steps(d)[-1]
    meta = ck.load_manifest(os.path.join(d, f"step_{step}"))["extra"]
    assert step == stop and meta["tol2_cut"] is True
    assert (meta["recheck_step"], meta["eq9_rechecks"]) == (stop, 1)
    m = SMOSolver(dataclasses.replace(c, resume=True)).fit(X, y)
    assert m.stats.resumed_from == step and m.stats.eq9_rechecks == 2
    same_fit(m, ref)


def test_resume_without_a_step_starts_fresh(tmp_path, data):
    X, y = data
    m = SMOSolver(cfg(checkpoint_dir=str(tmp_path / "none"),
                      resume=True)).fit(X, y)
    assert m.stats.resumed_from == -1
    same_fit(m, full(data, "dense"))


def test_save_retries_are_counted(tmp_path, data, monkeypatch):
    X, y = data
    real, calls = ck.save, {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:
            raise OSError("transient")
        return real(*a, **kw)

    monkeypatch.setattr(ck, "save", flaky)
    m = SMOSolver(cfg(checkpoint_dir=str(tmp_path), checkpoint_every=4,
                      ckpt_retries=2)).fit(X, y)
    assert m.stats.ckpt_retries == 1
    same_fit(m, full(data, "dense"))
    monkeypatch.setattr(ck, "save", lambda *a, **kw: (_ for _ in ()).throw(
        OSError("gone")))
    with pytest.raises(IOError, match="after 2 attempts"):
        SMOSolver(cfg(checkpoint_dir=str(tmp_path / "b"),
                      ckpt_retries=2)).fit(X, y)


@pytest.mark.parametrize("field,value", [
    ("C", 8.0), ("format", "ell"), ("heuristic", "single5pc"),
    ("sigma2", 2.0), ("selection", "wss2")])
def test_config_mismatch_refused(tmp_path, data, field, value):
    X, y = data
    c = cfg(checkpoint_dir=str(tmp_path), max_iters=128)
    SMOSolver(c).fit(X, y)
    with pytest.raises(ValueError, match=field):
        SMOSolver(dataclasses.replace(c, resume=True,
                                      **{field: value})).fit(X, y)


# -- the reference's resume cases (tests/test_resume.py) --------------------

@pytest.mark.parametrize("heur,fmt", [("single5pc", "dense"),
                                      ("multi5pc", "dense"),
                                      ("multi5pc", "ell")])
def test_resume_matches_uninterrupted(tmp_path, data, heur, fmt):
    X, y = data
    ref = full(data, fmt, heur)
    cut = int(ref.stats.iterations * 0.6)
    d = str(tmp_path)
    m1 = SMOSolver(cfg(fmt, heuristic=heur, checkpoint_dir=d,
                       max_iters=cut)).fit(X, y)
    assert m1.stats.iterations <= cut < ref.stats.iterations
    m2 = SMOSolver(cfg(fmt, heuristic=heur, checkpoint_dir=d,
                       resume=True)).fit(X, y)
    assert m2.stats.converged and m2.stats.resumed_from == cut
    same_fit(m2, ref)


def test_single_policy_resume_keeps_shrinking_off(tmp_path, data):
    """A Single-policy step taken after its one reconstruction carries
    shrink_on=False: the runner built after the restore has interval 0."""
    X, y = data
    ref = full(data, "dense", "single5pc")
    assert ref.stats.reconstructions == 1
    d = str(tmp_path)
    for back in (20, 60, 120, 250):
        cut = ref.stats.iterations - back
        m1 = SMOSolver(cfg(heuristic="single5pc", checkpoint_dir=d,
                           max_iters=cut)).fit(X, y)
        if m1.stats.reconstructions >= 1 and not m1.stats.converged:
            break
    assert m1.stats.reconstructions >= 1, "cut landed before reconstruction"
    meta = ck.load_manifest(os.path.join(d, f"step_{cut}"))["extra"]
    assert meta["shrink_on"] is False
    m2 = SMOSolver(cfg(heuristic="single5pc", checkpoint_dir=d,
                       resume=True)).fit(X, y)
    assert m2.stats.converged
    assert m2.stats.shrink_events == ref.stats.shrink_events
    same_fit(m2, ref)


def test_multi_shrink_events_counted_once(tmp_path, data):
    X, y = data
    d = str(tmp_path)
    m = SMOSolver(cfg(checkpoint_dir=d)).fit(X, y)
    assert m.stats.reconstructions >= 2 and m.stats.shrink_events > 0
    man = ck.load_manifest(os.path.join(d, f"step_{ck.latest_step(d)}"))
    assert m.stats.shrink_events == man["extra"]["shrink_events"]



# -- the saved active flags --------------------------------------------------

def _active_sets(data, active):
    """The buffer's rows and, per problem, its active rows, as sets of
    global sample ids: ``(rows, (active of problem 0, ...))``."""
    gids = data.gids.cpu().numpy()
    act = active.cpu().numpy().reshape(-1, gids.size)
    ok = gids >= 0
    return (frozenset(gids[ok].tolist()),
            tuple(frozenset(gids[ok & a].tolist()) for a in act))


def spy_dispatches(monkeypatch, owner, name, lanes_at=None):
    """Wrap the runner that ``owner.name`` makes so every dispatch of the
    fits that follow records what it is handed: the iteration counters,
    the buffer's rows and each problem's active rows (global ids) and the
    live lanes (the runner's argument ``lanes_at``, else lane 0)."""
    seen = []
    make = getattr(owner, name)

    def wrapped(*a, **kw):
        run = make(*a, **kw)

        def spied(data, yb, state, *rest):
            rows, act = _active_sets(data, state.active)
            lanes = (0,) if lanes_at is None else \
                tuple(int(k) for k in rest[lanes_at])
            seen.append((tuple(state.step.reshape(-1).tolist()), rows,
                         {k: act[k] for k in lanes}))
            return run(data, yb, state, *rest)
        return spied

    monkeypatch.setattr(owner, name, wrapped)
    return seen


def kill_with_shrunk_rows(seen) -> int:
    """A dispatch to kill at: one whose start finds rows of the buffer
    shrunk (inactive but not compacted away) for a live problem, so the
    save before it must carry those flags; the middle such dispatch."""
    hits = [i for i, (_, rows, act) in enumerate(seen)
            if i >= 2 and any(a < rows for a in act.values())]
    assert hits, "no dispatch starts with shrunk rows in its buffer"
    return hits[len(hits) // 2]


@pytest.mark.parametrize("fmt", FMTS)
def test_resume_restores_the_saved_active_flags(tmp_path, fmt, monkeypatch):
    """Right after a resume the buffer's active mask is the uncut fit's at
    the same step, shrunk rows included (the shrink-heavy set: its
    buffers hold shrunk rows between compactions). A fresh buffer marks
    every row active, so a resume that dropped the saved flags would
    start with rows active that the uncut fit had shrunk; those rows are
    never selected again and the bits still agree, which is why the
    bitwise tests above cannot see it."""
    X, y = make_sparse(400, 300, 0.05, seed=3, noise=0.05, label_noise=0.0,
                       margin=0.5)
    seen = spy_dispatches(monkeypatch, SMOSolver, "_runner")
    ref = SMOSolver(cfg(fmt, **SHRINKY)).fit(X, y)
    uncut = seen[:]
    kill = kill_with_shrunk_rows(uncut)
    c = cfg(fmt, checkpoint_dir=str(tmp_path), checkpoint_every=1,
            **SHRINKY)
    kill_fit(X, y, c, kill_at_dispatch=kill)
    del seen[:]
    m = SMOSolver(dataclasses.replace(c, resume=True)).fit(X, y)
    assert m.stats.resumed_from == uncut[kill][0][0]
    assert seen[0] == uncut[kill]
    same_fit(m, ref)


def test_multi_resume_restores_the_saved_active_flags(tmp_path, mdata,
                                                      monkeypatch):
    """The batched driver's twin of the test above: the saved flags go
    into ``act_m`` and the lane buffer is built from them, so the first
    dispatch after a resume hands every live lane the uncut fit's active
    mask at the same per-problem steps."""
    from repro_torch.core import multi
    X, Y = mdata
    seen = spy_dispatches(monkeypatch, multi, "make_multi_runner",
                          lanes_at=-1)
    ref = MultiProblemDriver(SVMConfig(**MKW)).fit_tasks(X, Y, C=CS)
    uncut = seen[:]
    kill = kill_with_shrunk_rows(uncut)
    c = SVMConfig(**MKW, checkpoint_dir=str(tmp_path))
    with chaos.inject(chaos.FaultPlan(kill_at_dispatch=kill)):
        with pytest.raises(chaos.InjectedKill):
            MultiProblemDriver(c).fit_tasks(X, Y, C=CS)
    del seen[:]
    m = MultiProblemDriver(dataclasses.replace(c, resume=True)).fit_tasks(
        X, Y, C=CS)
    assert seen[0] == uncut[kill]
    same_models(m, ref)

# -- batched multi-problem checkpoints ---------------------------------------

N, D = 384, 24
CS = np.geomspace(0.5, 8.0, 4)
MKW = dict(C=1.0, sigma2=4.0, eps=1e-3, heuristic="multi5pc", chunk_iters=64,
           min_buffer=64, row_cache_slots=128, ell_lane=16, device="cpu")


@pytest.fixture(scope="module")
def mdata():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(N, D)).astype(np.float32)
    X[rng.random(X.shape) < 0.5] = 0.0
    w = rng.normal(size=D)
    s = X @ w + 0.4 * rng.normal(size=N)
    y = np.where(s > np.median(s), 1.0, -1.0).astype(np.float32)
    Y = np.stack([y, -y, y[::-1], np.roll(y, 7)]).astype(np.float32)
    return X, Y


def same_models(got, want):
    assert [r["iterations"] for r in got[0].stats.per_problem] == \
        [r["iterations"] for r in want[0].stats.per_problem]
    for a, b in zip(got, want):
        assert np.array_equal(bits(a.alpha), bits(b.alpha))
        assert a.dual_objective() == b.dual_objective()


_MFULL: dict = {}


def mfull(mdata, **kw):
    key = tuple(sorted(kw.items()))
    if key not in _MFULL:
        X, Y = mdata
        _MFULL[key] = MultiProblemDriver(SVMConfig(**dict(MKW, **kw))) \
            .fit_tasks(X, Y, C=CS)
    return _MFULL[key]


@pytest.mark.parametrize("kw", [
    dict(), dict(format="ell"), dict(row_cache=True, fuse_iters=4),
    dict(selection="wss2", heuristic="single5pc")],
    ids=["dense", "ell", "cache", "wss2-single"])
def test_multi_kill_mid_sweep_resumes_bitwise(tmp_path, mdata, kw):
    X, Y = mdata
    ref = mfull(mdata, **kw)
    c = SVMConfig(**dict(MKW, **kw), checkpoint_dir=str(tmp_path))
    kill = ref[0].stats.dispatches // 2
    with chaos.inject(chaos.FaultPlan(kill_at_dispatch=kill)):
        with pytest.raises(chaos.InjectedKill):
            MultiProblemDriver(c).fit_tasks(X, Y, C=CS)
    m = MultiProblemDriver(dataclasses.replace(c, resume=True)).fit_tasks(
        X, Y, C=CS)
    assert 0 < m[0].stats.resumed_from < ref[0].stats.iterations
    same_models(m, ref)


def test_multi_resume_through_a_compaction(tmp_path, mdata):
    """Two problems of one label set (C 0.5 and 1): the union compaction
    fires, and a step saved after it holds the compacted membership, which
    the resume rebuilds."""
    X, Y = mdata
    Y2 = np.broadcast_to(Y[0], (2, N)).copy()
    ref = MultiProblemDriver(SVMConfig(**MKW)).fit_tasks(X, Y2, C=CS[:2])
    assert ref[0].stats.compactions >= 1
    c = SVMConfig(**MKW, checkpoint_dir=str(tmp_path))
    with chaos.inject(chaos.FaultPlan(
            kill_at_dispatch=ref[0].stats.dispatches - 1)):
        with pytest.raises(chaos.InjectedKill):
            MultiProblemDriver(c).fit_tasks(X, Y2, C=CS[:2])
    with np.load(os.path.join(str(tmp_path), "multi_masters.npz")) as z:
        assert int(z["in_buffer"].sum()) < N
    m = MultiProblemDriver(dataclasses.replace(c, resume=True)).fit_tasks(
        X, Y2, C=CS[:2])
    assert m[0].stats.buffer_sizes[0] < ref[0].stats.buffer_sizes[0]
    same_models(m, ref)


def test_multi_corruption_falls_back_to_the_prev_generation(tmp_path,
                                                           mdata):
    X, Y = mdata
    ref = mfull(mdata)
    d = str(tmp_path)
    c = SVMConfig(**MKW, checkpoint_dir=d)
    with chaos.inject(chaos.FaultPlan(
            kill_at_dispatch=ref[0].stats.dispatches // 2)):
        with pytest.raises(chaos.InjectedKill):
            MultiProblemDriver(c).fit_tasks(X, Y, C=CS)
    cur = os.path.join(d, "multi_masters.npz")
    assert os.path.exists(os.path.join(d, "multi_masters.prev.npz"))
    chaos.flip_byte(cur, offset=200)
    with pytest.warns(UserWarning, match="corrupt"):
        m = MultiProblemDriver(dataclasses.replace(c, resume=True)) \
            .fit_tasks(X, Y, C=CS)
    same_models(m, ref)


def test_multi_loop_backend_keeps_a_step_tree_per_problem(tmp_path, mdata):
    X, Y = mdata
    d = str(tmp_path)
    c = SVMConfig(**MKW, checkpoint_dir=d, checkpoint_every=2)
    ref = MultiProblemDriver(SVMConfig(**MKW), backend="loop").fit_tasks(
        X, Y, C=CS)
    with chaos.inject(chaos.FaultPlan(kill_at_dispatch=4)):
        with pytest.raises(chaos.InjectedKill):       # dies in problem 0
            MultiProblemDriver(c, backend="loop").fit_tasks(X, Y, C=CS)
    assert sorted(os.listdir(d)) == ["p0"] and ck.complete_steps(
        os.path.join(d, "p0"))
    m = MultiProblemDriver(dataclasses.replace(c, resume=True),
                           backend="loop").fit_tasks(X, Y, C=CS)
    assert sorted(os.listdir(d)) == [f"p{k}" for k in range(4)]
    same_models(m, ref)


def test_multi_grid_keeps_a_checkpoint_per_sigma2_batch(tmp_path, mdata):
    X, Y = mdata
    d = str(tmp_path)
    c = SVMConfig(**MKW, checkpoint_dir=d)
    grid = dict(Cs=[0.5, 4.0, 0.5, 4.0], sigma2s=[2.0, 2.0, 4.0, 4.0])
    ref = MultiProblemDriver(c).fit_grid(X, Y[0], **grid)
    assert sorted(os.listdir(d)) == ["sigma2_2.0", "sigma2_4.0"]
    m = MultiProblemDriver(dataclasses.replace(c, resume=True)).fit_grid(
        X, Y[0], **grid)
    assert all(r.stats.resumed_from > 0 for r in m)
    for a, b in zip(m, ref):
        assert np.array_equal(bits(a.alpha), bits(b.alpha))


@pytest.mark.parametrize("change", ["K", "n", "format", "C", "heuristic",
                                    "sigma2"])
def test_multi_config_mismatch_refused(tmp_path, mdata, change):
    X, Y = mdata
    d = str(tmp_path)
    c = SVMConfig(**MKW, checkpoint_dir=d, max_iters=128)
    MultiProblemDriver(c).fit_tasks(X, Y, C=CS)
    c = dataclasses.replace(c, resume=True)
    Xr, Yr, Cr = X, Y, CS
    if change == "K":
        Yr, Cr = Y[:3], CS[:3]
    elif change == "n":
        Xr, Yr = X[:-8], Y[:, :-8]
    elif change == "C":
        Cr = CS * 2.0
    else:
        c = dataclasses.replace(c, **{change: {
            "format": "ell", "heuristic": "multi2", "sigma2": 2.0}[change]})
    with pytest.raises(ValueError, match={"K": "shape", "n": "shape"}.get(
            change, change)):
        MultiProblemDriver(c).fit_tasks(Xr, Yr, C=Cr)


# -- across packages ---------------------------------------------------------

def outcome(got, want, X):
    """The ROADMAP outcome contract of a port fit against a reference fit:
    the same verdict, the dual objective within 5e-4 relative, labels on
    >= 99.5% of the points, the fp64 Eq. 9 gap <= 2 eps."""
    assert got.stats.converged == bool(want.stats.converged)
    wo = float(want.dual_objective())
    assert abs(got.dual_objective() - wo) <= 5e-4 * abs(wo)
    assert np.mean(got.predict(X) == np.asarray(want.predict(X))) >= 0.995
    assert got.stats.final_gap <= 2e-3


_JFULL: dict = {}


def jfull(data, fmt):
    if fmt not in _JFULL:
        X, y = data
        _JFULL[fmt] = JSolver(JConfig(format=fmt, **KW)).fit(X, y)
    return _JFULL[fmt]


@pytest.mark.parametrize("fmt", FMTS)
def test_a_reference_step_resumes_in_the_port(tmp_path, data, fmt):
    X, y = data
    want = jfull(data, fmt)
    d = str(tmp_path)
    with jchaos.inject(jchaos.FaultPlan(
            kill_at_dispatch=want.stats.dispatches // 2)):
        with pytest.raises(jchaos.InjectedKill):
            JSolver(JConfig(format=fmt, checkpoint_dir=d,
                            checkpoint_every=2, **KW)).fit(X, y)
    last = jck.complete_steps(d)[-1]
    m = SMOSolver(cfg(fmt, checkpoint_dir=d, checkpoint_every=2,
                      resume=True)).fit(X, y)
    assert m.stats.resumed_from == last > 0
    outcome(m, want, X)


@pytest.mark.parametrize("fmt", FMTS)
def test_a_port_step_resumes_in_the_reference(tmp_path, data, fmt):
    X, y = data
    want = jfull(data, fmt)
    d = str(tmp_path)
    kill_fit(X, y, cfg(fmt, checkpoint_dir=d, checkpoint_every=2),
             kill_at_dispatch=full(data, fmt).stats.dispatches // 2)
    last = ck.complete_steps(d)[-1]
    m = JSolver(JConfig(format=fmt, checkpoint_dir=d, checkpoint_every=2,
                        resume=True, **KW)).fit(X, y)
    assert m.stats.resumed_from == last > 0
    assert m.stats.converged
    wo = float(want.dual_objective())
    assert abs(float(m.dual_objective()) - wo) <= 5e-4 * abs(wo)
    assert np.mean(np.asarray(m.predict(X)) == np.asarray(
        want.predict(X))) >= 0.995


@pytest.mark.parametrize("direction", ["reference->port", "port->reference"])
def test_config_mismatch_refused_across_packages(tmp_path, data, direction):
    X, y = data
    d = str(tmp_path)
    if direction == "reference->port":
        JSolver(JConfig(checkpoint_dir=d, max_iters=128, **KW)).fit(X, y)
        resume = lambda **kw: SMOSolver(cfg(checkpoint_dir=d, resume=True,
                                            **kw)).fit(X, y)
    else:
        SMOSolver(cfg(checkpoint_dir=d, max_iters=128)).fit(X, y)
        resume = lambda **kw: JSolver(JConfig(**dict(
            KW, checkpoint_dir=d, resume=True, **kw))).fit(X, y)
    for field, value in (("C", 8.0), ("format", "ell"),
                         ("heuristic", "single5pc")):
        with pytest.raises(ValueError, match=field):
            resume(**{field: value})


def test_a_reference_multi_checkpoint_resumes_in_the_port(tmp_path, mdata):
    X, Y = mdata
    jkw = {k: v for k, v in MKW.items() if k != "device"}
    want = JMulti(JConfig(**jkw)).fit_tasks(X, Y, C=CS)
    cut = max(r["iterations"] for r in want[0].stats.per_problem) // 2
    d = str(tmp_path)
    JMulti(JConfig(checkpoint_dir=d, max_iters=cut, **jkw)).fit_tasks(
        X, Y, C=CS)
    m = MultiProblemDriver(SVMConfig(**MKW, checkpoint_dir=d,
                                     resume=True)).fit_tasks(X, Y, C=CS)
    assert m[0].stats.resumed_from > 0
    for k, (a, b) in enumerate(zip(m, want)):
        rec = m[0].stats.per_problem[k]
        assert rec["converged"] and rec["final_gap"] <= 2e-3
        wo = float(b.dual_objective())
        assert abs(a.dual_objective() - wo) <= 5e-4 * abs(wo)
        assert np.mean(a.predict(X) == np.asarray(b.predict(X))) >= 0.995
    # a mismatched reference file is refused
    with pytest.raises(ValueError, match="format"):
        MultiProblemDriver(SVMConfig(**dict(MKW, format="ell"),
                                     checkpoint_dir=d,
                                     resume=True)).fit_tasks(X, Y, C=CS)


def test_a_port_multi_checkpoint_resumes_in_the_reference(tmp_path, mdata):
    X, Y = mdata
    ref = mfull(mdata)
    jkw = {k: v for k, v in MKW.items() if k != "device"}
    d = str(tmp_path)
    with chaos.inject(chaos.FaultPlan(
            kill_at_dispatch=ref[0].stats.dispatches // 2)):
        with pytest.raises(chaos.InjectedKill):
            MultiProblemDriver(SVMConfig(**MKW, checkpoint_dir=d)) \
                .fit_tasks(X, Y, C=CS)
    m = JMulti(JConfig(checkpoint_dir=d, resume=True, **jkw)).fit_tasks(
        X, Y, C=CS)
    assert m[0].stats.converged
    for a, b in zip(m, ref):
        bo = b.dual_objective()
        assert abs(float(a.dual_objective()) - bo) <= 5e-4 * abs(bo)
    with pytest.raises(ValueError, match="shape"):
        JMulti(JConfig(checkpoint_dir=d, resume=True, **jkw)).fit_tasks(
            X, Y[:3], C=CS[:3])


def test_phase_snapshot_round_trips():
    ph = driver.Phase(cfg(), "single")
    ph.recon_count, ph.shrink_on, ph.recheck_step = 1, False, 77
    ph.eq9_rechecks, ph.tol2 = 2, ph._tol2_cut
    assert ph.cut and not driver.Phase(cfg(), "single").cut
    back = driver.Phase(cfg(), "single")
    back.load(ph.snapshot())
    assert vars(back) == vars(ph)
    ref = driver.Phase(cfg(), "multi")     # a reference step's keys only
    ref.load({"recon_count": 3, "shrink_on": True})
    assert (ref.recon_count, ref.cut, ref.recheck_step, ref.eq9_rechecks,
            ref.tol2) == (3, False, -1, 0, tsmo.f32(2e-3))
