"""Checkpoints and elastic resume of the port's distributed solvers on a
gloo process group of 4 CPU processes (``core/parallel.py``,
``core/multi.py`` with ``parallel=True``): the kill and rescale matrix of
the reference's ``tests/test_chaos.py:259-331``.

One module fixture spawns two groups of 4 ranks, one after the other (the
dense fits; then the ELL fits and the sharded multi runner), each with
its own 300 s deadline. On the
reference's chaos data (``make_sparse(600, 400, 0.04, seed=0)``, C 4,
sigma2 4, chunk_iters 64, multi5pc; ELL at a lane of 16), dense and ELL,
the ranks

* run the uncut P = 4 fit;
* kill it at half its dispatches (``checkpoint_every=2``; every rank
  raises at the same boundary, before any collective of it);
* resume on ``ParallelSMOSolver(devices=m)`` for m = 4, 2 and 1, each from
  its own copy of the step dir (rank 0 copies; resumed fits save too).
  The ranks past m take no part and receive rank 0's model;
* hold the reference's contract at every m (iterations equal, alpha
  within 1e-5, dual within 1e-4 relative), bitwise at m = 4;
* (dense) delay one dispatch on rank 0 only (by 8x the uncut fit's
  median dispatch, against a threshold of 3x) under the watchdog: the
  verdict is agreed over the ranks, so every rank saves at that boundary
  and none deadlocks, and the trajectory keeps its bits;

and, for the sharded multi runner (the reference's multi-problem set, N 384
x D 24, 4 points of its C grid, fuse 4), kill the batched fit mid-sweep and
resume it on the same group, bitwise per problem. Every rank asserts that
each model it returns equals rank 0's; rank 0 prints the results as JSON.
"""
import json
import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300          # seconds, for every subprocess

_RANK = r"""
import dataclasses, json, os, shutil, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.ckpt import checkpoint as ck
from repro_torch.core import MultiProblemDriver, SVMConfig
from repro_torch.core.parallel import ParallelSMOSolver
from repro_torch.data import make_sparse
from repro_torch.launch import chaos, dist

rank, world, init, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
parts = sys.argv[5].split(',')
dist.init(device='cpu', init_method=init, rank=rank, world=world)
X, y = make_sparse(600, 400, 0.04, seed=0)
# ell_lane 16: these rows hold ~16 nonzeros, and ELL bits do not depend on
# the lane budget; the narrower budget keeps the ranks quick
KW = dict(C=4.0, sigma2=4.0, heuristic='multi5pc', chunk_iters=64,
          eps=1e-3, ell_lane=16, device='cpu')
res = {'seconds': {}}


def bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def agreed(m):
    # every rank, member of the training group or not, holds rank 0's model
    got = dist.all_gather(torch.as_tensor(bits(m.alpha)))
    assert bool((got == got[0]).all()), 'ranks returned different alphas'
    return m


def record(m, ref):
    return dict(resumed_from=m.stats.resumed_from,
                iterations=m.stats.iterations,
                bitwise=bool(np.array_equal(bits(m.alpha), bits(ref.alpha))),
                max_err=float(np.abs(m.alpha - ref.alpha).max()),
                obj=float(m.dual_objective()),
                straggle_events=m.stats.straggle_events)


def barrier():
    dist.all_reduce(torch.zeros(1))


for fmt in [f for f in ('dense', 'ell') if f in parts]:
    t0 = time.perf_counter()
    ref = agreed(ParallelSMOSolver(SVMConfig(format=fmt, **KW)).fit(X, y))
    out = dict(iterations=ref.stats.iterations, obj=ref.dual_objective(),
               converged=bool(ref.stats.converged))
    snap = os.path.join(tmp, fmt)
    cfg = SVMConfig(format=fmt, checkpoint_dir=snap, checkpoint_every=2,
                    **KW)
    kill = ref.stats.dispatches // 2
    with chaos.inject(chaos.FaultPlan(kill_at_dispatch=kill)) as plan:
        try:
            ParallelSMOSolver(cfg).fit(X, y)
            raise SystemExit('kill did not fire: ' + fmt)
        except chaos.InjectedKill:
            pass
    out['killed_at'] = plan.dispatches - 1
    out['steps'] = ck.complete_steps(snap)
    for m in (4, 2, 1):
        d = snap + '_m%d' % m
        if rank == 0:
            shutil.copytree(snap, d)
        barrier()
        got = agreed(ParallelSMOSolver(
            dataclasses.replace(cfg, checkpoint_dir=d, resume=True),
            devices=m).fit(X, y))
        out[str(m)] = record(got, ref)
    res[fmt] = out
    res['seconds'][fmt] = time.perf_counter() - t0
    if fmt == 'ell':
        continue
    # a straggler on rank 0 alone: the verdict is agreed, every rank saves.
    # The delay is 8x the uncut fit's median dispatch (fuse 1; 2 here)
    d = snap + '_wd'
    delay = 8.0 * float(np.median(ref.stats.dispatch_times)) + 0.5
    plan = (chaos.FaultPlan(delay_dispatch=4, delay_seconds=delay)
            if rank == 0 else None)
    chaos.install(plan)
    try:
        got = agreed(ParallelSMOSolver(dataclasses.replace(
            cfg, checkpoint_dir=d, checkpoint_every=10**6, fuse_iters=2,
            watchdog_threshold=3.0, watchdog_warmup=2)).fit(X, y))
    finally:
        chaos.install(None)
    out['watchdog'] = dict(record(got, ref), steps=ck.complete_steps(d))
    res['seconds'][fmt] = time.perf_counter() - t0


def multi():
    # the sharded multi runner: killed mid-sweep, resumed on the same group
    t0 = time.perf_counter()
    rng = np.random.default_rng(7)
    Xm = rng.normal(size=(384, 24)).astype(np.float32)
    Xm[rng.random(Xm.shape) < 0.5] = 0.0
    w = rng.normal(size=24)
    s = Xm @ w + 0.4 * rng.normal(size=384)
    ym = np.where(s > np.median(s), 1.0, -1.0).astype(np.float32)
    Y = np.broadcast_to(ym, (4, 384)).copy()
    CS = np.geomspace(0.5, 8.0, 4)
    MKW = dict(C=1.0, sigma2=4.0, eps=1e-3, heuristic='multi5pc',
               chunk_iters=64, fuse_iters=4, min_buffer=64, selection='wss1',
               device='cpu')
    mref = MultiProblemDriver(SVMConfig(**MKW), parallel=True).fit_tasks(
        Xm, Y, C=CS)
    d = os.path.join(tmp, 'multi')
    mcfg = SVMConfig(checkpoint_dir=d, **MKW)
    with chaos.inject(chaos.FaultPlan(
            kill_at_dispatch=mref[0].stats.dispatches // 2)):
        try:
            MultiProblemDriver(mcfg, parallel=True).fit_tasks(Xm, Y, C=CS)
            raise SystemExit('multi kill did not fire')
        except chaos.InjectedKill:
            pass
    got = MultiProblemDriver(dataclasses.replace(mcfg, resume=True),
                             parallel=True).fit_tasks(Xm, Y, C=CS)
    for m in got:
        agreed(m)
    res['multi'] = dict(
        resumed_from=got[0].stats.resumed_from,
        iterations=[r['iterations'] for r in got[0].stats.per_problem],
        ref_iterations=[r['iterations'] for r in mref[0].stats.per_problem],
        bitwise=[bool(np.array_equal(bits(a.alpha), bits(b.alpha)))
                 for a, b in zip(got, mref)],
        obj=[[a.dual_objective(), b.dual_objective()]
             for a, b in zip(got, mref)])
    res['seconds']['multi'] = time.perf_counter() - t0


if 'multi' in parts:
    multi()
if rank == 0:
    print(json.dumps(res))
dist.destroy()
"""


# the groups of 4 ranks, one after the other, each under its own deadline
_GROUPS = ("dense", "ell,multi")


def _group(parts, tmp, env):
    """Rank 0's JSON for ``parts``; a timeout, or a rank that exits with an
    error, fails with the group, the rank and its stderr."""
    init = "file://" + str(tmp / f"pg-{parts}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), "4", init, str(tmp), parts],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=ROOT) for r in range(4)]
    deadline = time.monotonic() + TIMEOUT
    try:
        outs = []
        for r, p in enumerate(procs):
            try:
                outs.append(p.communicate(
                    timeout=max(1.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                tails = [q.communicate()[1][-1500:] for q in procs[r:]]
                pytest.fail(f"{parts}: rank {r} still running at the "
                            f"group's {TIMEOUT} s deadline; stderr of ranks "
                            f"{r}..: {tails}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"{parts}: rank {r} failed:\n{err[-3000:]}"
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("par_resume")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    got = {"seconds": {}}
    for parts in _GROUPS:
        res = _group(parts, tmp, env)
        got["seconds"].update(res.pop("seconds"))
        got.update(res)
    return got


@pytest.mark.parametrize("fmt", ["dense", "ell"])
def test_the_kill_fires_mid_schedule(runs, fmt):
    r = runs[fmt]
    assert r["converged"]
    assert r["steps"] and r["steps"][-1] < r["iterations"]
    assert r["killed_at"] >= 2


@pytest.mark.parametrize("m", [4, 2, 1])
@pytest.mark.parametrize("fmt", ["dense", "ell"])
def test_resume_on_m_devices(runs, fmt, m):
    """The reference's cross-count contract at every m, bitwise at the
    world size that saved the steps."""
    r = runs[fmt]
    got = r[str(m)]
    assert got["resumed_from"] == r["steps"][-1]
    assert got["iterations"] == r["iterations"]
    assert got["max_err"] <= 1e-5
    assert abs(got["obj"] - r["obj"]) <= 1e-4 * (1.0 + abs(r["obj"]))
    if m == 4:
        assert got["bitwise"] and got["obj"] == r["obj"]


def test_watchdog_verdict_is_agreed_over_the_ranks(runs):
    got = runs["dense"]["watchdog"]
    assert got["straggle_events"] >= 1
    assert got["steps"], "the agreed straggle did not force a save"
    assert got["bitwise"] and got["iterations"] == runs["dense"]["iterations"]


def test_sharded_multi_kill_mid_sweep_resumes_bitwise(runs):
    r = runs["multi"]
    assert 0 < r["resumed_from"] < sum(r["ref_iterations"])
    assert r["iterations"] == r["ref_iterations"]
    assert all(r["bitwise"])
    assert all(a == b for a, b in r["obj"])
