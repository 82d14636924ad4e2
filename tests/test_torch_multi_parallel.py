"""The port's sharded batched multi-problem runner
(``core.parallel.make_parallel_multi_runner``, reached through
``MultiProblemDriver(parallel=True)``) on a gloo process group of 4 CPU
processes, against the reference's sharded multi fit on a 4-device host
mesh and against the port's single-device batched fit of the same
problems.

One module fixture starts the 4 ranks (each asserts that its trained
alphas equal rank 0's; rank 0 prints the results as JSON) and the
reference (``repro.core.MultiProblemDriver(parallel=True)`` under
``--xla_force_host_platform_device_count=4``) as subprocesses and, while
they run, fits the same problems on one device in this process. The
inputs — the reference's multi-problem set (``tests/test_multi.py``: N 384
x D 24, 4 points of its C grid, fuse 4; and a 3-class one-vs-rest set) —
are made from a seed with numpy and handed to both packages in one
``.npz`` file. The tests then hold, per problem and through
reconstruction and un-shrink:

* port P = 4 vs reference P = 4, dense and ELL: the reference's own
  contract for its sharded runner (``tests/test_distributed.py``:
  iterations equal, alpha within 1e-5, dual objective within 1e-4) and
  the outcome contract (verdict, labels on >= 99.5% of the points, the
  fp64 Eq. 9 gap <= 2 eps); one-vs-rest, the outcome contract per class
  and the voted classes;
* port P = 4 vs one device, dense: bitwise (alpha bits, iterations,
  reconstructions);
* ELL: at least the reference's own contract for its sharded runner
  (``tests/test_distributed.py``: iterations equal, alpha within 1e-5,
  dual objective within 1e-4), and bitwise, since the port's ELL rows do
  not depend on the buffer they are computed in;
* one-vs-rest through the group, its union engine against the single
  device's scores.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300          # seconds, for every subprocess
EPS = 1e-3
KW = dict(C=1.0, sigma2=4.0, eps=1e-3, heuristic="multi5pc", chunk_iters=64,
          fuse_iters=4, min_buffer=64, selection="wss1", ell_lane=16,
          device="cpu")
CS = np.geomspace(0.5, 8.0, 4)


def _inputs(path):
    rng = np.random.default_rng(7)
    n, d = 384, 24
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[rng.random(X.shape) < 0.5] = 0.0
    w = rng.normal(size=d)
    s = X @ w + 0.4 * rng.normal(size=n)
    y = np.where(s > np.median(s), 1.0, -1.0).astype(np.float32)
    r = np.random.default_rng(11)
    Xm = r.normal(size=(180, 12)).astype(np.float32)
    wm = r.normal(size=(12, 3))
    ym = np.argmax(Xm @ wm + 0.5 * r.normal(size=(180, 3)), axis=1)
    np.savez(path, X=X, y=y, Xm=Xm, ym=ym.astype(np.int32))
    return np.load(path)


_RANK = """
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.launch import dist
from repro_torch.core import MultiProblemDriver, SVMConfig

rank, world, init, npz = sys.argv[1:5]
dist.init(device='cpu', init_method=init, rank=int(rank), world=int(world))
D = np.load(npz)
X, y, Cs = D['X'], D['y'], np.geomspace(0.5, 8.0, 4)
Y = np.broadcast_to(y, (4, y.size)).copy()
res = {}


def agree(alpha):
    got = dist.all_gather(torch.as_tensor(alpha.view(np.int32)))
    assert bool((got == got[0]).all()), 'ranks returned different alphas'


for fmt in ('dense', 'ell'):
    drv = MultiProblemDriver(SVMConfig(format=fmt, **%(kw)r), parallel=True)
    ms = drv.fit_tasks(X, Y, C=Cs)
    for m in ms:
        agree(m.alpha)
    st = ms[0].stats
    res[fmt] = dict(alpha=[m.alpha.view(np.int32).tolist() for m in ms],
                    obj=[m.dual_objective() for m in ms],
                    labels=[m.predict(X).tolist() for m in ms],
                    per=st.per_problem, buffer_sizes=st.buffer_sizes,
                    compactions=st.compactions, converged=st.converged,
                    joint=st.joint_iters)
ovr = MultiProblemDriver(SVMConfig(**%(kw)r), parallel=True).fit_ovr(
    D['Xm'], D['ym'])
res['ovr'] = dict(scores=ovr.decision_matrix(D['Xm']).tolist(),
                  alpha=[m.alpha.view(np.int32).tolist()
                         for m in ovr.models],
                  obj=[m.dual_objective() for m in ovr.models],
                  per=ovr.models[0].stats.per_problem)
if int(rank) == 0:
    print(json.dumps(res))
dist.destroy()
""" % dict(kw=KW)

_REFERENCE = """
import json, sys
import numpy as np
from repro.core import MultiProblemDriver, SVMConfig

D = np.load(sys.argv[1])
X, y, Cs = D['X'], D['y'], np.geomspace(0.5, 8.0, 4)
Y = np.broadcast_to(y, (4, y.size)).copy()
kw = {k: v for k, v in %(kw)r.items() if k != 'device'}
res = {}
for fmt in ('dense', 'ell'):
    ms = MultiProblemDriver(SVMConfig(format=fmt, **kw),
                            parallel=True).fit_tasks(X, Y, C=Cs)
    res[fmt] = dict(
        alpha=[np.asarray(m.alpha).tolist() for m in ms],
        obj=[float(m.dual_objective()) for m in ms],
        labels=[np.asarray(m.predict(X)).tolist() for m in ms],
        iterations=[int(r['iterations']) for r in ms[0].stats.per_problem],
        converged=[bool(r['converged']) for r in ms[0].stats.per_problem])
ovr = MultiProblemDriver(SVMConfig(**kw), parallel=True).fit_ovr(
    D['Xm'], D['ym'])
res['ovr'] = dict(
    scores=np.asarray(ovr.decision_matrix(D['Xm'])).tolist(),
    obj=[float(m.dual_objective()) for m in ovr.models],
    converged=[bool(r['converged'])
               for r in ovr.models[0].stats.per_problem])
print(json.dumps(res))
""" % dict(kw=KW)


def _eq9_gap(X, y, alpha, C, sigma2):
    """beta_low - beta_up over all samples on fp64 gamma, with the
    solver's at-bound thresholds."""
    from repro_torch.core import smo
    X = X.astype(np.float64)
    sq = (X * X).sum(1)
    K = np.exp(-np.maximum(sq[:, None] - 2 * X @ X.T + sq[None, :], 0)
               / (2 * sigma2))
    g = K @ (alpha.astype(np.float64) * y) - y
    thr0, thr1 = smo.bounds(C)
    in_up = np.where(y > 0, alpha < thr1, alpha > thr0)
    in_low = np.where(y > 0, alpha > thr0, alpha < thr1)
    return g[in_low].max() - g[in_up].min()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(sharded results of rank 0, single-device fits, inputs, the
    reference's sharded results), made once."""
    from repro_torch.core import MultiProblemDriver, SVMConfig
    tmp = tmp_path_factory.mktemp("multi_par")
    D = _inputs(tmp / "inputs.npz")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    init = "file://" + str(tmp / "pg")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK, str(r), "4", init,
         str(tmp / "inputs.npz")], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
        for r in range(4)]
    ref = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE, str(tmp / "inputs.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(env, JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        cwd=ROOT)
    try:
        single = {}
        Y = np.broadcast_to(D["y"], (4, D["y"].size)).copy()
        for fmt in ("dense", "ell"):
            single[fmt] = MultiProblemDriver(
                SVMConfig(format=fmt, **KW)).fit_tasks(D["X"], Y, C=CS)
        single["ovr"] = MultiProblemDriver(SVMConfig(**KW)).fit_ovr(
            D["Xm"], D["ym"])
        outs = [p.communicate(timeout=TIMEOUT) for p in procs + [ref]]
    finally:
        for p in procs + [ref]:
            if p.poll() is None:
                p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs + [ref], outs)):
        who = f"rank {r}" if r < len(procs) else "the reference"
        assert p.returncode == 0, f"{who} failed:\n{err[-3000:]}"
    last = lambda out: json.loads(out.strip().splitlines()[-1])
    return last(outs[0][0]), single, D, last(outs[-1][0])


def _check(res, ms, bitwise):
    for k, m in enumerate(ms):
        rec, solo = res["per"][k], m.stats.per_problem[k]
        assert rec["iterations"] == solo["iterations"], k
        assert rec["reconstructions"] == solo["reconstructions"], k
        got = np.asarray(res["alpha"][k], np.int32)
        if bitwise:
            assert np.array_equal(got, m.alpha.view(np.int32)), k
        np.testing.assert_allclose(got.view(np.float32), m.alpha, atol=1e-5)
        ro = m.dual_objective()
        assert abs(res["obj"][k] - ro) < 1e-4 * (1.0 + abs(ro)), k
    assert res["converged"] and ms[0].stats.converged


def test_sharded_multi_dense_equals_single_device_bitwise(runs):
    res, single, _, _ = runs
    _check(res["dense"], single["dense"], bitwise=True)
    # the sharded buffer stays whole: shrinking is logical only
    assert res["dense"]["compactions"] == 0
    assert len(set(res["dense"]["buffer_sizes"])) == 1


def test_sharded_multi_ell_equals_single_device(runs):
    res, single, _, _ = runs
    _check(res["ell"], single["ell"], bitwise=True)


def test_sharded_ovr_scores_equal_single_device(runs):
    res, single, D, _ = runs
    ovr = single["ovr"]
    for k, m in enumerate(ovr.models):
        assert np.array_equal(np.asarray(res["ovr"]["alpha"][k], np.int32),
                              m.alpha.view(np.int32)), k
    np.testing.assert_array_equal(np.asarray(res["ovr"]["scores"],
                                             np.float32),
                                  ovr.decision_matrix(D["Xm"]))


@pytest.mark.parametrize("fmt", ["dense", "ell"])
def test_sharded_multi_matches_reference(runs, fmt):
    res, _, D, ref = runs
    port, ref = res[fmt], ref[fmt]
    X, y = D["X"], D["y"]
    for k in range(len(CS)):
        # the reference's contract for its sharded runner
        assert res[fmt]["per"][k]["iterations"] == ref["iterations"][k], k
        alpha = np.asarray(port["alpha"][k], np.int32).view(np.float32)
        np.testing.assert_allclose(alpha, np.asarray(ref["alpha"][k]),
                                   atol=1e-5)
        ro = ref["obj"][k]
        assert abs(port["obj"][k] - ro) < 1e-4 * (1.0 + abs(ro)), k
        # the outcome contract
        assert port["per"][k]["converged"] == ref["converged"][k], k
        agree = np.mean(np.asarray(port["labels"][k])
                        == np.asarray(ref["labels"][k]))
        assert agree >= 0.995, (k, agree)
        assert _eq9_gap(X, y, alpha, CS[k], KW["sigma2"]) <= 2 * EPS, k


def test_sharded_ovr_matches_reference(runs):
    res, _, D, ref = runs
    port, ref = res["ovr"], ref["ovr"]
    X, ym = D["Xm"], D["ym"]
    classes = np.unique(ym)
    ps, rs = np.asarray(port["scores"]), np.asarray(ref["scores"])
    for k, c in enumerate(classes):
        y = np.where(ym == c, 1.0, -1.0)
        assert port["per"][k]["converged"] == ref["converged"][k], k
        ro = ref["obj"][k]
        assert abs(port["obj"][k] - ro) / abs(ro) <= 5e-4, k
        agree = np.mean(np.sign(ps[:, k]) == np.sign(rs[:, k]))
        assert agree >= 0.995, (k, agree)
        alpha = np.asarray(port["alpha"][k], np.int32).view(np.float32)
        assert _eq9_gap(X, y, alpha, KW["C"], KW["sigma2"]) <= 2 * EPS, k
    assert np.mean(ps.argmax(1) == rs.argmax(1)) >= 0.995
