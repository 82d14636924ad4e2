"""The port's sparse (block-ELL / CSR) slice on the CPU: its kernel plain
versions against the JAX reference's Pallas bodies (interpret mode), the
ELL kernel functions and data plane against the reference, the slice as a
whole against the reference (the outcome contract), ELL serving of a model
carried over from the reference, and the port's own bitwise contracts on
ELL storage. The CUDA kernels themselves are tested in
``test_torch_cuda.py``."""
import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.core import dataplane as jdp
from repro.core import kernel_fns as jkf
from repro.core import train as jtrain
from repro.data import sparse as jsp
from repro.data import synthetic as jsyn
from repro.kernels import rbf_row as jrr
from repro.kernels import sparse_ell as jse

from repro_torch import convert
from repro_torch.core import ServeEngine, SVMConfig, SMOSolver
from repro_torch.core import dataplane as tdp
from repro_torch.core import kernel_fns as tkf
from repro_torch.core import train as ttrain
from repro_torch.data import make, make_sparse
from repro_torch.data import sparse as tsp
from repro_torch.kernels import ops, ref

from test_torch_cuda import skewed_sparse
from test_torch_solver import eq9_gap

torch.set_num_threads(1)

SHRINKY = dict(C=2.0, sigma2=40.0, heuristic="multi5pc", chunk_iters=64,
               min_buffer=64, eps=1e-3, recon_block=256)


def fit(X, y, **kw):
    return ttrain(X, y, device="cpu", format="ell", **kw)


def _ell(n, d, density, seed):
    X, _ = make_sparse(n, d, density, seed=seed)
    e = tsp.to_ell(X)
    return X, e.vals, e.cols, e.sq_norms()


def _shrinky():
    return make_sparse(900, 300, 0.05, seed=3, noise=0.05, label_noise=0.0,
                       margin=0.5)


# ------------------------------------------------ kernel plain versions
# d = 300 (w7a's width); density 0.04 packs into K = 128, 0.5 into K = 256

@pytest.mark.parametrize("density,K", [(0.04, 128), (0.5, 256)])
def test_ell_rows_plain_match_reference(density, K):
    X, vals, cols, sq = _ell(512, 300, density, seed=K)
    assert vals.shape[1] == K
    r = np.random.default_rng(K)
    z2 = r.normal(size=(2, 300)).astype(np.float32)
    inv = np.float32(1 / 128)
    t = torch.as_tensor
    j = lambda a: jnp.asarray(a)
    want2 = np.asarray(jse.ell_kernel_rows2(j(vals), j(cols), j(sq), j(z2),
                                            jnp.float32(inv), block_m=128,
                                            interpret=True))
    got2 = ref.ell_kernel_rows2(t(vals), t(cols), t(sq), t(z2),
                                float(inv)).numpy()
    np.testing.assert_allclose(got2, want2, rtol=1e-5, atol=1e-6)
    want1 = np.asarray(jse.ell_kernel_row(j(vals), j(cols), j(sq), j(z2[1]),
                                          jnp.float32(inv), block_m=128,
                                          interpret=True))
    got1 = ref.ell_kernel_row(t(vals), t(cols), t(sq), t(z2[1]),
                              float(inv)).numpy()
    np.testing.assert_allclose(got1, want1, rtol=1e-5, atol=1e-6)
    # the plain two-row version is position-symmetric, bitwise
    zz = t(np.stack([z2[1], z2[1]]))
    rows = ref.ell_kernel_rows2(t(vals), t(cols), t(sq), zz, float(inv))
    assert torch.equal(rows[:, 0], rows[:, 1])
    sw = ref.ell_kernel_rows2(t(vals), t(cols), t(sq), t(z2[::-1].copy()),
                              float(inv)).numpy()
    np.testing.assert_array_equal(sw[:, ::-1], got2)


@pytest.mark.parametrize("density,K", [(0.04, 128), (0.5, 256)])
def test_ell_gamma_update_plain_matches_reference(density, K):
    _, vals, cols, sq = _ell(512, 300, density, seed=K + 1)
    r = np.random.default_rng(K + 1)
    z2 = r.normal(size=(2, 300)).astype(np.float32)
    g = r.normal(size=512).astype(np.float32)
    g[-5:] = np.inf                    # buffer padding rows stay +inf
    c2 = r.normal(size=2).astype(np.float32)
    inv = np.float32(0.05)
    want = np.asarray(jse.ell_gamma_update(
        *(jnp.asarray(a) for a in (vals, cols, sq, g, z2, c2)),
        jnp.float32(inv), block_m=128, interpret=True))
    got = ref.ell_gamma_update(*(torch.as_tensor(a) for a in
                                 (vals, cols, sq, g, z2, c2)),
                               float(inv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.isinf(got[-5:]).all()


@pytest.mark.parametrize("density,K", [(0.04, 128), (0.5, 256)])
def test_ell_rbf_accumulate_plain_matches_reference(density, K):
    X, vals, cols, sq = _ell(384, 300, density, seed=K + 2)
    r = np.random.default_rng(K + 2)
    coef = r.normal(size=384).astype(np.float32)
    coef[-17:] = 0.0                   # padding SV rows: exact zero
    Z = X[r.permutation(384)[:64]] + 0.01 * r.normal(size=(64, 300)) \
        .astype(np.float32)
    inv = np.float32(1 / 128)
    want = np.asarray(jrr.ell_rbf_accumulate(
        *(jnp.asarray(a) for a in (vals, cols, sq, coef, Z)),
        jnp.float32(inv), block_m=128, block_q=8, interpret=True))
    t = torch.as_tensor
    got = ref.ell_rbf_accumulate(t(vals), t(cols), t(sq), t(coef), t(Z),
                                 float(inv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    trimmed = ref.ell_rbf_accumulate(t(vals[:-17]), t(cols[:-17]),
                                     t(sq[:-17]), t(coef[:-17]), t(Z),
                                     float(inv)).numpy()
    np.testing.assert_array_equal(got, trimmed)
    # the SV blocking of the plain version does not move the fp64 sum
    small = ref.ell_rbf_accumulate(t(vals), t(cols), t(sq), t(coef), t(Z),
                                   float(inv), max_gather=64 * K * 7).numpy()
    np.testing.assert_allclose(small, got, rtol=1e-6, atol=1e-7)


def test_ell_ops_dispatch_plain_versions_on_cpu():
    X, vals, cols, sq = _ell(300, 50, 0.1, seed=5)
    r = np.random.default_rng(5)
    t = torch.as_tensor
    z2 = t(r.normal(size=(2, 50)).astype(np.float32))
    g = t(r.normal(size=300).astype(np.float32))
    c2 = t(r.normal(size=2).astype(np.float32))
    v, c, s = t(vals), t(cols), t(sq)
    inv = 0.2
    assert torch.equal(ops.ell_kernel_row(v, c, s, z2[0], inv),
                       ref.ell_kernel_row(v, c, s, z2[0], inv))
    assert torch.equal(ops.ell_kernel_rows2(v, c, s, z2, inv),
                       ref.ell_kernel_rows2(v, c, s, z2, inv))
    assert torch.equal(
        ops.ell_fused_gamma_update("rbf", v, c, s, g, z2, c2, inv),
        ref.ell_gamma_update(v, c, s, g, z2, c2, inv))
    Z = t(X[:40])
    assert torch.equal(ops.ell_rbf_accumulate(v, c, s, g, Z, inv),
                       ref.ell_rbf_accumulate(v, c, s, g, Z, inv))
    for kern in ("linear", "poly"):          # non-RBF: the plain rows
        rows = tkf.get_ell_rows2(kern)(v, c, s, z2, inv)
        assert torch.equal(
            ops.ell_fused_gamma_update(kern, v, c, s, g, z2, c2, inv),
            g + rows @ c2)
    # the ELL semantics agree with the dense kernel on the same data
    Xt = t(X)
    dense = tkf.rbf_rows2(Xt, (Xt * Xt).sum(1), z2, inv)
    torch.testing.assert_close(ref.ell_kernel_rows2(v, c, s, z2, inv),
                               dense, rtol=1e-4, atol=1e-5)


# ------------------------------------------------ ELL kernel functions

@pytest.mark.parametrize("kernel", ["rbf", "linear", "poly"])
def test_ell_dots_and_cross_kernel_match_reference(kernel):
    X, vals, cols, sq = _ell(200, 80, 0.1, seed=7)
    r = np.random.default_rng(7)
    z2 = r.normal(size=(2, 80)).astype(np.float32)
    Z = r.normal(size=(33, 80)).astype(np.float32)
    t, j = torch.as_tensor, jnp.asarray
    got = tkf.ell_dots2(t(vals), t(cols), t(z2)).numpy()
    want = np.asarray(jkf.ell_dots2(j(vals), j(cols), j(z2)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    zz = t(np.stack([z2[0], z2[0]]))
    d2 = tkf.ell_dots2(t(vals), t(cols), zz)
    assert torch.equal(d2[:, 0], d2[:, 1])            # position-symmetric
    np.testing.assert_allclose(
        tkf.ell_dots(t(vals), t(cols), t(z2[1])).numpy(),
        np.asarray(jkf.ell_dots(j(vals), j(cols), j(z2[1]))),
        rtol=1e-5, atol=1e-5)
    inv = 0.05
    got = tkf.ell_cross_kernel(kernel, t(Z), t(vals), t(cols), t(sq),
                               inv).numpy()
    want = np.asarray(jkf.ell_cross_kernel(kernel, j(Z), j(vals), j(cols),
                                           j(sq), inv))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    blocked = tkf.ell_cross_kernel(kernel, t(Z), t(vals), t(cols), t(sq),
                                   inv, max_gather=33 * 128 * 3).numpy()
    np.testing.assert_array_equal(blocked, got)
    for name in ("row", "rows2"):
        tf = getattr(tkf, f"get_ell_{name}")(kernel)
        jf = getattr(jkf, f"get_ell_{name}")(kernel)
        q = z2 if name == "rows2" else z2[0]
        np.testing.assert_allclose(
            tf(t(vals), t(cols), t(sq), t(q), inv).numpy(),
            np.asarray(jf(j(vals), j(cols), j(sq), j(q), inv)),
            rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("p", [1, 2, 4])
def test_ell_shard_extents_dyn_equals_static(p):
    r = np.random.default_rng(p)
    for M, K in ((37, 9), (256, 40)):
        vals = r.normal(size=(M, K)).astype(np.float32)
        ext = r.integers(0, K + 1, M)
        vals[np.arange(K)[None, :] >= ext[:, None]] = 0.0
        vals[r.random((M, K)) < 0.1] = 0.0              # explicit zeros
        keep = r.random(M) < 0.6
        n_act = int(keep.sum())
        m_per = max(1, -(-n_act // p)) + int(r.integers(0, 4))
        t = torch.as_tensor
        static = tdp.ell_shard_extents(t(vals), t(keep), n_act, p, m_per)
        dyn = tdp.ell_shard_extents_dyn(t(vals), t(keep),
                                        torch.tensor(n_act), p)
        np.testing.assert_array_equal(dyn.numpy(), static.numpy())
        want = np.asarray(jdp.ell_shard_extents(
            jnp.asarray(vals), jnp.asarray(keep), jnp.int32(n_act), p=p,
            m_per=m_per))
        np.testing.assert_array_equal(static.numpy(), want)
        np.testing.assert_array_equal(
            tdp.ell_extents(t(vals)).numpy(),
            np.asarray(jdp.ell_extents(jnp.asarray(vals))))
        np.testing.assert_array_equal(tdp.ell_extents(t(vals)).numpy(),
                                      tsp.ell_row_extent(vals))


@pytest.mark.parametrize("K_new", [None, 16, 40])
def test_ell_gather_rows_matches_reference(K_new):
    r = np.random.default_rng(3)
    M, K, p = 90, 40, 2
    vals = r.normal(size=(M, K)).astype(np.float32)
    vals[:, 16:] *= (r.random((M, 1)) < 0.3)         # most rows fit 16
    cols = r.integers(0, 70, (M, K)).astype(np.int32)
    cols[vals == 0] = 0
    sq = (vals * vals).sum(1)
    gids = np.arange(M)
    keep = (r.random(M) < 0.5) & (np.abs(vals[:, 16:]).sum(1) == 0) \
        if K_new == 16 else r.random(M) < 0.5
    n_act = int(keep.sum())
    m_per = -(-n_act // p) + 3
    t = torch.as_tensor
    src, valid = tdp.compact_plan(t(keep), n_act, p, m_per)
    got = tdp.gather_rows(tdp.ELLData(t(vals), t(cols), t(sq), 70, t(gids)),
                          src, valid, K_new)
    jsrc, jvalid = jdp.compact_plan(jnp.asarray(keep), jnp.int32(n_act), p,
                                    m_per)
    want = jdp.gather_rows(jdp.ELLData(jnp.asarray(vals), jnp.asarray(cols),
                                       jnp.asarray(sq), 70,
                                       jnp.asarray(gids, jnp.int32)),
                           jsrc, jvalid, K_new)
    for a in ("vals", "cols", "sq_norms", "gids"):
        np.testing.assert_array_equal(getattr(got, a).numpy(),
                                      np.asarray(getattr(want, a)))
    assert got.cols.dtype == torch.int32
    # dense working-set rows scatter exactly
    idx = torch.tensor([0, 5, 7])
    np.testing.assert_array_equal(
        got.dense_rows(idx).numpy(),
        np.stack([np.asarray(want.dense_row(i)) for i in (0, 5, 7)]))


def test_sparse_formats_and_make_sparse_are_byte_equal():
    for args in ((300, 200, 0.03, 1), (128, 64, 0.3, 2)):
        got, want = make_sparse(*args), jsyn.make_sparse(*args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    X = make_sparse(97, 150, 0.05, seed=4, margin=0.3)[0]
    assert jsyn.density(X) == __import__(
        "repro_torch.data", fromlist=["density"]).density(X)
    tc, jc = tsp.to_csr(X), jsp.to_csr(X)
    for a in ("data", "indices", "indptr"):
        assert getattr(tc, a).tobytes() == getattr(jc, a).tobytes()
    for K, lane in ((None, 128), (None, 8), (16, 8)):
        te, je = tsp.to_ell(X, K=K, lane=lane), jsp.to_ell(X, K=K, lane=lane)
        assert te.vals.tobytes() == je.vals.tobytes()
        assert te.cols.tobytes() == je.cols.tobytes()
        assert te.sq_norms().tobytes() == je.sq_norms().tobytes()
        np.testing.assert_array_equal(te.to_dense(), X)
    np.testing.assert_array_equal(tsp.csr_row_extent(tc),
                                  jsp.csr_row_extent(jc))
    assert tsp.csr_space_report(X) == jsp.csr_space_report(X)
    for k in range(0, 700, 13):
        for lane in (8, 128):
            assert tsp.round_lanes(k, lane) == jsp.round_lanes(k, lane)
            assert tsp.bucket_lanes(k, lane) == jsp.bucket_lanes(k, lane)
            assert tsp.bucket_lanes(k, lane, 256) == \
                jsp.bucket_lanes(k, lane, 256)
    tup = (tc.data, tc.indices, tc.indptr, tc.shape)
    assert tsp.is_csr_like(tup) and not tsp.is_csr_like(X[:4].tolist())
    np.testing.assert_array_equal(tsp.as_csr(tup).to_dense(), X)


def test_make_store_validates_and_builds_the_right_store():
    X, _ = _shrinky()
    csr = tsp.to_csr(X)
    assert isinstance(tdp.make_store(X, "ell"), tdp.ELLStore)
    st = tdp.make_store(csr, "ell", ell_K=100, ell_lane=32)
    assert isinstance(st, tdp.CSRStore) and st.K == 128
    assert isinstance(tdp.make_store(csr, "dense"), tdp.DenseStore)
    with pytest.raises(ValueError, match="ell_K"):
        tdp.make_store(X, "ell", ell_K=0)
    with pytest.raises(ValueError, match="exceeds"):
        tdp.make_store(csr, "ell", ell_K=8, ell_lane=8)
    with pytest.raises(ValueError, match="format"):
        tdp.make_store(X, "coo")

    class Csc:
        data, indices, indptr, shape, format = (csr.data, csr.indices,
                                                csr.indptr, csr.shape, "csc")
    with pytest.raises(TypeError, match="csc"):
        tdp.make_store(Csc(), "ell")
    # the same matrix through both ELL-family stores: identical buffers
    es, cs = tdp.make_store(X, "ell"), tdp.make_store(csr, "ell")
    rows = np.arange(0, 900, 7)
    for a, b in zip(es.ell_rows(rows), cs.ell_rows(rows)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(es.sq_rows(rows), cs.sq_rows(rows))
    np.testing.assert_array_equal(es.dense_rows(rows), X[rows])
    js = jdp.make_store(csr, "ell")
    np.testing.assert_array_equal(cs.sq_rows(rows), js.sq_rows(rows))
    assert cs.K == js.K and cs.buffer_K(rows) == js.buffer_K(rows)


# ------------------------------------------------ the slice as a whole

@pytest.mark.parametrize("heuristic", ["original", "multi5pc", "single5pc"])
@pytest.mark.parametrize("selection", ["wss1", "wss2"])
def test_ell_outcome_matches_reference(heuristic, selection):
    X, y = make_sparse(600, 400, 0.04, seed=0)
    C, s2, eps = 4.0, 4.0, 1e-3
    kw = dict(C=C, sigma2=s2, eps=eps, heuristic=heuristic,
              selection=selection, chunk_iters=64, format="ell")
    mt = ttrain(X, y, device="cpu", **kw)
    mj = jtrain(X, y, **kw)
    assert mt.stats.converged == mj.stats.converged
    assert mt.stats.buffer_K[0] == mj.stats.buffer_K[0]
    assert abs(mt.dual_objective() - mj.dual_objective()) \
        / abs(mj.dual_objective()) < 5e-4
    assert (mt.predict(X) == np.asarray(mj.predict(X))).mean() >= 0.995
    assert eq9_gap(X, y, mt.alpha, C, s2) <= 2 * eps


@pytest.mark.parametrize("heuristic", ["original", "multi5pc", "single5pc"])
@pytest.mark.parametrize("selection", ["wss1", "wss2"])
def test_ell_outcome_on_w7a_matches_reference(heuristic, selection):
    """w7a at scale 0.02; the main-path case (multi5pc, wss1) is fed as
    CSR."""
    csr = (heuristic, selection) == ("multi5pc", "wss1")
    X, y, Xt, yt = make("w7a", 0.02, seed=0)
    spec = jsyn.SPECS["w7a"]
    C, s2, eps = spec.C, spec.sigma2, 1e-3
    kw = dict(C=C, sigma2=s2, eps=eps, heuristic=heuristic,
              selection=selection, chunk_iters=128, format="ell")
    feed = tsp.to_csr(X) if csr else X
    mt = ttrain(feed, y, device="cpu", **kw)
    mj = jtrain(X, y, **kw)
    assert mt.stats.converged == mj.stats.converged
    assert mt.stats.buffer_K[0] == mj.stats.buffer_K[0] == 128
    assert abs(mt.dual_objective() - mj.dual_objective()) \
        / abs(mj.dual_objective()) < 5e-4
    assert (mt.predict(Xt) == np.asarray(mj.predict(Xt))).mean() >= 0.995
    assert eq9_gap(X, y, mt.alpha, C, s2) <= 2 * eps
    assert mt.sv_x is None and mt.sv_vals.shape[1] == 128


def test_converted_reference_ell_model_scores_like_reference():
    X, y = make_sparse(500, 300, 0.04, seed=21)
    Z, _ = make_sparse(300, 300, 0.04, seed=22)
    mj = jtrain(X, y, C=4.0, sigma2=4.0, heuristic="multi5pc",
                format="ell")
    want = np.asarray(mj.decision_function(Z))
    mt = convert.ell_model(mj.sv_vals, mj.sv_cols, mj.n_features,
                           mj.sv_coef, mj.beta, mj.alpha,
                           dataclasses.asdict(mj.config), device="cpu")
    got = ServeEngine(mt, device="cpu").decision_function(Z)
    assert np.abs(want).max() > 0.5
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    np.testing.assert_allclose(mt.decision_function_host(Z), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert abs(mt.dual_objective() - mj.dual_objective()) \
        / abs(mj.dual_objective()) < 1e-5


# ------------------------------------------------ bitwise contracts (port)

@pytest.mark.parametrize("selection", ["wss1", "wss2"])
def test_ell_device_compaction_equals_host_bitwise(selection):
    X, y = _shrinky()
    kw = dict(selection=selection, **SHRINKY)
    md = fit(X, y, compact_backend="device", **kw)
    mh = fit(X, y, compact_backend="host", **kw)
    assert md.stats.compactions >= 1 and md.stats.reconstructions >= 1
    assert md.stats.iterations == mh.stats.iterations
    np.testing.assert_array_equal(md.alpha, mh.alpha)
    assert md.stats.buffer_sizes == mh.stats.buffer_sizes
    assert md.stats.buffer_K == mh.stats.buffer_K
    assert md.stats.shard_K == mh.stats.shard_K
    assert md.beta == mh.beta


@pytest.mark.parametrize("selection", ["wss1", "wss2"])
def test_ell_mirror_reconstruction_equals_host_bitwise(selection):
    X, y = _shrinky()
    kw = dict(selection=selection, **SHRINKY)
    md = fit(X, y, mirror="device", **kw)
    mh = fit(X, y, mirror="host", **kw)
    assert (md.stats.mirror, mh.stats.mirror) == ("device", "host")
    assert md.stats.reconstructions >= 1
    assert md.stats.reconstructions == mh.stats.reconstructions
    assert md.stats.iterations == mh.stats.iterations
    np.testing.assert_array_equal(md.alpha, mh.alpha)
    assert md.stats.final_gap == mh.stats.final_gap
    assert md.beta == mh.beta


@pytest.mark.parametrize("heuristic", ["multi5pc", "original"])
def test_ell_fused_epoch_equals_unfused_bitwise(heuristic):
    X, y = _shrinky()
    kw = dict(SHRINKY, heuristic=heuristic, chunk_iters=16)
    m1 = fit(X, y, fuse_iters=1, **kw)
    m4 = fit(X, y, fuse_iters=4, **kw)
    assert m4.stats.dispatches < m1.stats.dispatches
    assert m4.stats.iterations == m1.stats.iterations
    assert m4.stats.compactions == m1.stats.compactions
    assert m4.stats.buffer_K == m1.stats.buffer_K
    np.testing.assert_array_equal(m4.alpha, m1.alpha)
    assert m4.beta == m1.beta


def test_ellstore_equals_csrstore_ingest_with_explicit_zeros():
    """Dense input (``ELLStore``) and CSR input (``CSRStore``) train the
    same bits; a CSR with explicitly stored zeros measures its extents by
    trailing nonzeros, like the device scan, so device and host
    compaction pick the same lane buckets."""
    X, y = _shrinky()
    me = fit(X, y, **SHRINKY)
    s = SMOSolver(SVMConfig(format="ell", device="cpu", **SHRINKY))
    mc = s.fit(tsp.to_csr(X), y)
    assert isinstance(s._store, tdp.CSRStore)
    assert not hasattr(s._store, "X")
    assert mc.stats.iterations == me.stats.iterations
    np.testing.assert_array_equal(mc.alpha, me.alpha)
    np.testing.assert_array_equal(mc.sv_vals, me.sv_vals)
    np.testing.assert_array_equal(mc.sv_cols, me.sv_cols)
    csr = tsp.to_csr(X)
    data = csr.data.copy()
    data[np.random.default_rng(0).random(data.size) < 0.3] = 0.0
    zcsr = tsp.CSRMatrix(data, csr.indices, csr.indptr, csr.shape)
    store = tdp.CSRStore(zcsr)
    rows = np.arange(zcsr.shape[0])
    buf = store.alloc(rows.size, store.K)
    store.fill(buf, slice(0, rows.size), rows)
    np.testing.assert_array_equal(
        store.row_extent, tdp.ell_extents(torch.as_tensor(buf[0])).numpy())
    md = fit(zcsr, y, **SHRINKY)
    mh = fit(zcsr, y, compact_backend="host", **SHRINKY)
    assert md.stats.compactions >= 1
    assert md.stats.iterations == mh.stats.iterations
    np.testing.assert_array_equal(md.alpha, mh.alpha)
    assert md.stats.buffer_K == mh.stats.buffer_K
    assert md.stats.shard_K == mh.stats.shard_K


def test_csr_queries_equal_dense_queries_in_the_engine():
    X, y = _shrinky()
    m = fit(X, y, **SHRINKY)
    Z = X[::3]
    eng = m.serve_engine()
    dense = eng.decision_function(Z)
    csr = tsp.to_csr(Z)
    np.testing.assert_array_equal(eng.decision_function(csr), dense)
    np.testing.assert_array_equal(
        eng.decision_function((csr.data, csr.indices, csr.indptr,
                               csr.shape)), dense)
    assert np.abs(dense).max() > 0.5
    np.testing.assert_allclose(dense, m.decision_function_host(Z),
                               rtol=1e-4, atol=2e-5)
    np.testing.assert_array_equal(m.decision_function_host(csr),
                                  m.decision_function_host(Z))
    d = eng.describe()
    assert d["fmt"] == "ell" and d["K"] == m.sv_vals.shape[1]
    assert d["memory_bytes"] == eng.memory_bytes() == \
        d["m_pad"] * (8 * d["K"] + 8)
    c = m.compact()
    assert c.sv_x is None and c.sv_vals.shape[0] <= m.sv_vals.shape[0]
    np.testing.assert_allclose(c.decision_function(Z), dense, rtol=1e-5,
                               atol=1e-5)


def test_row_via_rows2_equals_either_slot_and_row_provider():
    X, vals, cols, sq = _ell(500, 300, 0.04, seed=9)
    t = torch.as_tensor
    data = tdp.ELLData(t(vals), t(cols), t(sq), 300)
    prov = tkf.make_provider("rbf", "ell", True, 1 / 128)
    assert isinstance(prov, tkf.ELLKernelRowProvider)
    z2 = data.dense_rows(torch.tensor([3, 77]))
    np.testing.assert_array_equal(z2.numpy(), X[[3, 77]])
    rows = prov.rows2(data, z2)
    swap = prov.rows2(data, z2.flip(0).contiguous())
    for j in (0, 1):
        single = tkf.row_via_rows2(prov, data, z2[j])
        assert torch.equal(single, rows[:, j])
        assert torch.equal(single, swap[:, 1 - j])
    torch.testing.assert_close(prov.row(data, z2[0]), rows[:, 0],
                               rtol=1e-6, atol=1e-7)
    assert torch.equal(prov.row(data, z2[0]),
                       ref.ell_kernel_row(data.vals, data.cols,
                                          data.sq_norms, z2[0], 1 / 128))
    assert torch.equal(prov.diag(data), torch.ones(500))
    plain = tkf.make_provider("rbf", "ell", False, 1 / 128)
    torch.testing.assert_close(plain.rows2(data, z2), rows, rtol=1e-6,
                               atol=1e-7)


def test_adaptive_K_drops_at_compaction_and_matches_fixed_K():
    Xa, ya, kw = skewed_sparse()
    nnz = (Xa != 0).sum(axis=1)
    assert nnz.max() > 128 >= 4 * nnz.min()
    ma = fit(Xa, ya, **kw)
    assert ma.stats.converged and ma.stats.compactions >= 1
    ks = ma.stats.buffer_K
    assert len(ks) == len(ma.stats.buffer_sizes)
    assert any(b < a for a, b in zip(ks, ks[1:])), ks
    assert all(k % 128 == 0 for k in ks)
    for per_shard in ma.stats.shard_K:
        assert max(per_shard) <= max(ks)
    mf = fit(Xa, ya, ell_adaptive=False, **kw)
    assert ma.stats.iterations == mf.stats.iterations
    np.testing.assert_allclose(ma.alpha, mf.alpha, atol=1e-6)
    assert len(set(mf.stats.buffer_K)) == 1
    assert min(ks) < mf.stats.buffer_K[0]
