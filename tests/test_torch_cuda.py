"""Each hand-written CUDA kernel against its plain PyTorch version, and the
port's bitwise contracts of dense and ELL fits on the card, on a machine
with an NVIDIA GPU (marked ``cuda``; skips without one). Imports no JAX, so
it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda, ops, ref


def _inputs(n, d, seed):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, d)).astype(np.float32)
    sq = (X * X).sum(1).astype(np.float32)
    z2 = r.normal(size=(2, d)).astype(np.float32)
    return r, X, sq, z2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1000, 123), (4097, 37), (33, 300)])
def test_cuda_kernels_match_plain_versions(cuda_device, n, d):
    r, X, sq, z2 = _inputs(n, d, n)
    t = lambda a: torch.as_tensor(a, device=cuda_device)
    g = r.normal(size=n).astype(np.float32)
    c2 = r.normal(size=2).astype(np.float32)
    inv = 1 / 64
    before = dict(cuda.launches)
    torch.testing.assert_close(
        ops.kernel_rows2("rbf", t(X), t(sq), t(z2), inv),
        ref.kernel_rows2(t(X), t(sq), t(z2), inv), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(
        ops.fused_gamma_update("rbf", t(X), t(sq), t(g), t(z2), t(c2), inv),
        ref.gamma_update(t(X), t(sq), t(g), t(z2), t(c2), inv),
        rtol=1e-4, atol=1e-4)
    Z = t(r.normal(size=(77, d)).astype(np.float32))
    cf = t(np.abs(g))
    torch.testing.assert_close(ops.rbf_accumulate(t(X), t(sq), cf, Z, inv),
                               ref.rbf_accumulate(t(X), t(sq), cf, Z, inv),
                               rtol=1e-5, atol=1e-5)
    zz = t(np.stack([z2[1], z2[1]]))
    rows = ops.kernel_rows2("rbf", t(X), t(sq), zz, inv)
    assert torch.equal(rows[:, 0], rows[:, 1])
    assert all(cuda.launches[k] > before[k]
               for k in ("gamma_update", "rbf_rows2", "rbf_accumulate"))


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_tensors(cuda_device):
    from repro_torch.kernels import rbf_row
    X = torch.zeros((8, 4), device=cuda_device)
    with pytest.raises(TypeError):
        rbf_row.rbf_rows2(X.double(), X[:, 0], X[:2], 0.5)
    with pytest.raises(ValueError):
        rbf_row.rbf_rows2(X.t(), X[:, 0], X[:2], 0.5)
    with pytest.raises(ValueError):
        rbf_row.rbf_rows2(X, X[:4, 0], X[:2], 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("selection", ["wss1", "wss2"])
def test_cuda_fit_keeps_the_bitwise_contracts(cuda_device, selection):
    """On the card: device == host compaction, mirror == host
    reconstruction and fused == unfused epochs, bitwise; and the fit
    agrees with the CPU fit within the outcome contract."""
    from conftest import make_blobs
    from repro_torch.core import train
    X, y = make_blobs(n=800, d=5, sep=2.0, seed=6)
    kw = dict(C=2.0, sigma2=2.0, heuristic="single5pc", chunk_iters=64,
              min_buffer=64, recon_block=256, selection=selection)
    base = train(X, y, device="cuda", **kw)
    assert base.stats.compactions >= 1 and base.stats.reconstructions >= 1
    assert base.stats.mirror == "device"
    for other in (dict(compact_backend="host"), dict(mirror="host"),
                  dict(fuse_iters=4)):
        m = train(X, y, device="cuda", **kw, **other)
        assert m.stats.iterations == base.stats.iterations, other
        np.testing.assert_array_equal(m.alpha, base.alpha)
    cpu = train(X, y, device="cpu", **kw)
    assert cpu.stats.converged == base.stats.converged
    assert abs(cpu.dual_objective() - base.dual_objective()) \
        / abs(cpu.dual_objective()) < 5e-4
    assert (cpu.predict(X) == base.predict(X)).mean() >= 0.995


def _ell_inputs(n, K, d, seed):
    """Random block-ELL rows: each row packs a random number (<= K) of
    nonzeros at distinct random columns into a slot prefix; padding slots
    are (0.0, 0)."""
    r = np.random.default_rng(seed)
    ext = r.integers(0, K + 1, n)
    ext[0] = K                                   # one full row
    vals = np.zeros((n, K), np.float32)
    cols = np.zeros((n, K), np.int32)
    for i in range(n):
        k = int(ext[i])
        vals[i, :k] = r.normal(size=k)
        cols[i, :k] = r.choice(d, size=k, replace=False)
    sq = (vals * vals).sum(1).astype(np.float32)
    return r, vals, cols, sq


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,d", [(1000, 128, 300), (777, 13, 300),
                                   (513, 40, 20000)])
def test_cuda_ell_kernels_match_plain_versions(cuda_device, n, K, d):
    """w7a-like shape, a ragged lane budget (K = 13) and a width whose
    queries do not fit shared memory (global-gather branch of both
    kernels)."""
    r, vals, cols, sq = _ell_inputs(n, K, d, n + K)
    t = lambda a: torch.as_tensor(a, device=cuda_device)
    v, c, s = t(vals), t(cols), t(sq)
    # queries of norm ~ |x| keep K(z, x) well above 0 at every width
    z2 = t((r.normal(size=(2, d)) * np.sqrt(K / d)).astype(np.float32))
    g = r.normal(size=n).astype(np.float32)
    g[-3:] = np.inf                              # buffer padding rows
    g, c2 = t(g), t(r.normal(size=2).astype(np.float32))
    inv = 1 / 64
    before = dict(cuda.launches)
    torch.testing.assert_close(ops.ell_kernel_row(v, c, s, z2[0], inv),
                               ref.ell_kernel_row(v, c, s, z2[0], inv),
                               rtol=1e-5, atol=1e-6)
    rows = ops.ell_kernel_rows2(v, c, s, z2, inv)
    torch.testing.assert_close(rows, ref.ell_kernel_rows2(v, c, s, z2, inv),
                               rtol=1e-5, atol=1e-6)
    assert float(rows.min()) > 1e-3
    got = ops.ell_fused_gamma_update("rbf", v, c, s, g, z2, c2, inv)
    torch.testing.assert_close(got, ref.ell_gamma_update(v, c, s, g, z2, c2,
                                                         inv),
                               rtol=1e-4, atol=1e-4)
    assert torch.isinf(got[-3:]).all()
    # position symmetry: both slots and the one-query entry, bitwise
    zz = torch.stack([z2[1], z2[1]])
    same = ops.ell_kernel_rows2(v, c, s, zz, inv)
    swap = ops.ell_kernel_rows2(v, c, s, z2.flip(0).contiguous(), inv)
    assert torch.equal(same[:, 0], same[:, 1])
    assert torch.equal(swap[:, 0], rows[:, 1])
    assert torch.equal(swap[:, 1], rows[:, 0])
    assert torch.equal(ops.ell_kernel_row(v, c, s, z2[1], inv), same[:, 0])
    # accumulate: coef-0 padding rows add exactly 0
    cf = r.normal(size=n).astype(np.float32)
    cf[-7:] = 0.0
    dense = np.zeros((n, d), np.float32)
    np.add.at(dense, (np.repeat(np.arange(n), K), cols.reshape(-1)),
              vals.reshape(-1))
    Z = t((dense[r.permutation(n)[:70]]
           + np.sqrt(K / d) * r.normal(size=(70, d))).astype(np.float32))
    acc = ops.ell_rbf_accumulate(v, c, s, t(cf), Z, inv)
    want = ref.ell_rbf_accumulate(v, c, s, t(cf), Z, inv)
    assert float(want.abs().max()) > 0.1
    tol = 1e-5 * float(want.abs().max())
    torch.testing.assert_close(acc, want, rtol=1e-5, atol=tol)
    trim = ops.ell_rbf_accumulate(v[:-7].contiguous(), c[:-7].contiguous(),
                                  s[:-7].contiguous(), t(cf[:-7]), Z, inv)
    assert torch.equal(acc, trim)
    assert torch.equal(acc, ops.ell_rbf_accumulate(v, c, s, t(cf), Z, inv))
    for k in ("ell_kernel_row", "ell_kernel_rows2", "ell_gamma_update",
              "ell_rbf_accumulate"):
        assert cuda.launches[k] > before[k], k


@pytest.mark.cuda
def test_cuda_ell_wrappers_reject_bad_tensors(cuda_device):
    from repro_torch.kernels import sparse_ell
    v = torch.zeros((8, 4), device=cuda_device)
    c = torch.zeros((8, 4), dtype=torch.int32, device=cuda_device)
    s = torch.zeros(8, device=cuda_device)
    z2 = torch.zeros((2, 5), device=cuda_device)
    with pytest.raises(TypeError):
        sparse_ell.ell_kernel_rows2(v, c.long(), s, z2, 0.5)
    with pytest.raises(ValueError):
        sparse_ell.ell_kernel_rows2(v.t(), c, s, z2, 0.5)
    with pytest.raises(ValueError):
        sparse_ell.ell_kernel_rows2(v.cpu(), c, s, z2, 0.5)
    with pytest.raises(ValueError):
        sparse_ell.ell_kernel_row(v, c, s[:4], z2[0], 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("selection", ["wss1", "wss2"])
def test_cuda_ell_fit_keeps_the_bitwise_contracts(cuda_device, selection):
    """ELL on the card: device == host compaction, mirror == host
    reconstruction and fused == unfused epochs, bitwise, through the ELL
    kernels; and the fit agrees with the CPU fit within the outcome
    contract."""
    from repro_torch.core import train
    from repro_torch.data import make_sparse, to_csr
    X, y = make_sparse(900, 300, 0.05, seed=3, noise=0.05, label_noise=0.0,
                       margin=0.5)
    kw = dict(C=2.0, sigma2=40.0, heuristic="multi5pc", chunk_iters=64,
              min_buffer=64, recon_block=256, selection=selection,
              format="ell")
    cuda.reset_launches()
    base = train(to_csr(X), y, device="cuda", **kw)
    hot = "ell_gamma_update" if selection == "wss1" else "ell_kernel_rows2"
    assert cuda.launches[hot] > 0
    assert base.stats.compactions >= 1 and base.stats.reconstructions >= 1
    assert base.stats.mirror == "device"
    for other in (dict(compact_backend="host"), dict(mirror="host"),
                  dict(fuse_iters=4)):
        m = train(X, y, device="cuda", **kw, **other)
        assert m.stats.iterations == base.stats.iterations, other
        assert m.stats.buffer_K == base.stats.buffer_K, other
        np.testing.assert_array_equal(m.alpha, base.alpha)
    cpu = train(X, y, device="cpu", **kw)
    assert cpu.stats.converged == base.stats.converged
    assert abs(cpu.dual_objective() - base.dual_objective()) \
        / abs(cpu.dual_objective()) < 5e-4
    assert (cpu.predict(X) == base.predict(X)).mean() >= 0.995
    cuda.reset_launches()
    scores = base.decision_function(to_csr(X))
    assert cuda.launches["ell_rbf_accumulate"] > 0
    np.testing.assert_array_equal(scores, base.decision_function(X))
    host = base.decision_function_host(X)
    assert np.abs(host).max() > 0.5
    assert np.abs(scores - host).max() <= 1e-5 * np.abs(host).max()


_SKEWED = {}


def skewed_sparse():
    """A sparse set plus heavy easy rows (near-duplicates of wide-margin
    non-SVs with many tiny extra nonzeros): the heavy rows set the ingest
    K but are shrunk away early, so adaptive recompaction drops K. Built on
    the CPU (the heavy rows are picked by a CPU fit); shared with
    ``test_torch_sparse``."""
    if "data" in _SKEWED:
        return _SKEWED["data"]
    from repro_torch.core import train
    from repro_torch.data import make_sparse
    X, y = make_sparse(1200, 512, 0.02, seed=2, noise=0.05,
                       label_noise=0.0, margin=0.5)
    kw = dict(C=2.0, sigma2=80.0, heuristic="single5pc", chunk_iters=128,
              min_buffer=128)
    md = train(X, y, device="cpu", **kw)
    score = np.abs(md.decision_function(X))
    easy = np.flatnonzero(md.alpha == 0)
    heavy = easy[np.argsort(-score[easy])][:64]
    rng = np.random.default_rng(0)
    Xh = X[heavy].copy()
    for i in range(Xh.shape[0]):
        zero = np.flatnonzero(Xh[i] == 0)
        pick = rng.choice(zero, 200, replace=False)
        Xh[i, pick] = 1e-4 * rng.normal(size=200).astype(np.float32)
    _SKEWED["data"] = (np.vstack([X, Xh]), np.concatenate([y, y[heavy]]),
                       kw)
    return _SKEWED["data"]


@pytest.mark.cuda
def test_cuda_ell_adaptive_K_drops_and_keeps_the_contracts(cuda_device):
    """The adaptive lane budget drops at a device compaction in the middle
    of a fit on the card: the ELL kernels then run at the new live K.
    Device == host compaction bitwise, and adaptive K == fixed K (same
    iterations, alpha within 1e-6)."""
    from repro_torch.core import train
    from repro_torch.data import to_csr
    Xa, ya, kw = skewed_sparse()
    kw = dict(kw, format="ell")
    cuda.reset_launches()
    ma = train(to_csr(Xa), ya, device="cuda", **kw)
    assert cuda.launches["ell_gamma_update"] > 0
    assert ma.stats.converged and ma.stats.compactions >= 1
    ks = ma.stats.buffer_K
    assert any(b < a for a, b in zip(ks, ks[1:])), ks
    host = train(Xa, ya, device="cuda", compact_backend="host", **kw)
    assert host.stats.iterations == ma.stats.iterations
    assert host.stats.buffer_K == ks
    np.testing.assert_array_equal(host.alpha, ma.alpha)
    mf = train(Xa, ya, device="cuda", ell_adaptive=False, **kw)
    assert len(set(mf.stats.buffer_K)) == 1 and min(ks) < mf.stats.buffer_K[0]
    assert mf.stats.iterations == ma.stats.iterations
    np.testing.assert_allclose(mf.alpha, ma.alpha, atol=1e-6)
