"""Each hand-written CUDA kernel against its plain PyTorch version, on a
machine with an NVIDIA GPU (marked ``cuda``; skips without one). Imports no
JAX, so it also runs where only PyTorch is installed:

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
    assert all(cuda.launches[k] > before[k] for k in before)


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
