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


# -- flash attention (LM serving) ------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_cuda_flash_attention_matches_plain(cuda_device, dh, dtype):
    """Each head-dim instance, fp32 and bf16, GQA, at ragged lengths (not
    a multiple of the 64-row tiles), causal and not; the launch counter
    moves with every launch."""
    g = torch.Generator(device=cuda_device).manual_seed(dh)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    for B, H, Hkv, Lq, Lk, causal in [(2, 8, 2, 77, 77, True),
                                      (1, 4, 4, 200, 200, True),
                                      (2, 4, 1, 130, 67, False)]:
        mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device).to(
            dtype)
        q, k, v = mk(B, H, Lq, dh), mk(B, Hkv, Lk, dh), mk(B, Hkv, Lk, dh)
        before = cuda.launches["flash_attention"]
        got = ops.flash_attention(q, k, v, causal)
        assert cuda.launches["flash_attention"] == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        torch.testing.assert_close(got.float(),
                                   ref.flash_attention(q, k, v,
                                                       causal).float(),
                                   rtol=tol, atol=tol)


@pytest.mark.cuda
def test_cuda_flash_attention_rejects_bad_tensors(cuda_device):
    from repro_torch.kernels import flash_attention as fa
    q = torch.zeros(1, 4, 32, 64, device=cuda_device)
    k = torch.zeros(1, 2, 32, 64, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :8].contiguous(), k[..., :8].contiguous(),
                           k[..., :8].contiguous())
    with pytest.raises(ValueError, match="Lq == Lk"):
        ops.flash_attention(q, k[:, :, :16].contiguous(),
                            k[:, :, :16].contiguous(), causal=True)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3),
                           k, k)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q.cpu(), k.cpu(), k.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "qwen1.5-32b", "pixtral-12b"])
def test_cuda_forward_flash_equals_plain(cuda_device, arch, monkeypatch):
    """A smoke-config forward on the card through the flash kernel equals
    the plain attention path (fp32, ``ref.mha`` swapped in for the
    reference), and prefill launches the kernel once per layer."""
    from repro_torch import configs
    from repro_torch.models import common
    from repro_torch.models.api import build
    cfg = configs.smoke_config(arch)
    model = build(cfg)
    params = model.init(cfg, torch.Generator(device=cuda_device).manual_seed(0))
    r = np.random.default_rng(0)
    if cfg.frontend == "embeds":
        batch = {"embeds": torch.as_tensor(r.normal(size=(2, 40, cfg.d_model))
                                           .astype(np.float32),
                                           device=cuda_device)}
    else:
        batch = {"tokens": torch.as_tensor(
            r.integers(0, cfg.vocab_size, (2, 40)), device=cuda_device)}
    cuda.reset_launches()
    got, _ = model.forward(params, cfg, batch)
    assert cuda.launches["flash_attention"] == cfg.n_layers
    with monkeypatch.context() as m:
        m.setattr(common, "attention",
                  lambda q, k, v, causal=True: ref.mha(q, k, v, causal))
        plain, _ = model.forward(params, cfg, batch)
    assert cuda.launches["flash_attention"] == cfg.n_layers
    torch.testing.assert_close(got, plain, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_serve_cli_launches_flash_attention(cuda_device):
    """The serving CLI on the card (its default device) runs the prefill's
    attention through the kernel, once per layer, with the arch's config
    as it is (no option turns the kernel on)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    cfg = configs.smoke_config("llama3-8b")
    cuda.reset_launches()
    res = serve.main(["--arch", "llama3-8b", "--tokens", "4", "--batch", "2"])
    assert res["tokens"].device.type == "cuda"
    assert cuda.launches["flash_attention"] == cfg.n_layers


# -- the redesigned bodies: bf16 flash on the tensor cores, the dense row
# stream ----------------------------------------------------------------------

_FA_TILE_CASES = [
    # (B, H, Hkv, Lq, Lk, causal): lengths on both sides of the 128-row
    # query and key tiles, GQA groups 1, 4 and 8, B*H*q-tiles over one wave
    (1, 8, 8, 1, 1, True),
    (2, 8, 2, 63, 63, True),
    (1, 8, 1, 127, 127, True),
    (4, 64, 16, 129, 129, True),
    (1, 8, 2, 1000, 1000, True),
    (2, 4, 1, 130, 67, False),
    (1, 8, 2, 64, 300, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_cuda_flash_attention_bf16_crosses_the_tiles(cuda_device, dh):
    """The bf16 body (wgmma products, TMA-fed K/V ring) against the plain
    version at lengths that cross its 128-row query and key tiles, each
    head dim, GQA groups 1 / 4 / 8, causal and not; two launches on the
    same inputs give identical bits. Tolerance: the smoke's bf16 one (rtol
    2e-2, the reference's, atol 2e-3)."""
    g = torch.Generator(device=cuda_device).manual_seed(100 + dh)
    for B, H, Hkv, Lq, Lk, causal in _FA_TILE_CASES:
        mk = lambda *s: torch.randn(*s, generator=g, device=cuda_device).to(
            torch.bfloat16)
        q, k, v = mk(B, H, Lq, dh), mk(B, Hkv, Lk, dh), mk(B, Hkv, Lk, dh)
        got = ops.flash_attention(q, k, v, causal)
        torch.testing.assert_close(
            got.float(), ref.flash_attention(q, k, v, causal).float(),
            rtol=2e-2, atol=2e-3, msg=lambda m: f"{(B, H, Hkv, Lq, Lk, causal)}: {m}")
        assert torch.equal(ops.flash_attention(q, k, v, causal), got)
    from repro_torch.kernels import flash_attention as fa
    flat = torch.zeros(q.numel() + 1, device=cuda_device,
                       dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(flat[1:].view(q.shape), k, v, False)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1001, 1), (1001, 3), (4097, 123),
                                 (1001, 300), (301, 16384)])
def test_cuda_rbf_row_stream_matches_plain_and_is_symmetric(cuda_device, n,
                                                            d):
    """The dense row/gamma body (a cp.async ring of R-row tiles of X) at N
    not a multiple of its tile rows and widths from 1 to 16,384 (one row
    per tile): rows within 1e-5 / 1e-6 and gamma within 1e-4 of the plain
    versions; the columns bitwise position-symmetric; the single-row path
    (``row_via_rows2``: rows2([z, z])[:, 0]) bitwise equal to the same row
    made in either slot of a pair; and the same bits from a copy of X at a
    misaligned address (4-byte copies instead of 16-byte ones). Rows and
    queries are scaled to |x|^2 ~ 16 at every width, so K stays well above
    0 without a query near a row: there |x|^2 - 2<x, z> + |z|^2 cancels in
    fp32 whatever the summation order (at d = 16,384, ~1e-4 of K)."""
    from repro_torch.core import dataplane, kernel_fns
    r, X, _, z2 = _inputs(n, d, n + d)
    scale = np.float32(4.0 / np.sqrt(d))
    X, z2 = X * scale, z2 * scale
    t = lambda a: torch.as_tensor(a, device=cuda_device)
    X, sq, z2 = t(X), t((X * X).sum(1).astype(np.float32)), t(z2)
    g, c2 = t(r.normal(size=n).astype(np.float32)), t(
        r.normal(size=2).astype(np.float32))
    inv = 1 / 64
    rows = ops.kernel_rows2("rbf", X, sq, z2, inv)
    torch.testing.assert_close(rows, ref.kernel_rows2(X, sq, z2, inv),
                               rtol=1e-5, atol=1e-6)
    assert float(rows.max()) > 1e-3
    torch.testing.assert_close(
        ops.fused_gamma_update("rbf", X, sq, g, z2, c2, inv),
        ref.gamma_update(X, sq, g, z2, c2, inv), rtol=1e-4, atol=1e-4)
    swap = ops.kernel_rows2("rbf", X, sq, z2.flip(0).contiguous(), inv)
    assert torch.equal(swap[:, 0], rows[:, 1])
    assert torch.equal(swap[:, 1], rows[:, 0])
    provider = kernel_fns.make_provider("rbf", "dense", True, inv)
    single = kernel_fns.row_via_rows2(provider, dataplane.DenseData(X, sq),
                                      z2[1])
    assert torch.equal(single, rows[:, 1])
    assert torch.equal(single, swap[:, 0])
    shifted = torch.empty(n * d + 1, device=cuda_device)
    shifted[1:] = X.reshape(-1)
    assert torch.equal(ops.kernel_rows2("rbf", shifted[1:].view(n, d), sq,
                                        z2, inv), rows)


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,d", [(1001, 1, 1), (1001, 4, 300),
                                   (1001, 13, 300), (4097, 16, 300),
                                   (1001, 40, 20000), (1001, 128, 300),
                                   (777, 130, 300), (301, 128, 20000),
                                   (333, 13, 1), (40, 30000, 40000)])
def test_cuda_ell_row_stream_matches_plain_and_is_symmetric(cuda_device, n,
                                                            K, d):
    """The block-ELL row/gamma body (16-byte chunks of vals, the cols of the
    nonzero ones) at N not a multiple of its rows a pass, lane budgets K
    from 1 to 130 (16- and 4-byte loads, 1 to 8 lanes a row) and 30,000
    (rows of many rounds of chunks), and widths from 1 to 40,000 (queries
    in shared memory or gathered from global): all three entries
    within the plain versions' tolerances; the columns bitwise
    position-symmetric; the one-query entry, ``ELLKernelRowProvider.row``
    and ``row_via_rows2`` bitwise equal to the same row made in either
    slot; the same rows packed at a larger K' = K + 17 and a copy of vals
    at a misaligned address give the same bits; +inf gamma padding rows
    stay +inf. Rows (a random slot prefix each, columns repeated only where
    K > d) and queries are scaled to |x|^2 <= ~16, so the distance does not
    cancel in fp32."""
    from repro_torch.core import dataplane, kernel_fns
    r = np.random.default_rng(n + K + d)
    ext = r.integers(0, K + 1, n)
    ext[0] = K                                   # one full row
    wide_v = np.zeros((n, K + 17), np.float32)
    wide_c = np.zeros((n, K + 17), np.int32)
    for i, k in enumerate(ext):
        wide_v[i, :k] = r.normal(size=k) * (4.0 / np.sqrt(K))
        wide_c[i, :k] = r.choice(d, size=k, replace=bool(k > d))
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                  device=cuda_device)
    v, c = t(wide_v[:, :K]), t(wide_c[:, :K])
    s = t((wide_v * wide_v).sum(1).astype(np.float32))
    z2 = t((r.normal(size=(2, d)) * (4.0 / np.sqrt(d))).astype(np.float32))
    g = r.normal(size=n).astype(np.float32)
    g[-3:] = np.inf                              # buffer padding rows
    g, c2 = t(g), t(r.normal(size=2).astype(np.float32))
    inv = 1 / 64
    before = dict(cuda.launches)
    rows = ops.ell_kernel_rows2(v, c, s, z2, inv)
    torch.testing.assert_close(rows, ref.ell_kernel_rows2(v, c, s, z2, inv),
                               rtol=1e-5, atol=1e-6)
    assert float(rows.min()) > 1e-3
    row = ops.ell_kernel_row(v, c, s, z2[1], inv)
    torch.testing.assert_close(row, ref.ell_kernel_row(v, c, s, z2[1], inv),
                               rtol=1e-5, atol=1e-6)
    got = ops.ell_fused_gamma_update("rbf", v, c, s, g, z2, c2, inv)
    torch.testing.assert_close(got, ref.ell_gamma_update(v, c, s, g, z2, c2,
                                                         inv),
                               rtol=1e-4, atol=1e-4)
    assert torch.isinf(got[-3:]).all()
    # position symmetry, and the single-row paths, bitwise
    swap = ops.ell_kernel_rows2(v, c, s, z2.flip(0).contiguous(), inv)
    assert torch.equal(swap[:, 0], rows[:, 1])
    assert torch.equal(swap[:, 1], rows[:, 0])
    same = ops.ell_kernel_rows2(v, c, s, torch.stack([z2[0], z2[0]]), inv)
    assert torch.equal(same[:, 0], same[:, 1])
    assert torch.equal(same[:, 0], rows[:, 0])
    assert torch.equal(row, rows[:, 1])
    provider = kernel_fns.make_provider("rbf", "ell", True, inv)
    data = dataplane.ELLData(v, c, s, d)
    assert torch.equal(provider.row(data, z2[1]), rows[:, 1])
    assert torch.equal(kernel_fns.row_via_rows2(provider, data, z2[1]),
                       rows[:, 1])
    # the lane budget does not change the bits (nonzeros in a slot prefix)
    wv, wc = t(wide_v), t(wide_c)
    assert torch.equal(ops.ell_kernel_rows2(wv, wc, s, z2, inv), rows)
    assert torch.equal(
        ops.ell_fused_gamma_update("rbf", wv, wc, s, g, z2, c2, inv), got)
    # nor does a misaligned vals (4-byte copies)
    shifted = torch.empty(n * K + 1, device=cuda_device)
    shifted[1:] = v.reshape(-1)
    vm = shifted[1:].view(n, K)
    assert torch.equal(ops.ell_kernel_rows2(vm, c, s, z2, inv), rows)
    assert torch.equal(ops.ell_kernel_row(vm, c, s, z2[1], inv), row)
    assert torch.equal(
        ops.ell_fused_gamma_update("rbf", vm, c, s, g, z2, c2, inv), got)
    for k in ("ell_kernel_row", "ell_kernel_rows2", "ell_gamma_update"):
        assert cuda.launches[k] > before[k], k


def _accumulate_case(kind, m, d, K, seed, device):
    """SVs for one accumulate (dense rows, or ELL rows with nonzeros at
    random slots, explicit zeros among them), coefs of both signs with up
    to 7 trailing rows at 0, and a scale that keeps K(z, x) well above 0.
    Returns ``{name: score(Z)}``: ``kernel`` through ``ops``, ``plain`` the
    plain version, ``trim`` the kernel without the coef-0 rows and, for
    ELL, ``wide`` the kernel on the same SVs re-laid at a larger K."""
    r = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    cf = r.normal(size=m).astype(np.float32)
    n = m - min(7, m // 4)
    cf[n:] = 0.0                                  # trailing coef-0 rows
    cf = t(cf)
    inv = 1 / 64
    if kind == "dense":
        X = (r.normal(size=(m, d)) * (4.0 / np.sqrt(d))).astype(np.float32)
        X, sq = t(X), t((X * X).sum(1).astype(np.float32))
        return dict(
            kernel=lambda Z: ops.rbf_accumulate(X, sq, cf, Z, inv),
            plain=lambda Z: ref.rbf_accumulate(X, sq, cf, Z, inv),
            trim=lambda Z: ops.rbf_accumulate(X[:n].contiguous(),
                                              sq[:n].contiguous(),
                                              cf[:n].contiguous(), Z, inv))
    wide = np.zeros((m, K + 17), np.float32)
    wcol = np.zeros((m, K + 17), np.int32)
    for i in range(m):
        slots = np.sort(r.choice(K, size=r.integers(0, K + 1),
                                 replace=False))
        wide[i, slots] = r.normal(size=slots.size) * (4.0 / np.sqrt(K))
        wide[i, slots[::5]] = 0.0                  # explicit zeros
        wcol[i, slots] = r.choice(d, size=slots.size, replace=bool(K > d))
    v, c = t(wide[:, :K]), t(wcol[:, :K])
    s = t((wide * wide).sum(1).astype(np.float32))
    wv, wc = t(wide), t(wcol)
    return dict(
        kernel=lambda Z: ops.ell_rbf_accumulate(v, c, s, cf, Z, inv),
        plain=lambda Z: ref.ell_rbf_accumulate(v, c, s, cf, Z, inv),
        trim=lambda Z: ops.ell_rbf_accumulate(
            v[:n].contiguous(), c[:n].contiguous(), s[:n].contiguous(),
            cf[:n].contiguous(), Z, inv),
        wide=lambda Z: ops.ell_rbf_accumulate(wv, wc, s, cf, Z, inv))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,d,K", [
    ("dense", 5, 123, 0), ("dense", 127, 37, 0), ("dense", 128, 1, 0),
    ("dense", 1000, 123, 0), ("dense", 18048 + 77, 300, 0),
    ("ell", 5, 300, 128), ("ell", 127, 300, 13), ("ell", 1000, 300, 128),
    ("ell", 777, 40000, 40), ("ell", 300, 300, 1100)])
def test_cuda_accumulates_split_the_sv_axis(cuda_device, kind, m, d, K):
    """The split accumulates (SV chunks of 128 rows, partials added in
    chunk order) at M below one chunk, at one chunk, and not a multiple of
    it, at B = 64 and 4,096 and between (each query-tile shape), for dense
    widths from 1 to 300 and ELL lane budgets from 13 to 1,100 (a group's
    list refilled in windows, rows cut between rounds of loads) and a width
    whose query tile does not fit in shared memory: within 1e-5 of max
    |sum| of the plain version, one counted launch a call, and the same
    bits from run to run, without the trailing coef-0 rows and from the
    ELL rows re-laid at a larger K."""
    f = _accumulate_case(kind, m, d, K, m + d + K, cuda_device)
    r = np.random.default_rng(m)
    name = "rbf_accumulate" if kind == "dense" else "ell_rbf_accumulate"
    for b in (64, 200, 4096):
        Z = torch.as_tensor((r.normal(size=(b, d)) * (4.0 / np.sqrt(d)))
                            .astype(np.float32), device=cuda_device)
        before = cuda.launches[name]
        got = f["kernel"](Z)
        assert cuda.launches[name] == before + 1
        want = f["plain"](Z)
        assert float(want.abs().max()) > 0.1
        tol = 1e-5 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=tol)
        assert torch.equal(got, f["kernel"](Z))
        assert torch.equal(got, f["trim"](Z))
        if "wide" in f:
            assert torch.equal(got, f["wide"](Z))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,m,d,K", [("dense", 18048, 123, 0),
                                        ("dense", 1000, 37, 0),
                                        ("ell", 7936, 300, 128),
                                        ("ell", 1000, 300, 13)])
def test_cuda_accumulates_are_bucket_invariant(cuda_device, kind, m, d, K):
    """A query's score does not depend on the bucket: the same 64 queries
    scored as a B = 64 bucket, at scattered positions of a B = 4,096 bucket
    of other queries, and at the tail of a B = 200 bucket give the same
    bits; and for ELL, the same SVs re-laid at a larger K give the same
    bits (serving's scores do not depend on how a request is chopped into
    buckets or on the lane budget)."""
    f = _accumulate_case(kind, m, d, K, 7, cuda_device)
    score = f["kernel"]
    r = np.random.default_rng(8)
    rows = lambda n: torch.as_tensor(
        (r.normal(size=(n, d)) * (4.0 / np.sqrt(d))).astype(np.float32),
        device=cuda_device)
    Z = rows(64)
    small = score(Z)
    big = rows(4096)
    at = torch.as_tensor(np.sort(r.choice(4096, 64, replace=False)),
                         device=cuda_device)
    big[at] = Z
    assert torch.equal(score(big)[at], small)
    mid = torch.cat([rows(136), Z])
    assert torch.equal(score(mid)[136:], small)
    if "wide" in f:
        assert torch.equal(f["wide"](Z), small)
        assert torch.equal(f["wide"](big)[at], small)
