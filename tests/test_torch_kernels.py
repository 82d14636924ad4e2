"""The port's kernel plain versions against the JAX reference (Pallas bodies
in interpret mode and ``repro.kernels.ref``), and the CPU dispatch of the
kernel wrappers. The CUDA kernels themselves are tested in
``test_torch_cuda.py``."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import ref as jref
from repro.kernels.gamma_update import gamma_update as j_gamma_update
from repro.kernels.rbf_row import rbf_accumulate as j_rbf_accumulate
from repro.kernels.rbf_row import rbf_rows2 as j_rbf_rows2

from repro_torch.core import kernel_fns
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)


def _inputs(n, d, seed):
    r = np.random.default_rng(seed)
    X = r.normal(size=(n, d)).astype(np.float32)
    sq = (X * X).sum(1).astype(np.float32)
    z2 = r.normal(size=(2, d)).astype(np.float32)
    return r, X, sq, z2


@pytest.mark.parametrize("n,d,bm", [(256, 8, 128), (512, 5, 256),
                                    (384, 3, 128)])
def test_kernel_rows2_plain_matches_reference(n, d, bm):
    _, X, sq, z2 = _inputs(n, d, n + d)
    inv = np.float32(1 / 8)
    want = np.asarray(j_rbf_rows2(jnp.asarray(X), jnp.asarray(sq),
                                  jnp.asarray(z2), jnp.float32(inv),
                                  block_m=bm, interpret=True)).T
    got = ref.kernel_rows2(torch.as_tensor(X), torch.as_tensor(sq),
                           torch.as_tensor(z2), float(inv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jref.kernel_rows2(jnp.asarray(X), jnp.asarray(sq),
                                          jnp.asarray(z2), inv)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,d", [(256, 7), (512, 8), (640, 4)])
def test_gamma_update_plain_matches_reference(n, d):
    r, X, sq, z2 = _inputs(n, d, n * d)
    g = r.normal(size=n).astype(np.float32)
    c2 = r.normal(size=2).astype(np.float32)
    inv = np.float32(0.3)
    want = np.asarray(j_gamma_update(
        jnp.asarray(X), jnp.asarray(sq), jnp.asarray(g), jnp.asarray(z2),
        jnp.asarray(c2), jnp.float32(inv), block_m=128, interpret=True))
    got = ref.gamma_update(*(torch.as_tensor(a) for a in (X, sq, g, z2, c2)),
                           float(inv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    jwant = np.asarray(jref.gamma_update(*(jnp.asarray(a) for a in
                                           (X, sq, g, z2, c2)), inv))
    np.testing.assert_allclose(got, jwant, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("m,d,b", [(256, 8, 128), (384, 6, 256)])
def test_rbf_accumulate_plain_matches_reference(m, d, b):
    r, X, sq, _ = _inputs(m, d, m + b)
    coef = r.normal(size=m).astype(np.float32)
    coef[-17:] = 0.0                   # padding rows: exact zero contribution
    X[-17:] = 123.0
    Z = r.normal(size=(b, d)).astype(np.float32)
    inv = np.float32(0.125)
    want = np.asarray(j_rbf_accumulate(
        jnp.asarray(X), jnp.asarray(sq), jnp.asarray(coef), jnp.asarray(Z),
        jnp.float32(inv), block_m=128, block_q=128, interpret=True))
    got = ref.rbf_accumulate(*(torch.as_tensor(a) for a in (X, sq, coef, Z)),
                             float(inv)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    trimmed = ref.rbf_accumulate(*(torch.as_tensor(a[:-17]) for a in
                                   (X, sq, coef)), torch.as_tensor(Z),
                                 float(inv)).numpy()
    np.testing.assert_allclose(got, trimmed, rtol=1e-6, atol=1e-6)


def test_ops_dispatch_plain_versions_on_cpu():
    r, X, sq, z2 = _inputs(300, 6, 11)
    t = torch.as_tensor
    g = r.normal(size=300).astype(np.float32)
    c2 = r.normal(size=2).astype(np.float32)
    inv = 0.2
    assert torch.equal(ops.kernel_rows2("rbf", t(X), t(sq), t(z2), inv),
                       ref.kernel_rows2(t(X), t(sq), t(z2), inv))
    assert torch.equal(
        ops.fused_gamma_update("rbf", t(X), t(sq), t(g), t(z2), t(c2), inv),
        ref.gamma_update(t(X), t(sq), t(g), t(z2), t(c2), inv))
    rows = ops.kernel_rows2("rbf", t(X), t(sq), t(z2), inv)
    assert torch.equal(ops.gamma_from_rows(t(g), rows, t(c2)),
                       t(g) + rows @ t(c2))
    Z = t(r.normal(size=(40, 6)).astype(np.float32))
    assert torch.equal(ops.rbf_accumulate(t(X), t(sq), t(g), Z, inv),
                       ref.rbf_accumulate(t(X), t(sq), t(g), Z, inv))
    # non-RBF kernels use the plain rows, as in the reference wrappers
    for kern in ("linear", "poly"):
        rows = kernel_fns.get_rows2(kern)(t(X), t(sq), t(z2), inv)
        assert torch.equal(ops.kernel_rows2(kern, t(X), t(sq), t(z2), inv),
                           rows)
        assert torch.equal(
            ops.fused_gamma_update(kern, t(X), t(sq), t(g), t(z2), t(c2),
                                   inv), t(g) + rows @ t(c2))
    # position symmetry of the plain two-row version
    zz = t(np.stack([z2[0], z2[0]]))
    rows = ops.kernel_rows2("rbf", t(X), t(sq), zz, inv)
    assert torch.equal(rows[:, 0], rows[:, 1])
