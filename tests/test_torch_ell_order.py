"""The summation order of the block-ELL row/gamma CUDA body
(``src/repro_torch/kernels/csrc/ell_rows.cu``), emulated in numpy on the
CPU: a row's slots fall in 16-byte chunks (chunk q: slots 4q .. 4q + 3);
lane l of the row's G = 8 lanes owns the chunks q = l, l + 8, ... and sums
vals[i, k] * z[cols[i, k]] over their nonzero slots in slot order (one
fmaf each), then the lanes add by the xor tree (offsets 4, 2, 1); |z|^2 is
summed by 32 lanes (k = l, l + 32, ...) and the 32-lane xor tree; the
epilogue rounds each operation to fp32. On non-binary rows whose nonzeros
are a slot prefix, that order gives the same bits at every lane budget K
(the adaptive budget changes K at compactions), and it agrees with the JAX
package's Pallas bodies (interpret mode) within the kernel tolerances. The
CUDA kernel itself is held to the same contracts on the card in
``test_torch_cuda.py``."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels import sparse_ell as jse

from repro_torch.kernels import ref

G = 8
INV = np.float32(1 / 64)


def fmaf(x, y, a):
    """fp32 fmaf: the exact product (fp64 holds it), plus a, rounded to
    fp32 (once in fp64 first: double rounding aside, the hardware's)."""
    return (x.astype(np.float64) * y.astype(np.float64)
            + a.astype(np.float64)).astype(np.float32)


def xor_tree(lanes):
    """The shuffle tree over the last axis (G lanes): v += v[l ^ off] for
    off = G/2, ..., 1; every lane ends with the same bits."""
    off = lanes.shape[-1] // 2
    while off:
        lanes = (lanes + lanes[..., np.arange(lanes.shape[-1]) ^ off]) \
            .astype(np.float32)
        off //= 2
    return lanes[..., 0]


def lane_dots(vals, cols, z, g=G, split=False):
    """<x_i, z> (N,) in the body's order. ``split=True`` is a K-dependent
    order for contrast: lane l sums the contiguous slots [l*c, (l+1)*c),
    c = ceil(K / g)."""
    n, K = vals.shape
    lanes = np.zeros((n, g), np.float32)
    c = -(-K // g)
    for k in range(K):
        lane = k // c if split else (k // 4) % g
        x = vals[:, k]
        lanes[:, lane] = np.where(x != 0, fmaf(x, z[cols[:, k]],
                                               lanes[:, lane]),
                                  lanes[:, lane])
    return xor_tree(lanes)


def sq_norm(z):
    """|z|^2 as one warp sums it: lane l over k = l, l + 32, ..."""
    lanes = np.zeros(32, np.float32)
    for k in range(z.shape[0]):
        l = k % 32
        lanes[l:l + 1] = fmaf(z[k:k + 1], z[k:k + 1], lanes[l:l + 1])
    return xor_tree(lanes)


def rbf(sq, dot, zn):
    d2 = ((sq - (np.float32(2) * dot).astype(np.float32)).astype(np.float32)
          + zn).astype(np.float32)
    return np.exp((-np.maximum(d2, np.float32(0)) * INV).astype(np.float32))


def rows2(vals, cols, sq, z2, **kw):
    return np.stack([rbf(sq, lane_dots(vals, cols, z, **kw), sq_norm(z))
                     for z in z2], axis=1)


def gamma_update(vals, cols, sq, gamma, z2, coef2):
    k = rows2(vals, cols, sq, z2)
    upd = ((k[:, 0] * coef2[0]).astype(np.float32)
           + (k[:, 1] * coef2[1]).astype(np.float32)).astype(np.float32)
    return (gamma + upd).astype(np.float32)


def _rows(n=256, K=128, d=300, max_nnz=13, seed=0):
    """Non-binary rows packed into a slot prefix of at most ``max_nnz``
    slots (one row full), distinct columns; queries and coefficients."""
    r = np.random.default_rng(seed)
    ext = r.integers(0, max_nnz + 1, n)
    ext[0] = max_nnz
    vals = np.zeros((n, K), np.float32)
    cols = np.zeros((n, K), np.int32)
    for i, k in enumerate(ext):
        vals[i, :k] = r.normal(size=k) * np.float32(4 / np.sqrt(max_nnz))
        cols[i, :k] = r.choice(d, size=k, replace=False)
    sq = (vals * vals).sum(1).astype(np.float32)
    z2 = (r.normal(size=(2, d)) * (4 / np.sqrt(d))).astype(np.float32)
    gamma = r.normal(size=n).astype(np.float32)
    gamma[-3:] = np.inf                  # buffer padding rows
    coef2 = r.normal(size=2).astype(np.float32)
    return vals, cols, sq, z2, gamma, coef2


def test_ell_lane_order_gives_the_same_bits_at_every_lane_budget():
    vals, cols, sq, z2, gamma, coef2 = _rows()
    bits = lambda a: np.ascontiguousarray(a).view(np.uint32)
    want = rows2(vals, cols, sq, z2)
    want_g = gamma_update(vals, cols, sq, gamma, z2, coef2)
    assert np.isinf(want_g[-3:]).all()
    for K in (13, 16):
        v, c = vals[:, :K].copy(), cols[:, :K].copy()
        np.testing.assert_array_equal(bits(rows2(v, c, sq, z2)), bits(want))
        np.testing.assert_array_equal(
            bits(gamma_update(v, c, sq, gamma, z2, coef2)), bits(want_g))
        # contrast: an order whose lane split follows K does not
        assert not np.array_equal(
            lane_dots(v, c, z2[0], split=True),
            lane_dots(vals, cols, z2[0], split=True))


@pytest.mark.parametrize("K", [13, 16, 128])
def test_ell_lane_order_matches_the_reference_bodies(K):
    vals, cols, sq, z2, gamma, coef2 = _rows(seed=K)
    v, c = vals[:, :K].copy(), cols[:, :K].copy()
    j = jnp.asarray
    got = rows2(v, c, sq, z2)
    want = np.asarray(jse.ell_kernel_rows2(j(v), j(c), j(sq), j(z2),
                                           jnp.float32(INV), block_m=128,
                                           interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    t = torch.as_tensor
    np.testing.assert_allclose(
        got, ref.ell_kernel_rows2(t(v), t(c), t(sq), t(z2),
                                  float(INV)).numpy(), rtol=1e-5, atol=1e-6)
    got_g = gamma_update(v, c, sq, gamma, z2, coef2)
    want_g = np.asarray(jse.ell_gamma_update(
        *(j(a) for a in (v, c, sq, gamma, z2, coef2)), jnp.float32(INV),
        block_m=128, interpret=True))
    np.testing.assert_allclose(got_g, want_g, rtol=1e-4, atol=1e-4)
    assert np.isinf(got_g[-3:]).all()
