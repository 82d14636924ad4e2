"""Kernel functions and row providers (twin of ``repro.core.kernel_fns``).

The paper (Sec. 4.1) uses the Gaussian kernel K(x, z) = exp(-|x - z|^2 /
(2 sigma^2)); linear and polynomial kernels are provided for completeness
(``inv_2s2`` doubles as the polynomial scale). Kernel *rows* K(z, X) over
the active buffer are the hot path of SMO, and all row production goes
through a row provider, one per (storage format, backend):
:class:`DenseRowProvider` / :class:`ELLRowProvider` compute with plain
PyTorch ops; :class:`DenseKernelRowProvider` / :class:`ELLKernelRowProvider`
route the RBF rows, the fused Eq. 6 update and the serve-time accumulate
through the hand-written CUDA kernels (``kernels/ops.py``; plain versions
on CPU tensors). On block-ELL storage (the paper's sparse format, Sec.
2.2) the query stays dense and <x_i, z> = sum_k vals[i, k] * z[cols[i, k]].

The reference's ``optimization_barrier`` / degenerate-``lax.cond`` islands
are not ported: they pin XLA CPU code generation, which eager PyTorch does
not have — the same op on the same shapes runs the same code in every
context.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.core import dataplane
from repro_torch.kernels import ref

KernelRowFn = Callable[..., torch.Tensor]


def rbf_row(X, sq_norms, z, inv_2s2):
    """K(z, X_i) = exp(-|X_i - z|^2 * inv_2s2) for all rows i."""
    d2 = sq_norms - 2.0 * (X @ z) + torch.dot(z, z)
    return torch.exp(-torch.clamp(d2, min=0.0) * inv_2s2)


def rbf_rows2(X, sq_norms, z2, inv_2s2):
    """Two-row RBF K([z_up; z_low], X) in one pass over X. (N, 2)."""
    prods = X @ z2.T
    zn = torch.sum(z2 * z2, dim=-1)
    d2 = sq_norms[:, None] - 2.0 * prods + zn[None, :]
    return torch.exp(-torch.clamp(d2, min=0.0) * inv_2s2)


def linear_row(X, sq_norms, z, inv_2s2):
    return X @ z


def linear_rows2(X, sq_norms, z2, inv_2s2):
    return X @ z2.T


def poly_row(X, sq_norms, z, inv_2s2, degree: int = 3, coef0: float = 1.0):
    return (inv_2s2 * (X @ z) + coef0) ** degree


def poly_rows2(X, sq_norms, z2, inv_2s2, degree: int = 3, coef0: float = 1.0):
    return (inv_2s2 * (X @ z2.T) + coef0) ** degree


def self_kernel(kernel: str) -> Callable:
    """K(x, x) on a (k, d) block of rows -> (k,). For RBF identically 1,
    which spares two kernel evaluations per iteration (Eq. 12 needs K(up,up)
    and K(low,low))."""
    if kernel == "rbf":
        return lambda Z, inv_2s2: torch.ones(Z.shape[0], dtype=Z.dtype,
                                             device=Z.device)
    if kernel == "linear":
        return lambda Z, inv_2s2: torch.sum(Z * Z, dim=-1)
    if kernel == "poly":
        return lambda Z, inv_2s2: (inv_2s2 * torch.sum(Z * Z, dim=-1)
                                   + 1.0) ** 3
    raise ValueError(f"unknown kernel {kernel!r}")


_ROWS2 = {"rbf": rbf_rows2, "linear": linear_rows2, "poly": poly_rows2}
_ROW = {"rbf": rbf_row, "linear": linear_row, "poly": poly_row}


def get_rows2(kernel: str) -> KernelRowFn:
    try:
        return _ROWS2[kernel]
    except KeyError:
        raise ValueError(f"unknown kernel {kernel!r}") from None


def get_row(kernel: str) -> KernelRowFn:
    try:
        return _ROW[kernel]
    except KeyError:
        raise ValueError(f"unknown kernel {kernel!r}") from None


# -- block-ELL samples: (vals, cols) rows padded to K slots with (0.0, 0) --

def ell_dots(vals, cols, z):
    """<x_i, z> for every ELL row i. vals/cols (M, K), z (d,) -> (M,)."""
    return ref.ell_dots(vals, cols, z[None, :])[0]


def ell_dots2(vals, cols, z2):
    """<x_i, z_j> for two dense queries z2 (2, d) -> (M, 2). Batch-major
    (``ref.ell_dots``), so both columns are position-symmetric."""
    return ref.ell_dots(vals, cols, z2).T


# the RBF rows are the kernels' plain versions themselves
ell_rbf_row = ref.ell_kernel_row
ell_rbf_rows2 = ref.ell_kernel_rows2


def ell_linear_row(vals, cols, sq_norms, z, inv_2s2):
    return ell_dots(vals, cols, z)


def ell_linear_rows2(vals, cols, sq_norms, z2, inv_2s2):
    return ell_dots2(vals, cols, z2)


def ell_poly_row(vals, cols, sq_norms, z, inv_2s2, degree=3, coef0=1.0):
    return (inv_2s2 * ell_dots(vals, cols, z) + coef0) ** degree


def ell_poly_rows2(vals, cols, sq_norms, z2, inv_2s2, degree=3, coef0=1.0):
    return (inv_2s2 * ell_dots2(vals, cols, z2) + coef0) ** degree


_ELL_ROWS2 = {"rbf": ell_rbf_rows2, "linear": ell_linear_rows2,
              "poly": ell_poly_rows2}
_ELL_ROW = {"rbf": ell_rbf_row, "linear": ell_linear_row,
            "poly": ell_poly_row}


def get_ell_rows2(kernel: str) -> KernelRowFn:
    try:
        return _ELL_ROWS2[kernel]
    except KeyError:
        raise ValueError(f"unknown kernel {kernel!r}") from None


def get_ell_row(kernel: str) -> KernelRowFn:
    try:
        return _ELL_ROW[kernel]
    except KeyError:
        raise ValueError(f"unknown kernel {kernel!r}") from None


def ell_cross_kernel(kernel: str, Z: torch.Tensor, vals: torch.Tensor,
                     cols: torch.Tensor, sq_norms: torch.Tensor,
                     inv_2s2: float, max_gather: int = 1 << 24
                     ) -> torch.Tensor:
    """K(Z_j, x_i) for dense queries Z (nZ, d) against ELL samples -> (nZ,
    M); the ELL analogue of :func:`full_kernel_matrix`. The (nZ, blk, K)
    gather is blocked over the samples to stay under ``max_gather``
    elements. Runs in the dtype of ``Z`` and ``vals``."""
    nZ = Z.shape[0]
    M, K = vals.shape
    blk = max(1, min(M, max_gather // max(nZ * K, 1)))
    c64 = cols.to(torch.int64)
    dots = torch.cat(
        [torch.sum(vals[None, s: s + blk, :] * Z[:, c64[s: s + blk]],
                   dim=-1) for s in range(0, M, blk)], dim=1) if M else \
        torch.zeros((nZ, 0), dtype=Z.dtype, device=Z.device)
    if kernel == "linear":
        return dots
    if kernel == "poly":
        return (inv_2s2 * dots + 1.0) ** 3
    zn = torch.sum(Z * Z, dim=-1)
    d2 = zn[:, None] - 2.0 * dots + sq_norms[None, :]
    return torch.exp(-torch.clamp(d2, min=0.0) * inv_2s2)


def full_kernel_matrix(kernel: str, X: torch.Tensor, Z: torch.Tensor,
                       inv_2s2: float) -> torch.Tensor:
    """K(X_i, Z_j) — (nX, nZ). A predict/reconstruction-time helper; never
    formed in training (the paper's no-kernel-cache doctrine, Sec. 3.1.1)."""
    if kernel == "linear":
        return X @ Z.T
    if kernel == "poly":
        return (inv_2s2 * (X @ Z.T) + 1.0) ** 3
    xn = torch.sum(X * X, dim=-1)
    zn = torch.sum(Z * Z, dim=-1)
    d2 = xn[:, None] - 2.0 * (X @ Z.T) + zn[None, :]
    return torch.exp(-torch.clamp(d2, min=0.0) * inv_2s2)


@dataclasses.dataclass(frozen=True)
class _ProviderBase:
    """Kernel-row production over a device buffer (``DenseData`` /
    ``ELLData``), the protocol every provider follows:

    ``row`` K(z, buffer) (M,); ``rows2`` K([z_up; z_low], buffer) (M, 2);
    ``matrix`` K(Z_j, buffer_i) (nZ, M); ``gamma_update`` the fused Eq. 6;
    ``diag`` K(x_i, x_i); ``accumulate`` sum_i coef[i] K(Z_j, buffer_i)
    (nZ,) — the serving plane's one hot call.
    """
    kernel: str
    inv_2s2: float

    def gamma_update(self, data, gamma, z2, coef2):
        return gamma + self.rows2(data, z2) @ coef2

    def diag(self, data):
        sq = data.sq_norms
        if self.kernel == "rbf":
            return torch.ones_like(sq)
        if self.kernel == "linear":
            return sq
        return (self.inv_2s2 * sq + 1.0) ** 3

    def accumulate(self, data, Z, coef):
        return self.matrix(data, Z) @ coef


@dataclasses.dataclass(frozen=True)
class DenseRowProvider(_ProviderBase):
    """Dense storage, plain PyTorch ops."""

    def row(self, data, z):
        return _ROW[self.kernel](data.X, data.sq_norms, z, self.inv_2s2)

    def rows2(self, data, z2):
        return _ROWS2[self.kernel](data.X, data.sq_norms, z2, self.inv_2s2)

    def matrix(self, data, Z):
        return full_kernel_matrix(self.kernel, Z, data.X, self.inv_2s2)


@dataclasses.dataclass(frozen=True)
class DenseKernelRowProvider(DenseRowProvider):
    """Dense storage, hand-written kernel backend (twin of
    ``DensePallasRowProvider``): ``rows2`` -> ``rbf_rows2``,
    ``gamma_update`` -> ``gamma_update``, ``accumulate`` ->
    ``rbf_accumulate`` on CUDA tensors. ``row`` and ``matrix`` stay plain,
    as in the reference (there is no dense single-row kernel; the solver's
    single rows go through :func:`row_via_rows2`)."""

    def rows2(self, data, z2):
        from repro_torch.kernels import ops
        return ops.kernel_rows2(self.kernel, data.X, data.sq_norms, z2,
                                self.inv_2s2)

    def gamma_update(self, data, gamma, z2, coef2):
        from repro_torch.kernels import ops
        return ops.fused_gamma_update(self.kernel, data.X, data.sq_norms,
                                      gamma, z2, coef2, self.inv_2s2)

    def accumulate(self, data, Z, coef):
        from repro_torch.kernels import ops
        if self.kernel != "rbf":    # the accumulate kernel is RBF-only
            return super().accumulate(data, Z, coef)
        return ops.rbf_accumulate(data.X, data.sq_norms, coef, Z,
                                  self.inv_2s2)


@dataclasses.dataclass(frozen=True)
class ELLRowProvider(_ProviderBase):
    """Block-ELL storage, plain PyTorch ops."""

    def row(self, data, z):
        return _ELL_ROW[self.kernel](data.vals, data.cols, data.sq_norms, z,
                                     self.inv_2s2)

    def rows2(self, data, z2):
        return _ELL_ROWS2[self.kernel](data.vals, data.cols, data.sq_norms,
                                       z2, self.inv_2s2)

    def matrix(self, data, Z):
        return ell_cross_kernel(self.kernel, Z, data.vals, data.cols,
                                data.sq_norms, self.inv_2s2)


@dataclasses.dataclass(frozen=True)
class ELLKernelRowProvider(ELLRowProvider):
    """Block-ELL storage, hand-written kernel backend (twin of
    ``ELLPallasRowProvider``): on CUDA tensors ``row`` ->
    ``ell_kernel_row``, ``rows2`` -> ``ell_kernel_rows2``,
    ``gamma_update`` -> ``ell_gamma_update``, ``accumulate`` ->
    ``ell_rbf_accumulate``; the kernels are RBF-only, so other kernels use
    the plain rows, as in the reference. ``matrix`` stays plain."""

    def row(self, data, z):
        from repro_torch.kernels import ops
        if self.kernel != "rbf":
            return super().row(data, z)
        return ops.ell_kernel_row(data.vals, data.cols, data.sq_norms, z,
                                  self.inv_2s2)

    def rows2(self, data, z2):
        from repro_torch.kernels import ops
        if self.kernel != "rbf":
            return super().rows2(data, z2)
        return ops.ell_kernel_rows2(data.vals, data.cols, data.sq_norms, z2,
                                    self.inv_2s2)

    def gamma_update(self, data, gamma, z2, coef2):
        from repro_torch.kernels import ops
        return ops.ell_fused_gamma_update(self.kernel, data.vals, data.cols,
                                          data.sq_norms, gamma, z2, coef2,
                                          self.inv_2s2)

    def accumulate(self, data, Z, coef):
        from repro_torch.kernels import ops
        if self.kernel != "rbf":
            return super().accumulate(data, Z, coef)
        return ops.ell_rbf_accumulate(data.vals, data.cols, data.sq_norms,
                                      coef, Z, self.inv_2s2)


def recon_block(provider: _ProviderBase, sv_data, Zi: torch.Tensor,
                coef: torch.Tensor) -> torch.Tensor:
    """One Alg. 6 block: K(Zi, sv_data) @ coef — (nZ,) partial gammas, in
    fp64. A reconstructed gamma is a sum over every support vector whose
    signed terms mostly cancel; fp32 would leave errors of ~1e-4 at a9a
    size, the order of the Eq. 9 margin. The SV block keeps its storage
    format (ELL blocks stay ELL; only the query rows ``Zi`` are dense).
    The one block computation both reconstruction backends (host streaming
    and the device mirror) run, so they produce the same bits."""
    if isinstance(sv_data, dataplane.ELLData):
        sv64 = dataplane.ELLData(sv_data.vals.double(), sv_data.cols,
                                 sv_data.sq_norms.double(),
                                 sv_data.n_features)
    else:
        sv64 = dataplane.DenseData(sv_data.X.double(),
                                   sv_data.sq_norms.double())
    return provider.matrix(sv64, Zi.double()) @ coef.double()


def row_via_rows2(provider: _ProviderBase, data,
                  z: torch.Tensor) -> torch.Tensor:
    """K(z, buffer) as column 0 of the two-row kernel on a duplicated query
    — (M,). The rows2 columns are position-symmetric (the CUDA kernels
    compute both with identical code, the plain ELL version is
    batch-major), so this single row has the same bits as the same row
    produced in either slot of a pair."""
    return provider.rows2(data, torch.stack([z, z]))[:, 0]


def make_provider(kernel: str, fmt: str = "dense", use_kernels: bool = True,
                  inv_2s2: float = 1.0) -> _ProviderBase:
    """Row provider for a (kernel, storage format, backend) triple: the
    hand-written kernels (``use_kernels=True``) or plain PyTorch ops, over
    'dense' or 'ell' buffers."""
    if kernel not in _ROW:
        raise ValueError(f"unknown kernel {kernel!r}")
    if fmt == "dense":
        cls = DenseKernelRowProvider if use_kernels else DenseRowProvider
    elif fmt == "ell":
        cls = ELLKernelRowProvider if use_kernels else ELLRowProvider
    else:
        raise ValueError(f"unknown data format {fmt!r}")
    return cls(kernel, float(inv_2s2))
