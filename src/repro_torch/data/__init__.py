"""Data substrate of the port: the synthetic dataset generators and the
sparse CSR / block-ELL formats."""
from repro_torch.data.synthetic import (SPECS, DatasetSpec, make, make_sparse,
                                        density)
from repro_torch.data.sparse import (CSRMatrix, ELLMatrix, as_csr,
                                     is_csr_like, to_csr, to_ell,
                                     csr_row_extent, ell_row_extent,
                                     round_lanes, bucket_lanes,
                                     csr_space_report)

__all__ = ["SPECS", "DatasetSpec", "make", "make_sparse", "density",
           "CSRMatrix", "ELLMatrix", "as_csr", "is_csr_like", "to_csr",
           "to_ell", "csr_row_extent", "ell_row_extent", "round_lanes",
           "bucket_lanes", "csr_space_report"]
