"""Data substrate of the port: the synthetic dataset generators, the
sparse CSR / block-ELL formats and the LM token pipeline."""
from repro_torch.data.synthetic import (SPECS, DatasetSpec, make, make_sparse,
                                        make_repeat_heavy, density)
from repro_torch.data.sparse import (CSRMatrix, ELLMatrix, as_csr,
                                     is_csr_like, to_csr, to_ell,
                                     csr_row_extent, ell_row_extent,
                                     round_lanes, bucket_lanes,
                                     csr_space_report)
from repro_torch.data.tokens import TokenPipeline

__all__ = ["SPECS", "DatasetSpec", "make", "make_sparse",
           "make_repeat_heavy", "density",
           "CSRMatrix", "ELLMatrix", "as_csr", "is_csr_like", "to_csr",
           "to_ell", "csr_row_extent", "ell_row_extent", "round_lanes",
           "bucket_lanes", "csr_space_report", "TokenPipeline"]
