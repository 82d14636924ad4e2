"""Data substrate of the port: the synthetic dataset generators."""
from repro_torch.data.synthetic import SPECS, DatasetSpec, make

__all__ = ["SPECS", "DatasetSpec", "make"]
