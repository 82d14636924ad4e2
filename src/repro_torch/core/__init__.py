"""Core of the port: parallel SMO with adaptive shrinking, dense or block-ELL
storage, one device. ``from repro_torch.core import train`` is the library
boundary."""
from repro_torch.core.heuristics import (TABLE3, ShrinkHeuristic,
                                         get as get_heuristic)
from repro_torch.core.serve import ServeEngine
from repro_torch.core.solver import (SVMConfig, SVMModel, SMOSolver, FitStats,
                                     train)

__all__ = ["TABLE3", "ShrinkHeuristic", "get_heuristic", "ServeEngine",
           "SVMConfig", "SVMModel", "SMOSolver", "FitStats", "train"]
