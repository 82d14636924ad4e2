"""Core of the port: parallel SMO with adaptive shrinking, dense or block-ELL
storage, one device, and batched multi-problem training (one-vs-rest, C /
sigma2 grids). ``from repro_torch.core import train`` is the library
boundary; ``train_ovr`` its multi-class twin."""
from repro_torch.core.heuristics import (TABLE3, ShrinkHeuristic,
                                         get as get_heuristic)
from repro_torch.core.multi import (MultiProblemDriver, OvRSVMModel,
                                    ovr_tasks, train_ovr)
from repro_torch.core.serve import ServeEngine
from repro_torch.core.solver import (SVMConfig, SVMModel, SMOSolver, FitStats,
                                     train)

__all__ = ["TABLE3", "ShrinkHeuristic", "get_heuristic", "ServeEngine",
           "SVMConfig", "SVMModel", "SMOSolver", "FitStats", "train",
           "MultiProblemDriver", "OvRSVMModel", "ovr_tasks", "train_ovr"]
