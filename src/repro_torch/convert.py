"""Carry state from the JAX reference into the port.

The functions take the reference's numpy arrays (and plain config values)
and return the port's objects, so one model or one mid-fit solver state
can be handed to both packages. Nothing here imports the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import dataplane, smo
from repro_torch.core.driver import FitStats
from repro_torch.core.solver import SVMConfig, SVMModel

# Reference config fields with no counterpart here: the port always runs
# its kernels, on CUDA tensors (their plain versions on CPU tensors).
_DROP = ("use_pallas",)


def config(fields: dict, device: str = "cuda") -> SVMConfig:
    """A port ``SVMConfig`` from the reference config's fields (e.g.
    ``dataclasses.asdict(ref_cfg)``). A heuristic given as a dict (what
    ``asdict`` makes of a ``ShrinkHeuristic``) is taken by its name.
    Fields of later slices raise ``NotImplementedError`` when set."""
    kw = {k: v for k, v in fields.items() if k not in _DROP}
    h = kw.get("heuristic")
    if isinstance(h, dict):
        kw["heuristic"] = h["name"]
    known = {f.name for f in dataclasses.fields(SVMConfig)}
    unknown = sorted(set(kw) - known)
    if unknown:
        raise ValueError(f"unknown config fields {unknown}")
    kw["device"] = device
    return SVMConfig(**kw)


def model(sv_x: np.ndarray, sv_coef: np.ndarray, beta: float,
          alpha: np.ndarray, config_fields: dict,
          device: str = "cuda") -> SVMModel:
    """A port ``SVMModel`` scoring the reference model's support set."""
    return SVMModel(config(config_fields, device),
                    np.ascontiguousarray(sv_x, np.float32),
                    np.ascontiguousarray(sv_coef, np.float32).reshape(-1),
                    float(beta), np.asarray(alpha, np.float32), FitStats())


def ell_model(sv_vals: np.ndarray, sv_cols: np.ndarray, n_features: int,
              sv_coef: np.ndarray, beta: float, alpha: np.ndarray,
              config_fields: dict, device: str = "cuda") -> SVMModel:
    """A port ``SVMModel`` scoring a reference ELL model's support set
    (its ``sv_vals`` / ``sv_cols`` / ``n_features``)."""
    return SVMModel(config(config_fields, device), None,
                    np.ascontiguousarray(sv_coef, np.float32).reshape(-1),
                    float(beta), np.asarray(alpha, np.float32), FitStats(),
                    sv_vals=np.ascontiguousarray(sv_vals, np.float32),
                    sv_cols=np.ascontiguousarray(sv_cols, np.int32),
                    n_features=int(n_features))


def solver_state(alpha: np.ndarray, gamma: np.ndarray, active: np.ndarray,
                 X, y: np.ndarray, sq_norms: np.ndarray,
                 device: str = "cuda", gids: "np.ndarray | None" = None,
                 n_features: "int | None" = None):
    """The port's ``(data, y, SMOState)`` for a reference buffer: its
    alpha/gamma/active arrays, rows, labels y and squared norms (taken as
    given, not recomputed, so both packages see the same bits). ``X`` is
    the dense (M, d) rows (a ``DenseData`` buffer) or an ELL ``(vals,
    cols)`` pair with ``n_features`` = d (an ``ELLData`` buffer)."""
    dev = devmod.resolve(device)
    # copies: the runner updates alpha in place, the caller's arrays stay
    put = lambda a, dt: torch.tensor(np.asarray(a, dt), device=dev)
    g = None if gids is None else put(gids, np.int64)
    if isinstance(X, (tuple, list)):
        if n_features is None:
            raise ValueError("an ELL (vals, cols) buffer needs n_features")
        vals, cols = X
        data = dataplane.ELLData(put(vals, np.float32), put(cols, np.int32),
                                 put(sq_norms, np.float32), int(n_features),
                                 g)
    else:
        data = dataplane.DenseData(put(X, np.float32),
                                   put(sq_norms, np.float32), g)
    state = smo.init_state(put(alpha, np.float32), put(gamma, np.float32),
                           put(active, bool))
    return data, put(y, np.float32), state
