"""Carry state from the JAX reference into the port.

The functions take the reference's numpy arrays (and plain config values)
and return the port's objects, so one SVM model, one mid-fit solver state
or one LM's weights and optimizer state can be handed to both packages.
Nothing here imports the reference.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as devmod
from repro_torch.core import bf16, dataplane, smo
from repro_torch.core.driver import FitStats
from repro_torch.core.solver import SVMConfig, SVMModel
from repro_torch.models.api import ModelConfig

# Reference config fields with no counterpart here: the port always runs
# its kernels, on CUDA tensors (their plain versions on CPU tensors).
_DROP = ("use_pallas", "use_flash")


def config(fields: dict, device: str = "cuda") -> SVMConfig:
    """A port ``SVMConfig`` from the reference config's fields (e.g.
    ``dataclasses.asdict(ref_cfg)``). A heuristic given as a dict (what
    ``asdict`` makes of a ``ShrinkHeuristic``) is taken by its name;
    ``use_pallas`` has no counterpart and is dropped."""
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


def _sv_values(a):
    """SV values in the port's storage: fp32 numpy, or a host
    ``torch.bfloat16`` tensor for bf16 input (``ml_dtypes`` arrays are
    read through their ``uint16`` view; nothing imports ``ml_dtypes``)."""
    if bf16.is_bf16(a):
        return bf16.round_bf16(a)
    return np.ascontiguousarray(a, np.float32)


def model(sv_x: np.ndarray, sv_coef: np.ndarray, beta: float,
          alpha: np.ndarray, config_fields: dict,
          device: str = "cuda") -> SVMModel:
    """A port ``SVMModel`` scoring the reference model's support set. A
    bf16 model (``sv_x`` an ``ml_dtypes.bfloat16`` array, e.g. from the
    reference's ``compact(dtype='bfloat16')``) stays bf16, bit for bit."""
    return SVMModel(config(config_fields, device), _sv_values(sv_x),
                    np.ascontiguousarray(sv_coef, np.float32).reshape(-1),
                    float(beta), np.asarray(alpha, np.float32), FitStats())


def ell_model(sv_vals: np.ndarray, sv_cols: np.ndarray, n_features: int,
              sv_coef: np.ndarray, beta: float, alpha: np.ndarray,
              config_fields: dict, device: str = "cuda") -> SVMModel:
    """A port ``SVMModel`` scoring a reference ELL model's support set
    (its ``sv_vals`` / ``sv_cols`` / ``n_features``); bf16 ``sv_vals``
    stay bf16, as in :func:`model`."""
    return SVMModel(config(config_fields, device), None,
                    np.ascontiguousarray(sv_coef, np.float32).reshape(-1),
                    float(beta), np.asarray(alpha, np.float32), FitStats(),
                    sv_vals=_sv_values(sv_vals),
                    sv_cols=np.ascontiguousarray(sv_cols, np.int32),
                    n_features=int(n_features))


def ovr_model(classes, models: list, device: str = "cuda"):
    """A port ``core.multi.OvRSVMModel`` (with its union serving model)
    from a reference one-vs-rest model's per-class binary models, each
    given as a dict of its numpy fields: ``sv_coef``, ``beta``, ``alpha``,
    ``config`` (the config's fields) and either ``sv_x`` or ``sv_vals`` /
    ``sv_cols`` / ``n_features``."""
    from repro_torch.core import multi
    out = []
    for f in models:
        if f.get("sv_vals") is not None:
            out.append(ell_model(f["sv_vals"], f["sv_cols"],
                                 f["n_features"], f["sv_coef"], f["beta"],
                                 f["alpha"], f["config"], device))
        else:
            out.append(model(f["sv_x"], f["sv_coef"], f["beta"], f["alpha"],
                             f["config"], device))
    stats = FitStats(n_problems=len(out))
    return multi.OvRSVMModel(np.asarray(classes), out, stats,
                             multi._union_model(out))


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


# -- LM substrate ------------------------------------------------------------

def model_config(fields: dict) -> ModelConfig:
    """A port ``ModelConfig`` from the reference config's fields
    (``dataclasses.asdict(ref_cfg)``): the two types agree field for
    field. ``use_flash`` is dropped (left at its default): the port's
    attention does not read it."""
    return ModelConfig(**{k: v for k, v in fields.items()
                          if k not in _DROP})


def lm_params(tree: dict, device: str = "cuda") -> dict:
    """The port's parameter tree from the reference's, given as nested
    dicts of numpy arrays (e.g. ``jax.tree.map(np.asarray, params)``): any
    family's, stacked groups (``groups``, ``m_groups``, ...) included.
    Leaves keep their type, so the fp32 leaves of a bf16 config (an MoE
    ``router``, xLSTM gates, Zamba2's ``a_log`` / ``dt_bias``) stay fp32;
    bf16 leaves (``ml_dtypes.bfloat16`` arrays) go through float32, which
    holds every bf16 value exactly."""
    dev = devmod.resolve(device)

    def leaf(a) -> torch.Tensor:
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.astype(np.float32),
                                device=dev).to(torch.bfloat16)
        return torch.tensor(a, device=dev)

    def walk(t):
        return {k: walk(v) if isinstance(v, dict) else leaf(v)
                for k, v in t.items()}

    return walk(tree)


def adamw_state(tree: dict, device: str = "cuda") -> dict:
    """The port's AdamW state (``optim.adamw.init``'s layout) from the
    reference's ``{'m', 'v', 'step'}`` given as numpy arrays: the fp32
    moments through :func:`lm_params`, the step an int32 0-d tensor."""
    dev = devmod.resolve(device)
    return {"m": lm_params(tree["m"], device),
            "v": lm_params(tree["v"], device),
            "step": torch.tensor(np.asarray(tree["step"]), dtype=torch.int32,
                                 device=dev)}
