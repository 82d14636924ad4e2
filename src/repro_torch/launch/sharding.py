"""Sharding rules (twin of ``repro.launch.sharding``): logical parameter,
cache and batch layouts -> specs, and the explicit moves between a whole
tensor and the block a rank holds.

The rule tables are the reference's MaxText-style tables, regex for
regex, with its *divisibility-aware fallbacks*: each leaf (matched by its
dot-joined tree path) carries an ordered list of candidate specs over its
trailing dims, and the first whose named axes divide those dims wins
(yi-34b's 56 heads don't divide the 16-way model axis, so its attention
shards head_dim = 128 instead).

Conventions, as there:
  'model'  tensor/expert parallel axis: attention heads (head_dim where
           the heads do not divide), the FFN width, the experts, the
           vocabulary, and the heads, columns and channels of the Mamba2
           and xLSTM leaves (:func:`model_role`)
  'data'   FSDP axis for parameters & optimizer moments (intra-pod);
           multi-pod keeps params replicated across 'pod'
  batch    activations shard over ('pod','data') combined

A :class:`Spec` plays ``PartitionSpec``'s part: one entry per leading dim,
each None (replicated), an axis name, or a tuple of axis names (the dim
split over their product, major to minor in the tuple's order, as a
``NamedSharding`` splits it). Trailing dims past the entries are
replicated.
"""
from __future__ import annotations

import math
import re
from typing import Any

import torch

from repro_torch.launch import dist
from repro_torch.launch.mesh import batch_axes


class Spec(tuple):
    """``Spec(*entries)``: a partition spec (see the module docstring)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "Spec" + tuple.__repr__(self)


# (regex on the dot-joined tree path, [candidate trailing-dim specs]
#  [, the role of each trailing dim where 'model' splits it: what the
#  sharded step's tensor-parallel product splits, model_role]); the
#  reference's one rule for a_log / dt_bias / bias / b_gates is two here,
#  with the same candidates, as the sLSTM ``bias``'s last dim is head_dim
_PARAM_RULES: list[tuple] = [
    (r"\bembed$",        [("model", "data"), (None, "data"), (None, None)],
     ("vocab", None)),
    (r"\bunembed$",      [("data", "model"), (None, "model"), (None, None)],
     (None, "vocab")),
    (r"\bw[qkv]$",       [("data", "model", None), ("data", None, "model"),
                          (None, "model", None), (None, None, "model"),
                          (None, None, None)],
     (None, "heads", "head_dim")),
    (r"\bwo$",           [("model", None, "data"), (None, "model", "data"),
                          (None, None, "data"), (None, None, None)],
     ("heads", "head_dim", None)),
    (r"\bw_(gate|up)$",  [("data", "model"), (None, "model"), (None, None)],
     (None, "ffn")),
    (r"\bw_down$",       [("model", "data"), ("model", None), (None, None)],
     ("ffn", None)),
    (r"\bwe_(gate|up)$", [("model", "data", None), (None, "data", None),
                          (None, None, None)],
     ("experts", None, None)),
    (r"\bwe_down$",      [("model", None, "data"), (None, None, "data"),
                          (None, None, None)],
     ("experts", None, None)),
    (r"\brouter$",       [(None, None)]),
    (r"\bb[qkv]$",       [("model", None), (None, "model"), (None, None)],
     ("heads", "head_dim")),
    # xLSTM
    (r"\bw_gates$",      [(None, None, None)]),
    (r"\br$",            [(None, "model", None, None),
                          (None, None, None, None)],
     (None, "heads", None, None)),
    (r"\bwx$",           [("data", None, "model", None),
                          ("data", None, None, "model"),
                          (None, None, None, None)],
     (None, None, "heads", "head_dim")),
    # mamba / zamba
    (r"\bw_in$",         [("data", "model"), (None, "model"), (None, None)],
     (None, "columns")),
    (r"\bw_out$",        [("model", "data"), ("model", None), (None, None)],
     ("heads", None)),
    (r"\bconv_w$",       [(None, "model"), (None, None)],
     (None, "channels")),
    (r"\b(a_log|dt_bias|b_gates)$", [("model",), (None,)], ("heads",)),
    (r"\bbias$",         [("model",), (None,)], ("head_dim",)),
    (r"\bln", [(None,)]),
]

_CACHE_RULES: list[tuple[str, list[tuple]]] = [
    # transformer KV cache: (layers, B, S, Hkv, hd)
    (r"\b[kv]$", [("batch", None, "model", None), ("batch", None, None, "model"),
                  (None, None, "model", None), (None, None, None, "model"),
                  (None, None, None, None)]),
    # zamba shared-attn caches: (G, B, S, Hkv, hd) — B may be 1 (long_500k):
    # fall back to sharding the sequence dim (contraction dim -> psum)
    (r"\ba[kv]$", [("batch", None, "model", None),
                   (None, "batch", "model", None),
                   (None, "batch", None, "model"),
                   (None, None, None, None)]),
    # xlstm mLSTM matrix memory: (..., B, H, dh, dh)
    (r"\b(m_C|t_C)$", [("batch", "model", None, None),
                       ("batch", None, "model", None),
                       (None, "model", None, None), (None,) * 4]),
    (r"\b(m_n|t_n)$", [("batch", "model", None), (None, "model", None),
                       (None, None, None)]),
    (r"\b(m_m|t_m)$", [("batch", "model"), (None, "model"), (None, None)]),
    (r"\bs_state",    [("batch", "model", None), (None, "model", None),
                       (None, None, None)]),
    # mamba states: conv (..., B, K-1, C), ssm (..., B, H, N, P)
    (r"\b(g_conv|t_conv)$", [("batch", None, "model"), (None, None, "model"),
                             (None, None, None)]),
    (r"\b(g_ssm|t_ssm)$", [("batch", "model", None, None),
                           (None, "model", None, None), (None,) * 4]),
    (r"\bpos$",       [()]),
]


# ------------------------------------------------------------------ trees
def map_with_path(fn, tree: Any, path: tuple = ()):
    """``fn(dot-joined path, leaf)`` over a nested dict / tuple / list
    (the reference's ``_path_str`` of a pytree path), in its structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], path + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, Spec):
        out = [map_with_path(fn, v, path + (str(i),))
               for i, v in enumerate(tree)]
        return tuple(out) if isinstance(tree, tuple) else out
    return fn(".".join(path), tree)


def leaves(tree: Any) -> list:
    """The leaves of a nested dict / tuple / list (a Spec is a leaf), dict
    keys sorted (``adamw.leaves``' order)."""
    out = []
    map_with_path(lambda _, x: out.append(x), tree)
    return out


def leaf_paths(tree: Any) -> list:
    """The dot-joined paths of the leaves, in :func:`leaves`' order."""
    out = []
    map_with_path(lambda p, _: out.append(p), tree)
    return out


def _shape(leaf) -> tuple:
    return tuple(getattr(leaf, "shape", ()))


def _sizes(mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


# ------------------------------------------------------------------ rules
def _spec_for(path_s: str, shape: tuple, mesh, rules, batch_ax) -> Spec:
    sizes = _sizes(mesh)

    def ax_size(name) -> int:
        if name == "batch":
            return math.prod(sizes[a] for a in batch_ax) if batch_ax else 1
        return sizes.get(name, 0)

    def resolve(name):
        return batch_ax if name == "batch" else name

    for pat, candidates, *_ in rules:
        if re.search(pat, path_s):
            for cand in candidates:
                if len(cand) > len(shape):
                    continue
                dims = shape[len(shape) - len(cand):]
                ok = all(a is None or (ax_size(a) and dim % ax_size(a) == 0)
                         for a, dim in zip(cand, dims))
                if ok:
                    full = (None,) * (len(shape) - len(cand)) + tuple(
                        resolve(a) for a in cand)
                    return Spec(*full)
            return Spec()
    # default: replicate (scalars, counters)
    return Spec()


def param_specs(shape_tree: Any, mesh, layout: str = "tp"):
    """Spec tree for a parameter (or optimizer-moment) tree.

    layout='fsdp': the model axis joins data parallelism — every parameter
    shards its first divisible dim over the combined ('data','model') axes
    (pure ZeRO-3; no tensor parallelism)."""
    ba = batch_axes(mesh)
    if layout == "fsdp":
        sizes = _sizes(mesh)
        fs = tuple(a for a in ("data", "model") if a in sizes)
        nfs = math.prod(sizes[a] for a in fs) if fs else 1

        def f(_, leaf):
            shape = _shape(leaf)
            # largest-first: prefer sharding the biggest divisible dim
            order = sorted(range(len(shape)), key=lambda i: -shape[i])
            for i in order:
                if shape[i] % nfs == 0 and shape[i] >= nfs:
                    spec = [None] * len(shape)
                    spec[i] = fs
                    return Spec(*spec)
            return Spec()

        return map_with_path(f, shape_tree)

    return map_with_path(
        lambda p, leaf: _spec_for(p, _shape(leaf), mesh, _PARAM_RULES, ba),
        shape_tree)


def strip_fsdp(spec_tree: Any):
    """Remove 'data'/'pod' (FSDP) axes from parameter specs -> the
    gathered-weights layout of gather-params-once-per-step."""
    def keep(a):
        if a is None:
            return None
        if isinstance(a, (tuple, list)):
            kept = tuple(x for x in a if x not in ("data", "pod"))
            return kept if kept else None
        return None if a in ("data", "pod") else a

    return map_with_path(lambda _, s: Spec(*map(keep, s)), spec_tree)


def model_role(path_s: str, spec: Spec) -> "tuple | None":
    """(dim, role) of the dim of a leaf that the 'model' axis splits under
    the tp layout, the role (from the rule table) one of 'heads',
    'head_dim' (the table's fallback where the heads do not divide),
    'ffn', 'experts', 'vocab', 'columns' (a Mamba2 ``w_in``'s, which do
    not fall on heads) and 'channels' (its ``conv_w``'s); None where
    'model' splits no dim of the leaf. Norms, the router and the mLSTM
    gates are replicated over 'model', as the table has them.
    ``launch.train_lib.MeshStep`` decides from these which leaf groups
    its forward computes split."""
    for pat, _, *roles in _PARAM_RULES:
        if re.search(pat, path_s):
            roles = roles[0] if roles else ()
            for i, axs in sharded_dims(spec):
                j = len(roles) - (len(spec) - i)
                if "model" in axs and j >= 0 and roles[j]:
                    return i, roles[j]
            return None
    return None


def cache_specs(shape_tree: Any, mesh):
    ba = batch_axes(mesh)
    return map_with_path(
        lambda p, leaf: _spec_for(p, _shape(leaf), mesh, _CACHE_RULES, ba),
        shape_tree)


def batch_axes_for(mesh, layout: str = "tp") -> tuple:
    """The axes a batch shards over: ('pod','data'), plus 'model' under the
    fsdp layout (which folds it into data parallelism)."""
    names = ("pod", "data", "model") if layout == "fsdp" else ("pod", "data")
    return tuple(a for a in names if a in mesh.axis_names)


def batch_specs(batch_tree: Any, mesh, layout: str = "tp"):
    """Token/embedding batches: shard dim 0 over the batch axes when it
    divides, else replicate (long_500k's batch=1)."""
    ba = batch_axes_for(mesh, layout)
    n = math.prod(_sizes(mesh)[a] for a in ba) if ba else 1

    def f(_, leaf):
        shape = _shape(leaf)
        if len(shape) >= 1 and n and shape[0] % n == 0:
            return Spec(ba, *([None] * (len(shape) - 1)))
        return Spec(*([None] * len(shape)))

    return map_with_path(f, batch_tree)


def logits_spec(mesh) -> Spec:
    return Spec(batch_axes(mesh), None, "model")


# ------------------------------------------------------ blocks of a tensor
def entry_axes(entry) -> tuple:
    """The axes of one spec entry: () for None, else a tuple of names."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_axes(spec: Spec) -> tuple:
    """Every axis a spec names, in entry order."""
    return tuple(a for e in spec for a in entry_axes(e))


def sharded_dims(spec: Spec) -> list:
    """[(dim, axes)] of the dims a spec splits."""
    return [(i, entry_axes(e)) for i, e in enumerate(spec) if entry_axes(e)]


def block(spec: Spec, shape, mesh, coord: dict) -> tuple:
    """The index (a tuple of slices, one a dim) of the block that the rank
    at ``coord`` holds of a tensor of ``shape``: a dim split over a tuple
    of axes takes its part at the coordinates' row-major index over them,
    major to minor in the tuple's order (``NamedSharding``'s layout)."""
    sizes = _sizes(mesh)
    out = [slice(0, int(d)) for d in shape]
    for i, axs in sharded_dims(spec):
        n = math.prod(sizes[a] for a in axs)
        idx = 0
        for a in axs:
            idx = idx * sizes[a] + coord[a]
        if shape[i] % n:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"over {axs} ({n})")
        part = shape[i] // n
        out[i] = slice(idx * part, (idx + 1) * part)
    return tuple(out)


def block_shape(spec: Spec, shape, mesh) -> tuple:
    """The shape of every rank's block."""
    sizes = _sizes(mesh)
    out = list(shape)
    for i, axs in sharded_dims(spec):
        out[i] //= math.prod(sizes[a] for a in axs)
    return tuple(out)


def shard(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` (a copy)."""
    return t[block(spec, t.shape, mesh, mesh.coord)].clone()


def gather(b: torch.Tensor, spec: Spec, mesh,
           keep: tuple = ()) -> torch.Tensor:
    """The whole tensor from every rank's block ``b``: one all-gather a
    split dim, over the group of its axes. A bit copy. A dim split over an
    axis of ``keep`` stays this rank's block (``keep=('model',)``: the
    block a tensor-parallel product takes, :func:`strip_fsdp`'s layout
    reached by gathering); a dim "split" over axes of size 1 is whole
    already, and makes no collective."""
    sizes = _sizes(mesh)
    for i, axs in sharded_dims(spec):
        if set(axs) & set(keep) or math.prod(sizes[a] for a in axs) == 1:
            continue
        if mesh.ordered(axs) != axs:
            raise ValueError(f"{spec}: axes {axs} are not in the mesh's "
                             f"order {mesh.axis_names}")
        b = dist.all_gather_rows(b, i, group=mesh.group(axs))
    return b


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """This rank's blocks of a tree of whole tensors."""
    return _zip_map(lambda t, s: shard(t, s, mesh), tree, specs)


def gather_tree(tree: Any, specs: Any, mesh) -> Any:
    """The whole tensors of a tree of this rank's blocks."""
    return _zip_map(lambda b, s: gather(b, s, mesh), tree, specs)


def _zip_map(fn, tree: Any, specs: Any):
    it = iter(leaves(specs))
    return map_with_path(lambda _, x: fn(x, next(it)), tree)
