"""Step builders (twin of ``repro.launch.train_lib``): the loss, the
train step with gradient accumulation (on one device or on a mesh), the
specs of a sharded state (``shardings_for``, ``serve_shardings``), the
prefill step and the greedy decode step (on one device, or on a mesh:
:class:`MeshServe`). PyTorch runs
eagerly, so each builder returns a plain function or callable (the
reference returns what it jit-compiles).

On a mesh (``launch.mesh.make_mesh``, one process a device) the step is
explicit where the reference's is one GSPMD program:

* each rank holds its block of every parameter and AdamW moment, as
  ``sharding.param_specs`` assigns it under ``cfg.layout``;
* it takes the global batch, like the reference's step, and reads only
  its rows of each microbatch: a microbatch splits over the batch axes
  (('pod','data'); with 'model' under the fsdp layout) when it divides
  over them, else every rank takes all of it;
* gather: as the reference's GSPMD gathers FSDP blocks inside its layer
  scan, the model gets this rank's blocks (inside ``common.fsdp_blocks``)
  and gathers each layer's over their batch axes ('data', with 'model'
  under the fsdp layout) as the layer runs, inside its remat block, so
  the recompute gathers again (``common.weights``, ``dist.gather_block``);
  ``embed``, ``ln_f`` and ``unembed`` are gathered at their use, zamba2's
  shared block once a microbatch. With ``gather_params_once`` it gathers
  every whole leaf once a step instead (the reference's ``strip_fsdp``
  layout). Under the tp layout the leaves that 'model' splits stay this
  rank's 'model' block (below), the rest come whole;
* compute: loss and gradients of its rows; the loss divides by the
  batch's count of unmasked targets (all-reduced first) and the MoE
  router's batch means are reduced inside the forward
  (``common.sharded_batch``), so the ranks' losses add up to the batch's;
* reduce: it sums the fp32 gradients over the batch axes (and 'model'
  for a leaf used in part) and keeps its block (a reduce-scatter over the
  axes that split both, a local slice over axes that split the leaf only,
  an all-reduce over axes that split the batch only); a 'model' block's
  gradient is already its block. The
  backward does it a layer at a time, as it leaves the layer, into fp32
  buffers of this rank's blocks (the shared block's after its last use),
  so no rank makes the whole model's gradient; with
  ``gather_params_once``, once a step, on the whole leaves' gradients;
* update: AdamW on its blocks, with the global norm of the blocks (each
  block counted by one of the ranks that hold it).

Under the tp layout the 'model' axis is the tensor and expert parallel
axis, as the reference's GSPMD makes it (``launch.sharding.model_role``):
each rank holds and computes its 'model' block of the attention heads (or
of head_dim, where the heads do not divide: q, k and v are then gathered
and the attention runs whole), of the FFN width, of the experts and of
the vocabulary, and of the heads of a Mamba2 layer, an mLSTM block and an
sLSTM block, inside ``common.model_parallel`` (given ``MeshStep.roles``).
A split block ends in one all-reduce over 'model', and its input's
gradient is all-reduced in the backward. The recurrent blocks keep the
table's blocks too where these do not fall on heads (a Mamba2 ``w_in``'s
and an mLSTM ``w_up``'s columns): each rank computes its block of the
in-projection and the blocks are gathered (a reduce-scatter in the
backward). The leaves a rank gets whole and uses in part (role 'part':
a Mamba2 layer's ``conv_w`` and ``ln_h``, an mLSTM block's ``w_gates``
and ``ln_h``, an sLSTM block's ``bias`` and ``ln_h``) have their
gradients summed over 'model'; their gated norms sum their squares over
'model'. Other norms and the router stay replicated. No rank makes a
split leaf's whole weight or its whole fp32 gradient. A leaf group whose
split the model cannot compute (the table's candidates differ between
``wq`` and ``wo``, or xlstm-125m's 4 heads on a 'model' of 16) is
gathered whole over 'model', as is everything at a 'model' of size 1 and
under the fsdp layout (where 'model' joins the batch axes).
:meth:`MeshStep.plan` lists every collective the step makes, with its
group and bytes; ``launch.dryrun`` prices the same plan.

With ``cfg.seq_parallel`` (the reference's ``constrain_hidden``: 'model'
in the mesh, L a multiple of its size and more than 1) a transformer's
residual stream between its products is this rank's block of L: each
split product's input is all-gathered over L and its output
reduce-scattered (all-reduced without), the norms run on the block and
their gradients are summed over 'model'; the plan lists these (``sp
...``). :class:`MeshServe` is the serving step on the same blocks,
forward only.
"""
from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import torch

from repro_torch.launch import dist
from repro_torch.launch import sharding as shd
from repro_torch.models import common
from repro_torch.models.api import ModelConfig, build
from repro_torch.optim import adamw, compress


# ----------------------------------------------------------------- train
def make_loss_fn(cfg: ModelConfig):
    """loss_fn(params, batch) -> (loss, metrics): cross-entropy on
    ``batch['targets']``, plus ``router_aux_weight`` times the MoE aux term
    (reported as ``router_aux``)."""
    model = build(cfg)

    def loss_fn(params: dict, batch: dict) -> tuple:
        logits, aux = model.forward(params, cfg, batch)
        loss, metrics = common.cross_entropy(logits, batch["targets"])
        if cfg.is_moe:
            loss = loss + cfg.router_aux_weight * aux
            metrics = dict(metrics, router_aux=aux)
        return loss, metrics

    return loss_fn


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig,
                    mesh=None, grad_compress: "str | None" = None,
                    accum_steps: int = 1, gather_params_once: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), which updates ``params`` and ``opt_state`` in place (the
    reference's step donates both).

    Gradients come from ``torch.autograd.grad`` over aliases of the
    parameter leaves, so no ``.grad`` lingers and the caller's tensors
    never require grad. ``accum_steps`` > 1 splits the batch into that
    many equal microbatches and sums their gradients in fp32, then
    divides; the loss is the microbatches' mean, the other metrics the
    last one's. With a ``mesh`` it is a :class:`MeshStep` over this rank's
    blocks (``grad_compress`` then acts over a 'pod' axis, as in the
    reference); without one, ``grad_compress`` and ``gather_params_once``
    have no effect."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    if mesh is not None:
        return MeshStep(cfg, opt_cfg, mesh, grad_compress, accum_steps,
                        gather_params_once)
    loss_fn = make_loss_fn(cfg)

    def grads_of(params: dict, batch: dict) -> tuple:
        flat = [w.detach().requires_grad_() for w in adamw.leaves(params)]
        loss, metrics = loss_fn(adamw.tree_like(params, flat), batch)
        grads = torch.autograd.grad(loss, flat)
        return loss.detach(), {k: m.detach() for k, m in metrics.items()}, \
            grads

    def train_step(params: dict, opt_state: dict, batch: dict) -> tuple:
        if accum_steps > 1:
            per = _microbatch(batch, accum_steps)
            gsum = [torch.zeros(w.shape, dtype=torch.float32,
                                device=w.device)
                    for w in adamw.leaves(params)]
            lsum = 0.0
            for i in range(accum_steps):
                micro = {k: x[i * per: (i + 1) * per]
                         for k, x in batch.items()}
                loss, metrics, grads = grads_of(params, micro)
                for a, g in zip(gsum, grads):
                    a.add_(g.float())
                del grads
                lsum = lsum + loss
            grads = [g.div_(accum_steps) for g in gsum]
            loss = lsum / accum_steps
        else:
            loss, metrics, grads = grads_of(params, batch)
        params, opt_state, om = adamw.update(opt_cfg, grads, opt_state,
                                             params)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return train_step


def _microbatch(batch: dict, accum_steps: int) -> int:
    n = next(iter(batch.values())).shape[0]
    if n % accum_steps:
        raise ValueError(f"batch of {n} does not split into "
                         f"{accum_steps} equal microbatches")
    return n // accum_steps


def _nbytes(shape, dtype: torch.dtype) -> int:
    return math.prod(shape) * dtype.itemsize


class _Unit(NamedTuple):
    """A leaf's unit of the per-layer gather: one layer of a stack (a
    top-level leaf is its own unit)."""
    lead: int                 # the stacked leading dims
    count: int                # the units a forward gathers
    passes: int               # the gathers of each (2: remat's recompute)
    spec: "shd.Spec"          # a unit's spec
    meta: torch.Tensor        # a meta tensor of a unit's shape


_CODECS = (None, "bf16", "int8")
_QKV = ("wq", "wk", "wv", "bq", "bk", "bv")
# the leaf groups of the recurrent blocks that split over 'model' together:
# the table's role each needs, the leaves each rank then gets whole and
# uses in part ('part': gradients summed over 'model'), and the roles the
# model reads where the table's name for the dim is another block's
_MAMBA = ({"w_in": "columns", "w_out": "heads", "a_log": "heads",
           "dt_bias": "heads"}, ("conv_w", "ln_h"), {})
_MLSTM = ({"mlstm.w_up": "ffn", "mlstm.w_down": "ffn", "mlstm.wq": "heads",
           "mlstm.wk": "heads", "mlstm.wv": "heads",
           "mlstm.b_gates": "heads"}, ("mlstm.w_gates", "mlstm.ln_h"),
          {"mlstm.w_up": "columns", "mlstm.w_down": "heads"})
_SLSTM = ({"slstm.wx": "heads", "slstm.r": "heads"},
          ("slstm.bias", "slstm.ln_h"), {})


# the families whose forward has the reference's constrain_hidden (where
# ``seq_parallel`` acts)
_TRANSFORMER = ("dense", "moe", "vlm", "audio")
# the leaves a transformer layer uses in part under seq_parallel (the norms
# run on this rank's block of L): their gradients are summed over 'model'
_SEQ_PART = ("ln1", "ln2", "ln_f")


class _MeshModel:
    """What the train and serving steps on a mesh share: the parameter
    tree's shapes and ``cfg.layout``'s specs, each leaf's unit of the
    per-layer gather, and the 'model' roles (``roles``, ``split``,
    ``summed``; under ``seq_parallel`` ``seq_roles`` and ``seq_summed``)."""

    def __init__(self, cfg: ModelConfig, mesh,
                 gather_params_once: bool = False):
        self.cfg, self.mesh, self.once = cfg, mesh, gather_params_once
        self.model = build(cfg)
        self.tree = self.model.init(cfg, common.MetaDraw())
        self.shapes = adamw.leaves(self.tree)
        self.specs = shd.leaves(shd.param_specs(self.tree, mesh, cfg.layout))
        paths = shd.leaf_paths(self.tree)
        self.index = {p: j for j, p in enumerate(paths)}
        self.units = []
        for p, x, spec in zip(paths, self.shapes, self.specs):
            lead, rem = self.model.STACKS.get(p.split(".")[0], (0, False))
            lead_axes = [a for e in spec[:lead] for a in shd.entry_axes(e)]
            if not self.once and math.prod(mesh.sizes[a]
                                           for a in lead_axes) > 1:
                raise ValueError(
                    f"{p} {tuple(x.shape)}: the {cfg.layout} layout splits "
                    f"its stacked layer dim ({spec}), so a layer lives "
                    f"whole on one rank and the per-layer gather has no "
                    f"block to gather; pass gather_params_once=True, or "
                    f"use a mesh whose batch axes divide another dim")
            self.units.append(_Unit(
                lead, math.prod(x.shape[:lead]),
                2 if rem and cfg.remat == "full" else 1,
                shd.Spec(*spec[lead:]),
                torch.empty(x.shape[lead:], dtype=x.dtype, device="meta")))
        self.n_model = mesh.sizes.get("model", 1)
        # leaf key (self._key) -> the role of the dim whose 'model' block
        # the forward takes, or 'part' for a leaf it gets whole and uses in
        # part (common.model_parallel reads it); empty: all gathered whole
        self.roles = {}
        if cfg.layout == "tp" and self.n_model > 1:
            self.roles = self._split_roles(paths)
        keys = [self._key(p) for p in paths]
        self.split = [self.roles.get(k) not in (None, "part") for k in keys]
        self.summed = [self.roles.get(k) == "part" for k in keys]
        self.tp = bool(self.roles)
        # under seq_parallel the norms, and an embedding gathered whole, run
        # on this rank's block of L: used in part
        part = list(_SEQ_PART) + (["embed"] if "embed" in keys
                                  and "embed" not in self.roles else [])
        self.seq_roles = dict(self.roles, **{k: "part" for k in part})
        self.seq_summed = [self.seq_roles.get(k) == "part" for k in keys]

    def _key(self, path: str) -> str:
        """A leaf's key in :attr:`roles`: its name, scoped by its stack
        where the family's names mean two things (``ROLE_SCOPES``)."""
        scope = getattr(self.model, "ROLE_SCOPES", {}).get(
            path.split(".")[0])
        name = path.rsplit(".", 1)[-1]
        return f"{scope}.{name}" if scope else name

    def _seq(self, seq: int, split: tuple) -> bool:
        """Whether ``cfg.seq_parallel`` puts L over 'model' for sequences of
        ``seq`` positions whose rows split over ``split``: the reference's
        ``constrain_hidden`` condition ('model' in the mesh, ``seq`` a
        multiple of its size and more than 1), in the transformer families
        (the others have no such constraint). Under the fsdp layout rows
        that split over the batch axes split over 'model' too, and the
        reference's constraint then names 'model' twice, which JAX refuses
        (``DuplicateSpecError``, on a 4-device host mesh): so does this.
        Where the rows do not split, or 'model' has size 1, it places
        nothing and the function is the same: the port computes as without
        it. Under tp with 'model' > 1 the layer's attention and FFN must be
        split over 'model' (their products join the L blocks)."""
        cfg = self.cfg
        if not (cfg.seq_parallel and cfg.family in _TRANSFORMER
                and "model" in self.mesh.sizes and seq % self.n_model == 0
                and seq > 1):
            return False
        if "model" in split:
            raise ValueError(
                f"seq_parallel with the batch split over {split}: the "
                f"{cfg.layout} layout's batch axes hold 'model', and the "
                f"residual stream's constraint would name 'model' twice "
                f"(the reference raises DuplicateSpecError)")
        if not self.tp:
            return False
        if "wo" not in self.roles or not ({"w_gate", "we_gate"}
                                          & set(self.roles)):
            raise ValueError(
                f"seq_parallel on {cfg.name}: its attention or FFN is not "
                f"split over 'model' (split: {sorted(self.roles)}), so no "
                f"product joins the L blocks")
        return True

    def _split_roles(self, paths: list) -> dict:
        """The leaves (by key, with the role of their split dim) whose
        'model' block the forward takes: a group of leaves is split where
        the model can compute each of its products from the blocks the
        table gives (attention all by heads, k and v by heads or head_dim,
        with whole GQA groups a rank, or all by head_dim; the FFN by its
        width; the experts; each vocabulary table; a Mamba2 layer, an
        mLSTM block and an sLSTM block by heads, where the table splits
        every one of their leaves that it names on heads, or on columns
        that the model gathers). A split recurrent block also lists the
        leaves it gets whole and uses in part ('part')."""
        cfg = self.cfg
        role = {self._key(p): (shd.model_role(p, s) or (0, None))[1]
                for p, s in zip(paths, self.specs)}
        kept = {}
        if "wo" in role:
            qkv = [n for n in _QKV if n in role]
            h_loc = cfg.n_heads // self.n_model
            g = cfg.n_heads // cfg.n_kv_heads
            by_heads = (
                role["wo"] == role["wq"] == role.get("bq", "heads") == "heads"
                and all(role[w] in ("heads", "head_dim")
                        and role.get("b" + w[1], role[w]) == role[w]
                        for w in ("wk", "wv"))
                and (h_loc % g == 0 or g % h_loc == 0))
            by_dim = all(role[n] == "head_dim" for n in qkv + ["wo"])
            if by_heads or by_dim:
                kept.update({n: role[n] for n in qkv + ["wo"]})
        for group, want in ((("w_gate", "w_up", "w_down"), "ffn"),
                            (("slstm.w_gate", "slstm.w_up", "slstm.w_down"),
                             "ffn"),
                            (("we_gate", "we_up", "we_down"), "experts"),
                            (("embed",), "vocab"), (("unembed",), "vocab")):
            if all(role.get(n) == want for n in group):
                kept.update({n: want for n in group})
        for need, part, rename in (_MAMBA, _MLSTM, _SLSTM):
            if all(role.get(n) == r for n, r in need.items()):
                kept.update({n: rename.get(n, r) for n, r in need.items()})
                kept.update({n: "part" for n in part})
        return kept

    def local_shapes(self) -> list:
        """The shape of each leaf as the forward gets it: whole, or this
        rank's 'model' block of a split leaf."""
        out = []
        for x, spec, split in zip(self.shapes, self.specs, self.split):
            shape = list(x.shape)
            for i, axs in shd.sharded_dims(spec):
                if split and "model" in axs:
                    shape[i] //= self.n_model
            out.append(tuple(shape))
        return out

    def gather_plan(self, calls: int = 1, whole: bool = False,
                    per_layer: bool = False, remat: bool = True) -> list:
        """The plan's all-gathers of the parameters, ``calls`` times: one a
        split dim of each leaf, of the block gathered so far; a split
        leaf's 'model' dim stays its block unless ``whole`` (every whole
        parameter: what a step that runs the whole model on every rank
        would gather). ``per_layer``:
        of each unit (a layer of a stack, whose stacked dims are not split;
        a top-level leaf), every unit once a forward, and a unit under
        remat again in its recompute (``remat``: a pass that records
        gradients; serving runs none)."""
        sizes, out = self.mesh.sizes, []
        for x, spec, split, unit in zip(self.shapes, self.specs, self.split,
                                        self.units):
            n = calls
            if per_layer:
                n = calls * unit.count * (unit.passes if remat else 1)
                spec, x = unit.spec, unit.meta
            cur = list(shd.block_shape(spec, x.shape, self.mesh))
            for i, axs in shd.sharded_dims(spec):
                g = math.prod(sizes[a] for a in axs)
                if split and not whole and "model" in axs or g == 1:
                    continue
                out.append(dict(op="all_gather", axes=axs, group=g,
                                bytes=_nbytes(cur, x.dtype), calls=n,
                                what="params"))
                cur[i] *= g
        return out


class MeshStep(_MeshModel):
    """The train step on a live mesh (see the module docstring): called as
    ``step(params, opt_state, batch)`` with this rank's blocks of params
    and moments (``shardings_for``'s specs) and the global batch; it
    returns ``(params, opt_state, metrics)``, plus the residuals of the
    compressed pod exchange as a fourth value when ``grad_compress`` is
    set and the mesh has a 'pod' axis (pass them back in as
    ``residuals``).

    The pod path keeps the reference's per-pod semantics (its step vmaps
    over 'pod'): each pod's loss, aux term and gradient are its own
    (global over its other batch axes); the codec acts on each pod's fp32
    gradient plus its residual; the gradient is the mean over pods of the
    decoded values, which travel compressed (an all-gather of int8 codes
    and their scales, or of bf16 values); the loss is the mean of the
    pods'. A rank's residual is its block of its pod's row. With
    ``accum_steps`` > 1 each microbatch starts from a zero residual and
    the residuals come back as passed in, as there."""

    def __init__(self, cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, mesh,
                 grad_compress: "str | None" = None, accum_steps: int = 1,
                 gather_params_once: bool = False):
        if grad_compress not in _CODECS:
            raise ValueError(f"grad_compress must be one of {_CODECS}, got "
                             f"{grad_compress!r}")
        super().__init__(cfg, mesh, gather_params_once)
        self.opt_cfg, self.accum = opt_cfg, accum_steps
        self.use_pod = bool(grad_compress) and "pod" in mesh.axis_names
        self.codec = grad_compress if self.use_pod else None
        self.in_pod = tuple(a for a in mesh.axis_names if a != "pod")

    # -------------------------------------------------------- the layout
    def layout(self, rows: int) -> tuple:
        """(rows of a microbatch, the axes its rows split over, the axes its
        gradients sum over) for a global batch of ``rows``. The pod path
        splits over 'pod' first, and sums within a pod."""
        sizes = self.mesh.sizes
        per = rows // self.accum
        if rows % self.accum:
            raise ValueError(f"batch of {rows} does not split into "
                             f"{self.accum} equal microbatches")
        bax = shd.batch_axes_for(self.mesh, self.cfg.layout)
        lead = ()
        if self.use_pod:
            if per % sizes["pod"]:
                raise ValueError(f"a microbatch of {per} does not split "
                                 f"over {sizes['pod']} pods")
            lead, per_pod = ("pod",), per // sizes["pod"]
            bax = tuple(a for a in bax if a != "pod")
        else:
            per_pod = per
        red = bax if per_pod % math.prod(sizes[a] for a in bax) == 0 \
            else ()
        return per, lead + red, red

    def _rows(self, i: int, per: int, split: tuple) -> slice:
        sizes, coord = self.mesh.sizes, self.mesh.coord
        n, idx = 1, 0
        for a in split:
            n, idx = n * sizes[a], idx * sizes[a] + coord[a]
        size = per // n
        return slice(i * per + idx * size, i * per + (idx + 1) * size)

    # ------------------------------------------------------- the moves
    def _gather(self, params: dict) -> list:
        return [shd.gather(b, s, self.mesh, ("model",) if split else ())
                for b, s, split in zip(adamw.leaves(params), self.specs,
                                       self.split)]

    def _fetcher(self, token: torch.Tensor, bufs: list, red: tuple,
                 sp: bool):
        """``common.fsdp_blocks``' fetch: a unit's blocks -> its weights,
        each through ``dist.gather_block``, whose backward puts the unit's
        reduced fp32 gradient in ``bufs`` (this rank's blocks, made at the
        first gradient that reaches each: a top-level leaf's is that
        gradient itself, a stack's is zeros, added into a layer at a
        time)."""
        def fetch(tree: dict, path: str, idx: tuple) -> dict:
            out = {}
            for k, b in tree.items():
                j = self.index[f"{path}.{k}" if path else k]
                u = self.units[j]
                if len(idx) != u.lead:
                    raise ValueError(f"{path}.{k}: a layer takes {u.lead} "
                                     f"stack indices, got {idx}")
                keep = ("model",) if self.split[j] else ()

                def sink(g, j=j, idx=idx):
                    if bufs[j] is None and not idx:
                        bufs[j] = g
                        return
                    if bufs[j] is None:
                        bufs[j] = torch.zeros(
                            shd.block_shape(self.specs[j],
                                            self.shapes[j].shape, self.mesh),
                            dtype=torch.float32, device=g.device)
                    bufs[j][idx].add_(g)

                out[k] = dist.gather_block(
                    b, lambda x, u=u, keep=keep: shd.gather(
                        x, u.spec, self.mesh, keep),
                    lambda g, j=j, u=u: self._reduce(
                        g, u.meta, u.spec, self._red(red, j, sp),
                        self.split[j]),
                    sink, token)
            return out
        return fetch

    def _red(self, red: tuple, j: int, sp: bool = False) -> tuple:
        """The axes leaf ``j``'s gradients sum over: the batch axes
        ``red``, and 'model' for a leaf used in part (``summed``; under
        seq_parallel, ``sp``, ``seq_summed``)."""
        if not (self.seq_summed if sp else self.summed)[j]:
            return red
        return self.mesh.ordered(red + ("model",))

    def _reduce(self, g: torch.Tensor, leaf, spec, red: tuple,
                split: bool = False) -> torch.Tensor:
        """This rank's fp32 block of the sum over ``red`` of every rank's
        gradient ``g``: of the whole ``leaf`` (a meta tensor of its shape;
        of one layer on the per-layer path), or of its 'model' block where
        the leaf is ``split``. A ``g`` in another dtype, or sliced, is
        copied once to fp32, laid out as its reduce-scatter reads it (so
        that makes no second copy)."""
        idx = shd.block(spec, leaf.shape, self.mesh, self.mesh.coord)
        local = [i for i, axs in shd.sharded_dims(spec)
                 if not set(axs) & set(red)
                 and not (split and "model" in axs)]
        if local:
            g = g[tuple(idx[i] if i in local else slice(None)
                        for i in range(g.ndim))]
        scatter = []
        for i, axs in shd.sharded_dims(spec):
            if set(axs) <= set(red):
                scatter.append((i, axs))
            elif set(axs) & set(red):
                raise ValueError(f"{spec}: axes {axs} split the batch only "
                                 f"in part ({red})")
        lead = scatter[0][0] if scatter else 0
        moved = g.movedim(lead, 0)
        if local or g.dtype != torch.float32 or not moved.is_contiguous():
            g = torch.empty(moved.shape, dtype=torch.float32,
                            device=g.device).copy_(moved).movedim(0, lead)
        sizes = self.mesh.sizes
        for i, axs in scatter:
            if math.prod(sizes[a] for a in axs) > 1:
                g = dist.reduce_scatter(g, i, self.mesh.group(axs))
        rest = tuple(a for a in red if a not in shd.spec_axes(spec))
        if math.prod(sizes[a] for a in rest) > 1:
            g = dist.all_reduce(g, "sum", self.mesh.group(rest))
        return g.contiguous()

    def _reduce_all(self, grads: list, red: tuple, sp: bool) -> list:
        return [self._reduce(g, x, s, self._red(red, j, sp), k)
                for j, (g, x, s, k) in enumerate(
                    zip(grads, self.shapes, self.specs, self.split))]

    def _owns(self, spec) -> bool:
        """Whether this rank is the first of the ranks that hold its block
        (the one that counts it in the global norm)."""
        named = shd.spec_axes(spec)
        return all(c == 0 for a, c in self.mesh.coord.items()
                   if a not in named)

    def _grads(self, params: dict, full: "list | None", mb: dict,
               count: torch.Tensor, red: tuple, sp: bool):
        """(loss, ce, aux, grads) of this rank's rows ``mb``: its share of
        the microbatch's loss (the whole count divides it; the aux term
        once over the ``red`` ranks), the aux term (the batch's), and the
        gradients: of the gathered leaves ``full`` (whole, or 'model'
        blocks), or, without them, this rank's fp32 blocks of the sums
        over ``red``, which the model's per-layer gathers of ``params``
        (this rank's blocks) reduce in the backward. ``sp``: under
        seq_parallel."""
        cfg, n_red = self.cfg, math.prod(self.mesh.sizes[a] for a in red)
        with contextlib.ExitStack() as ctx:
            if red:
                ctx.enter_context(common.sharded_batch(self.mesh.group(red),
                                                       n_red))
            if self.tp:
                ctx.enter_context(common.model_parallel(
                    self.mesh.group(("model",)), self.n_model,
                    self.mesh.coord["model"],
                    self.seq_roles if sp else self.roles, seq=sp))
            if full is not None:
                flat = [w.detach().requires_grad_() for w in full]
                tree = adamw.tree_like(self.tree, flat)
            else:
                flat = [torch.zeros((), dtype=torch.float32,
                                    device=adamw.leaves(params)[0].device,
                                    requires_grad=True)]
                bufs = [None] * len(self.shapes)
                ctx.enter_context(common.fsdp_blocks(
                    self._fetcher(flat[0], bufs, red, sp)))
                tree = params
            logits, aux = self.model.forward(tree, cfg, mb)
            loss, metrics = common.cross_entropy(logits, mb["targets"],
                                                 count=count)
            if cfg.is_moe:
                loss = loss + cfg.router_aux_weight * aux / n_red
            grads = torch.autograd.grad(loss, flat)
        if full is None:
            missing = [p for p, j in self.index.items() if bufs[j] is None]
            if missing:
                raise RuntimeError(f"no gradient reached {missing}: the "
                                   f"forward must take every leaf through "
                                   f"common.weights")
            grads = bufs
        return loss.detach(), metrics["ce"].detach(), aux.detach(), grads

    def _pod_codec(self, blocks: list, residuals: "list | None") -> tuple:
        """(mean over pods of the decoded ``blocks`` + residuals, the new
        residuals): the reference's per-pod codec, exchanged compressed."""
        pod = self.mesh.group(("pod",))
        npod = self.mesh.sizes["pod"]
        xs = [g + (torch.zeros_like(g) if residuals is None else e)
              for g, e in zip(blocks, residuals or blocks)]
        if self.codec == "int8":
            amax = torch.stack([x.abs().max() for x in xs])
            if self.in_pod:
                amax = dist.all_reduce(amax, "max",
                                       self.mesh.group(self.in_pod))
            scale = torch.clamp(amax, min=1e-12) / 127.0
            codes = [torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
                     for x, s in zip(xs, scale)]
            deq = [compress.dequantize_int8(q, s)
                   for q, s in zip(codes, scale)]
            got = dist.all_gather(torch.cat([q.reshape(-1) for q in codes]),
                                  pod)
            scales = dist.all_gather(scale, pod)
            decode = lambda p, q, j: compress.dequantize_int8(q, scales[p, j])
        else:
            deq = [x.to(torch.bfloat16).float() for x in xs]
            got = dist.all_gather(torch.cat(
                [x.to(torch.bfloat16).reshape(-1) for x in xs]), pod)
            decode = lambda p, q, j: q.float()
        out, off = [], 0
        for j, x in enumerate(xs):
            n = x.numel()
            acc = decode(0, got[0, off: off + n], j)
            for p in range(1, npod):
                acc = acc + decode(p, got[p, off: off + n], j)
            out.append((acc / npod).reshape(x.shape))
            off += n
        return out, [x - d for x, d in zip(xs, deq)]

    # ----------------------------------------------------------- the step
    def __call__(self, params: dict, opt_state: dict, batch: dict,
                 residuals: "dict | None" = None) -> tuple:
        mesh, cfg, A = self.mesh, self.cfg, self.accum
        first = next(iter(batch.values()))
        per, split, red = self.layout(first.shape[0])
        sp = self._seq(first.shape[1], split)
        micro = [{k: x[self._rows(i, per, split)] for k, x in batch.items()}
                 for i in range(A)]
        counts = torch.stack([(mb["targets"] >= 0).float().sum()
                              for mb in micro])
        if red:
            counts = dist.all_reduce(counts, "sum", self.mesh.group(red))
        res_in = None if residuals is None or A > 1 \
            else adamw.leaves(residuals)
        full = self._gather(params) if self.once else None
        acc, vec, new_res = None, [], None
        for i, mb in enumerate(micro):
            loss, ce, aux, grads = self._grads(params, full, mb, counts[i],
                                               red, sp)
            n_red = math.prod(mesh.sizes[a] for a in red)
            vec.append(torch.stack([loss, ce, aux.float() / n_red]))
            if self.once:
                grads = [g.float() for g in grads]
            if self.once and self.use_pod:
                grads = self._reduce_all(grads, red, sp)
            if self.use_pod:
                grads, new_res = self._pod_codec(grads, res_in)
            if A == 1:
                acc = grads
                continue
            if acc is None:
                acc = [torch.zeros_like(g) for g in grads]
            for a, g in zip(acc, grads):
                a.add_(g)
            del grads
        del full
        if A > 1:
            acc = [g.div_(A) for g in acc]
        if self.once and not self.use_pod:
            acc = self._reduce_all(acc, red, sp)
        vec = torch.stack(vec)
        if split:
            vec = dist.all_reduce(vec, "sum", self.mesh.group(split))
        if self.use_pod:
            vec = vec / mesh.sizes["pod"]
        sq = torch.stack([torch.sum(torch.square(g)) if self._owns(s)
                          else torch.zeros((), device=g.device)
                          for g, s in zip(acc, self.specs)])
        sq = dist.all_reduce(sq, "sum", self.mesh.group(mesh.axis_names))
        total = 0.0
        for t in sq:
            total = total + t
        params, opt_state, om = adamw.update(
            self.opt_cfg, acc, opt_state, params, gnorm=torch.sqrt(total))
        if A > 1:
            lsum = 0.0
            for v in vec:
                lsum = lsum + v[0]
            loss = lsum / A
        else:
            loss = vec[0, 0]
        metrics = {"ce": vec[-1, 1]}
        if cfg.is_moe:
            metrics["router_aux"] = vec[-1, 2]
        out = (params, opt_state, dict(metrics, loss=loss, **om))
        if not self.use_pod:
            return out
        if A == 1:
            residuals = adamw.tree_like(params, new_res)
        return out + (residuals,)

    # ----------------------------------------------------------- the plan
    def plan(self, batch_shapes: dict) -> list:
        """Every collective one call of the step makes on this mesh, given
        the global batch's shapes: dicts of ``op`` (the ``launch.dist``
        helper), ``axes``, ``group`` (ranks), ``bytes`` (the tensor the
        helper is handed), ``calls`` and ``what``. Needs no process group
        (an axis view will do)."""
        mesh, cfg, A = self.mesh, self.cfg, self.accum
        sizes = mesh.sizes
        rows, seq = tuple(next(iter(batch_shapes.values())).shape)[:2]
        per, split, red = self.layout(rows)
        sp = self._seq(seq, split)
        out = []

        def add(op, axes, nbytes, calls, what):
            if calls:
                out.append(dict(op=op, axes=tuple(axes),
                                group=math.prod(sizes[a] for a in axes),
                                bytes=int(nbytes), calls=int(calls),
                                what=what))

        if red:
            add("all_reduce", red, 4 * A, 1, "target counts")
        out += self.gather_plan(1) if self.once \
            else self.gather_plan(A, per_layer=True)
        if self.tp:
            mine = per // math.prod(sizes[a] for a in split)
            for op, nbytes, calls, what in self._tp_plan(mine, seq, sp):
                add(op, ("model",), nbytes, A * calls, what)
        if red and cfg.is_moe:
            per_layer = 3 if cfg.remat == "full" else 2
            add("all_reduce", red, 4 * 2 * cfg.n_experts,
                A * cfg.n_layers * per_layer, "router batch means")
        for j, (x, spec, unit) in enumerate(zip(self.shapes, self.specs,
                                                self.units)):
            if self.once:
                n_reduce = A if self.use_pod else 1
            else:                        # a unit's, as the backward leaves it
                n_reduce, spec, x = A * unit.count, unit.spec, unit.meta
            red_j = self._red(red, j, sp)
            cur = list(x.shape)
            for i, axs in shd.sharded_dims(spec):
                if not set(axs) & set(red_j):
                    cur[i] //= math.prod(sizes[a] for a in axs)
            for i, axs in shd.sharded_dims(spec):
                g = math.prod(sizes[a] for a in axs)
                if set(axs) <= set(red_j) and g > 1:
                    add("reduce_scatter", axs, _nbytes(cur, torch.float32),
                        n_reduce, "grads")
                    cur[i] //= g
            rest = tuple(a for a in red_j if a not in shd.spec_axes(spec))
            if math.prod(sizes[a] for a in rest) > 1:
                add("all_reduce", rest, _nbytes(cur, torch.float32),
                    n_reduce, "grads")
        if self.use_pod:
            numel = sum(math.prod(shd.block_shape(s, x.shape, mesh))
                        for x, s in zip(self.shapes, self.specs))
            L = len(self.specs)
            if self.codec == "int8":
                if self.in_pod:
                    add("all_reduce", self.in_pod, 4 * L, A, "int8 scales")
                add("all_gather", ("pod",), numel, A, "int8 codes")
                add("all_gather", ("pod",), 4 * L, A, "int8 scales")
            else:
                add("all_gather", ("pod",), 2 * numel, A, "bf16 grads")
        if split:
            add("all_reduce", split, 4 * 3 * A, 1, "metrics")
        add("all_reduce", mesh.axis_names, 4 * len(self.specs), 1,
            "grad norm")
        return out


    def _tp_plan(self, rows: int, seq: int, sp: bool = False) -> list:
        """(helper, bytes, calls, what) of the 'model' collectives of one
        microbatch of ``rows`` x ``seq`` on this rank, in the forward, the
        backward and the remat recompute (which repeats a block's forward
        ones, but not the reduce of a transformer FFN, a Mamba2 layer or
        an mLSTM block, which comes after the block). zamba2's shared
        block runs once a group, outside remat. Under seq_parallel
        (``sp``) a split product's input is all-gathered over L (its
        backward reduce-scatters) and its output reduce-scattered over L
        (its backward all-gathers), where they are all-reduced without."""
        from repro_torch.models import xlstm, zamba
        from repro_torch.models.transformer import dtype_of
        cfg, m, roles = self.cfg, self.n_model, self.roles
        e = dtype_of(cfg).itemsize
        tok = rows * seq
        act = tok * cfg.d_model * e
        twice = 2 if cfg.remat == "full" else 1
        L, L_twice = cfg.n_layers, twice
        if cfg.family == "hybrid":
            L, L_twice = zamba._group_struct(cfg)[0], 1
        blk = act // m
        out = []
        if "embed" in roles:
            out += [("reduce_scatter", act, 1, "sp embedding"),
                    ("all_gather", blk, 1, "sp embedding grads")] if sp \
                else [("all_reduce", act, 1, "tp embedding")]
        if "wo" in roles:
            out += [("all_gather", blk, L * L_twice, "sp attention input"),
                    ("reduce_scatter", act, L, "sp attention input grads")] \
                if sp else [("all_reduce", act, L,
                             "tp attention input grads")]
            for w, heads in (("wq", cfg.n_heads), ("wk", cfg.n_kv_heads),
                             ("wv", cfg.n_kv_heads)):
                if roles[w] == "head_dim":
                    whole = tok * heads * cfg.hd * e
                    out.append(("all_gather", whole // m, L * L_twice,
                                f"tp {w[1]} head_dim"))
                    out.append(("reduce_scatter", whole, L,
                                f"tp {w[1]} head_dim grads"))
            out += [("reduce_scatter", act, L * L_twice, "sp attention"),
                    ("all_gather", blk, L, "sp attention grads")] if sp \
                else [("all_reduce", act, L * L_twice, "tp attention")]
        if sp and ("w_gate" in roles or "we_gate" in roles):
            out += [("all_gather", blk, L * L_twice, "sp ffn input"),
                    ("reduce_scatter", act, L, "sp ffn input grads"),
                    ("reduce_scatter", act, L, "sp ffn"),
                    ("all_gather", blk, L, "sp ffn grads")]
        elif "w_gate" in roles or "we_gate" in roles:
            out.append(("all_reduce", act, L, "tp ffn input grads"))
            out.append(("all_reduce", act, L, "tp ffn"))
        if "we_gate" in roles:
            out.append(("all_reduce", tok * cfg.top_k * 4, L,
                        "tp gate grads"))
        # a Mamba2 layer / an mLSTM block (both under remat): the input's
        # gradient, the gathered in-projection, the norm's sum of squares
        # (summed in the backward too), and after the block the
        # out-projection's partials
        blocks = []
        if "w_in" in roles:
            di, N, H, _, _ = zamba._dims(cfg)
            blocks.append(("mamba", cfg.n_layers, 2 * di + 2 * N + H))
        if "mlstm.w_up" in roles:
            G, M, tail = xlstm._group_struct(cfg)
            blocks.append(("mlstm", G * M + tail, 4 * cfg.d_model))
        for what, n, width in blocks:
            out += [("all_reduce", act, n, f"tp {what} input grads"),
                    ("all_gather", tok * width // m * e, n * twice,
                     f"tp {what} in-projection"),
                    ("reduce_scatter", tok * width * e, n,
                     f"tp {what} in-projection grads"),
                    ("all_reduce", tok * 4, n * twice, f"tp {what} norm"),
                    ("all_reduce", tok * 4, n, f"tp {what} norm grads"),
                    ("all_reduce", act, n, f"tp {what}")]
        n_s = xlstm._group_struct(cfg)[0] if cfg.family == "ssm" else 0
        if "slstm.wx" in roles:                  # no remat: once each
            out += [("all_reduce", act, n_s, "tp slstm input grads"),
                    ("all_reduce", tok * 4, n_s, "tp slstm norm"),
                    ("all_reduce", tok * 4, n_s, "tp slstm norm grads"),
                    ("all_gather", act // m, n_s, "tp slstm")]
        if "slstm.w_gate" in roles:
            out += [("all_reduce", act, n_s, "tp slstm ffn input grads"),
                    ("all_reduce", act, n_s, "tp slstm ffn")]
        if sp:                  # ln_f on the block, L gathered for unembed
            out.append(("all_gather", blk, 1, "sp logits input"))
            if "unembed" in roles:
                out.append(("reduce_scatter", act, 1,
                            "sp logits input grads"))
        elif "unembed" in roles:
            out.append(("all_reduce", act, 1, "tp logits input grads"))
        if "unembed" in roles:
            out.append(("all_reduce", tok * 4, 1, "tp ce max"))
            out.append(("all_reduce", 2 * tok * 4, 1, "tp ce sums"))
        return out


def plan_calls(plan: list) -> dict:
    """{helper: calls} of a plan (what ``dist.calls`` counts)."""
    out = {}
    for e in plan:
        out[e["op"]] = out.get(e["op"], 0) + e["calls"]
    return out


def link_bytes(plan: list) -> float:
    """Bytes a rank sends over its links for a plan, by the ring model of
    each collective (the reference's ``parse_collectives`` rule):
    all-gather in_bytes * (g - 1), reduce-scatter in_bytes * (g - 1) / g,
    all-reduce 2 * bytes * (g - 1) / g."""
    total = 0.0
    for e in plan:
        g, b = e["group"], e["bytes"]
        one = {"all_gather": b * (g - 1),
               "reduce_scatter": b * (g - 1) / g,
               "all_reduce": 2.0 * b * (g - 1) / g}[e["op"]]
        total += one * e["calls"]
    return total


def shardings_for(cfg: ModelConfig, mesh, batch_shapes: dict,
                  gathered_params: bool = False) -> tuple:
    """(param specs, opt specs, batch specs, (param shapes, opt shapes)):
    spec trees from meta shapes, no allocation. ``gathered_params`` strips
    the FSDP axes (gather-params-once's layout)."""
    model = build(cfg)
    p_shapes = model.init(cfg, common.MetaDraw())
    o_shapes = adamw.init(p_shapes)
    p_specs = shd.param_specs(p_shapes, mesh, cfg.layout)
    if gathered_params:
        p_specs = shd.strip_fsdp(p_specs)
    o_specs = {"m": p_specs, "v": p_specs, "step": shd.Spec()}
    b_specs = shd.batch_specs(batch_shapes, mesh, cfg.layout)
    return p_specs, o_specs, b_specs, (p_shapes, o_shapes)


# ----------------------------------------------------------------- serve
def make_prefill_step(cfg: ModelConfig, mesh=None):
    """Prefill: forward over the prompt; returns the last position's greedy
    next token (B,). Given an empty cache (``init_cache``), the same pass
    also fills it (the prompt's K / V; the recurrent families' end
    states), so decoding goes on from position L (the reference's step
    leaves the cache to the caller). With a ``mesh`` it is a
    :class:`MeshServe` over this rank's blocks."""
    if mesh is not None:
        return MeshServe(cfg, mesh, "prefill")
    model = build(cfg)

    def prefill_step(params: dict, batch: dict,
                     cache: "dict | None" = None) -> torch.Tensor:
        logits, _ = model.forward(params, cfg, batch, cache=cache)
        return torch.argmax(logits[:, -1, :], dim=-1)

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None):
    """One greedy decode step against the cache: (next token (B,), cache).
    With a ``mesh`` it is a :class:`MeshServe` over this rank's blocks."""
    if mesh is not None:
        return MeshServe(cfg, mesh, "decode")
    model = build(cfg)

    def serve_step(params: dict, cache: dict, batch: dict) -> tuple:
        logits, cache = model.decode(params, cfg, cache, batch)
        return torch.argmax(logits[:, -1, :], dim=-1), cache

    return serve_step


# the cache leaves that may split a dim other than their heads over 'model'
# while their block's computation runs whole over it: an mLSTM memory by
# dhk, whose readout q·C is then summed over 'model'
# (xlstm._mlstm_decode_step)
_PARTIAL = ("m_C", "t_C")


class MeshServe(_MeshModel):
    """Prefill (``kind`` 'prefill') or one greedy decode step ('decode') on
    a live mesh, the program of the reference's serving cells (its dry-run
    lowers them with the parameters in their specs under ``cfg.layout``,
    the batch in its batch specs and the cache in ``cache_specs``), for
    every family:

    * the batch is the global batch; a rank reads its rows (split over the
      batch axes where they divide it, ``batch_specs``' block, else all of
      it) and returns their greedy tokens;
    * the parameters are this rank's blocks (``shardings_for``'s specs): a
      layer gathers its 'data' blocks as it runs and frees them after it
      (``common.fsdp_blocks``, forward only), ``embed``, ``ln_f`` and
      ``unembed`` at their use, zamba2's shared block once a call; under
      the tp layout the 'model' axis splits as :class:`MeshStep`'s does
      (``roles``): attention by heads (by head_dim where they do not
      divide), the FFN by its width, MoE by experts under both
      dispatches, a Mamba2 layer, an mLSTM block and an sLSTM block by
      heads, ``unembed`` by vocabulary. No rank holds a whole stacked
      leaf;
    * the cache is this rank's block of every leaf under
      ``serve_shardings``' specs (:meth:`init_cache`); prefill writes it,
      decode reads and writes it in place, a layer at a time. A KV cache
      holds its rows and its kv heads or its slice of head_dim (from a
      slice the attention logits are partial sums, summed over 'model'
      before the softmax); zamba2's shared cache at a batch that does not
      split holds its block of the positions over the batch axes (each
      rank's softmax maxima, sums and weighted v are combined over them,
      the new row written by the rank that holds its position). A
      recurrent state holds its heads' block; a conv state its block of
      the channels, gathered over 'model' a layer to convolve (the rank
      writes its block of the new state from the gathered in-projection's
      whole row); an mLSTM memory split by dhk (its heads do not divide
      'model') its rows of C, whose readout is summed over 'model'. A
      state whose spec leaves its rows whole while the batch splits holds
      every row: a rank computes its own and gathers the others' over the
      batch axes after each write;
    * under a vocabulary split the greedy token is the (value, index)
      maximum across 'model', the lowest index winning ties: the token of
      the unsharded ``torch.argmax``;
    * prefill under ``cfg.seq_parallel`` puts L over 'model' between the
      products, as :class:`MeshStep` does.

    Called as the unsharded steps are: ``serve(params, batch, cache=None)
    -> tokens`` (prefill), ``serve(params, cache, batch) -> (tokens,
    cache)`` (decode); :meth:`logits` gives this rank's logits.
    :meth:`plan` lists every collective of one call, in
    :meth:`MeshStep.plan`'s format."""

    def __init__(self, cfg: ModelConfig, mesh, kind: str):
        if kind not in ("prefill", "decode"):
            raise ValueError(f"kind must be 'prefill' or 'decode', got "
                             f"{kind!r}")
        super().__init__(cfg, mesh)
        self.kind = kind
        self.bax = shd.batch_axes_for(mesh, cfg.layout)

    # ------------------------------------------------------ rows and cache
    def row_axes(self, n: int) -> tuple:
        """The axes a global batch of ``n`` rows splits over: the batch
        axes where they divide it, else none (every rank takes all)."""
        nb = math.prod(self.mesh.sizes[a] for a in self.bax)
        return self.bax if n % nb == 0 else ()

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        sizes, coord = self.mesh.sizes, self.mesh.coord
        k, idx = 1, 0
        for a in self.row_axes(n):
            k, idx = k * sizes[a], idx * sizes[a] + coord[a]
        return slice(idx * (n // k), (idx + 1) * (n // k))

    def join_rows(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """Every rank's rows of ``x`` (this rank's of a global batch of
        ``n``: the tokens a call returns) joined in order: the global
        batch's, which the next decode step takes."""
        axes = self.row_axes(n)
        if not axes:
            return x
        return dist.all_gather_rows(x.contiguous(), 0, self.mesh.group(axes))

    @staticmethod
    def _parts(specs: dict, shapes: dict) -> list:
        """(leaf, spec, meta tensor) of each part of every cache leaf but
        ``pos`` (the four of the sLSTM's ``s_state`` tuple under its
        name)."""
        out = []
        for key, x in shapes.items():
            if key == "pos":
                continue
            if isinstance(x, tuple):
                out += [(key, s, t) for s, t in zip(specs[key], x)]
            else:
                out.append((key, specs[key], x))
        return out

    def cache_blocks(self, batch: int, max_len: int) -> dict:
        """{leaf: (shape, dtype)} of this rank's block of every leaf of the
        cache of a global batch of ``batch`` rows and ``max_len``
        positions (a list of them for a tuple leaf, the sLSTM's
        ``s_state``). Raises ``ValueError`` where this rank's blocks are
        not what its computation reads and writes: a leaf's rows must
        split as the batch's do, or (a recurrent state) be whole; an
        attention cache split over 'model' needs the attention split over
        it, and one whose positions split over the batch axes a batch that
        does not split and its kv heads whole on the rank's head_dim; a
        recurrent state split over 'model' needs its layer split by heads
        and the split on its heads (or, an mLSTM memory, on dhk with its
        block whole)."""
        specs, shapes = serve_shardings(self.cfg, self.mesh, batch, max_len)
        rows = set(self.row_axes(batch))
        out = {}
        for key, spec, x in self._parts(specs, shapes):
            self._check(key, spec, rows)
            blk = (shd.block_shape(spec, tuple(x.shape), self.mesh), x.dtype)
            if isinstance(shapes[key], tuple):
                out.setdefault(key, []).append(blk)
            else:
                out[key] = blk
        return out

    def _check(self, key: str, spec, rows: set) -> None:
        rdim, follows = self.model.CACHE[key]
        held = set(shd.entry_axes(spec[rdim]))
        attn = follows == "wo"
        if held != rows and (held or attn):
            raise ValueError(
                f"the cache's rows split over {tuple(held)} ({key} {spec}) "
                f"and the batch's over {tuple(rows)} (layout "
                f"{self.cfg.layout}): a rank would not hold its rows' cache")
        model = [i - rdim for i, axs in shd.sharded_dims(spec)
                 if "model" in axs] if self.n_model > 1 else []
        if attn:
            if model and "wo" not in self.roles:
                raise ValueError(
                    f"the cache splits over 'model' ({key} {spec}) and the "
                    f"attention does not (split: {sorted(self.roles)})")
            if self._seq_axes({key: spec}) and 3 in model:
                raise ValueError(
                    f"{key} {spec}: the cache splits its positions over the "
                    f"batch axes and its head_dim over 'model'; its decode "
                    f"would sum partial logits of blocks of positions")
            return
        if follows is None:              # gathered over 'model' a layer
            return
        split = follows in self.roles
        if model != ([1] if split else []) and not (
                key in _PARTIAL and model == [2] and not split):
            raise ValueError(
                f"cache[{key!r}] {spec} splits over 'model' on its dims "
                f"{model} (after the rows) and its layer computes "
                f"{'a block of its heads' if split else 'all its heads'} "
                f"(split: {sorted(self.roles)})")

    def _seq_axes(self, specs: "dict | None") -> tuple:
        """The axes that split an attention cache's positions (zamba2's
        shared cache at a batch that does not split), or ()."""
        for key in ("k", "ak"):
            if specs is not None and key in specs:
                axs = shd.entry_axes(specs[key][self.model.CACHE[key][0] + 1])
                if math.prod(self.mesh.sizes[a] for a in axs) > 1:
                    return axs
        return ()

    def init_cache(self, batch: int, max_len: int,
                   device: "torch.device | str" = "cuda") -> dict:
        """This rank's block of an empty cache (position 0): no rank makes
        the whole cache. ``len`` keeps the whole cache's positions (a
        block of them may be all a rank holds)."""
        zero = lambda b: torch.zeros(b[0], dtype=b[1], device=device)
        out = {k: tuple(map(zero, b)) if isinstance(b, list) else zero(b)
               for k, b in self.cache_blocks(batch, max_len).items()}
        out.update(pos=0, len=max_len)
        return out

    def _cache_specs(self, n: int, cache: dict) -> dict:
        """The specs of ``cache``, this rank's blocks of the cache of a
        global batch of ``n`` rows (from :meth:`init_cache`), after
        checking every block's shape."""
        if "len" not in cache:
            raise ValueError("a MeshServe call needs this rank's block of "
                             "the cache from its init_cache")
        for k, blk in self.cache_blocks(n, cache["len"]).items():
            parts = isinstance(blk, list)
            got = [tuple(t.shape) for t in (cache[k] if parts else [cache[k]])]
            if got != [tuple(b[0]) for b in (blk if parts else [blk])]:
                raise ValueError(f"cache[{k!r}] is {got}; this rank's "
                                 f"block is {blk}")
        return serve_shardings(self.cfg, self.mesh, n, cache["len"])[0]

    def context(self, n: int, specs: "dict | None" = None, sp: bool = False,
                live: bool = True) -> contextlib.ExitStack:
        """The contexts a call on a global batch of ``n`` rows runs in,
        with the cache of ``specs`` (None: none): the 'model' axis
        (``common.model_parallel`` with ``roles``, or the ``seq_roles``
        under seq_parallel, ``sp``; with nothing split it still gives the
        cache's collectives their group), and the batch axes that split
        the rows or the shared cache's positions
        (``common.cache_axes``). Not ``live``: with no process group (the
        dry-run's meta pass), as the rank at coordinate 0."""
        sizes = self.mesh.sizes
        coord = self.mesh.coord if live else dict.fromkeys(sizes, 0)
        group = self.mesh.group if live else (lambda axes: None)
        ctx = contextlib.ExitStack()
        if self.n_model > 1:
            ctx.enter_context(common.model_parallel(
                group(("model",)), self.n_model, coord["model"],
                self.seq_roles if sp else self.roles, seq=sp))
        seq = self._seq_axes(specs)
        axes = seq or self.row_axes(n)
        size, idx = 1, 0
        for a in axes:
            size, idx = size * sizes[a], idx * sizes[a] + coord[a]
        if size > 1:
            ctx.enter_context(common.cache_axes(group(axes), size, idx,
                                                bool(seq)))
        return ctx

    def _fetch(self, tree: dict, path: str, idx: tuple) -> dict:
        """``common.fsdp_blocks``' fetch: a unit's blocks gathered over
        their batch axes (a split leaf keeps its 'model' block)."""
        out = {}
        for k, b in tree.items():
            j = self.index[f"{path}.{k}" if path else k]
            u = self.units[j]
            if len(idx) != u.lead:
                raise ValueError(f"{path}.{k}: a layer takes {u.lead} "
                                 f"stack indices, got {idx}")
            out[k] = shd.gather(b, u.spec, self.mesh,
                                ("model",) if self.split[j] else ())
        return out

    # ----------------------------------------------------------- the step
    def logits(self, params: dict, batch: dict,
               cache: "dict | None" = None) -> tuple:
        """(this rank's rows' logits, the cache): the last dim this rank's
        block of the vocabulary where ``unembed`` is split over 'model'.
        Prefill fills an empty ``cache`` (this rank's block, from
        :meth:`init_cache`); decode needs one."""
        n, seq = next(iter(batch.values())).shape[:2]
        axes = self.row_axes(n)
        mine = self.rows(n)
        mb = {k: x[mine] for k, x in batch.items()}
        specs = None if cache is None else self._cache_specs(n, cache)
        sp = self._seq(seq, axes)
        with torch.no_grad(), self.context(n, specs, sp):
            with common.fsdp_blocks(self._fetch):
                if self.kind == "prefill":
                    logits, _ = self.model.forward(params, self.cfg, mb,
                                                   cache=cache)
                else:
                    logits, cache = self.model.decode(params, self.cfg,
                                                      cache, mb)
        return logits, cache

    def greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy tokens of this rank's rows: the last position's
        argmax over the whole vocabulary, across 'model' where ``unembed``
        is split (each rank's first maximum and its index, gathered; the
        largest value wins, then the lowest index)."""
        last = logits[:, -1, :]
        if "unembed" not in self.roles:
            return torch.argmax(last, dim=-1)
        idx = torch.argmax(last, dim=-1)
        val = torch.gather(last, -1, idx[:, None])[:, 0].float()
        base = self.mesh.coord["model"] * last.shape[-1]
        got = dist.all_gather(torch.stack([val, (idx + base).float()]),
                              self.mesh.group(("model",)))   # (m, 2, B)
        best = got[:, 0].amax(dim=0)
        cand = torch.where(got[:, 0] == best, got[:, 1],
                           torch.full_like(got[:, 1], float("inf")))
        return cand.amin(dim=0).long()

    def __call__(self, params: dict, a, b=None):
        if self.kind == "prefill":
            return self.greedy(self.logits(params, a, b)[0])
        logits, cache = self.logits(params, b, a)
        return self.greedy(logits), cache

    # ----------------------------------------------------------- the plan
    def plan(self, batch_shapes: dict, pos: int = 0,
             max_len: "int | None" = None) -> list:
        """Every collective one call makes on this mesh, in
        :meth:`MeshStep.plan`'s format, given the global batch's shapes,
        the whole cache's positions ``max_len`` (a prefill's None: it
        fills no cache; a decode's default ``pos + 1``) and, for decode,
        the position it reads (the logits summed over a head_dim-split
        cache grow with it). Needs no process group."""
        sizes = self.mesh.sizes
        n, seq = tuple(next(iter(batch_shapes.values())).shape)[:2]
        axes = self.row_axes(n)
        rows = n // math.prod(sizes[a] for a in axes)
        decode = self.kind == "decode"
        if decode and max_len is None:
            max_len = pos + 1
        specs, shapes = (None, None) if max_len is None else \
            serve_shardings(self.cfg, self.mesh, n, max_len)
        out = self.gather_plan(1, per_layer=True, remat=False)

        def add(op, axs, nbytes, calls, what):
            if calls:
                out.append(dict(op=op, axes=tuple(axs),
                                group=math.prod(sizes[a] for a in axs),
                                bytes=int(nbytes), calls=int(calls),
                                what=what))

        if self.tp:
            part = decode and "k" in specs and "model" in shd.entry_axes(
                specs["k"][-1])
            for e in self._serve_tp_plan(rows, seq, self._seq(seq, axes),
                                         part, pos):
                add(e[0], ("model",), *e[1:])
        if specs is not None:
            for e in self._cache_plan(specs, shapes, n, rows, decode):
                add(*e)
        return out

    def _serve_tp_plan(self, rows: int, seq: int, sp: bool, part: bool,
                       pos: int) -> list:
        """(helper, bytes, calls, what) of the 'model' collectives of one
        call on ``rows`` x ``seq`` (forward only); ``part``: decode from a
        head_dim slice of the cache, reading ``pos + 1`` rows. The
        attention and FFN run once a layer of a transformer and once an
        invocation of zamba2's shared block; a Mamba2 layer and an mLSTM
        block gather their in-projection, sum their gated norm's squares
        and reduce their out-projection; an sLSTM block sums its norm's
        squares and gathers its heads, and reduces its FFN."""
        from repro_torch.models import xlstm, zamba
        from repro_torch.models.transformer import dtype_of
        cfg, m, roles = self.cfg, self.n_model, self.roles
        e, H, hd = dtype_of(cfg).itemsize, cfg.n_heads, cfg.hd
        L = {"hybrid": zamba._group_struct(cfg)[0], "ssm": 0}.get(
            cfg.family, cfg.n_layers)
        tok = rows * seq
        act = tok * cfg.d_model * e
        blk = act // m
        out = []
        if "embed" in roles:
            out.append(("reduce_scatter", act, 1, "sp embedding") if sp
                       else ("all_reduce", act, 1, "tp embedding"))
        if "wo" in roles:
            if sp:
                out.append(("all_gather", blk, L, "sp attention input"))
            for w, heads in (("wq", H), ("wk", cfg.n_kv_heads),
                             ("wv", cfg.n_kv_heads)):
                if roles[w] == "head_dim":
                    out.append(("all_gather", tok * heads * hd * e // m, L,
                                f"tp {w[1]} head_dim"))
            if part:
                if roles["wq"] == "heads":
                    out.append(("all_gather", rows * H // m * hd * e, L,
                                "tp decode q heads"))
                out.append(("all_reduce", rows * H * (pos + 1) * 4, L,
                            "tp decode logits"))
                if roles["wo"] != "head_dim":
                    out.append(("all_gather", rows * H * hd // m * e, L,
                                "tp decode attention"))
            out.append(("reduce_scatter", act, L, "sp attention") if sp
                       else ("all_reduce", act, L, "tp attention"))
        if "w_gate" in roles or "we_gate" in roles:
            out += [("all_gather", blk, L, "sp ffn input"),
                    ("reduce_scatter", act, L, "sp ffn")] if sp \
                else [("all_reduce", act, L, "tp ffn")]
        blocks = []
        if "w_in" in roles:
            di, N, Hm, _, _ = zamba._dims(cfg)
            blocks.append(("mamba", cfg.n_layers, 2 * di + 2 * N + Hm))
        if "mlstm.w_up" in roles:
            G, M, tail = xlstm._group_struct(cfg)
            blocks.append(("mlstm", G * M + tail, 4 * cfg.d_model))
        for what, n, width in blocks:
            out += [("all_gather", tok * width // m * e, n,
                     f"tp {what} in-projection"),
                    ("all_reduce", tok * 4, n, f"tp {what} norm"),
                    ("all_reduce", act, n, f"tp {what}")]
        n_s = xlstm._group_struct(cfg)[0] if cfg.family == "ssm" else 0
        if "slstm.wx" in roles:
            out += [("all_reduce", tok * 4, n_s, "tp slstm norm"),
                    ("all_gather", blk, n_s, "tp slstm")]
        if "slstm.w_gate" in roles:
            out.append(("all_reduce", act, n_s, "tp slstm ffn"))
        if sp:
            out.append(("all_gather", blk, 1, "sp logits input"))
        if "unembed" in roles:
            out.append(("all_gather", 2 * rows * 4, 1, "tp greedy token"))
        return out

    def _cache_plan(self, specs: dict, shapes: dict, n: int, rows: int,
                    decode: bool) -> list:
        """(helper, axes, bytes, calls, what) of the collectives of the
        cache of ``specs`` and ``shapes`` in one call on this rank's
        ``rows`` of a global batch of ``n``, each a layer (a unit of a
        stacked leaf): the rows of a state whose block holds every row
        while the batch splits, gathered over the batch axes after each
        write; and in decode a conv state's 'model' blocks gathered, an
        mLSTM memory split by dhk's readout summed over 'model', and the
        combine over the batch axes of a shared-cache block of positions
        (its softmax maxima, then its sums and weighted v)."""
        out = []
        row_axes = self.row_axes(n)
        split = math.prod(self.mesh.sizes[a] for a in row_axes) > 1
        seq = self._seq_axes(specs)
        for key, spec, x in self._parts(specs, shapes):
            rdim, follows = self.model.CACHE[key]
            units = math.prod(x.shape[:rdim])
            uspec, ushape = spec[rdim:], tuple(x.shape[rdim:])
            blk = list(shd.block_shape(uspec, ushape, self.mesh))
            blk[0] = rows
            nbytes = math.prod(blk) * x.dtype.itemsize
            model = self.n_model > 1 and "model" in shd.spec_axes(uspec)
            if split and not shd.entry_axes(uspec[0]) and follows != "wo":
                out.append(("all_gather", row_axes, nbytes, units,
                            f"rows of {key}"))
            if not decode:
                continue
            if follows is None and model:
                out.append(("all_gather", ("model",), nbytes, units,
                            f"tp {key} blocks"))
            if key in _PARTIAL and model and "mlstm.wq" not in self.roles:
                out.append(("all_reduce", ("model",),
                            rows * ushape[1] * ushape[3] * 4, units,
                            f"tp {key} dhk readout"))
            if key in ("k", "ak") and seq:
                hq = self.cfg.n_heads // (self.n_model if "wo" in self.roles
                                          else 1)
                out += [("all_reduce", seq, rows * hq * 4, units,
                         f"seq {key} maxima"),
                        ("all_reduce", seq, rows * hq * (ushape[-1] + 1) * 4,
                         units, f"seq {key} sums")]
        return out


def serve_shardings(cfg: ModelConfig, mesh, batch: int,
                    max_len: int) -> tuple:
    """(cache specs, cache meta shapes); ``pos`` as the reference's 0-d
    int32."""
    c_shapes = build(cfg).init_cache(cfg, batch, max_len, device="meta")
    c_shapes["pos"] = torch.empty((), dtype=torch.int32, device="meta")
    return shd.cache_specs(c_shapes, mesh), c_shapes
