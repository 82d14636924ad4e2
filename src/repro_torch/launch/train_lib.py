"""Step builders (twin of ``repro.launch.train_lib``): the loss and the
train step with gradient accumulation, the prefill step and the greedy
decode step. PyTorch runs eagerly, so each builder returns a plain
function (the reference returns what it jit-compiles). ``shardings_for``
and ``serve_shardings`` come with the mesh and sharding slice (ROADMAP
item 14)."""
from __future__ import annotations

import torch

from repro_torch.models import common
from repro_torch.models.api import ModelConfig, build
from repro_torch.optim import adamw


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
    last one's. ``grad_compress`` acts only over a 'pod' mesh axis in the
    reference and ``gather_params_once`` only moves sharding, so on one
    device neither has an effect. A ``mesh`` raises: meshes come with the
    mesh and sharding slice (ROADMAP item 14)."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=...): meshes and sharding come with the "
            "mesh/sharding slice of ROADMAP item 14; pass mesh=None")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    loss_fn = make_loss_fn(cfg)

    def grads_of(params: dict, batch: dict) -> tuple:
        flat = [w.detach().requires_grad_() for w in adamw.leaves(params)]
        loss, metrics = loss_fn(adamw.tree_like(params, flat), batch)
        grads = torch.autograd.grad(loss, flat)
        return loss.detach(), {k: m.detach() for k, m in metrics.items()}, \
            grads

    def train_step(params: dict, opt_state: dict, batch: dict) -> tuple:
        if accum_steps > 1:
            n = next(iter(batch.values())).shape[0]
            if n % accum_steps:
                raise ValueError(f"batch of {n} does not split into "
                                 f"{accum_steps} equal microbatches")
            per = n // accum_steps
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


# ----------------------------------------------------------------- serve
def make_prefill_step(cfg: ModelConfig):
    """Prefill: forward over the prompt; returns the last position's greedy
    next token (B,). Given an empty cache (``init_cache``), the same pass
    also fills it (the prompt's K / V; the recurrent families' end
    states), so decoding goes on from position L (the reference's step
    leaves the cache to the caller)."""
    model = build(cfg)

    def prefill_step(params: dict, batch: dict,
                     cache: "dict | None" = None) -> torch.Tensor:
        logits, _ = model.forward(params, cfg, batch, cache=cache)
        return torch.argmax(logits[:, -1, :], dim=-1)

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step against the cache: (next token (B,), cache)."""
    model = build(cfg)

    def serve_step(params: dict, cache: dict, batch: dict) -> tuple:
        logits, cache = model.decode(params, cfg, cache, batch)
        return torch.argmax(logits[:, -1, :], dim=-1), cache

    return serve_step
