"""AdamW over nested dicts of tensors (twin of ``repro.optim.adamw``).

Moments are fp32 whatever the parameter dtype; the update is computed in
fp32 and cast back, with weight decay on leaves of two or more dims (the
stacked per-layer norms are 2-D and decayed, as in the reference). Unlike
the reference's functional update, :func:`update` writes the parameters
and moments in place, leaf by leaf: the reference's jitted step donates
both trees, and keeping an old and a new tree side by side would double
their bytes. Leaves are walked in the reference's pytree order (dict keys
sorted), so the global norm sums them in the same order.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1


def leaves(tree) -> list:
    """The tensors of a nested dict, dict keys sorted (the reference's
    ``jax.tree.leaves`` order)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += leaves(v) if isinstance(v, dict) else [v]
    return out


def tree_like(tree, values):
    """A nested dict of ``tree``'s structure holding ``values`` (an
    iterable in :func:`leaves` order)."""
    it = iter(values)

    def walk(t):
        return {k: walk(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}

    return walk(tree)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay, fp32."""
    step = step.float()
    warm = step / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.decay_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.clamp(warm, max=1.0) * cos


def init(params: dict) -> dict:
    """Zero fp32 moments beside every leaf and an int32 0-d step counter,
    on the parameters' device."""
    f32 = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return {"m": tree_like(params, map(f32, leaves(params))),
            "v": tree_like(params, map(f32, leaves(params))),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the fp32 sums of squares of the leaves, added in leaf
    order."""
    total = 0.0
    for g in leaves(tree) if isinstance(tree, dict) else tree:
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: dict, params: dict,
           gnorm: "torch.Tensor | None" = None) -> tuple:
    """One AdamW step; ``grads`` is a tree like ``params`` or a list in
    :func:`leaves` order. Writes ``params`` and ``state``'s moments in
    place and returns (params, state, {'grad_norm', 'lr'}) with the
    advanced step. ``gnorm`` is the gradients' global norm when they are
    one rank's blocks (the sharded step computes it over the mesh); by
    default :func:`global_norm` of ``grads``."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0) if cfg.grad_clip else 1.0
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    flat_g = leaves(grads) if isinstance(grads, dict) else list(grads)
    for p, g, m, v in zip(leaves(params), flat_g, leaves(state["m"]),
                          leaves(state["v"])):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        den = (v / b2c).sqrt_().add_(cfg.eps)
        upd = (m / b1c).div_(den)
        del den
        if p.ndim >= 2:  # decay matrices only, not norms / biases
            upd.add_(cfg.weight_decay * p.float())
        p.copy_(torch.sub(p.float(), upd.mul_(lr)))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
