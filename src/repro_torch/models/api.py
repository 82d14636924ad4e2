"""Model zoo public surface of the port: ModelConfig + the family
registry (twin of ``repro.models.api``).

``ModelConfig`` is the reference's, field for field, so a reference config
maps across unchanged (``convert.model_config``). ``remat="full"``
checkpoints each layer (each mLSTM / Mamba2 block) when autograd records
the forward (``common.remat``), as ``jax.checkpoint`` does there; serving
and ``"none"`` run plain. ``layout`` steers the port's sharding as it
does the reference's: the specs of ``launch.sharding.param_specs``, the
sharded steps (``launch.train_lib.MeshStep`` and ``MeshServe``: 'tp'
splits the 'model' axis as tensor and expert parallelism, 'fsdp' folds
it into the batch axes) and the dry-run's cells (``launch.dryrun``).
``seq_parallel`` puts L over 'model' in the transformer's residual
stream on a mesh, where the reference's ``constrain_hidden`` does (the
train step and the prefill under tp; no config of either package sets
it). ``scan_layers``, which steers only XLA there, is kept and has no
effect here: the port runs the layers in a Python loop. ``moe_impl``
picks the MoE dispatch, as there. ``use_flash`` and ``attn_block_q``,
which choose the attention path there, are kept and have no effect
either: prefill attention always goes through ``ops.flash_attention``
(the kernel on the card, its plain version on the CPU), as every kernel
of the port is chosen by tensor device. ``build``
accepts every family the reference builds: the transformer (dense / moe /
vlm / audio), xLSTM (``ssm``) and Zamba2 (``hybrid``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | audio | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False         # qwen-style
    rope_theta: float = 5e5
    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2
    moe_impl: str = "scatter"      # 'scatter': gather/scatter dispatch,
                                   # O(T*d) movement; 'einsum': GShard
                                   # one-hot dispatch, O(T*E*cap*d) FLOPs
                                   # (~2x expert compute — §Perf iter 4)
    # frontend: 'tokens' (embedding lookup) or 'embeds' (stub modality
    # frontend supplies precomputed patch/frame embeddings)
    frontend: str = "tokens"
    # ssm / hybrid structure
    ssm_state: int = 0             # mamba2 state size N
    ssm_conv: int = 4
    ssm_head_dim: int = 64         # mamba2 P
    ssm_expand: int = 2
    slstm_every: int = 0           # xLSTM: every k-th block is sLSTM
    attn_every: int = 0            # zamba2: shared attn block every k layers
    chunk: int = 256               # chunkwise scan length (mLSTM/SSD)
    # numerics / execution
    dtype: str = "bfloat16"
    remat: str = "full"            # none | full
    use_flash: bool = False        # Pallas attention in train/prefill
                                   # (no effect in the port)
    scan_layers: bool = True       # False: unroll (dry-run needs exact
                                   # cost_analysis; XLA doesn't scale while-
                                   # loop bodies by trip count)
    attn_block_q: int = 512        # blockwise-attention q tile (jnp path;
                                   # no effect in the port)
    seq_parallel: bool = False     # Korthikanti-style L-sharded residual
                                   # stream between the transformer's
                                   # products on a mesh (the reference
                                   # measured ~5% on prefill, 2.5x the
                                   # collectives on train) — off by
                                   # default
    layout: str = "tp"             # 'tp': tensor/expert parallel over
                                   # 'model' (baseline); 'fsdp': fold the
                                   # model axis into data parallelism —
                                   # per-layer weight AG replaces the
                                   # per-layer activation AR (4x less link
                                   # traffic for dense train at this size;
                                   # §Perf iteration 6)
    # capability flags
    subquadratic: bool = False     # long_500k eligibility (DESIGN.md §5)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def active_params(self) -> int:
        """~6*N*D convention's N: parameters touched per token."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.hd \
            + self.n_heads * self.hd * d
        if self.family == "ssm":
            din = self.ssm_expand * d
            blk = 2 * d * din + din * d + din * self.ssm_state * 2
            return self.n_layers * blk + 2 * V * d
        mlp = 3 * d * ff
        if self.is_moe:
            mlp = mlp * self.top_k + d * self.n_experts
        per_layer = attn + mlp
        if self.family == "hybrid":
            din = self.ssm_expand * d
            per_layer = 2 * d * din + din * d + din * self.ssm_state * 2
            shared = attn + 3 * d * ff
            return self.n_layers * per_layer + shared + 2 * V * d
        return self.n_layers * per_layer + 2 * V * d

    def total_params(self) -> int:
        if not self.is_moe:
            return self.active_params()
        d, ff = self.d_model, self.d_ff
        attn = d * (self.n_heads + 2 * self.n_kv_heads) * self.hd \
            + self.n_heads * self.hd * d
        per_layer = attn + 3 * d * ff * self.n_experts + d * self.n_experts
        return self.n_layers * per_layer + 2 * self.vocab_size * d


def build(cfg: ModelConfig):
    """Returns the family module implementing init/forward/init_cache/decode."""
    if cfg.family == "ssm":
        from repro_torch.models import xlstm
        return xlstm
    if cfg.family == "hybrid":
        from repro_torch.models import zamba
        return zamba
    from repro_torch.models import transformer
    return transformer
