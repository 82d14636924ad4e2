"""zamba2-1.2b [arXiv:2411.15242; hf]
38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000, ssm_state=64 —
Mamba2 backbone + one shared attention block every 6 layers.
Sub-quadratic: runs long_500k."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="zamba2-1.2b", family="hybrid", n_layers=38, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, attn_every=6,
    chunk=256, subquadratic=True, dtype="bfloat16", remat="full")

SMOKE = ModelConfig(
    name="zamba2-smoke", family="hybrid", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
    ssm_state=16, ssm_head_dim=16, attn_every=2, chunk=16,
    subquadratic=True, dtype="float32", remat="none")
