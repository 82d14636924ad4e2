"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct; hf]
32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe", n_layers=32, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=6400, vocab_size=32064,
    n_experts=16, top_k=2, rope_theta=1e4,
    dtype="bfloat16", remat="full")

SMOKE = ModelConfig(
    name="phi3.5-moe-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=256,
    n_experts=4, top_k=2, dtype="float32", remat="none")
