"""llama4-scout-17b-a16e [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 16 experts
top-1 (early fusion — text path; modality fusion stub not required for
the LM backbone cells)."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe", n_layers=48, d_model=5120,
    n_heads=40, n_kv_heads=8, d_ff=8192, vocab_size=202048,
    n_experts=16, top_k=1, rope_theta=5e5,
    dtype="bfloat16", remat="full")

SMOKE = ModelConfig(
    name="llama4-scout-smoke", family="moe", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=96, vocab_size=256,
    n_experts=4, top_k=1, dtype="float32", remat="none")
