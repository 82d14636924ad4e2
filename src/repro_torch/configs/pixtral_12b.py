"""pixtral-12b [hf:mistralai/Pixtral-12B-2409; unverified]
40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072.
Backbone only (mistral-nemo body); the pixtral-ViT frontend is a stub —
input_specs() supplies precomputed patch embeddings (B, L, d_model)."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="pixtral-12b", family="vlm", n_layers=40, d_model=5120,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab_size=131072,
    head_dim=128, frontend="embeds", rope_theta=1e6,
    dtype="bfloat16", remat="full")

SMOKE = ModelConfig(
    name="pixtral-smoke", family="vlm", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=2, d_ff=160, vocab_size=256,
    frontend="embeds", dtype="float32", remat="none")
