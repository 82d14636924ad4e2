"""musicgen-large [arXiv:2306.05284; hf]
48L d_model=2048 32H (kv=32, MHA) d_ff=8192 vocab=2048 (EnCodec codes).
Decoder-only over EnCodec tokens; the EnCodec frontend is a stub —
input_specs() supplies precomputed frame embeddings."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="musicgen-large", family="audio", n_layers=48, d_model=2048,
    n_heads=32, n_kv_heads=32, d_ff=8192, vocab_size=2048,
    frontend="embeds", rope_theta=1e4, dtype="bfloat16", remat="full")

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=160, vocab_size=64,
    frontend="embeds", dtype="float32", remat="none")
