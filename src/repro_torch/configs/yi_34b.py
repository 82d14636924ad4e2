"""yi-34b [arXiv:2403.04652; hf]
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 (llama arch)."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="yi-34b", family="dense", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, d_ff=20480, vocab_size=64000,
    rope_theta=5e6, dtype="bfloat16", remat="full")

SMOKE = ModelConfig(
    name="yi-34b-smoke", family="dense", n_layers=2, d_model=56,
    n_heads=7, n_kv_heads=1, d_ff=160, vocab_size=256,
    dtype="float32", remat="none")
