"""qwen1.5-32b [hf:Qwen/Qwen1.5-0.5B config family; hf]
64L d_model=5120 40H (GQA kv=40 — full MHA KV) d_ff=27392 vocab=152064,
QKV bias."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120,
    n_heads=40, n_kv_heads=40, d_ff=27392, vocab_size=152064,
    qkv_bias=True, rope_theta=1e6, dtype="bfloat16", remat="full")

SMOKE = ModelConfig(
    name="qwen1.5-smoke", family="dense", n_layers=2, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=160, vocab_size=256,
    qkv_bias=True, dtype="float32", remat="none")
