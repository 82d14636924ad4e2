"""xlstm-125m [arXiv:2405.04517; unverified]
12L d_model=768 4H d_ff=0 vocab=50304 — sLSTM + mLSTM blocks (1 sLSTM per
4-block group; mLSTM pf=2 / sLSTM pf=4/3 gated projections replace the
FFN, hence d_ff=0). Sub-quadratic: runs long_500k."""
from repro_torch.models.api import ModelConfig

FULL = ModelConfig(
    name="xlstm-125m", family="ssm", n_layers=12, d_model=768,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=50304,
    slstm_every=4, chunk=256, subquadratic=True,
    dtype="bfloat16", remat="full")

SMOKE = ModelConfig(
    name="xlstm-smoke", family="ssm", n_layers=4, d_model=64,
    n_heads=4, n_kv_heads=4, d_ff=0, vocab_size=256,
    slstm_every=2, chunk=16, subquadratic=True,
    dtype="float32", remat="none")
