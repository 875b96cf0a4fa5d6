"""[PyTorch port: a copy of ``repro.configs.mamba2_130m``, kept here so the port imports
nothing of the JAX package.]

mamba2-130m [ssm]: 24L d=768, attention-free, vocab=50280, ssm_state=128.
SSD (state-space duality) blocks per arXiv:2405.21060: expand=2, head_dim=64
=> 24 SSD heads; chunked scan with chunk=128."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m", family="ssm",
    n_layers=24, d_model=768, n_heads=1, n_kv=1, d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
    tie_embeddings=True, accum=1,
)

def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, vocab=512, ssm_state=16,
                          ssm_head_dim=16, ssm_chunk=32, accum=1)
