"""[PyTorch port: a copy of ``repro.configs.granite_3_8b``, kept here so the port imports
nothing of the JAX package.]

granite-3-8b [dense]: 40L d=4096 32H (GQA kv=8) d_ff=12800 vocab=49155.
Source: hf:ibm-granite family (GQA, SwiGLU, RoPE)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-8b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, d_ff=12800, vocab=49155,
    mlp="swiglu", accum=2,
)

def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
                          vocab=512, accum=1, attn_chunk=64)
