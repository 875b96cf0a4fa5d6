"""[PyTorch port: a copy of ``repro.configs.recurrentgemma_2b``, kept here so the port
imports nothing of the JAX package.]

recurrentgemma-2b [hybrid]: 26L d=2560 10H (MQA kv=1) d_ff=7680 vocab=256000.
RG-LRU + local (sliding-window) attention in a 2:1 pattern (arXiv:2402.19427:
two recurrent blocks followed by one local-attention block)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv=1, d_ff=7680, vocab=256000,
    mlp="geglu", block_pattern=("rec", "rec", "attn"), lru_width=2560,
    conv_width=4, window=2048, accum=2,
)

def reduced() -> ModelConfig:
    return CONFIG.replace(n_layers=3, d_model=64, n_heads=4, n_kv=1, d_ff=128,
                          vocab=512, lru_width=64, window=32, accum=1, attn_chunk=32)
