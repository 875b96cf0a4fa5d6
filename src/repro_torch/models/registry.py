"""Model factory (PyTorch counterpart of ``repro.models.registry``).

The dense, hybrid (RG-LRU) and SSM (Mamba-2) families build ``DecoderLM``; the kinds it
does not serve yet raise ``NotImplementedError`` there."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from .transformer import DecoderLM


def build_model(cfg: ModelConfig, device="cuda"):
    if cfg.family == "encdec":
        raise NotImplementedError("encoder-decoder models are not ported yet")
    return DecoderLM(cfg, device=device)
