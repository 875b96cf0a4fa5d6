"""Model factory (PyTorch counterpart of ``repro.models.registry``)."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig

from .transformer import DecoderLM


def build_model(cfg: ModelConfig, device="cuda"):
    if cfg.family == "encdec":
        raise NotImplementedError("encoder-decoder models are not ported yet")
    return DecoderLM(cfg, device=device)
