"""Plain PyTorch version of the flash-attention kernel (independent of models/).

Follows ``repro.kernels.flash_attention.ref.attention_ref``: K/V repeated to
the query heads, float32 scores (float64 for float64 inputs), a ``NEG_INF``
band mask, softmax, output in q's dtype.  The CPU tests run it, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """q: (B, Sq, H, hd); k/v: (B, Skv, Hkv, hd) with H % Hkv == 0."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if hkv != h:
        rep = h // hkv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) / math.sqrt(hd)
    diff = (
        torch.arange(sq, device=q.device)[:, None] - torch.arange(skv, device=q.device)[None, :]
    )
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= diff >= 0
    if window > 0:
        mask &= diff < window
    s = torch.where(mask[None, None], s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(ct))
    return out.to(q.dtype)
