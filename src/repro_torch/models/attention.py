"""Attention: GQA/MQA, causal + sliding-window, full-sequence and decode.

PyTorch counterpart of ``repro.models.attention``:

  * ``attn_xla``    — plain masked grouped einsum, the reference's oracle.
  * ``attn_decode`` — one new token against a (possibly ring-buffered) KV
                      cache, with the two-part softmax for ``extra_kv``.  It
                      has no Pallas kernel in the reference and stays plain
                      PyTorch here.
  * ``attention``   — the full-sequence dispatcher.  On a CUDA tensor every
                      call goes to the hand-written flash kernel
                      (``repro_torch.kernels.flash_attention``); on the CPU
                      to ``attn_xla``.  ``impl == "xla"`` forces ``attn_xla``
                      on any device, as it does in the reference.

The reference's ``chunked``/``triangular`` variants work around XLA's
memory limits; the kernel takes their place on the card and computes the
same function.  Score products take float32 inputs, the counterpart of the
reference's ``preferred_element_type=jnp.float32``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.flash_attention import ops as fa_ops

NEG_INF = -1e30


def _band_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int):
    """Boolean mask (..., S_q, S_kv): True = attend."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    mask = torch.ones(diff.shape, dtype=torch.bool, device=diff.device)
    if causal:
        mask &= diff >= 0
    if window > 0:
        mask &= diff < window
    return mask


def _group_q(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, Hkv, G, hd): K/V are never repeated to H heads."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, hkv, h // hkv, hd)


def attn_xla(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
) -> torch.Tensor:
    """Reference attention.  q_offset shifts query positions (decode/chunks)."""
    b, sq, h, hd = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(hd)
    qg = _group_q(q * torch.tensor(scale, dtype=q.dtype), hkv)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg.to(k.dtype).float(), k.float())
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(skv, device=q.device)
    mask = _band_mask(q_pos, k_pos, causal, window)
    scores = scores.masked_fill(~mask[None, None, None], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def attn_decode(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    cur_len,
    *,
    window: int = 0,
    ring: bool = False,
    extra_kv: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> torch.Tensor:
    """q: (B, 1, H, hd); caches: (B, S_max, Hkv, hd); cur_len: () or (B,)
    number of valid cache positions.

    ``ring`` marks a sliding-window ring buffer: all S_max slots are valid
    once cur_len >= S_max (softmax is order-invariant).  ``extra_kv``:
    (k_new, v_new) of shape (B, 1, Hkv, hd), the current token's K/V,
    attended alongside the read-only cache by a two-part online softmax."""
    b, sq, h, hd = q.shape
    s_max = k_cache.shape[1]
    hkv = k_cache.shape[2]
    g = h // hkv
    scale = 1.0 / math.sqrt(hd)
    qg = (q * torch.tensor(scale, dtype=q.dtype)).reshape(b, sq, hkv, g, hd)
    qf = qg.to(k_cache.dtype).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qf, k_cache.float())
    k_pos = torch.arange(s_max, device=q.device)
    cur = torch.as_tensor(cur_len, device=q.device)
    cur = cur[..., None, None, None, None] if cur.ndim else cur
    if ring:
        valid = k_pos < torch.clamp(cur, max=s_max)
        if extra_kv is not None:
            # the slot the new token will occupy still holds the token that
            # just left the window: mask it out
            stale = (k_pos == torch.remainder(cur, s_max)) & (cur >= s_max)
            valid = valid & ~stale
    else:
        valid = k_pos < cur
        if window > 0:
            valid = valid & (k_pos >= (cur - window))
    valid = valid.expand(s.shape) if valid.ndim == s.ndim else valid[None, None, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    if extra_kv is not None:
        k_new, v_new = extra_kv
        s_self = torch.einsum("bqkgd,bskd->bkgqs", qg.to(k_new.dtype).float(), k_new.float())
        m = torch.maximum(torch.amax(s, dim=-1, keepdim=True), s_self)
        p = torch.exp(s - m)
        p_self = torch.exp(s_self - m)
        denom = torch.sum(p, dim=-1, keepdim=True) + p_self
        out = torch.einsum(
            "bkgqs,bskd->bqkgd", p.to(v_cache.dtype).float(), v_cache.float()
        ) + torch.einsum(
            "bkgqs,bskd->bqkgd", p_self.to(v_new.dtype).float(), v_new.float()
        )
        # denom (b, kv, g, q, 1) -> (b, q, kv, g, 1) to divide out (b,q,kv,g,d)
        out = out / torch.movedim(denom[..., 0], -1, 1)[..., None]
    else:
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bkgqs,bskd->bqkgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    impl: str = "chunked",
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """Full-sequence attention.  The reference sends ``q_len <= attn_chunk``
    to ``attn_xla`` and longer queries to its streamed variants or the
    Pallas kernel; all of them compute one function, so here only the device
    decides which implementation runs."""
    if impl == "xla" or q.device.type != "cuda":
        return attn_xla(q, k, v, causal=causal, window=window)
    return fa_ops.flash_attention(q, k, v, causal=causal, window=window)
